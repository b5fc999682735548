"""Normalizing-flow variational inference (RealNVP couplings).

Port of the JAX package's ``samplers/flows.py``: a RealNVP flow pushes
``N(0, I)`` through alternating affine coupling layers, so ``q`` can fit
curved, non-Gaussian posteriors.  The coupling nets are two-layer tanh
MLPs stored as plain dicts of tensors, optimized by optax's Adam update
through :func:`..ppl.elbo.scan_vi` exactly like :mod:`.advi`.  The
``n_mc`` draws of a step are one ``vmap`` batch of the target: through
the linreg kernel, one launch.

ELBO with the reparameterization trick through the flow::

    x = f(z),  z ~ N(0, I)
    ELBO = E_z[ logp(x) + logdet Jf(z) ] + H[N(0, I)]

Dimension-1 targets have nothing to couple; ``realnvp_advi_fit``
requires ``d >= 2`` and points dim-1 users at :func:`.advi.advi_fit`.
"""

from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple

import torch

from ..ppl.elbo import gaussian_entropy, normal, scan_vi
from ..utils import LOG_2PI
from .util import flatten_logp

__all__ = ["FlowADVIResult", "realnvp_advi_fit"]


def _mlp_init(noise, in_dim, hidden, out_dim, like):
    """One coupling net; ``noise`` gives the ``(in_dim, hidden)`` first
    layer's standard normal draws (a generator, or the draws)."""
    s1 = 1.0 / math.sqrt(in_dim)
    z = lambda *shape: torch.zeros(shape, dtype=like.dtype, device=like.device)
    return {
        "w1": s1 * normal(noise, (in_dim, hidden), like),
        "b1": z(hidden),
        # zero-init output layer: the flow starts as the identity, which
        # keeps early ELBO gradients sane (standard RealNVP practice).
        "w2": z(hidden, 2 * out_dim),
        "b2": z(2 * out_dim),
    }


def _mlp_apply(p, x):
    h = torch.tanh(x @ p["w1"] + p["b1"])
    return h @ p["w2"] + p["b2"]


def _coupling_forward(p, x, mask):
    """One affine coupling: the masked half parameterizes an affine
    map of the complement.  Returns ``(y, logdet)``."""
    xm = x * mask
    st = _mlp_apply(p, xm)
    d = x.shape[-1]
    s, t = st[..., :d], st[..., d:]
    # soft-clamp the log-scale so one bad step cannot explode the flow
    s = torch.tanh(s) * 2.0
    free = 1.0 - mask
    y = xm + free * (x * torch.exp(s) + t)
    logdet = torch.sum(free * s, dim=-1)
    return y, logdet


def _flow_forward(flow, masks, x):
    """``x`` through the coupling stack: ``(y, Σ logdet)``."""
    logdet = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    for p, mask in zip(flow, masks):
        x, ld = _coupling_forward(p, x, mask)
        logdet = logdet + ld
    return x, logdet


class FlowADVIResult(NamedTuple):
    flow_params: Any  # list of coupling-net dicts
    masks: torch.Tensor  # (num_layers, d) binary masks
    shift: torch.Tensor  # (d,) base-distribution shift (the init point)
    elbo_trace: torch.Tensor  # (num_steps,)
    dim: int

    def _forward(self, z):
        """The same map the ELBO optimized: shifted base through the
        coupling stack.  The shift is volume-preserving (logdet 0)."""
        return _flow_forward(self.flow_params, self.masks, z + self.shift)

    def sample(self, generator: torch.Generator, n: int, unravel) -> Any:
        x, _ = self._forward(normal(generator, (n, self.dim), self.shift))
        return unravel(x)

    def sample_with_logq(self, generator: torch.Generator, n: int):
        """Flat draws and their variational log-density (for importance
        reweighting / PSIS diagnostics)."""
        z = normal(generator, (n, self.dim), self.shift)
        x, logdet = self._forward(z)
        log_base = -0.5 * torch.sum(z**2, dim=-1) - 0.5 * self.dim * LOG_2PI
        return x, log_base - logdet


def flow_neg_elbo(batch_logp, masks, shift, n_mc):
    """The flow estimator: ``-(E_z[logp(f(z)) + logdet] + H[N(0, I)])``
    from ``n_mc`` base draws shifted by ``shift``."""
    dim = shift.shape[0]
    base_entropy = gaussian_entropy(dim)

    def neg_elbo(flow, noise):
        z = normal(noise, (n_mc, dim), shift)
        # shift the base by the init point so the identity-init flow
        # starts centered where the user's init_params point
        x, logdet = _flow_forward(flow, masks, z + shift[None, :])
        return -(torch.mean(batch_logp(x) + logdet) + base_entropy)

    return neg_elbo


def realnvp_advi_fit(
    logp_fn: Callable[[Any], torch.Tensor],
    init_params: Any,
    *,
    generator: torch.Generator,
    num_layers: int = 6,
    hidden: int = 32,
    num_steps: int = 3000,
    n_mc: int = 16,
    learning_rate: float = 3e-3,
) -> tuple[FlowADVIResult, Callable]:
    """Fit a RealNVP flow posterior to ``logp_fn``.

    Same contract as :func:`.advi.advi_fit`: returns ``(result,
    unravel)``; ``result.sample(generator, n, unravel)`` draws in the
    user's pytree structure.  The nets' first layers are drawn from
    ``generator`` first, then each step's base draws.
    """
    flat_logp, flat_init, unravel = flatten_logp(logp_fn, init_params)
    flat_init = flat_init.detach()
    dim = flat_init.shape[0]
    if dim < 2:
        raise ValueError("RealNVP couplings need d >= 2; use advi_fit for scalars")
    # alternating even/odd masks
    base_mask = (torch.arange(dim, device=flat_init.device) % 2).to(flat_init.dtype)
    masks = torch.stack([base_mask if i % 2 == 0 else 1.0 - base_mask
                         for i in range(num_layers)])
    flow0 = [_mlp_init(generator, dim, hidden, dim, flat_init) for _ in range(num_layers)]
    neg_elbo = flow_neg_elbo(torch.func.vmap(flat_logp), masks, flat_init, n_mc)
    flow, elbos = scan_vi(
        neg_elbo, flow0, generator=generator, num_steps=num_steps, learning_rate=learning_rate
    )
    result = FlowADVIResult(
        flow_params=flow,
        masks=masks,
        shift=flat_init,
        elbo_trace=elbos,
        dim=dim,
    )
    return result, unravel

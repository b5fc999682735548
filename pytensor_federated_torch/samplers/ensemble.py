"""Affine-invariant ensemble sampler (stretch move) — gradient-free MCMC.

Port of the JAX package's ``samplers/ensemble.py``.  To update walker
``x``, pick a partner ``c`` from the complementary half-ensemble, draw
``z`` from ``g(z) ∝ 1/sqrt(z)`` on ``[1/a, a]``, propose ``y = c + z (x
- c)`` and accept with probability ``min(1, z^(d-1) p(y)/p(x))``.  Every
step updates the two half-ensembles in turn, each with one batched logp
evaluation of its ``n_walkers / 2`` proposals: through the linreg
kernel, one launch.  Where the JAX package takes a PRNG key this takes a
``torch.Generator``; the run is an eager loop with no host sync.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from .util import flatten_logp


class EnsembleResult(NamedTuple):
    samples: Any  # user pytree, leaves lead with (n_steps, n_walkers)
    logps: torch.Tensor  # (n_steps, n_walkers)
    accept_rate: torch.Tensor  # scalar mean acceptance


def _stretch_move(batch_logp, movers, movers_lp, others, u, partner, u_acc, stretch_a):
    """Stretch-move update of one half-ensemble against the other, from
    its draws: ``u`` and ``u_acc`` uniform ``(half,)``, ``partner``
    indices into ``others``.  Returns ``(movers, logps, acceptance)``."""
    dim = movers.shape[-1]
    # z ~ g(z) ∝ 1/sqrt(z) on [1/a, a]:  z = ((a-1) u + 1)^2 / a
    z = ((stretch_a - 1.0) * u + 1.0) ** 2 / stretch_a
    partners = others[partner]
    prop = partners + z[:, None] * (movers - partners)
    prop_lp = batch_logp(prop)
    log_ratio = (dim - 1) * torch.log(z) + prop_lp - movers_lp
    acc = torch.log(u_acc) < log_ratio
    movers = torch.where(acc[:, None], prop, movers)
    movers_lp = torch.where(acc, prop_lp, movers_lp)
    return movers, movers_lp, torch.mean(acc.to(movers.dtype))


def _half_draws(generator, half, like):
    kw = dict(generator=generator, dtype=like.dtype, device=like.device)
    u = torch.rand((half,), **kw)
    partner = torch.randint(0, half, (half,), generator=generator, device=like.device)
    return u, partner, torch.rand((half,), **kw)


@torch.no_grad()
def ensemble_sample(
    logp_fn: Callable[[Any], torch.Tensor],
    init_params: Any,
    *,
    generator: torch.Generator,
    n_walkers: int = 64,
    num_warmup: int = 500,
    num_samples: int = 500,
    stretch_a: float = 2.0,
    init_jitter: float = 0.1,
    thin: int = 1,
) -> EnsembleResult:
    """Run the stretch-move ensemble sampler against ``logp_fn``.

    ``n_walkers`` must be even and should be >= 2x the parameter
    dimension.  Per step both half-ensembles update, costing two batched
    logp evaluations of ``n_walkers/2`` particles each.
    """
    if n_walkers % 2 != 0:
        raise ValueError(f"n_walkers must be even, got {n_walkers}")
    flat_logp, flat_init, unravel = flatten_logp(logp_fn, init_params)
    dim = flat_init.shape[0]
    if n_walkers < 2 * dim:
        raise ValueError(
            f"n_walkers={n_walkers} < 2*dim={2 * dim}; the stretch move "
            "degenerates when the ensemble does not span the space"
        )
    half = n_walkers // 2
    batch_logp = torch.func.vmap(flat_logp)
    x = flat_init[None, :] + init_jitter * torch.randn(
        (n_walkers, dim), generator=generator, dtype=flat_init.dtype, device=flat_init.device)
    lp = batch_logp(x)
    xs, lps, accs = [], [], []
    for _ in range(num_warmup + num_samples * thin):
        a, a_lp, acc_a = _stretch_move(batch_logp, x[:half], lp[:half], x[half:],
                                       *_half_draws(generator, half, x), stretch_a)
        b, b_lp, acc_b = _stretch_move(batch_logp, x[half:], lp[half:], a,
                                       *_half_draws(generator, half, x), stretch_a)
        x, lp = torch.cat([a, b]), torch.cat([a_lp, b_lp])
        xs.append(x)
        lps.append(lp)
        accs.append(0.5 * (acc_a + acc_b))
    keep = torch.stack(xs[num_warmup::thin][:num_samples])
    keep_lp = torch.stack(lps[num_warmup::thin][:num_samples])
    accept = torch.stack(accs[num_warmup:]).mean()
    return EnsembleResult(samples=unravel(keep), logps=keep_lp, accept_rate=accept)

"""Expert parallelism: mixture components sharded over a mesh axis.

Port of the JAX package's ``parallel/expert.py``.  The Bayesian analog
of MoE expert sharding is a mixture likelihood whose COMPONENT set
outgrows a device: each slot owns a block of components (its
"experts") and evaluates their densities for every observation; the
per-observation mixture loglik is then a cross-slot ``logsumexp``, by
the max-shift trick: the shift is the max over every slot's block
maximum, taken under ``detach()`` (the JAX package's
``stop_gradient``), so the gradient flows only through the summed term,
exactly as in the one-device logsumexp identity.  The weights'
log-softmax is the same construction.

In a single controller (:mod:`.mesh`) each parameter is a tuple of
per-slot blocks, block ``j`` on slot ``j``'s device; the observations
are copied to every slot, the shifts are gathered on the first slot's
device and sent back, and the slots' sums are added there in slot
order.  Every observation "visits" every expert, but each slot only
ever holds its own component block.
"""

from __future__ import annotations

from typing import Any, List, Optional

import numpy as np
import torch

from ..models.linear import _normal_logpdf
from ..utils import resolve_device, tree_map, value_and_grad
from .mesh import Mesh
from .sharded import _cross_slot_sum

EXPERTS_AXIS = "experts"

__all__ = ["EXPERTS_AXIS", "ExpertShardedMixture"]

_KEYS = ("mu", "log_sigma", "weight_logits")


def _local_terms(y, log_w_block, mu_block, log_sigma_block):
    """(n, K_local) component log-terms: log w_k + logN(y | mu_k, s_k)."""
    sigma = torch.exp(log_sigma_block)
    return log_w_block[None, :] + _normal_logpdf(y[:, None], mu_block[None, :], sigma[None, :])


def _axis_max(local: List[torch.Tensor], home: torch.device) -> torch.Tensor:
    """The max over every slot's ``local`` maximum, on ``home``, out of
    the gradient (the logsumexp shift is gradient-neutral)."""
    return torch.stack([m.detach().to(home) for m in local]).amax(0)


class ExpertShardedMixture:
    """Gaussian mixture with components sharded over ``"experts"``.

    ``params``: ``mu`` (K,), ``log_sigma`` (K,), ``weight_logits`` (K,) —
    on a mesh each a tuple of per-slot blocks (block ``j`` on slot
    ``j``'s device), else one tensor each.

    Free (unordered) means with Normal priors: label switching is the
    user's concern, as in
    :class:`~pytensor_federated_torch.models.mixture.FederatedGaussianMixture`;
    this class is about the PARALLELISM of the component axis, and its
    logp equals the unsharded mixture's modulo reduction order.  ``y``
    becomes ``dtype`` (float32, as in the JAX package) on ``device``
    (CUDA unless told otherwise) without a mesh."""

    def __init__(
        self,
        y,
        n_components: int,
        *,
        mesh: Optional[Mesh] = None,
        axis: str = EXPERTS_AXIS,
        prior_scale: float = 3.0,
        device: Any = None,
        dtype: torch.dtype = torch.float32,
    ):
        self.mesh = mesh
        self.axis = axis
        self.k = int(n_components)
        self.prior_scale = prior_scale
        self.dtype = dtype
        y = torch.as_tensor(np.asarray(y)).to(dtype)
        if mesh is not None:
            n_dev = mesh.shape[axis]
            if self.k % n_dev != 0:
                raise ValueError(
                    f"n_components={self.k} not divisible by mesh axis "
                    f"{axis!r} of size {n_dev}"
                )
            self._devices = mesh.slot_devices(axis)
            self.device = self._devices[0]
            self._y_slots = [y.to(d) for d in self._devices]
            self.y = self._y_slots[0]
        else:
            self.device = resolve_device(device)
            self.y = y.to(self.device)

    def _loglik(self, params: Any) -> torch.Tensor:
        if self.mesh is None:
            log_w = torch.log_softmax(params["weight_logits"], dim=-1)
            t = _local_terms(self.y, log_w, params["mu"], params["log_sigma"])
            return torch.sum(torch.logsumexp(t, dim=1))
        home, devs = self.device, self._devices
        mu, ls, wl = (params[k] for k in _KEYS)
        # log-softmax over ALL experts, computed blockwise: a cross-slot
        # logsumexp of the weight logits.
        m_w = _axis_max([torch.max(b) for b in wl], home)
        z = _cross_slot_sum([torch.sum(torch.exp(b - m_w.to(d))) for b, d in zip(wl, devs)])
        terms = [
            _local_terms(y, b - m_w.to(d) - torch.log(z).to(d), mu_b, ls_b)
            for y, b, mu_b, ls_b, d in zip(self._y_slots, wl, mu, ls, devs)
        ]
        m = _axis_max([torch.amax(t, dim=1) for t in terms], home)
        s = _cross_slot_sum([torch.sum(torch.exp(t - m.to(d)[:, None]), dim=1)
                             for t, d in zip(terms, devs)])
        return torch.sum(m + torch.log(s))

    def prior_logp(self, params: Any) -> torch.Tensor:
        s = self.prior_scale

        def total(x, scale):
            if torch.is_tensor(x):
                return torch.sum(_normal_logpdf(x, 0.0, scale))
            return _cross_slot_sum([torch.sum(_normal_logpdf(b, 0.0, scale)) for b in x])

        lp = total(params["mu"], s)
        lp = lp + total(params["log_sigma"], 1.0)
        return lp + total(params["weight_logits"], 1.0)

    def logp(self, params: Any) -> torch.Tensor:
        return self.prior_logp(params) + self._loglik(params)

    def logp_and_grad(self, params: Any):
        return value_and_grad(self.logp, params)

    def init_params(self) -> Any:
        # Spread initial means over the data range so components
        # separate; deterministic (no RNG) for reproducible tests.
        lo, hi = float(torch.min(self.y)), float(torch.max(self.y))
        params = {
            "mu": torch.linspace(lo, hi, self.k, dtype=self.dtype, device=self.device),
            "log_sigma": torch.zeros((self.k,), dtype=self.dtype, device=self.device),
            "weight_logits": torch.zeros((self.k,), dtype=self.dtype, device=self.device),
        }
        return params if self.mesh is None else self._place(params)

    def _place(self, params: Any) -> Any:
        """Whole ``(K,)`` parameters cut into the slots' blocks, each on
        its slot's device."""
        per = self.k // len(self._devices)
        return {k: tuple(v[j * per:(j + 1) * per].to(d) for j, d in enumerate(self._devices))
                for k, v in params.items()}

    def find_map(self, **kwargs):
        from ..samplers import find_map

        # find_map steps one flat vector on the first slot's device; the
        # logp sends each block to its slot.
        init = tree_map(lambda t: t.to(self.device), self.init_params())
        est = find_map(self.logp, init, **kwargs)
        if self.mesh is None:
            return est
        return {k: tuple(b.to(d) for b, d in zip(v, self._devices)) for k, v in est.items()}


def generate_expert_mixture_data(
    n_obs: int = 512,
    mus=(-4.0, -1.0, 1.5, 4.0),
    sigmas=(0.5, 0.4, 0.6, 0.5),
    *,
    seed: int = 23,
):
    """Draws from a Gaussian mixture (numpy, the JAX package's bytes for
    the same seed) and the generating components."""
    rng = np.random.default_rng(seed)
    mus = np.asarray(mus)
    sigmas = np.asarray(sigmas)
    z = rng.integers(0, mus.size, size=n_obs)
    y = (mus[z] + sigmas[z] * rng.normal(size=n_obs)).astype(np.float32)
    return y, {"mu": mus, "sigma": sigmas}

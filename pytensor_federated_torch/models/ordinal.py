"""Federated ordinal regression: cumulative-logit (proportional odds).

Port of the JAX package's ``models/ordinal.py``.  Ordered categorical
outcomes (severity grades, ratings, stages) over federated shards, with
shared slopes, ordered cutpoints and the non-centered per-shard
intercept of :mod:`.hierbase`:

    P(y_ij <= c) = sigmoid(kappa_c - eta_ij),   c = 0..C-2
    eta_ij = x_ij . w + tau * b_raw_i           (no global intercept: the
                                                 cutpoints absorb it)
    P(y = c) = P(y <= c) - P(y <= c-1)

Cutpoints are ``kappa_0`` plus log-increments (``kappa_c = kappa_0 +
Σ exp(delta)``), so every point of the sampler's state space is a valid
ordered vector, and the transform's log-Jacobian is ``Σ delta``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from ..parallel.mesh import Mesh
from ..parallel.packing import ShardedData, pack_shards
from .hierbase import HierarchicalGLMBase
from .linear import _normal_logpdf

__all__ = [
    "FederatedOrdinalRegression",
    "cumulative_logit_loglik",
    "generate_ordinal_data",
]


def generate_ordinal_data(
    n_shards: int = 8,
    *,
    n_obs: int = 64,
    n_features: int = 3,
    n_categories: int = 4,
    tau: float = 0.3,
    seed: int = 41,
    device: Any = None,
):
    """Per-shard ordered outcomes in {0..C-1} with latent-logistic
    generation (numpy draws in the JAX package's order: the packed bytes
    equal its)."""
    rng = np.random.default_rng(seed)
    w_true = rng.normal(0.0, 0.5, size=n_features)
    b_true = tau * rng.normal(size=n_shards)
    kappa_true = np.sort(rng.normal(0.0, 1.5, size=n_categories - 1))
    shards = []
    for i in range(n_shards):
        X = rng.normal(0.0, 1.0, size=(n_obs, n_features)).astype(np.float32)
        eta = X @ w_true + b_true[i]
        u = rng.logistic(size=n_obs)
        y = np.sum((eta + u)[:, None] > kappa_true[None, :], axis=1)
        shards.append((X, y.astype(np.float32)))
    truth = {"w": w_true, "b": b_true, "kappa": kappa_true}
    return pack_shards(shards, pad_to_multiple=8, device=device), truth


def _softplus(x):
    """``log(1 + e^x)`` as ``logaddexp(x, 0)`` (``jax.nn.softplus``):
    ``torch.nn.functional.softplus`` has a threshold that changes the
    numerics."""
    return torch.logaddexp(x, torch.zeros_like(x))


def cumulative_logit_loglik(y, eta, kappa):
    """log P(y | eta, kappa) per observation, branch-free.

    ``kappa`` is the ordered cutpoint vector ``(C-1,)``; the categories'
    bounds are ``kappa`` padded with ∓1e30 sentinels and gathered by
    ``y``: ``log[sigmoid(ku-eta) - sigmoid(kl-eta)]`` by the stable
    log-difference-of-sigmoids identity.  The index is clamped to
    ``0..C-1`` (``jnp.take``'s clamp): an out-of-range index raises in
    torch, and on CUDA it is a device assert; the model rejects such
    data at construction.
    """
    C = kappa.shape[-1] + 1
    big = torch.full_like(kappa[..., :1], 1e30)
    upper = torch.cat([kappa, big], dim=-1)  # (C,)
    lower = torch.cat([-big, kappa], dim=-1)  # (C,)
    yi = y.long().clamp(0, C - 1)
    ku = upper[yi] - eta
    kl = lower[yi] - eta
    # log[σ(ku) - σ(kl)] = -softplus(-ku) - softplus(kl)
    #                      + log1p(-exp(-(ku - kl)))      (kl < ku)
    gap = torch.clamp(ku - kl, min=1e-6)
    return -_softplus(-ku) - _softplus(kl) + torch.log1p(-torch.exp(-gap))


@dataclasses.dataclass
class FederatedOrdinalRegression(HierarchicalGLMBase):
    """Proportional-odds model over federated shards, on the shared
    hierarchical base with NO global intercept (the cutpoints absorb
    it)."""

    data: ShardedData
    n_categories: int
    mesh: Optional[Mesh] = None
    prior_scale: float = 5.0
    compute_dtype: Optional[Any] = None  # see HierarchicalGLMBase
    _init_log_tau = -1.0
    _has_global_intercept = False

    def __post_init__(self):
        (_X, y), mask = self.data.tree()
        y_real = y.detach().cpu().numpy()[mask.detach().cpu().numpy() > 0]
        # An out-of-range category would be clamped into a confidently
        # wrong model: validate the whole coding up front.
        if y_real.size and (
            y_real.max() >= self.n_categories or y_real.min() < 0
        ):
            raise ValueError(
                f"observed categories span [{y_real.min():.0f}, "
                f"{y_real.max():.0f}]; need 0..n_categories-1 with "
                f"n_categories={self.n_categories}"
            )
        if y_real.size and np.any(y_real != np.round(y_real)):
            raise ValueError("ordinal outcomes must be integer-coded")
        self._post_init()

    def _obs_logpmf(self, params, y, eta):
        return cumulative_logit_loglik(y, eta, self._kappa(params))

    def _sample_obs(self, params, generator, eta):
        # Standard logistic draws by inverse cdf, u in [tiny, 1).
        p = torch.rand(eta.shape, generator=generator, device=eta.device, dtype=eta.dtype)
        p = torch.clamp(p, min=torch.finfo(eta.dtype).tiny)
        u = torch.log(p) - torch.log1p(-p)
        kappa = self._kappa(params)[..., None, None, :]  # per draw, over (S, N)
        return torch.sum((eta + u)[..., None] > kappa, dim=-1).to(eta.dtype)

    @staticmethod
    def _kappa(params):
        """Ordered cutpoints from the unconstrained parameterization:
        ``kappa_0`` free, increments strictly positive via exp (leading
        draw axes allowed)."""
        k0 = params["kappa0"][..., None]
        incr = torch.exp(params["log_incr"])
        return torch.cat([k0, k0 + torch.cumsum(incr, dim=-1)], dim=-1)

    def prior_logp(self, params: Any) -> torch.Tensor:
        lp = super().prior_logp(params)
        # Normal(0, 3) prior on each ordered cutpoint + the transform's
        # log-Jacobian (lower-triangular: det = prod exp(log_incr)).
        kappa = self._kappa(params)
        lp = lp + torch.sum(_normal_logpdf(kappa, 0.0, 3.0))
        return lp + torch.sum(params["log_incr"])

    def init_params(self) -> Any:
        p = super().init_params()
        p["kappa0"] = torch.tensor(-1.0, device=self.device)
        p["log_incr"] = torch.zeros((self.n_categories - 2,), device=self.device)
        return p

    def _sample_extra_params(self, generator) -> dict:
        # The induced prior on kappa is iid N(0, 3) conditioned on being
        # sorted, so the exact draw is sort(iid draws) mapped back to
        # (kappa0, log increments).
        z = torch.randn((self.n_categories - 1,), generator=generator, device=generator.device)
        k = torch.sort(3.0 * z).values
        return {
            "kappa0": k[0],
            "log_incr": torch.log(torch.diff(k) + torch.finfo(torch.float32).tiny),
        }

"""Federated robust (Student-t) regression.

Port of the JAX package's ``models/robust.py``.  A Gaussian likelihood
gives outliers quadratic influence; a Student-t one caps it, so a few
corrupted observations on one federated shard cannot drag the shared
slopes.  The shared hierarchical structure (:mod:`.hierbase`) with

    y_ij ~ StudentT(nu, loc=eta_ij, scale=sigma)

and log-parameterized ``sigma`` (HalfNormal(1) prior) and ``nu``
(shifted so nu > 1; Exponential(1/10) prior on nu - 1).  ``nu`` is
learned, so its gradient goes through ``digamma`` (``lgamma``'s
derivative).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import numpy as np
import torch

from ..parallel.mesh import Mesh
from ..parallel.packing import ShardedData, pack_shards
from .hierbase import HierarchicalGLMBase, log_halfnormal_draw, per_draw

__all__ = [
    "FederatedRobustRegression",
    "generate_robust_data",
    "student_t_logpdf",
]


def generate_robust_data(
    n_shards: int = 8,
    *,
    n_obs: int = 64,
    n_features: int = 4,
    tau: float = 0.3,
    outlier_frac: float = 0.1,
    outlier_scale: float = 10.0,
    seed: int = 23,
    device: Any = None,
):
    """Per-shard Gaussian data with a fraction of gross outliers (numpy
    draws in the JAX package's order: the packed bytes equal its)."""
    rng = np.random.default_rng(seed)
    w_true = rng.normal(0.0, 0.5, size=n_features)
    b0_true = 0.5
    b_true = b0_true + tau * rng.normal(size=n_shards)
    shards = []
    for i in range(n_shards):
        X = rng.normal(0.0, 1.0, size=(n_obs, n_features)).astype(np.float32)
        y = b_true[i] + X @ w_true + 0.5 * rng.normal(size=n_obs)
        n_out = int(outlier_frac * n_obs)
        if n_out:
            idx = rng.choice(n_obs, size=n_out, replace=False)
            y[idx] += outlier_scale * rng.standard_cauchy(size=n_out)
        shards.append((X, y.astype(np.float32)))
    truth = {"w": w_true, "b0": b0_true, "b": b_true}
    return pack_shards(shards, pad_to_multiple=8, device=device), truth


def student_t_logpdf(y, loc, scale, nu):
    """log StudentT(y | nu, loc, scale), branch-free."""
    z = (y - loc) / scale
    half_nu = 0.5 * nu
    return (
        torch.lgamma(half_nu + 0.5)
        - torch.lgamma(half_nu)
        - 0.5 * torch.log(nu * math.pi)
        - torch.log(scale)
        - (half_nu + 0.5) * torch.log1p(z * z / nu)
    )


@dataclasses.dataclass
class FederatedRobustRegression(HierarchicalGLMBase):
    """Hierarchical Student-t regression over federated shards."""

    data: ShardedData
    mesh: Optional[Mesh] = None
    prior_scale: float = 5.0
    compute_dtype: Optional[Any] = None  # see HierarchicalGLMBase

    def __post_init__(self):
        self._post_init()

    def _obs_logpmf(self, params, y, eta):
        sigma = torch.exp(params["log_sigma"])
        nu = 1.0 + torch.exp(params["log_numinus1"])
        return student_t_logpdf(y, eta, sigma, nu)

    def _sample_obs(self, params, generator, eta):
        # t = Z / sqrt(V / nu) with V ~ Chi2(nu) = 2 Gamma(nu / 2):
        # torch has no Student-t sampler that takes a generator.
        sigma = per_draw(torch.exp(params["log_sigma"]), eta)
        nu = per_draw(1.0 + torch.exp(params["log_numinus1"]), eta)
        z = torch.randn(eta.shape, generator=generator, device=eta.device, dtype=eta.dtype)
        g = torch._standard_gamma((0.5 * nu).expand(eta.shape).contiguous(), generator=generator)
        return eta + sigma * z / torch.sqrt(2.0 * g / nu)

    def prior_logp(self, params: Any) -> torch.Tensor:
        lp = super().prior_logp(params)
        # HalfNormal(1) on sigma (log-param + Jacobian).
        sigma = torch.exp(params["log_sigma"])
        lp = lp + (-0.5 * sigma**2 + params["log_sigma"])
        # Exponential(rate=1/10) on nu - 1 (log-param + Jacobian):
        # weakly favors heavy tails but lets nu grow if data are clean.
        numinus1 = torch.exp(params["log_numinus1"])
        return lp + (-numinus1 / 10.0 + params["log_numinus1"])

    def init_params(self) -> Any:
        p = super().init_params()
        p["log_sigma"] = torch.zeros((), device=self.device)
        p["log_numinus1"] = torch.tensor(1.0, device=self.device)
        return p

    def nu(self, params: Any) -> torch.Tensor:
        """The implied degrees of freedom."""
        return 1.0 + torch.exp(params["log_numinus1"])

    def _sample_extra_params(self, generator) -> dict:
        # HalfNormal(1) sigma; Exponential(1/10) on nu - 1.
        e = torch.empty((), device=generator.device).exponential_(generator=generator)
        return {
            "log_sigma": log_halfnormal_draw(generator),
            "log_numinus1": torch.log(10.0 * e + torch.finfo(torch.float32).tiny),
        }

"""Federated Gamma regression (log link) — positive continuous outcomes.

Port of the JAX package's ``models/gamma.py``: durations, costs,
concentrations — strictly positive, right-skewed data, in the
shape/mean parameterization

    y_ij ~ Gamma(shape=alpha, rate=alpha / mu_ij),  mu_ij = exp(eta_ij)

so ``E[y] = mu`` and ``Var[y] = mu^2 / alpha``; alpha is shared and
log-parameterized (HalfNormal(10) prior), on the hierarchical structure
of :mod:`.hierbase`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from ..parallel.mesh import Mesh
from ..parallel.packing import ShardedData, pack_shards
from .hierbase import HierarchicalGLMBase, log_halfnormal_draw, per_draw

__all__ = [
    "FederatedGammaGLM",
    "gamma_logpdf",
    "generate_gamma_data",
]


def generate_gamma_data(
    n_shards: int = 8,
    *,
    n_obs: int = 64,
    n_features: int = 4,
    tau: float = 0.3,
    alpha: float = 3.0,
    seed: int = 29,
    device: Any = None,
):
    """Per-shard positive outcomes with log-link mean structure (numpy
    draws in the JAX package's order: the packed bytes equal its)."""
    rng = np.random.default_rng(seed)
    w_true = rng.normal(0.0, 0.4, size=n_features)
    b0_true = 0.5
    b_true = b0_true + tau * rng.normal(size=n_shards)
    shards = []
    for i in range(n_shards):
        X = rng.normal(0.0, 1.0, size=(n_obs, n_features)).astype(np.float32)
        mu = np.exp(b_true[i] + X @ w_true)
        y = rng.gamma(alpha, mu / alpha)
        shards.append((X, y.astype(np.float32)))
    truth = {"w": w_true, "b0": b0_true, "b": b_true, "alpha": alpha}
    return pack_shards(shards, pad_to_multiple=8, device=device), truth


def gamma_logpdf(y, eta, alpha):
    """log Gamma(y | shape=alpha, rate=alpha/exp(eta)), in log space.

    ``log rate = log(alpha) - eta`` never forms ``exp(eta)``, and the
    rate-term exponent is clamped (as in ``poisson_logpmf``) so an
    extreme proposal gives a huge-but-finite negative logp with finite
    gradients.  Padded rows carry y=0, where ``log y`` would be -inf;
    ``y`` is floored at the dtype's tiny so those rows stay FINITE and
    the base's ``ll * mask`` cannot form ``0 * inf = NaN``.
    """
    log_rate = torch.log(alpha) - eta
    log_y = torch.log(torch.clamp(y, min=torch.finfo(y.dtype).tiny))
    # rate*y as exp(log_rate + log y) with the WHOLE exponent clamped:
    # clamping log_rate alone still overflows for large y.
    return (
        alpha * log_rate
        + (alpha - 1.0) * log_y
        - torch.exp(torch.clamp(log_rate + log_y, max=80.0))
        - torch.lgamma(alpha)
    )


@dataclasses.dataclass
class FederatedGammaGLM(HierarchicalGLMBase):
    """Hierarchical Gamma regression over federated shards."""

    data: ShardedData
    mesh: Optional[Mesh] = None
    prior_scale: float = 5.0
    compute_dtype: Optional[Any] = None  # see HierarchicalGLMBase

    def __post_init__(self):
        self._post_init()

    def _obs_logpmf(self, params, y, eta):
        return gamma_logpdf(y, eta, torch.exp(params["log_alpha"]))

    def _sample_obs(self, params, generator, eta):
        alpha = per_draw(torch.exp(params["log_alpha"]), eta)
        g = torch._standard_gamma(alpha.expand(eta.shape).contiguous(), generator=generator)
        return g * (torch.exp(eta) / alpha)

    def prior_logp(self, params: Any) -> torch.Tensor:
        lp = super().prior_logp(params)
        # HalfNormal(10) on alpha (log-param + Jacobian).
        alpha = torch.exp(params["log_alpha"])
        return lp + (-0.5 * (alpha / 10.0) ** 2 + params["log_alpha"])

    def init_params(self) -> Any:
        p = super().init_params()
        p["log_alpha"] = torch.tensor(0.5, device=self.device)
        return p

    def _sample_extra_params(self, generator) -> dict:
        # HalfNormal(10) on alpha, matching prior_logp.
        return {"log_alpha": log_halfnormal_draw(generator, 10.0)}

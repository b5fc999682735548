"""Federated survival analysis: censored Weibull regression (AFT).

Port of the JAX package's ``models/survival.py``.  Time-to-event data
split across institutions that cannot pool patient records;
accelerated-failure-time Weibull model with right censoring:

    T_ij ~ Weibull(shape=k, scale=exp(eta_ij))
    eta_ij = x_ij . w + b0 + tau * b_raw_i       (per-shard frailty)
    observed: (t_ij, delta_ij),  delta = 1 event, 0 right-censored

With ``z = k (log t - eta)`` the per-observation log-likelihood is

    event    (delta=1):  log k - log t + z - e^z
    censored (delta=0):  -e^z                      (log survival)

On the shared hierarchical base (:mod:`.hierbase`) with the observation
tree ``y = (t, delta)``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from ..parallel.mesh import Mesh
from ..parallel.packing import ShardedData, pack_shards
from .hierbase import HierarchicalGLMBase, per_draw
from .linear import _normal_logpdf

__all__ = [
    "FederatedWeibullAFT",
    "generate_survival_data",
    "weibull_censored_loglik",
]


def generate_survival_data(
    n_shards: int = 8,
    *,
    n_obs: int = 64,
    n_features: int = 3,
    tau: float = 0.3,
    shape_k: float = 1.5,
    censor_frac: float = 0.3,
    seed: int = 37,
    device: Any = None,
):
    """Per-shard ``(X, (t, delta))`` with administrative right censoring
    tuned to hit ``censor_frac`` on average (numpy draws in the JAX
    package's order: the packed bytes equal its)."""
    rng = np.random.default_rng(seed)
    w_true = rng.normal(0.0, 0.4, size=n_features)
    b0_true = 0.5
    b_true = b0_true + tau * rng.normal(size=n_shards)
    shards = []
    for i in range(n_shards):
        X = rng.normal(0.0, 1.0, size=(n_obs, n_features)).astype(np.float32)
        scale = np.exp(b_true[i] + X @ w_true)
        t_event = scale * rng.weibull(shape_k, size=n_obs)
        # censor times drawn so ~censor_frac of events are cut off
        c = np.quantile(t_event, 1.0 - censor_frac) * rng.uniform(
            0.5, 1.5, size=n_obs
        )
        delta = (t_event <= c).astype(np.float32)
        t = np.minimum(t_event, c).astype(np.float32)
        # padded-slot safety: keep times strictly positive
        t = np.maximum(t, 1e-6)
        shards.append((X, (t, delta)))
    truth = {"w": w_true, "b0": b0_true, "b": b_true, "k": shape_k}
    return pack_shards(shards, pad_to_multiple=8, device=device), truth


def weibull_censored_loglik(t, delta, eta, k):
    """Censored Weibull AFT log-likelihood per observation.

    ``z = k * (log t - eta)``: the density term is ``log k - log t + z -
    exp(z)`` and the survival term ``-exp(z)``, one shared ``exp(z)``
    (clamped at 80 like the siblings, so extreme proposals stay finite
    with finite gradients; ``t`` floored at the dtype's tiny, so padded
    rows with t = 0 stay finite), censoring as a multiply.
    """
    log_t = torch.log(torch.clamp(t, min=torch.finfo(t.dtype).tiny))
    z = k * (log_t - eta)
    ez = torch.exp(torch.clamp(z, max=80.0))
    event_term = torch.log(k) - log_t + z - ez
    censor_term = -ez
    return delta * event_term + (1.0 - delta) * censor_term


@dataclasses.dataclass
class FederatedWeibullAFT(HierarchicalGLMBase):
    """Hierarchical Weibull AFT over federated shards."""

    data: ShardedData
    mesh: Optional[Mesh] = None
    prior_scale: float = 5.0
    compute_dtype: Optional[Any] = None  # see HierarchicalGLMBase
    _init_log_tau = -1.0

    def __post_init__(self):
        self._post_init()

    def _obs_logpmf(self, params, y, eta):
        t, delta = y
        return weibull_censored_loglik(t, delta, eta, torch.exp(params["log_k"]))

    def _sample_obs(self, params, generator, eta):
        # UNCENSORED event times by inverse cdf: T = scale*(-log u)^(1/k),
        # u uniform in [1e-7, 1 - 1e-7).
        k = per_draw(torch.exp(params["log_k"]), eta)
        u = torch.rand(eta.shape, generator=generator, device=eta.device, dtype=eta.dtype)
        u = 1e-7 + (1.0 - 2e-7) * u
        return torch.exp(eta) * torch.pow(-torch.log(u), 1.0 / k)

    def prior_logp(self, params: Any) -> torch.Tensor:
        lp = super().prior_logp(params)
        # LogNormal(0, 1) prior on the Weibull shape via log_k.
        return lp + _normal_logpdf(params["log_k"], 0.0, 1.0)

    def init_params(self) -> Any:
        p = super().init_params()
        p["log_k"] = torch.zeros((), device=self.device)
        return p

    def _sample_extra_params(self, generator) -> dict:
        # LogNormal(0, 1) shape, matching prior_logp.
        return {"log_k": torch.randn((), generator=generator, device=generator.device)}

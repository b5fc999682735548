"""Federated count-data GLMs: Poisson and negative-binomial regression,
and their zero-inflated forms.

Port of the JAX package's ``models/countdata.py``.  Every family shares
the hierarchical structure of :mod:`.hierbase`:

    w          ~ Normal(0, prior_scale)^d         shared slopes
    b0         ~ Normal(0, prior_scale)           global intercept
    b_raw_i    ~ Normal(0, 1)                     per shard (non-centered)
    tau        ~ HalfNormal(1)  (log-param)       intercept spread
    eta_ij     = b0 + tau * b_raw_i + x_ij . w
    Poisson:   y_ij ~ Poisson(exp(eta_ij))
    NegBin:    y_ij ~ NB(mean=exp(eta_ij), dispersion=phi)  (log-param)

The negative binomial uses the mean/dispersion ("NB2") parameterization
``Var[y] = mu + mu^2 / phi``; ``phi -> inf`` recovers Poisson.  The
per-shard work is one ``(n, d) @ (d,)`` product and elementwise
``exp``/``lgamma``: no kernel of its own.
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
    "FederatedNegBinGLM",
    "FederatedPoissonGLM",
    "FederatedZeroInflNegBinGLM",
    "FederatedZeroInflPoissonGLM",
    "generate_count_data",
    "generate_zi_count_data",
    "negbin_logpmf",
    "poisson_logpmf",
    "zero_inflate_logpmf",
]


def generate_count_data(
    n_shards: int = 8,
    *,
    n_obs: int = 64,
    n_features: int = 4,
    tau: float = 0.3,
    dispersion: Optional[float] = None,
    pi: float = 0.0,
    seed: int = 19,
    device: Any = None,
):
    """Per-shard count data; ``dispersion=None`` draws Poisson, a float
    draws NB2 with that dispersion.  ``pi > 0`` mixes in that fraction
    of structural zeros (the extra uniform draw happens only then).
    numpy draws in the JAX package's order, so the packed bytes equal
    its."""
    rng = np.random.default_rng(seed)
    w_true = rng.normal(0.0, 0.4, size=n_features)
    b0_true = 0.8
    b_true = b0_true + tau * rng.normal(size=n_shards)
    shards = []
    for i in range(n_shards):
        X = rng.normal(0.0, 1.0, size=(n_obs, n_features)).astype(np.float32)
        eta = b_true[i] + X @ w_true
        mu = np.exp(eta)
        if dispersion is None:
            y = rng.poisson(mu)
        else:
            # NB2 as Gamma-Poisson mixture: rate ~ Gamma(phi, phi/mu)
            lam = rng.gamma(dispersion, mu / dispersion)
            y = rng.poisson(lam)
        if pi > 0:
            y = np.where(rng.uniform(size=n_obs) < pi, 0, y)
        shards.append((X, y.astype(np.float32)))
    truth = {"w": w_true, "b0": b0_true, "b": b_true}
    if pi > 0:
        truth["pi"] = pi
    return pack_shards(shards, pad_to_multiple=8, device=device), truth


def poisson_logpmf(y, eta):
    """log Poisson(y | mu=exp(eta)) with eta the linear predictor.

    The mean term ``-exp(eta)`` is evaluated with eta clamped to 80
    (exp(80) ~ 5.5e34, inside float32): beyond that the true logp is
    astronomically negative anyway, and the clamp keeps the value and
    the gradient FINITE.  Unclamped, an overflowing proposal gives
    ``-inf``, whose chain rule forms ``0 * -inf = NaN`` on padded
    (mask=0) rows and poisons the whole shard sum."""
    return y * eta - torch.exp(torch.clamp(eta, max=80.0)) - torch.lgamma(y + 1.0)


def negbin_logpmf(y, eta, phi):
    """log NB2(y | mu=exp(eta), dispersion=phi).

    NB2 pmf: C(y+phi-1, y) (phi/(phi+mu))^phi (mu/(phi+mu))^y with
    Var = mu + mu^2/phi, written with lgamma and log-space ratios.
    """
    # log(phi + mu) via logaddexp stays finite when eta overflows exp
    # (float32: eta > ~88); otherwise 0 * -inf on zero-count or padded
    # rows turns the shard's logp into NaN mid-NUTS.
    log_phi = torch.log(phi)
    log_phi_plus_mu = torch.logaddexp(log_phi, eta)
    log_phi_mu = log_phi - log_phi_plus_mu
    log_mu_phi = eta - log_phi_plus_mu
    return (
        torch.lgamma(y + phi)
        - torch.lgamma(phi)
        - torch.lgamma(y + 1.0)
        + phi * log_phi_mu
        + y * log_mu_phi
    )


@dataclasses.dataclass
class FederatedPoissonGLM(HierarchicalGLMBase):
    """Hierarchical Poisson regression over federated shards."""

    data: ShardedData
    mesh: Optional[Mesh] = None
    prior_scale: float = 5.0
    compute_dtype: Optional[Any] = None  # see HierarchicalGLMBase
    _init_log_tau = -1.0

    def __post_init__(self):
        self._post_init()

    def _obs_logpmf(self, params, y, eta):
        return poisson_logpmf(y, eta)

    # Simulated-count ceiling, as in the JAX package (whose Poisson
    # sampler clamps at INT32_MAX): 1e8 keeps every draw an exact count
    # and the prior-predictive moments free of sentinel values.
    _MAX_SIM_MEAN = 1e8

    def _sample_obs(self, params, generator, eta):
        lam = torch.clamp(torch.exp(eta), max=self._MAX_SIM_MEAN)
        return torch.poisson(lam, generator=generator).to(eta.dtype)


@dataclasses.dataclass
class FederatedNegBinGLM(HierarchicalGLMBase):
    """Hierarchical negative-binomial (NB2) regression over federated
    shards, with a learned dispersion."""

    data: ShardedData
    mesh: Optional[Mesh] = None
    prior_scale: float = 5.0
    compute_dtype: Optional[Any] = None  # see HierarchicalGLMBase
    _init_log_tau = -1.0

    def __post_init__(self):
        self._post_init()

    def _obs_logpmf(self, params, y, eta):
        return negbin_logpmf(y, eta, torch.exp(params["log_phi"]))

    def _sample_obs(self, params, generator, eta):
        # NB2 as its Gamma-Poisson mixture: lam ~ Gamma(phi, mu/phi), with
        # the Poisson family's ceiling on the simulated mean.
        phi = per_draw(torch.exp(params["log_phi"]), eta)
        g = torch._standard_gamma(phi.expand(eta.shape).contiguous(), generator=generator)
        lam = torch.clamp(g * (torch.exp(eta) / phi), max=FederatedPoissonGLM._MAX_SIM_MEAN)
        return torch.poisson(lam, generator=generator).to(eta.dtype)

    def prior_logp(self, params: Any) -> torch.Tensor:
        lp = super().prior_logp(params)
        # HalfNormal(10) on phi (weakly informative; log-param).
        phi = torch.exp(params["log_phi"])
        return lp + (-0.5 * (phi / 10.0) ** 2 + params["log_phi"])

    def init_params(self) -> Any:
        p = super().init_params()
        p["log_phi"] = torch.tensor(1.0, device=self.device)
        return p

    def _sample_extra_params(self, generator) -> dict:
        # HalfNormal(10) on phi, matching prior_logp.
        return {"log_phi": log_halfnormal_draw(generator, 10.0)}


def zero_inflate_logpmf(y, base_logpmf, logit_pi):
    """Zero-inflated observation log-pmf from any count base family.

    A structural-zero component with probability ``pi = sigmoid(
    logit_pi)`` mixes with the base pmf:

        y = 0:  log(pi + (1 - pi) * base(0))
        y > 0:  log(1 - pi) + log base(y)

    in log space (``logsigmoid`` both ways, no ``log(1 - sigmoid)``) and
    branch-free (``where``).  The one implementation of ZIP and ZINB.
    """
    log_pi = torch.nn.functional.logsigmoid(logit_pi)
    log1m_pi = torch.nn.functional.logsigmoid(-logit_pi)
    with_base = log1m_pi + base_logpmf
    return torch.where(y == 0, torch.logaddexp(log_pi, with_base), with_base)


def generate_zi_count_data(
    n_shards: int = 8,
    *,
    n_obs: int = 64,
    n_features: int = 4,
    tau: float = 0.3,
    pi: float = 0.3,
    dispersion: Optional[float] = None,
    seed: int = 23,
    device: Any = None,
):
    """:func:`generate_count_data` with ``pi`` structural zeros.
    ``dispersion=None`` -> ZIP, a float -> ZINB."""
    if not 0.0 < pi < 1.0:
        raise ValueError(f"pi must be in (0, 1), got {pi}")
    return generate_count_data(
        n_shards,
        n_obs=n_obs,
        n_features=n_features,
        tau=tau,
        dispersion=dispersion,
        pi=pi,
        seed=seed,
        device=device,
    )


class _ZeroInflatedMixin:
    """The zero-inflation overlay (a learned logit-parameterized
    structural-zero probability): wraps the BASE family's pmf, simulator,
    prior and parameters through ``super()``, so ZIP and ZINB cannot
    drift from their base families or from each other.  It comes first
    in the bases of a dataclass, so the MRO reaches the base family
    after it."""

    def _obs_logpmf(self, params, y, eta):
        return zero_inflate_logpmf(
            y, super()._obs_logpmf(params, y, eta), params["logit_pi"]
        )

    def _sample_obs(self, params, generator, eta):
        y = super()._sample_obs(params, generator, eta)
        pi = per_draw(torch.sigmoid(params["logit_pi"]), eta)
        structural = torch.rand(eta.shape, generator=generator, device=eta.device) < pi
        return torch.where(structural, torch.zeros_like(y), y)

    def prior_logp(self, params: Any) -> torch.Tensor:
        # Normal(0, 1.5) on the logit keeps pi away from the 0/1
        # boundaries a priori without forbidding them.
        lp = super().prior_logp(params)
        return lp + torch.sum(-0.5 * (params["logit_pi"] / 1.5) ** 2)

    def init_params(self) -> Any:
        p = super().init_params()
        p["logit_pi"] = torch.tensor(-1.0, device=self.device)  # pi ~ 0.27 warm start
        return p

    def _sample_extra_params(self, generator) -> dict:
        extra = super()._sample_extra_params(generator)
        extra["logit_pi"] = 1.5 * torch.randn((), generator=generator, device=generator.device)
        return extra


@dataclasses.dataclass
class FederatedZeroInflPoissonGLM(_ZeroInflatedMixin, FederatedPoissonGLM):
    """Hierarchical zero-inflated Poisson (ZIP) regression: zeros beyond
    what the Poisson rate explains get a learned structural-zero
    probability ``pi`` (global, logit-parameterized)."""


@dataclasses.dataclass
class FederatedZeroInflNegBinGLM(_ZeroInflatedMixin, FederatedNegBinGLM):
    """Hierarchical zero-inflated NB2 regression: overdispersion AND
    excess zeros, each with its own learned parameter (``log_phi``,
    ``logit_pi``)."""

"""Shared base for hierarchical-intercept federated GLMs.

Port of the JAX package's ``models/hierbase.py``.  One structure for
every observation family:

    w ~ Normal(0, prior_scale)^d      (shared slopes)
    b0 ~ Normal(0, prior_scale)       (global intercept)
    tau ~ HalfNormal(1)               (via log_tau + Jacobian)
    b_raw_i ~ Normal(0, 1)            per shard i (NON-CENTERED)
    eta_ij = x_ij . w + b0 + tau * b_raw_i
    y_ij ~ family(eta_ij)

Subclasses supply ``_obs_logpmf(params, y, eta)`` and
``_sample_obs(params, generator, eta)``.  The non-centered form keeps the
log-posterior bounded as ``tau -> 0`` (the centered one is unbounded
there, so its MAP is ill-defined and NUTS meets a funnel).
"""

from __future__ import annotations

from typing import Any

import torch

from ..parallel.sharded import FederatedLogp
from ..utils import value_and_grad
from .linear import _normal_logpdf

__all__ = [
    "HierarchicalGLMBase",
    "linear_predictor",
    "log_halfnormal_draw",
    "per_draw",
]


def log_halfnormal_draw(generator: torch.Generator, scale: float = 1.0) -> torch.Tensor:
    """log of one HalfNormal(scale) draw, on the generator's device — the
    one implementation for log-parameterized scale priors."""
    z = torch.randn((), generator=generator, device=generator.device)
    return torch.log(scale * torch.abs(z) + torch.finfo(torch.float32).tiny)


def per_draw(x: torch.Tensor, eta: torch.Tensor) -> torch.Tensor:
    """A per-draw parameter (leading draw axes only; 0-d for one draw)
    with singleton axes appended so it broadcasts against ``eta``
    ``(*draws, n_shards, n_obs)``."""
    return x.reshape(x.shape + (1,) * (eta.ndim - x.ndim))


def linear_predictor(X, w, b, compute_dtype=None):
    """``X @ w + b``, optionally with the operands rounded to
    ``compute_dtype`` (e.g. ``torch.bfloat16``) and multiplied in
    float32 — the mixed-precision recipe of the JAX package's
    ``preferred_element_type=float32``.  (A bf16 ``torch.matmul`` would
    round its result to bf16 as well, which is not that recipe.)

    ``compute_dtype="float32_strict"`` forces a true-float32 contraction
    through the bf16x3 split (:func:`..precision.pdot`).
    """
    if compute_dtype is None:
        return X @ w + b
    if compute_dtype == "float32_strict":
        from ..precision import pdot

        return pdot(X, w, "strict") + b
    return X.to(compute_dtype).float() @ w.to(compute_dtype).float() + b


class HierarchicalGLMBase:
    """Dataclass mixin: subclasses declare ``data``, ``mesh`` and
    ``prior_scale`` fields and call :meth:`_post_init` from their
    ``__post_init__``.  The model runs on the device that holds
    ``data``."""

    #: initial value for log_tau (families tune their own warm start)
    _init_log_tau: float = 0.0

    #: families whose global intercept is absorbed elsewhere set this
    #: False — ``b0`` then vanishes from the params, prior and intercepts.
    _has_global_intercept: bool = True

    #: None: scalar linear predictor.  An int ``m``: VECTOR predictor
    #: with ``m`` columns (``w``: (d, m), ``b0``: (m,), ``b_raw``:
    #: (S, m), eta: (..., m)).  Every broadcasting expression below works
    #: for both; only the parameter shapes differ.
    _coef_cols = None

    #: optional matmul compute dtype (e.g. ``torch.bfloat16``) or
    #: ``"float32_strict"``; see :func:`linear_predictor`.  Expect ~1e-2
    #: relative logp divergence from float32 with bf16.
    compute_dtype = None

    def _intercept_base(self, params):
        return params["b0"] if self._has_global_intercept else 0.0

    def _linear_predictor(self, X, w, b):
        return linear_predictor(X, w, b, self.compute_dtype)

    def _post_init(self):
        (X, y), mask = self.data.tree()
        n = X.shape[0]
        self.device = mask.device
        shard_ids = torch.arange(n, device=self.device)

        def per_shard_logp(params, shard):
            (X, y), mask, sid = shard
            tau = torch.exp(params["log_tau"])
            b = self._intercept_base(params) + tau * params["b_raw"][sid]
            eta = self._linear_predictor(X, params["w"], b)
            ll = self._obs_logpmf(params, y, eta)
            return torch.sum(ll * mask)

        self.fed = FederatedLogp(per_shard_logp, ((X, y), mask, shard_ids), mesh=self.mesh)
        self.n_shards = n
        self.n_features = X.shape[-1]

    def _obs_logpmf(self, params, y, eta):  # pragma: no cover - abstract
        raise NotImplementedError

    def prior_logp(self, params: Any) -> torch.Tensor:
        s = self.prior_scale
        lp = torch.sum(_normal_logpdf(params["w"], 0.0, s))
        if self._has_global_intercept:
            lp = lp + torch.sum(_normal_logpdf(params["b0"], 0.0, s))
        lp = lp + torch.sum(_normal_logpdf(params["b_raw"], 0.0, 1.0))
        # HalfNormal(1) on tau via the log-transform + Jacobian.
        tau = torch.exp(params["log_tau"])
        return lp + (-0.5 * tau**2 + params["log_tau"])

    def intercepts(self, params: Any) -> torch.Tensor:
        """The implied per-shard intercepts ``b0 + tau * b_raw``."""
        return self._intercept_base(params) + torch.exp(params["log_tau"]) * params["b_raw"]

    def logp(self, params: Any) -> torch.Tensor:
        return self.prior_logp(params) + self.fed.logp(params)

    def logp_and_grad(self, params: Any):
        return value_and_grad(self.logp, params)

    def _shape(self, *lead):
        m = self._coef_cols
        return lead if m is None else lead + (m,)

    def init_params(self) -> Any:
        z = lambda shape: torch.zeros(shape, dtype=torch.float32, device=self.device)
        p = {
            "w": z(self._shape(self.n_features)),
            "log_tau": torch.tensor(self._init_log_tau, dtype=torch.float32, device=self.device),
            "b_raw": z(self._shape(self.n_shards)),
        }
        if self._has_global_intercept:
            p["b0"] = z(self._shape())
        return p

    def _sample_obs(self, params, generator, eta):  # pragma: no cover - abstract
        raise NotImplementedError

    def _eta(self, params: Any) -> torch.Tensor:
        (X, _y), _mask = self.data.tree()
        b = self.intercepts(params)
        return self._linear_predictor(X, params["w"], b[:, None])

    def pointwise_loglik(self, params: Any) -> torch.Tensor:
        """``(n_shards, n_obs)`` per-observation data log-likelihoods
        (padded slots zeroed), for WAIC / PSIS-LOO."""
        (_X, y), mask = self.data.tree()
        return self._obs_logpmf(params, y, self._eta(params)) * mask

    def predictive(self, params: Any, generator: torch.Generator) -> torch.Tensor:
        """Simulate replicated data ``(*draws, n_shards, n_obs)`` from the
        observation model at ``params`` (padded slots zeroed).

        ``params`` may carry leading draw axes on every leaf (as
        :func:`..samplers.predictive.posterior_predictive` passes them):
        the linear predictor is mapped over them with ``torch.func.vmap``
        and the observations are drawn for all draws at once from the one
        ``generator``, since every family's ``_sample_obs`` is
        elementwise (its per-draw parameters go through :func:`per_draw`)."""
        eta_fn = self._eta
        for _ in range(params["log_tau"].ndim):
            eta_fn = torch.func.vmap(eta_fn)
        mask = self.data.tree()[1]
        return self._sample_obs(params, generator, eta_fn(params)) * mask

    def _sample_extra_params(self, generator) -> dict:
        """Family-specific extra parameter draws (override to match any
        extra ``prior_logp`` terms)."""
        return {}

    def sample_prior(self, generator: torch.Generator) -> Any:
        """One draw from the prior, shaped like :meth:`init_params`."""
        randn = lambda shape: torch.randn(shape, generator=generator, device=generator.device)
        p = {
            "w": self.prior_scale * randn(self._shape(self.n_features)),
            "log_tau": log_halfnormal_draw(generator),  # HalfNormal(1)
            "b_raw": randn(self._shape(self.n_shards)),
        }
        if self._has_global_intercept:
            p["b0"] = self.prior_scale * randn(self._shape())
        p.update(self._sample_extra_params(generator))
        return p

    def find_map(self, **kwargs):
        from ..samplers import find_map

        return find_map(self.logp, self.init_params(), **kwargs)

    def sample(self, *, generator: torch.Generator | None = None, **kwargs):
        """NUTS on the posterior (``samplers.sample``); the default
        generator is seeded with 0 on the model's device."""
        from ..samplers import sample

        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        return sample(self.logp, self.init_params(), generator=generator, **kwargs)

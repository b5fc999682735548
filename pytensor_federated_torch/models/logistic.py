"""Federated logistic regression — the many-shard scale config.

Port of the JAX package's ``models/logistic.py`` (BASELINE.json config
5): each shard owns a private design-matrix block ``(X_i, y_i)``; the
global posterior is

    w ~ Normal(0, 5)^d,   b ~ Normal(0, 5)
    y_ij ~ Bernoulli(sigmoid(X_i w + b))

Per-shard compute is one ``(n, d) @ (d,)`` matvec, batched over shards.
The Bernoulli log-likelihood is ``y·η − logaddexp(0, η)`` in every form
(``softplus`` has a threshold that changes the numerics).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from ..parallel.mesh import Mesh
from ..parallel.packing import ShardedData, pack_shards
from ..parallel.sharded import FederatedLogp, NoFederatedShards
from ..utils import tree_leaves, value_and_grad
from .hierbase import HierarchicalGLMBase, linear_predictor
from .linear import _normal_logpdf


def _log1p_exp(eta: torch.Tensor) -> torch.Tensor:
    """``log(1 + e^eta)``, stable, as ``logaddexp(0, eta)``."""
    return torch.logaddexp(torch.zeros_like(eta), eta)


def _simulate_logistic_shards(rng, n_shards, n_obs, n_features, intercepts, device=None):
    """Shared simulator: Bernoulli(sigmoid(X w + b_i)) with a per-shard
    intercept array (a broadcast scalar for the flat model).  numpy
    draws in the JAX package's order, so the packed bytes equal its."""
    w_true = rng.normal(0, 1.0, size=n_features)
    intercepts = np.broadcast_to(intercepts, (n_shards,))
    shards = []
    for i in range(n_shards):
        X = rng.normal(size=(n_obs, n_features)).astype(np.float32)
        logits = X @ w_true + intercepts[i]
        y = (rng.uniform(size=n_obs) < 1.0 / (1.0 + np.exp(-logits))).astype(
            np.float32
        )
        shards.append((X, y))
    return pack_shards(shards, device=device), w_true


def generate_logistic_data(
    n_shards: int = 64,
    *,
    n_obs: int = 128,
    n_features: int = 8,
    seed: int = 21,
    device: Any = None,
):
    rng = np.random.default_rng(seed)
    packed, w_true = _simulate_logistic_shards(
        rng, n_shards, n_obs, n_features, 0.5, device
    )
    return packed, {"w": w_true, "b": 0.5}


def generate_hier_logistic_data(
    n_shards: int = 16,
    *,
    n_obs: int = 64,
    n_features: int = 4,
    tau: float = 0.8,
    seed: int = 31,
    device: Any = None,
):
    """Per-shard data with shard-specific intercepts b_i ~ N(0.5, tau)."""
    rng = np.random.default_rng(seed)
    b_true = 0.5 + tau * rng.normal(size=n_shards)
    packed, w_true = _simulate_logistic_shards(
        rng, n_shards, n_obs, n_features, b_true, device
    )
    return packed, {"w": w_true, "b": b_true}


@dataclasses.dataclass
class HierarchicalLogisticRegression(HierarchicalGLMBase):
    """Mixed-effects logistic regression: shared slopes, one random
    intercept per federated shard with a learned group scale
    (non-centered, see :mod:`.hierbase`)::

        w ~ Normal(0, prior_scale)^d      (shared)
        b0 ~ Normal(0, prior_scale)
        tau ~ HalfNormal(1)               (via log_tau + Jacobian)
        b_raw_i ~ Normal(0, 1)            per shard i
        y_ij ~ Bernoulli(sigmoid(X_i w + b0 + tau * b_raw_i))
    """

    data: ShardedData
    mesh: Optional[Mesh] = None
    prior_scale: float = 5.0
    compute_dtype: Optional[Any] = None  # see HierarchicalGLMBase

    def __post_init__(self):
        self._post_init()

    def _obs_logpmf(self, params, y, eta):
        return y * eta - _log1p_exp(eta)

    def _sample_obs(self, params, generator, eta):
        return torch.bernoulli(torch.sigmoid(eta), generator=generator).to(eta.dtype)


@dataclasses.dataclass
class FederatedLogisticRegression:
    """Logistic regression with shared ``(w, b)`` over federated shards,
    in one of three exact forms of the same posterior:

    - plain: the per-shard Bernoulli log-likelihood mapped over shards;
    - ``use_suffstats=True``: the y-interaction term is linear in
      ``(w, b)``, so ``(Σ y x, Σ y)`` fold into per-shard constants at
      build time and the hot loop evaluates only the softplus normalizer,
      ``Syx·w + Sy·b − Σ logaddexp(0, logits)``;
    - ``flatten=True``: with shared ``(w, b)`` the likelihood does not
      care which shard a row lives in, so the S batched ``(n, d)``
      matvecs become ONE ``(S·n, d)`` matvec and one flat reduction;
      ``fed`` is then a :class:`NoFederatedShards`.

    ``compute_dtype`` is as in :func:`.hierbase.linear_predictor`.  The
    model runs on the device that holds ``data``.
    """

    data: ShardedData
    mesh: Optional[Mesh] = None
    prior_scale: float = 5.0
    compute_dtype: Optional[Any] = None
    use_suffstats: bool = False
    flatten: bool = False

    def __post_init__(self):
        (X, y), mask = self.data.tree()
        self.device = mask.device
        if self.flatten:
            if self.mesh is not None:
                raise ValueError(
                    "flatten=True collapses the shard axis and cannot "
                    "be sharded over a mesh; use use_suffstats instead"
                )
            if self.use_suffstats:
                raise ValueError(
                    "flatten=True and use_suffstats=True are distinct "
                    "implementations of the same posterior — pick one "
                    "(flatten already folds the suffstats terms)"
                )
            d = X.shape[-1]
            Xf = X.reshape(-1, d)
            mf = mask.reshape(-1)
            ymf = y.reshape(-1) * mf
            syx = ymf @ Xf  # (d,), build-time constant
            sy = torch.sum(ymf)

            def flat_loglik(params):
                logits = linear_predictor(Xf, params["w"], params["b"], self.compute_dtype)
                sp = torch.sum(_log1p_exp(logits) * mf)
                return syx @ params["w"] + sy * params["b"] - sp

            self._loglik = flat_loglik
            self.fed = NoFederatedShards("flatten=True folds all shards")
        elif self.use_suffstats:
            ym = y * mask
            syx = torch.einsum("snd,sn->sd", X, ym)  # (S, D), build-time
            sy = torch.sum(ym, dim=1)  # (S,)

            def per_shard_logp(params, shard):
                (X, syx, sy), mask = shard
                logits = linear_predictor(X, params["w"], params["b"], self.compute_dtype)
                sp = torch.sum(_log1p_exp(logits) * mask)
                return syx @ params["w"] + sy * params["b"] - sp

            self.fed = FederatedLogp(per_shard_logp, ((X, syx, sy), mask), mesh=self.mesh)
            self._loglik = self.fed.logp
        else:

            def per_shard_logp(params, shard):
                (X, y), mask = shard
                logits = linear_predictor(X, params["w"], params["b"], self.compute_dtype)
                ll = y * logits - _log1p_exp(logits)
                return torch.sum(ll * mask)

            self.fed = FederatedLogp(per_shard_logp, self.data.tree(), mesh=self.mesh)
            self._loglik = self.fed.logp
        self.n_features = tree_leaves(self.data.data)[0].shape[-1]

    def prior_logp(self, params: Any) -> torch.Tensor:
        lp = torch.sum(_normal_logpdf(params["w"], 0.0, self.prior_scale))
        return lp + _normal_logpdf(params["b"], 0.0, self.prior_scale)

    def logp(self, params: Any) -> torch.Tensor:
        return self.prior_logp(params) + self._loglik(params)

    def logp_and_grad(self, params: Any):
        return value_and_grad(self.logp, params)

    def init_params(self) -> Any:
        z = lambda *shape: torch.zeros(shape, dtype=torch.float32, device=self.device)
        return {"w": z(self.n_features), "b": z()}

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

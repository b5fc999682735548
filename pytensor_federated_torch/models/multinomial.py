"""Federated multinomial (softmax) regression — categorical outcomes.

Port of the JAX package's ``models/multinomial.py``.  Each federated
shard owns private ``(X_i, y_i)`` with ``y ∈ {0..K-1}``; coefficients
are shared:

    W ~ Normal(0, prior_scale)  per entry, shape (d, K-1)
    b ~ Normal(0, prior_scale)  per entry, shape (K-1,)
    logits = [0, X w_1 + b_1, ..., X w_{K-1} + b_{K-1}]
    y ~ Categorical(softmax(logits))

Class 0's logit is pinned to zero, which keeps the model identifiable
without constraints.  Per-shard compute is one ``(n, d) @ (d, K-1)``
product and one logsumexp over K.  The hierarchical variant
(:class:`HierarchicalSoftmaxRegression`) sits on
:class:`.hierbase.HierarchicalGLMBase` with ``_coef_cols = K - 1``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from ..parallel.mesh import Mesh
from ..parallel.packing import ShardedData, pack_shards
from ..parallel.sharded import FederatedLogp
from ..utils import tree_leaves, value_and_grad
from .hierbase import HierarchicalGLMBase
from .linear import _normal_logpdf

__all__ = [
    "FederatedSoftmaxRegression",
    "HierarchicalSoftmaxRegression",
    "generate_hier_multinomial_data",
    "generate_multinomial_data",
]


def _pinned_logits(free):
    """(…, K) logits from (…, K-1) free columns; class 0 pinned to 0."""
    return torch.cat([torch.zeros_like(free[..., :1]), free], dim=-1)


def _categorical_loglik(y, free):
    """Per-observation categorical log-likelihood from the free logit
    columns — the one implementation of the flat and hierarchical
    models.  The class index is clamped to ``0..K-1`` (as ``jnp``'s
    gathers clamp): an out-of-range index would be a device assert on
    CUDA."""
    eta = _pinned_logits(free)
    y_idx = y.long().clamp(0, eta.shape[-1] - 1)
    picked = torch.gather(eta, -1, y_idx[..., None])[..., 0]
    return picked - torch.logsumexp(eta, dim=-1)


def _sample_categorical(generator, free):
    """One class per row by the Gumbel-max trick over the pinned
    logits (float32 labels, as in the JAX package)."""
    logits = _pinned_logits(free)
    u = torch.rand(logits.shape, generator=generator, device=logits.device, dtype=logits.dtype)
    gumbel = -torch.log(-torch.log(torch.clamp(u, min=torch.finfo(u.dtype).tiny)))
    return torch.argmax(logits + gumbel, dim=-1).to(torch.float32)


def _simulate_softmax_shards(rng, n_shards, n_obs, n_features,
                             n_classes, W, intercepts, device):
    """Shared simulator: per-shard intercept rows (broadcast for the
    flat model), zero-pinned softmax draws, in numpy."""
    intercepts = np.broadcast_to(intercepts, (n_shards, n_classes - 1))
    shards = []
    for s in range(n_shards):
        X = rng.normal(size=(n_obs, n_features)).astype(np.float32)
        logits = np.concatenate(
            [np.zeros((n_obs, 1)), X @ W + intercepts[s]], axis=1
        )
        p = np.exp(logits - logits.max(axis=1, keepdims=True))
        p /= p.sum(axis=1, keepdims=True)
        y = np.array([rng.choice(n_classes, p=pi) for pi in p], dtype=np.float32)
        shards.append((X, y))
    return pack_shards(shards, device=device)


def generate_multinomial_data(
    n_shards: int = 8,
    *,
    n_obs: int = 64,
    n_features: int = 4,
    n_classes: int = 3,
    seed: int = 37,
    device: Any = None,
):
    """Flat softmax data (numpy draws in the JAX package's order: the
    packed bytes equal its)."""
    rng = np.random.default_rng(seed)
    W = rng.normal(0, 1.0, size=(n_features, n_classes - 1))
    b = rng.normal(0, 0.5, size=(n_classes - 1,))
    packed = _simulate_softmax_shards(
        rng, n_shards, n_obs, n_features, n_classes, W, b, device
    )
    return packed, {"W": W, "b": b}


def generate_hier_multinomial_data(
    n_shards: int = 8,
    *,
    n_obs: int = 64,
    n_features: int = 3,
    n_classes: int = 3,
    tau: float = 0.8,
    seed: int = 47,
    device: Any = None,
):
    """Per-shard data with shard-specific class intercepts
    ``b_s ~ N(b0, tau)`` (one per free class)."""
    rng = np.random.default_rng(seed)
    W = rng.normal(0, 1.0, size=(n_features, n_classes - 1))
    b0 = rng.normal(0, 0.5, size=(n_classes - 1,))
    b_s = b0[None, :] + tau * rng.normal(size=(n_shards, n_classes - 1))
    packed = _simulate_softmax_shards(
        rng, n_shards, n_obs, n_features, n_classes, W, b_s, device
    )
    return packed, {"W": W, "b0": b0, "tau": tau}


@dataclasses.dataclass
class FederatedSoftmaxRegression:
    """Softmax regression with shared ``(W, b)`` over federated shards,
    on the device that holds ``data``."""

    data: ShardedData
    n_classes: int
    mesh: Optional[Mesh] = None
    prior_scale: float = 5.0
    #: partial sufficient statistics: the picked-logit term is LINEAR in
    #: (W, b) — Σ_i eta[y_i] = Σ_k (Σ_{i: y_i=k} x_i)·w_k + n_k b_k — so
    #: its coefficients (per-shard per-class Σx and counts) fold into
    #: build-time constants and the hot loop evaluates only the
    #: logsumexp normalizer.  The same posterior; equality-tested.
    use_suffstats: bool = False

    def __post_init__(self):
        K = int(self.n_classes)
        if K < 2:
            raise ValueError(f"n_classes must be >= 2, got {K}")
        self._k = K
        (X, y), mask = self.data.tree()
        self.device = mask.device

        if self.use_suffstats:
            # one-hot over the K-1 FREE classes (class 0's logit is a
            # pinned zero, so it has no linear term)
            free_classes = torch.arange(1, K, dtype=y.dtype, device=self.device)
            onehot = (y[..., None] == free_classes).to(X.dtype) * mask[..., None].to(X.dtype)
            sx = torch.einsum("snd,snk->sdk", X, onehot)
            sn = torch.sum(onehot, dim=1)  # (S, K-1)

            def per_shard_logp(params, shard):
                (X_s, sx_s, sn_s), m_s = shard
                free = X_s @ params["W"] + params["b"]
                lse = torch.logsumexp(_pinned_logits(free), dim=-1)
                picked = torch.sum(sx_s * params["W"]) + torch.sum(sn_s * params["b"])
                return picked - torch.sum(lse * m_s)

            self.fed = FederatedLogp(per_shard_logp, ((X, sx, sn), mask), mesh=self.mesh)
        else:

            def per_shard_logp(params, shard):
                (X, y), mask = shard
                ll = _categorical_loglik(y, X @ params["W"] + params["b"])
                return torch.sum(ll * mask)

            self.fed = FederatedLogp(per_shard_logp, self.data.tree(), mesh=self.mesh)
        self.n_features = tree_leaves(self.data.data)[0].shape[-1]

    def prior_logp(self, params: Any) -> torch.Tensor:
        lp = torch.sum(_normal_logpdf(params["W"], 0.0, self.prior_scale))
        return lp + torch.sum(_normal_logpdf(params["b"], 0.0, self.prior_scale))

    def logp(self, params: Any) -> torch.Tensor:
        return self.prior_logp(params) + self.fed.logp(params)

    def logp_and_grad(self, params: Any):
        return value_and_grad(self.logp, params)

    def init_params(self) -> Any:
        z = lambda *shape: torch.zeros(shape, dtype=torch.float32, device=self.device)
        return {"W": z(self.n_features, self._k - 1), "b": z(self._k - 1)}

    def pointwise_loglik(self, params: Any) -> torch.Tensor:
        """Flat per-observation log-likelihoods (masked slots -> 0), for
        PSIS-LOO / WAIC (samplers.model_comparison)."""
        (X, y), mask = self.data.tree()
        ll = _categorical_loglik(y, X @ params["W"] + params["b"])
        return (ll * mask).reshape(-1)

    def predictive(self, params: Any, generator: torch.Generator) -> torch.Tensor:
        """Simulate class labels ``(*draws, n_shards, n_obs)`` for every
        design row (padded slots produce labels too; apply the mask
        downstream).  ``params`` may carry leading draw axes, as in
        :meth:`.hierbase.HierarchicalGLMBase.predictive`."""
        X = self.data.tree()[0][0]
        free_fn = lambda p: X @ p["W"] + p["b"]
        for _ in range(params["b"].ndim - 1):
            free_fn = torch.func.vmap(free_fn)
        return _sample_categorical(generator, free_fn(params))

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


@dataclasses.dataclass
class HierarchicalSoftmaxRegression(HierarchicalGLMBase):
    """Mixed-effects softmax: shared slopes, per-site class intercepts.

    On :class:`.hierbase.HierarchicalGLMBase` with vector coefficient
    columns (``_coef_cols = K - 1``)::

        w ~ Normal(0, prior_scale)          (d, K-1), shared
        b0 ~ Normal(0, prior_scale)         (K-1,)
        tau ~ HalfNormal(1)                 via log_tau + Jacobian
        b_raw_s ~ Normal(0, 1)              (S, K-1) per site
        logits = [0, X_s w + b0 + tau * b_raw_s]

    The base supplies the hierarchy and the pointwise, predictive and
    prior machinery; this class supplies the categorical family.
    """

    data: ShardedData = None
    n_classes: int = 2
    mesh: Optional[Mesh] = None
    prior_scale: float = 5.0

    def __post_init__(self):
        K = int(self.n_classes)
        if K < 2:
            raise ValueError(f"n_classes must be >= 2, got {K}")
        self._coef_cols = K - 1
        self._post_init()

    def _obs_logpmf(self, params, y, eta):
        # eta: (..., K-1) free logit columns from the base's X @ w + b
        return _categorical_loglik(y, eta)

    def _sample_obs(self, params, generator, eta):
        return _sample_categorical(generator, eta)

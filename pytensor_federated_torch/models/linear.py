"""Federated Bayesian linear regression — the flagship demo model.

Port of the JAX package's ``models/linear.py``: each "node" owns a
private ``(x, y)`` dataset and contributes a partial log-likelihood with
a per-shard intercept offset; the driver places a prior over the
intercepts and samples the posterior with NUTS.

Model:

    intercept   ~ Normal(0, prior_scale)
    offset_i    ~ Normal(0, offset_scale)      per shard i (fixed scale)
    slope       ~ Normal(0, prior_scale)
    sigma       ~ HalfNormal(1)  (via log_sigma + change of variables)
    y_ij        ~ Normal((intercept + offset_i) + slope * x_ij, sigma)
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Sequence

import numpy as np
import torch

from ..parallel.packing import ShardedData, pack_shards
from ..parallel.sharded import FederatedLogp
from ..utils import LOG_2PI, value_and_grad


def generate_node_data(
    n_shards: int = 8,
    *,
    n_obs: int | Sequence[int] = 64,
    intercept: float = 1.5,
    slope: float = 2.0,
    sigma: float = 0.5,
    intercept_spread: float = 0.3,
    seed: int = 123,
    device: Any = None,
) -> tuple[ShardedData, np.ndarray]:
    """Per-node private datasets, packed; and the true per-shard offsets.

    Draws from ``np.random.default_rng(seed)`` in the JAX package's
    order, so the packed bytes equal its ``generate_node_data``'s.
    """
    rng = np.random.default_rng(seed)
    if isinstance(n_obs, int):
        n_obs = [n_obs] * n_shards
    offsets = rng.normal(0.0, intercept_spread, size=n_shards)
    shards = []
    for i in range(n_shards):
        x = rng.uniform(-3.0, 3.0, size=n_obs[i]).astype(np.float32)
        y = (
            (intercept + offsets[i])
            + slope * x
            + rng.normal(0.0, sigma, size=n_obs[i])
        ).astype(np.float32)
        shards.append((x, y))
    return pack_shards(shards, pad_to_multiple=8, device=device), offsets


def _normal_logpdf(x, mu, sigma):
    z = (x - mu) / sigma
    log_sigma = torch.log(sigma) if torch.is_tensor(sigma) else math.log(sigma)
    return -0.5 * z * z - log_sigma - 0.5 * LOG_2PI


def linreg_suffstats(x: torch.Tensor, y: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Per-shard sufficient statistics ``(S, 6)``: ``[n, x̄, ȳ, Cxx, Cxy, Cyy]``
    (counts, masked means, and *centered* second moments).

    For a Gaussian linear model the data enter the likelihood only
    through these six numbers per shard.  The centered form keeps
    float32 well-conditioned.  Accumulation runs in float64 numpy (one
    time, off the hot path); the stats come back as float32 on ``x``'s
    device.
    """
    device = x.device
    x, y, m = (np.asarray(t.detach().cpu().numpy(), np.float64) for t in (x, y, mask))
    n = m.sum(axis=1)
    safe_n = np.where(n > 0, n, 1.0)
    xb = (m * x).sum(axis=1) / safe_n
    yb = (m * y).sum(axis=1) / safe_n
    dx = (x - xb[:, None]) * m
    dy = (y - yb[:, None]) * m
    cxx = (dx * dx).sum(axis=1)
    cxy = (dx * dy).sum(axis=1)
    cyy = (dy * dy).sum(axis=1)
    stats = np.stack([n, xb, yb, cxx, cxy, cyy], axis=1).astype(np.float32)
    return torch.as_tensor(stats, device=device)


def _suffstat_shard_logp(A, slope, log_sigma, stats):
    """Shard data-loglik from sufficient stats; ``A`` = intercept+offset.

    With ``d = ȳ - A - slope·x̄`` the masked residual sum of squares is
    ``Cyy - 2·slope·Cxy + slope²·Cxx + n·d²``, so the whole shard
    likelihood is O(1) regardless of the number of observations.
    """
    n, xb, yb, cxx, cxy, cyy = (stats[..., i] for i in range(6))
    d = yb - A - slope * xb
    ssr = cyy - 2.0 * slope * cxy + slope * slope * cxx + n * d * d
    inv_s2 = torch.exp(-2.0 * log_sigma)
    return -0.5 * ssr * inv_s2 - (log_sigma + 0.5 * LOG_2PI) * n


def linreg_prior_logp(
    params: Any, *, prior_scale: float = 10.0, offset_scale: float = 0.3
) -> torch.Tensor:
    """The model's prior log-density; it needs no data, so a federated
    driver that holds none computes it (the nodes supply the rest)."""
    lp = _normal_logpdf(params["intercept"], 0.0, prior_scale)
    lp = lp + _normal_logpdf(params["slope"], 0.0, prior_scale)
    lp = lp + torch.sum(_normal_logpdf(params["offsets"], 0.0, offset_scale))
    # HalfNormal(1) on sigma via log_sigma with Jacobian |d sigma/d log_sigma|.
    sigma = torch.exp(params["log_sigma"])
    return lp + (-0.5 * sigma**2 + params["log_sigma"])


@dataclasses.dataclass
class FederatedLinearRegression:
    """Hierarchical linear regression over federated shards.

    ``params`` tree::

        intercept: ()      slope: ()      log_sigma: ()
        offsets: (n_shards,)

    The per-shard likelihood closes over that shard's private data; the
    shard picks out its own offset via the shard index carried in the
    data tree.  The model runs on the device that holds ``data``.
    """

    data: ShardedData
    prior_scale: float = 10.0
    offset_scale: float = 0.3
    use_suffstats: bool = False

    def __post_init__(self):
        n = self.data.n_shards
        (x, y), mask = self.data.tree()
        self.device = mask.device
        shard_ids = torch.arange(n, device=self.device)

        if self.use_suffstats:
            tree = (linreg_suffstats(x, y, mask), shard_ids)

            def per_shard_logp(params, shard):
                stats, sid = shard
                A = params["intercept"] + params["offsets"][sid]
                return _suffstat_shard_logp(
                    A, params["slope"], params["log_sigma"], stats
                )

        else:
            tree = ((x, y), mask, shard_ids)

            def per_shard_logp(params, shard):
                (x, y), mask, sid = shard
                offset = params["offsets"][sid]
                mu = (params["intercept"] + offset) + params["slope"] * x
                sigma = torch.exp(params["log_sigma"])
                ll = _normal_logpdf(y, mu, sigma)
                return torch.sum(ll * mask)

        self.fed = FederatedLogp(per_shard_logp, tree)
        self.n_shards = n

    # -- prior + posterior ------------------------------------------------

    def prior_logp(self, params: Any) -> torch.Tensor:
        return linreg_prior_logp(
            params, prior_scale=self.prior_scale, offset_scale=self.offset_scale
        )

    def logp(self, params: Any) -> torch.Tensor:
        return self.prior_logp(params) + self.fed.logp(params)

    def logp_and_grad(self, params: Any):
        """Posterior logp and its gradient tree, one backward pass."""
        return value_and_grad(self.logp, params)

    def init_params(self) -> Any:
        z = lambda *shape: torch.zeros(shape, dtype=torch.float32, device=self.device)
        return {
            "intercept": z(),
            "slope": z(),
            "log_sigma": z(),
            "offsets": z(self.n_shards),
        }

    def sample(self, *, generator: torch.Generator | None = None, **kwargs):
        """NUTS on the posterior (``samplers.sample``); the default
        generator is seeded with 0 on the model's device."""
        from ..samplers import sample

        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        return sample(self.logp, self.init_params(), generator=generator, **kwargs)

"""Hierarchical (radon-style) GLM — one federated shard per county group.

Port of the JAX package's ``models/glm.py`` (BASELINE.json config 3):
varying-intercept regression with partial pooling,

    mu_alpha      ~ Normal(0, 10)
    sigma_alpha   ~ HalfNormal(1)
    alpha_c       = mu_alpha + sigma_alpha * alpha_raw_c   (non-centered)
    alpha_raw_c   ~ Normal(0, 1)           per county c
    beta          ~ Normal(0, 10)
    sigma         ~ HalfNormal(1)
    log_radon_ij  ~ Normal(alpha_{county(ij)} + beta * floor_ij, sigma)

Each county's observations are one federated shard (heterogeneous
sizes — pad+mask via pack_shards).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from ..parallel.mesh import Mesh
from ..parallel.packing import ShardedData, pack_shards
from ..parallel.sharded import FederatedLogp
from ..utils import value_and_grad
from .linear import _normal_logpdf


def generate_radon_data(
    n_counties: int = 16,
    *,
    mean_obs: int = 24,
    seed: int = 11,
    device: Any = None,
):
    """Synthetic radon-style data with per-county sizes drawn ~Poisson.

    Draws from ``np.random.default_rng(seed)`` in the JAX package's
    order, so the packed bytes equal its ``generate_radon_data``'s."""
    rng = np.random.default_rng(seed)
    true = {
        "mu_alpha": 1.5,
        "sigma_alpha": 0.4,
        "beta": -0.6,
        "sigma": 0.7,
    }
    alphas = rng.normal(true["mu_alpha"], true["sigma_alpha"], size=n_counties)
    shards = []
    for c in range(n_counties):
        n = max(3, int(rng.poisson(mean_obs)))
        floor = rng.integers(0, 2, size=n).astype(np.float32)
        y = (
            alphas[c] + true["beta"] * floor + rng.normal(0, true["sigma"], n)
        ).astype(np.float32)
        shards.append((floor, y))
    return pack_shards(shards, pad_to_multiple=8, device=device), true


@dataclasses.dataclass
class HierarchicalRadonGLM:
    """Partial-pooling GLM over county shards, on the device of ``data``."""

    data: ShardedData
    mesh: Optional[Mesh] = None

    def __post_init__(self):
        n = self.data.n_shards
        (floor, y), mask = self.data.tree()
        self.device = mask.device
        county_ids = torch.arange(n, device=self.device)
        tree = ((floor, y), mask, county_ids)

        def per_shard_logp(params, shard):
            (floor, y), mask, cid = shard
            sigma_alpha = torch.exp(params["log_sigma_alpha"])
            alpha = params["mu_alpha"] + sigma_alpha * params["alpha_raw"][cid]
            mu = alpha + params["beta"] * floor
            sigma = torch.exp(params["log_sigma"])
            return torch.sum(_normal_logpdf(y, mu, sigma) * mask)

        self.fed = FederatedLogp(per_shard_logp, tree, mesh=self.mesh)
        self.n_counties = n

    def prior_logp(self, params: Any) -> torch.Tensor:
        lp = _normal_logpdf(params["mu_alpha"], 0.0, 10.0)
        lp = lp + _normal_logpdf(params["beta"], 0.0, 10.0)
        lp = lp + torch.sum(_normal_logpdf(params["alpha_raw"], 0.0, 1.0))
        # HalfNormal(1) via log-transform + Jacobian, for both scales.
        for name in ("log_sigma_alpha", "log_sigma"):
            s = torch.exp(params[name])
            lp = lp + (-0.5 * s**2 + params[name])
        return lp

    def logp(self, params: Any) -> torch.Tensor:
        return self.prior_logp(params) + self.fed.logp(params)

    def logp_and_grad(self, params: Any):
        return value_and_grad(self.logp, params)

    def init_params(self) -> Any:
        scalar = lambda v: torch.tensor(v, dtype=torch.float32, device=self.device)
        return {
            "mu_alpha": scalar(0.0),
            "log_sigma_alpha": scalar(-1.0),
            "beta": scalar(0.0),
            "log_sigma": scalar(0.0),
            "alpha_raw": torch.zeros(self.n_counties, dtype=torch.float32, device=self.device),
        }

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

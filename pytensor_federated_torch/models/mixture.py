"""Federated Gaussian mixtures: shared components, per-site weights.

Port of the JAX package's ``models/mixture.py``.  Density estimation
across sites whose populations mix the SAME latent subgroups in
DIFFERENT proportions:

    y_ij ~ Σ_k  π_ik  N(mu_k, sigma_k)      (k = 1..K components)
    π_i  = softmax(logits_i)                 per shard i
    mu, sigma shared across shards

Component labels are marginalized (one ``logsumexp`` per observation, so
NUTS applies directly), and the component means are ORDERED by
construction (``mu_0`` + positive increments, the ordinal cutpoint
device), which removes label switching.

Priors: ``mu_0 ~ N(0, prior_scale)``, increments LogNormal(0,1),
``log_sigma_k ~ N(0,1)``, per-shard weight logits ``~ N(0,1)``, each a
proper prior on the unconstrained coordinate (no Jacobian terms).
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

__all__ = [
    "FederatedGaussianMixture",
    "generate_mixture_data",
    "mixture_loglik",
]


def generate_mixture_data(
    n_shards: int = 8,
    *,
    n_obs: int = 128,
    mus=(-2.0, 0.5, 3.0),
    sigmas=(0.5, 0.7, 0.6),
    concentration: float = 2.0,
    seed: int = 47,
    device: Any = None,
):
    """Per-shard draws from shared components with Dirichlet per-shard
    weights (numpy draws in the JAX package's order: the packed bytes
    equal its)."""
    rng = np.random.default_rng(seed)
    mus = np.asarray(mus, np.float64)
    sigmas = np.asarray(sigmas, np.float64)
    K = mus.size
    weights = rng.dirichlet(np.full(K, concentration), size=n_shards)
    shards = []
    for i in range(n_shards):
        z = rng.choice(K, size=n_obs, p=weights[i])
        y = (mus[z] + sigmas[z] * rng.normal(size=n_obs)).astype(np.float32)
        shards.append((y,))
    truth = {"mu": mus, "sigma": sigmas, "weights": weights}
    return pack_shards(shards, pad_to_multiple=8, device=device), truth


def mixture_loglik(y, log_w, mu, sigma):
    """Marginalized per-observation mixture log-density.

    ``y``: (n,), ``log_w``: (K,) normalized log-weights, ``mu`` /
    ``sigma``: (K,); one (n, K) broadcast + logsumexp.  Leading axes
    broadcast (``y`` (S, n) with ``log_w`` (S, 1, K))."""
    comp = _normal_logpdf(y[..., None], mu, sigma) + log_w
    return torch.logsumexp(comp, dim=-1)


@dataclasses.dataclass
class FederatedGaussianMixture:
    """K shared Gaussian components, per-shard mixing weights, on the
    device that holds ``data``."""

    data: ShardedData
    n_components: int
    mesh: Optional[Mesh] = None
    prior_scale: float = 5.0

    def __post_init__(self):
        (y,), mask = self.data.tree()
        n = y.shape[0]
        self.device = mask.device
        shard_ids = torch.arange(n, device=self.device)

        def per_shard_logp(params, shard):
            (y,), mask, sid = shard
            mu, sigma = self._components(params)
            # The shard's logits by its id: a gather that also runs
            # inside the samplers' vmap over chains.
            log_w = torch.log_softmax(params["weight_logits"][sid], dim=-1)
            ll = mixture_loglik(y, log_w, mu, sigma)
            return torch.sum(ll * mask)

        self.fed = FederatedLogp(per_shard_logp, ((y,), mask, shard_ids), mesh=self.mesh)
        self.n_shards = n

    @staticmethod
    def _components(params):
        """Ordered means (mu0 + positive increments) and scales (leading
        draw axes allowed)."""
        mu0 = params["mu0"][..., None]
        incr = torch.exp(params["log_incr"])
        mu = torch.cat([mu0, mu0 + torch.cumsum(incr, dim=-1)], dim=-1)
        return mu, torch.exp(params["log_sigma"])

    def prior_logp(self, params: Any) -> torch.Tensor:
        lp = _normal_logpdf(params["mu0"], 0.0, self.prior_scale)
        # LogNormal(0,1) increments: N(0,1) density on log_incr IS the
        # prior on the unconstrained coordinate (no extra Jacobian).
        lp = lp + torch.sum(_normal_logpdf(params["log_incr"], 0.0, 1.0))
        lp = lp + torch.sum(_normal_logpdf(params["log_sigma"], 0.0, 1.0))
        return lp + torch.sum(_normal_logpdf(params["weight_logits"], 0.0, 1.0))

    def logp(self, params: Any) -> torch.Tensor:
        return self.prior_logp(params) + self.fed.logp(params)

    def logp_and_grad(self, params: Any):
        return value_and_grad(self.logp, params)

    def weights(self, params: Any) -> torch.Tensor:
        """Implied per-shard mixing proportions ``(n_shards, K)``."""
        return torch.softmax(params["weight_logits"], dim=-1)

    def pointwise_loglik(self, params: Any) -> torch.Tensor:
        """``(n_shards, n_obs)`` per-observation log-likelihoods (padded
        slots zeroed)."""
        (y,), mask = self.data.tree()
        mu, sigma = self._components(params)
        log_w = torch.log_softmax(params["weight_logits"], dim=-1)
        return mixture_loglik(y, log_w[:, None, :], mu, sigma) * mask

    def predictive(self, params: Any, generator: torch.Generator) -> torch.Tensor:
        """Simulate replicated data ``(*draws, n_shards, n_obs)`` (padded
        slots zeroed); ``params`` may carry leading draw axes.  Each
        observation's component is a Gumbel-max draw from its shard's
        weights."""
        (y,), mask = self.data.tree()
        mu, sigma = self._components(params)
        logits = params["weight_logits"][..., :, None, :]  # (*draws, S, 1, K)
        shape = logits.shape[:-3] + tuple(y.shape) + logits.shape[-1:]
        u = torch.rand(shape, generator=generator, device=y.device, dtype=logits.dtype)
        gumbel = -torch.log(-torch.log(torch.clamp(u, min=torch.finfo(u.dtype).tiny)))
        z = torch.argmax(logits + gumbel, dim=-1, keepdim=True)  # (*draws, S, N, 1)

        def pick(per_component):
            return torch.gather(per_component[..., None, None, :].expand(shape), -1, z)[..., 0]

        eps = torch.randn(z.shape[:-1], generator=generator, device=y.device, dtype=logits.dtype)
        return (pick(mu) + pick(sigma) * eps) * mask

    def init_params(self) -> Any:
        K = self.n_components
        (y,), mask = self.data.tree()
        y_real = y.detach().cpu().numpy()[mask.detach().cpu().numpy() > 0]
        spread = float(np.std(y_real) + 1e-3)
        full = lambda shape, v: torch.full(shape, v, dtype=torch.float32, device=self.device)
        return {
            "mu0": full((), float(np.min(y_real))),
            "log_incr": full((K - 1,), float(np.log(spread))),
            "log_sigma": full((K,), float(np.log(0.5 * spread))),
            "weight_logits": full((self.n_shards, K), 0.0),
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

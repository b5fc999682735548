"""Lotka-Volterra ODE parameter estimation — [theta] -> [LL, dLL] per shard.

Port of the JAX package's ``models/ode.py`` (BASELINE.json config 4):
each federated shard owns a noisy observed predator/prey trajectory;
the sampler infers the shared dynamics parameters.

    du/dt = alpha*u - beta*u*v          (prey)
    dv/dt = -gamma*v + delta*u*v        (predator)
    y_obs ~ LogNormal(log(traj), sigma)

The integrator is fixed-step RK4 as a Python loop over tensors; the
gradient flows through it by autograd.  Each step is ~30 small
elementwise launches on a 2-vector, so on a GPU an evaluation is bound
by launch latency, not arithmetic.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import numpy as np
import torch

from ..parallel.mesh import Mesh
from ..parallel.sharded import FederatedLogp
from ..utils import resolve_device, value_and_grad
from .linear import _normal_logpdf


def lv_vector_field(state: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    u, v = state[0], state[1]
    alpha, beta, gamma, delta = theta.unbind()
    du = alpha * u - beta * u * v
    dv = -gamma * v + delta * u * v
    return torch.stack([du, dv])


def _lv_field_fn(theta: torch.Tensor):
    """:func:`lv_vector_field` as two coefficient vectors, so that one
    evaluation is 4 elementwise launches on the 2-vector instead of ~10 on
    scalars.  The roundings are the same: ``alpha*u + ((-beta)*u)*v``
    equals ``alpha*u - beta*u*v`` and ``(-gamma)*v + (delta*u)*v`` is the
    JAX expression itself."""
    alpha, beta, gamma, delta = theta.unbind()
    linear = torch.stack([alpha, -gamma])
    cross = torch.stack([-beta, delta])
    return lambda y: linear * y + (cross * y[0]) * y[1]


def rk4_integrate(theta: torch.Tensor, y0: torch.Tensor, dt: float, n_steps: int) -> torch.Tensor:
    """Fixed-step RK4; returns the trajectory ``(n_steps+1, 2)``."""
    f = _lv_field_fn(theta)
    y, traj = y0, [y0]
    for _ in range(n_steps):
        k1 = f(y)
        k2 = f(y + 0.5 * dt * k1)
        k3 = f(y + 0.5 * dt * k2)
        k4 = f(y + dt * k3)
        y = y + (dt / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
        traj.append(y)
    return torch.stack(traj)


def generate_lv_data(
    n_shards: int = 8,
    *,
    n_obs: int = 32,
    dt: float = 0.1,
    obs_every: int = 4,
    seed: int = 31,
    device: Any = None,
):
    """Noisy replicate observations of one true trajectory per shard.

    The noise comes from ``np.random.default_rng(seed)`` as in the JAX
    package; the clean trajectory is float32 RK4 on the CPU, so the
    observations equal the JAX package's to float32 rounding of the
    integration (not byte for byte)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    theta_true = np.array([0.8, 0.4, 0.6, 0.3], dtype=np.float32)
    y0 = np.array([1.5, 1.0], dtype=np.float32)
    n_steps = n_obs * obs_every
    with torch.no_grad():
        traj = rk4_integrate(torch.from_numpy(theta_true), torch.from_numpy(y0), dt, n_steps).numpy()
    obs_idx = np.arange(1, n_obs + 1) * obs_every
    clean = traj[obs_idx]  # (n_obs, 2)
    sigma_true = 0.1
    shards = np.stack(
        [
            clean * np.exp(rng.normal(0, sigma_true, size=clean.shape))
            for _ in range(n_shards)
        ]
    ).astype(np.float32)
    meta = {
        "theta": theta_true,
        "sigma": sigma_true,
        "y0": y0,
        "dt": dt,
        "n_steps": n_steps,
        "obs_idx": obs_idx,
    }
    return torch.as_tensor(shards, device=dev), meta


@dataclasses.dataclass
class LotkaVolterraModel:
    """Infer shared ODE params from per-shard noisy trajectories.

    ``params``: ``log_theta`` (4,) — positivity via log-transform — and
    ``log_sigma``.  The model runs on the device (and in the dtype) of
    ``observations``.
    """

    observations: torch.Tensor  # (n_shards, n_obs, 2)
    y0: Any
    dt: float
    n_steps: int
    obs_idx: Any
    mesh: Optional[Mesh] = None

    def __post_init__(self):
        self.device = self.observations.device
        y0 = torch.as_tensor(np.asarray(self.y0), dtype=self.observations.dtype, device=self.device)
        obs_idx = torch.as_tensor(np.asarray(self.obs_idx), device=self.device)

        def per_shard_logp(params, shard_obs):
            # The trajectory depends on the parameters only, which
            # torch.func.vmap does not batch: the integration runs once
            # per evaluation, shared by every shard, and only the
            # observation likelihood below is batched over shards.
            theta = torch.exp(params["log_theta"])
            dev = shard_obs.device  # a mesh slot's device
            traj = rk4_integrate(theta, y0.to(dev), self.dt, self.n_steps)
            mu = torch.log(torch.clamp(traj[obs_idx.to(dev)], min=1e-6))
            sigma = torch.exp(params["log_sigma"])
            log_obs = torch.log(shard_obs)
            return torch.sum(_normal_logpdf(log_obs, mu, sigma) - log_obs)

        self.fed = FederatedLogp(per_shard_logp, self.observations, mesh=self.mesh)

    def prior_logp(self, params: Any) -> torch.Tensor:
        # LogNormal(log 0.5, 1) on each theta; HalfNormal(1) on sigma.
        lp = torch.sum(_normal_logpdf(params["log_theta"], math.log(0.5), 1.0))
        s = torch.exp(params["log_sigma"])
        return lp + (-0.5 * s**2 + params["log_sigma"])

    def logp(self, params: Any) -> torch.Tensor:
        return self.prior_logp(params) + self.fed.logp(params)

    def logp_and_grad(self, params: Any):
        """[theta] -> [LL, dLL] — the reference's per-node contract,
        fused across all shards."""
        return value_and_grad(self.logp, params)

    def init_params(self) -> Any:
        return {
            "log_theta": torch.full((4,), math.log(0.5), dtype=torch.float32, device=self.device),
            "log_sigma": torch.tensor(-2.0, dtype=torch.float32, device=self.device),
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


def make_lv_model(
    n_shards: int = 8, *, mesh: Optional[Mesh] = None, device: Any = None, **kwargs
):
    obs, meta = generate_lv_data(n_shards, device=device, **kwargs)
    model = LotkaVolterraModel(
        observations=obs,
        y0=meta["y0"],
        dt=meta["dt"],
        n_steps=meta["n_steps"],
        obs_idx=meta["obs_idx"],
        mesh=mesh,
    )
    return model, meta

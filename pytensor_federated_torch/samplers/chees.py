"""ChEES-HMC: cross-chain adaptive HMC built for lockstep chains.

Port of the JAX package's ``samplers/chees.py`` (Hoffman, Radul &
Sountsov, AISTATS 2021, "An Adaptive MCMC Scheme for Setting Trajectory
Lengths in Hamiltonian Monte Carlo").  NUTS's tree doubling makes every
lockstep chain wait for the deepest tree in the batch each draw; ChEES
runs every chain along the SAME jittered fixed-length trajectory each
iteration and adapts that length by ascending the Change-in-the-
Estimator-of-the-Expected-Square criterion with a cross-chain stochastic
gradient — the many parallel chains are exactly the statistic the
adaptation needs.

Per iteration t (all chains in lockstep):

- jitter ``h_t`` from a Halton sequence; every chain integrates
  ``L_t = ceil(h_t * 2 T / eps)`` leapfrog steps, each one value+grad
  evaluation of the whole batch (``L_t`` is one host read per
  iteration: the loop runs on the host);
- the ChEES gradient estimate combines per-chain proposal quantities
  (centered squared-radius change times proposal-velocity projection),
  accept-probability weighted, and updates ``log T`` by Adam;
- the step size follows dual averaging on the across-chain mean
  accept probability, and the diagonal mass matrix is the
  across-(chains x recent draws) variance.

After warmup, ``(eps, T, mass)`` freeze and sampling keeps the Halton
jitter.  Returns the same ``SampleResult`` as :func:`..mcmc.sample`, with
the adapted trajectory length in ``extra["traj_len"]``.
"""

from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Optional

import torch

from .hmc import (
    IntegratorState,
    energy_delta,
    find_reasonable_step_size,
    kinetic_energy,
    leapfrog,
    normal_like,
    sample_momentum,
    uniform_like,
)
from .mcmc import (
    SampleResult,
    make_batch_logp_and_grad,
    make_flat_logp_and_grad,
    place_with_sharding,
)
from .util import da_init, da_update

__all__ = ["chees_sample"]

_BITS = torch.arange(32, dtype=torch.int64)
_HALTON_WEIGHTS = 0.5 ** (_BITS.to(torch.float32) + 1.0)


def _halton(i) -> torch.Tensor:
    """i-th element (0-based) of the base-2 Halton sequence in (0, 1), in
    float32, for an int or an int64 tensor of indices.

    32 bits of radical inverse: stays strictly inside (0, 1) for every
    iteration count a sampler can reach (16 bits would return exactly
    0.0 whenever i+1 is a multiple of 2^16).  The JAX package's
    arithmetic: each bit times its float32 weight, summed in float32."""
    i = torch.as_tensor(i, dtype=torch.int64)
    digits = (((i + 1) % 2**32)[..., None] >> _BITS) & 1
    return torch.sum(digits.to(torch.float32) * _HALTON_WEIGHTS, dim=-1)


class _AdamState(NamedTuple):
    m: torch.Tensor
    v: torch.Tensor
    t: torch.Tensor


def _adam_init(dtype=torch.float32, device=None) -> _AdamState:
    z = torch.zeros((), dtype=dtype, device=device)
    return _AdamState(z, z, z)


def _adam_update(s: _AdamState, grad, lr=0.025, b1=0.9, b2=0.95):
    """One Adam step on a scalar, in the JAX package's update order."""
    t = s.t + 1.0
    m = b1 * s.m + (1 - b1) * grad
    v = b2 * s.v + (1 - b2) * grad**2
    mhat = m / (1 - b1**t)
    vhat = v / (1 - b2**t)
    step = lr * mhat / (torch.sqrt(vhat) + 1e-8)
    return _AdamState(m, v, t), step


class CheesIteration(NamedTuple):
    x: torch.Tensor  # (C, d) after the transition
    logp: torch.Tensor  # (C,)
    grad: torch.Tensor  # (C, d)
    accept_prob: torch.Tensor  # (C,)
    chees_grad: torch.Tensor  # () the criterion's gradient in log T
    info: dict  # accept_prob, diverging, energy, n_steps: (C,) each


def chees_iteration(
    logp_and_grad: Callable,
    x: torch.Tensor,
    logp: torch.Tensor,
    grad: torch.Tensor,
    inv_mass: torch.Tensor,
    step_size: torch.Tensor,
    traj_len: torch.Tensor,
    it: int,
    *,
    z: torch.Tensor,
    u: torch.Tensor,
    max_leapfrogs: int = 1024,
) -> CheesIteration:
    """All chains take one jittered-length HMC transition.

    ``z`` (``(C, d)`` standard normals, the momenta) and ``u`` (``(C,)``
    accept uniforms) are the draws; ``inv_mass`` is the shared ``(d,)``
    diagonal.  The trajectory's length is read on the host."""
    h = _halton(it).to(x.device)
    n_steps = int(
        torch.clamp(
            torch.ceil(2.0 * h * traj_len / step_size).to(torch.int32), 1, max_leapfrogs
        )
    )
    r0 = sample_momentum(z, inv_mass)
    energy0 = -logp + kinetic_energy(r0, inv_mass)
    end = IntegratorState(x, r0, logp, grad)
    for _ in range(n_steps):
        end = leapfrog(logp_and_grad, end, step_size, inv_mass)
    energy1, delta = energy_delta(energy0, end, inv_mass)
    accept_prob = torch.clamp(torch.exp(delta), max=1.0)
    accepted = u < accept_prob
    x_new = torch.where(accepted[:, None], end.x, x)
    logp_new = torch.where(accepted, end.logp, logp)
    grad_new = torch.where(accepted[:, None], end.grad, grad)

    # ChEES gradient (paper eq. 14): centered squared-radius change
    # times the proposal-velocity projection, accept-weighted.
    # Divergent trajectories produce NaN endpoints with accept weight 0,
    # but 0 * NaN = NaN, so non-finite contributions are ZEROED, or one
    # early divergence would poison the Adam state (and so log T) for
    # the whole run.  The centering skips non-finite endpoints: a mean
    # over chains would go NaN if ANY chain diverged, zeroing every
    # chain's contribution — one bad chain must not erase the others.
    end_ok = torch.all(torch.isfinite(end.x), dim=1, keepdim=True)
    n_ok = torch.clamp(torch.sum(end_ok), min=1.0)
    end_safe = torch.where(end_ok, end.x, 0.0)
    xc = x - torch.mean(x, dim=0)
    pc = end_safe - torch.sum(end_safe, dim=0) / n_ok
    dsq = torch.sum(pc**2, dim=1) - torch.sum(xc**2, dim=1)
    v_end = end.r * inv_mass[None, :]  # final velocity
    proj = torch.sum(pc * v_end, dim=1)
    contrib = dsq * proj
    finite = torch.isfinite(contrib) & end_ok[:, 0]
    w = torch.where(finite, accept_prob, 0.0)
    contrib = torch.where(finite, contrib, 0.0)
    chees_grad = h * torch.sum(w * contrib) / (torch.sum(w) + 1e-10)

    info = {
        "accept_prob": accept_prob,
        "diverging": delta < -1000.0,
        # The occupied state's energy: rejected proposals must not leak
        # NaN or huge endpoint energies into E-BFMI (hmc.py does the same).
        "energy": torch.where(accepted, energy1, energy0),
        "n_steps": torch.full(logp.shape, n_steps, dtype=torch.int32, device=x.device),
    }
    return CheesIteration(x_new, logp_new, grad_new, accept_prob, chees_grad, info)


def chees_sample(
    logp_fn: Callable[[Any], torch.Tensor],
    init_params: Any,
    *,
    generator: torch.Generator,
    num_warmup: int = 500,
    num_samples: int = 500,
    num_chains: int = 16,
    target_accept: float = 0.75,
    jitter: float = 1.0,
    max_leapfrogs: int = 1024,
    logp_and_grad_fn: Optional[Callable] = None,
    chain_sharding: Optional[Any] = None,
) -> SampleResult:
    """Cross-chain adaptive HMC; more chains = better adaptation.

    ``max_leapfrogs`` bounds the per-iteration trajectory.  Every chain
    runs in one batch on the device of ``init_params`` (with
    ``chain_sharding``, on the first slot's device); ``generator`` (on
    that device) draws the initial jitter, then every iteration's
    momenta and accept uniforms for all chains at once.

    ``chain_sharding`` (a :class:`..parallel.mesh.NamedSharding`)
    partitions the chain batch over a mesh axis, as in
    :func:`.mcmc.sample`: each slot's block of chains is evaluated on its
    device; the cross-chain adaptation reductions (mean accept-stat,
    ChEES gradient, cross-chain variance mass) run on the first slot's
    device, where the gathered batch lives.  ``num_chains`` must be
    divisible by the mesh axis."""
    flat_logp, flat_init, unravel, _ = make_flat_logp_and_grad(logp_fn, init_params)
    lg = make_batch_logp_and_grad(flat_logp, unravel, logp_and_grad_fn)
    if chain_sharding is not None:
        flat_init = flat_init.to(chain_sharding.devices[0])
        lg = chain_sharding.map_blocks(lg)
    dim, dtype, device = flat_init.shape[0], flat_init.dtype, flat_init.device
    C = num_chains

    x = flat_init[None, :] + jitter * torch.randn(
        (C, dim), generator=generator, dtype=dtype, device=device
    )
    x = place_with_sharding(x, chain_sharding, axis_desc=f"num_chains={C}")
    logp, grad = lg(x)

    def draws(x, logp):
        return dict(z=normal_like(generator, x), u=uniform_like(generator, logp))

    # ---- warmup: adapt eps (dual averaging), T (Adam on ChEES), mass
    # (cross-chain variance with decay) -------------------------------
    inv_mass = torch.ones((dim,), dtype=dtype, device=device)
    step0 = find_reasonable_step_size(lg, x[:1], generator, inv_mass)[0]
    da = da_init(step0)
    adam = _adam_init(dtype, device)
    log_traj = torch.zeros((), dtype=dtype, device=device)  # log T = log 1
    for it in range(num_warmup):
        out = chees_iteration(
            lg, x, logp, grad, inv_mass, torch.exp(da.log_step), torch.exp(log_traj), it,
            max_leapfrogs=max_leapfrogs, **draws(x, logp),
        )
        x, logp, grad = out.x, out.logp, out.grad
        da = da_update(da, torch.mean(out.accept_prob), target=target_accept)
        adam, step = _adam_update(adam, out.chees_grad)
        log_traj = log_traj + step  # ascend the criterion
        # cap T so eps*L stays sane early in warmup
        log_traj = torch.clamp(log_traj, math.log(1e-3), math.log(1e3))
        # cross-chain variance, exponentially mixed in
        var_c = torch.var(x, dim=0, unbiased=False) + 1e-6
        inv_mass = 0.9 * inv_mass + 0.1 * var_c
    # num_warmup=0: no da_update ever ran, log_step_avg is still its zero
    # init — fall back to the probed initial step (mcmc.py's _warmup
    # carries the same guard).
    step_size = torch.exp(torch.where(da.count > 0, da.log_step_avg, da.log_step))
    traj_len = torch.exp(log_traj)

    # ---- sampling: frozen (eps, T, mass), jitter continues -----------
    xs, stats = [], {k: [] for k in ("accept_prob", "diverging", "energy", "n_steps")}
    for it in range(num_warmup, num_warmup + num_samples):
        out = chees_iteration(
            lg, x, logp, grad, inv_mass, step_size, traj_len, it,
            max_leapfrogs=max_leapfrogs, **draws(x, logp),
        )
        x, logp, grad = out.x, out.logp, out.grad
        xs.append(x)
        for k, v in stats.items():
            v.append(out.info[k])

    return SampleResult(
        samples=unravel(torch.stack(xs, dim=1)),
        stats={k: torch.stack(v, dim=1) for k, v in stats.items()},
        step_size=step_size.expand(C).clone(),
        inv_mass=inv_mass.expand(C, dim).clone(),
        extra={"traj_len": traj_len},
    )

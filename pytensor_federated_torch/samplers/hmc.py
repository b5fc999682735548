"""Hamiltonian Monte Carlo: leapfrog integrator + HMC kernel.

Port of the JAX package's ``samplers/hmc.py``.  State lives on the
device of the position vector; randomness comes from an explicit
``torch.Generator`` on that device.  ``hmc_step`` and
``find_reasonable_step_size`` also take their standard-normal and
uniform draws as arguments, so that a step can be held against the JAX
one on the same draws.

Every function takes a leading chain axis, as ``jax.vmap`` of the JAX
function does: positions ``(C, d)``, log densities ``(C,)``, step sizes
``(C,)`` or one shared, inverse masses ``(C, d)``, ``(C, d, d)`` or one
shared diagonal ``(d,)``.  The value+grad function then takes ``(C, d)``
and returns ``((C,), (C, d))``: one evaluation for every chain.  Without
the chain axis (``(d,)`` positions) they are the JAX functions as they
are.  An inverse mass is dense when it has one axis more than the
positions.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch


class IntegratorState(NamedTuple):
    x: torch.Tensor
    r: torch.Tensor
    logp: torch.Tensor
    grad: torch.Tensor


def is_dense(inv_mass: torch.Tensor, r: torch.Tensor) -> bool:
    """A full ``M⁻¹`` (one axis more than ``r``), not its diagonal."""
    return inv_mass.ndim == r.ndim + 1


def mass_velocity(inv_mass: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """``v = M⁻¹ r``.  ``inv_mass`` is either the diagonal of M⁻¹ (shaped
    like ``r``, or shared) or the full M⁻¹ (``r.shape + (d,)``)."""
    if is_dense(inv_mass, r):
        return (inv_mass @ r[..., None])[..., 0]
    return inv_mass * r


def _col(step_size, x: torch.Tensor) -> torch.Tensor:
    """A step size (a number, ``()`` or ``(C,)``) as a column that
    broadcasts against positions ``(..., d)``."""
    return torch.as_tensor(step_size, dtype=x.dtype, device=x.device)[..., None]


def leapfrog(
    logp_and_grad: Callable,
    state: IntegratorState,
    step_size,
    inv_mass: torch.Tensor,
) -> IntegratorState:
    """One leapfrog step (diagonal or dense mass matrix)."""
    eps = _col(step_size, state.x)
    r_half = state.r + 0.5 * eps * state.grad
    if is_dense(inv_mass, r_half):
        x_new = state.x + eps * mass_velocity(inv_mass, r_half)
    else:
        # Bitwise-identical grouping to the pre-dense form:
        # (step_size * inv_mass) * r_half, NOT step_size * (inv_mass *
        # r_half) — the rounding difference flips borderline accepts.
        x_new = state.x + eps * inv_mass * r_half
    logp_new, grad_new = logp_and_grad(x_new)
    r_new = r_half + 0.5 * eps * grad_new
    return IntegratorState(x_new, r_new, logp_new, grad_new)


def kinetic_energy(r: torch.Tensor, inv_mass: torch.Tensor) -> torch.Tensor:
    if is_dense(inv_mass, r):
        return 0.5 * torch.sum(r * mass_velocity(inv_mass, r), dim=-1)
    # Keep the diagonal path BITWISE identical to the pre-dense form
    # (0.5 * Σ m⁻¹ r² rounds differently from 0.5 * Σ r·(m⁻¹r), which
    # is enough to flip borderline accept decisions and send seeded
    # posterior-recovery tests off their tolerance).
    return 0.5 * torch.sum(inv_mass * r**2, dim=-1)


def normal_like(generator: torch.Generator, x: torch.Tensor) -> torch.Tensor:
    """Standard-normal draw shaped like ``x``."""
    return torch.randn(x.shape, generator=generator, dtype=x.dtype, device=x.device)


def uniform_like(generator: torch.Generator, t: torch.Tensor) -> torch.Tensor:
    """U(0, 1) draws shaped like ``t`` (one per chain for a ``(C,)`` log
    density), on its device, in its dtype."""
    return torch.rand(t.shape, generator=generator, dtype=t.dtype, device=t.device)


def sample_momentum(z: torch.Tensor, inv_mass: torch.Tensor) -> torch.Tensor:
    """``r ~ N(0, M)`` with ``M = inv_mass⁻¹``, from a standard-normal ``z``.

    Dense case: with ``inv_mass = L Lᵀ`` (Cholesky), ``r = L⁻ᵀ z`` has
    covariance ``L⁻ᵀ L⁻¹ = (L Lᵀ)⁻¹ = M``."""
    if is_dense(inv_mass, z):
        chol = torch.linalg.cholesky(inv_mass)
        return torch.linalg.solve_triangular(chol.mT, z[..., None], upper=True)[..., 0]
    return z / torch.sqrt(inv_mass)


class HMCState(NamedTuple):
    x: torch.Tensor
    logp: torch.Tensor
    grad: torch.Tensor


class HMCInfo(NamedTuple):
    accept_prob: torch.Tensor
    accepted: torch.Tensor
    energy: torch.Tensor
    diverging: torch.Tensor


def hmc_init(logp_and_grad: Callable, x0: torch.Tensor) -> HMCState:
    logp, grad = logp_and_grad(x0)
    return HMCState(x0, logp, grad)


def energy_delta(energy0: torch.Tensor, end: IntegratorState, inv_mass) -> tuple:
    """``(energy of end, energy0 - that)``, a NaN difference as ``-inf``."""
    energy1 = -end.logp + kinetic_energy(end.r, inv_mass)
    delta = energy0 - energy1
    return energy1, torch.where(torch.isnan(delta), -math.inf, delta)


def hmc_step(
    logp_and_grad: Callable,
    state: HMCState,
    generator: Optional[torch.Generator],
    *,
    step_size,
    inv_mass: torch.Tensor,
    num_steps: int = 16,
    divergence_threshold: float = 1000.0,
    z: Optional[torch.Tensor] = None,
    u: Optional[torch.Tensor] = None,
):
    """One HMC transition with ``num_steps`` leapfrog steps, every chain
    in lockstep.

    ``z`` (the momenta's standard-normal draws, shaped like ``x``) and
    ``u`` (the accept uniforms, shaped like ``logp``) are drawn from
    ``generator`` unless given."""
    if z is None:
        z = normal_like(generator, state.x)
    if u is None:
        u = uniform_like(generator, state.logp)
    r0 = sample_momentum(z, inv_mass)
    energy0 = -state.logp + kinetic_energy(r0, inv_mass)

    end = IntegratorState(state.x, r0, state.logp, state.grad)
    for _ in range(num_steps):
        end = leapfrog(logp_and_grad, end, step_size, inv_mass)

    energy1, delta = energy_delta(energy0, end, inv_mass)
    diverging = -delta > divergence_threshold
    accept_prob = torch.clamp(torch.exp(delta), max=1.0)
    accept = u < accept_prob

    new_state = HMCState(
        x=torch.where(accept[..., None], end.x, state.x),
        logp=torch.where(accept, end.logp, state.logp),
        grad=torch.where(accept[..., None], end.grad, state.grad),
    )
    # Report the energy of the state the chain actually occupies, so
    # energy-marginal diagnostics (E-BFMI) are not polluted by rejected
    # (possibly divergent) trajectory endpoints.
    info = HMCInfo(accept_prob, accept, torch.where(accept, energy1, energy0), diverging)
    return new_state, info


def find_reasonable_step_size(
    logp_and_grad: Callable,
    x0: torch.Tensor,
    generator: Optional[torch.Generator],
    inv_mass: torch.Tensor,
    *,
    init_step_size: float = 1.0,
    target: float = 0.8,
    max_iters: int = 60,
    z: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Heuristic initial step size (Hoffman & Gelman 2014, Algorithm 4),
    one per chain.

    The JAX ``while_loop`` under ``vmap`` becomes a Python loop over all
    chains at once: each trial costs one batched leapfrog step and one
    host sync on whether any chain is still searching.  Each chain
    doubles or halves its own step size until its own acceptance
    crosses the target; a chain that has crossed keeps its step size."""
    logp0, grad0 = logp_and_grad(x0)
    if z is None:
        z = normal_like(generator, x0)
    r0 = sample_momentum(z, inv_mass)
    energy0 = -logp0 + kinetic_energy(r0, inv_mass)
    log_target = math.log(target)

    def log_accept(step_size):
        st = IntegratorState(x0, r0, logp0, grad0)
        end = leapfrog(logp_and_grad, st, step_size, inv_mass)
        return energy_delta(energy0, end, inv_mass)[1]

    step_size = torch.full(logp0.shape, init_step_size, dtype=x0.dtype, device=x0.device)
    delta = log_accept(step_size)
    direction = torch.where(delta > log_target, 1.0, -1.0).to(x0.dtype)

    def crossed(delta):
        return torch.where(direction > 0, delta < log_target, delta > log_target)

    searching = ~crossed(delta)
    for _ in range(max_iters):
        if not bool(searching.any()):
            break
        step_size = torch.where(searching, step_size * (2.0**direction), step_size)
        searching = searching & ~crossed(log_accept(step_size))
    return step_size

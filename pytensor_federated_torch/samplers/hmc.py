"""Hamiltonian Monte Carlo: leapfrog integrator + HMC kernel.

Port of the JAX package's ``samplers/hmc.py``.  State lives on the
device of the position vector; randomness comes from an explicit
``torch.Generator`` on that device.  ``hmc_step`` and
``find_reasonable_step_size`` also take their standard-normal and
uniform draws as arguments, so that a step can be held against the JAX
one on the same draws.
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


def mass_velocity(inv_mass: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """``v = M⁻¹ r``.  ``inv_mass`` is either the diagonal of M⁻¹ (a
    ``(d,)`` vector) or the full M⁻¹ (a ``(d, d)`` matrix).  ``r`` may
    carry leading batch axes."""
    if inv_mass.ndim == 2:
        return r @ inv_mass.T
    return inv_mass * r


def leapfrog(
    logp_and_grad: Callable,
    state: IntegratorState,
    step_size,
    inv_mass: torch.Tensor,
) -> IntegratorState:
    """One leapfrog step (diagonal or dense mass matrix)."""
    r_half = state.r + 0.5 * step_size * state.grad
    if inv_mass.ndim == 2:
        x_new = state.x + step_size * (inv_mass @ r_half)
    else:
        # Bitwise-identical grouping to the pre-dense form:
        # (step_size * inv_mass) * r_half, NOT step_size * (inv_mass *
        # r_half) — the rounding difference flips borderline accepts.
        x_new = state.x + step_size * inv_mass * r_half
    logp_new, grad_new = logp_and_grad(x_new)
    r_new = r_half + 0.5 * step_size * grad_new
    return IntegratorState(x_new, r_new, logp_new, grad_new)


def kinetic_energy(r: torch.Tensor, inv_mass: torch.Tensor) -> torch.Tensor:
    if inv_mass.ndim == 2:
        return 0.5 * r @ (inv_mass @ r)
    # Keep the diagonal path BITWISE identical to the pre-dense form
    # (0.5 * Σ m⁻¹ r² rounds differently from 0.5 * Σ r·(m⁻¹r), which
    # is enough to flip borderline accept decisions and send seeded
    # posterior-recovery tests off their tolerance).
    return 0.5 * torch.sum(inv_mass * r**2)


def normal_like(generator: torch.Generator, x: torch.Tensor) -> torch.Tensor:
    """Standard-normal draw shaped like ``x``."""
    return torch.randn(x.shape, generator=generator, dtype=x.dtype, device=x.device)


def uniform_like(generator: torch.Generator, x: torch.Tensor) -> torch.Tensor:
    """One U(0, 1) scalar on ``x``'s device, in its dtype."""
    return torch.rand((), generator=generator, dtype=x.dtype, device=x.device)


def sample_momentum(z: torch.Tensor, inv_mass: torch.Tensor) -> torch.Tensor:
    """``r ~ N(0, M)`` with ``M = inv_mass⁻¹``, from a standard-normal ``z``.

    Dense case: with ``inv_mass = L Lᵀ`` (Cholesky), ``r = L⁻ᵀ z`` has
    covariance ``L⁻ᵀ L⁻¹ = (L Lᵀ)⁻¹ = M``."""
    if inv_mass.ndim == 2:
        chol = torch.linalg.cholesky(inv_mass)
        return torch.linalg.solve_triangular(chol.T, z[:, None], upper=True)[:, 0]
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


def _energy_delta(energy0: torch.Tensor, end: IntegratorState, inv_mass) -> tuple:
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
    """One HMC transition with ``num_steps`` leapfrog steps.

    ``z`` (the momentum's standard-normal draw) and ``u`` (the accept
    uniform) are drawn from ``generator`` unless given."""
    if z is None:
        z = normal_like(generator, state.x)
    if u is None:
        u = uniform_like(generator, state.x)
    r0 = sample_momentum(z, inv_mass)
    energy0 = -state.logp + kinetic_energy(r0, inv_mass)

    end = IntegratorState(state.x, r0, state.logp, state.grad)
    for _ in range(num_steps):
        end = leapfrog(logp_and_grad, end, step_size, inv_mass)

    energy1, delta = _energy_delta(energy0, end, inv_mass)
    diverging = -delta > divergence_threshold
    accept_prob = torch.clamp(torch.exp(delta), max=1.0)
    accept = u < accept_prob

    new_state = HMCState(
        x=torch.where(accept, end.x, state.x),
        logp=torch.where(accept, end.logp, state.logp),
        grad=torch.where(accept, end.grad, state.grad),
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
    """Heuristic initial step size (Hoffman & Gelman 2014, Algorithm 4).

    The JAX ``while_loop`` becomes a Python loop: each trial step size
    costs one leapfrog step and one host sync on the comparison."""
    logp0, grad0 = logp_and_grad(x0)
    if z is None:
        z = normal_like(generator, x0)
    r0 = sample_momentum(z, inv_mass)
    energy0 = -logp0 + kinetic_energy(r0, inv_mass)
    log_target = math.log(target)

    def log_accept(step_size):
        st = IntegratorState(x0, r0, logp0, grad0)
        end = leapfrog(logp_and_grad, st, step_size, inv_mass)
        return _energy_delta(energy0, end, inv_mass)[1]

    step_size = torch.tensor(init_step_size, dtype=x0.dtype, device=x0.device)
    direction = 1.0 if log_accept(step_size).item() > log_target else -1.0
    for _ in range(max_iters):
        delta = log_accept(step_size).item()
        if (delta < log_target) if direction > 0 else (delta > log_target):
            break
        step_size = step_size * (2.0**direction)
    return step_size

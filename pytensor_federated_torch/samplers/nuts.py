"""No-U-Turn Sampler, iterative, eager.

Port of the JAX package's ``samplers/nuts.py``: multinomial NUTS with
biased progressive sampling and the iterative power-of-two checkpoint
scheme for intra-subtree U-turn detection (Hoffman & Gelman 2014;
Betancourt 2017 appendix A.4; the iterative formulation of Phan et al.
2019), with a diagonal or dense mass matrix and the generalized U-turn
criterion with half-leaf correction.

The JAX ``while_loop``s and ``cond``s become Python control flow over
tensors that stay on the device.  The known host cost: every leaf ends
in ONE device-to-host sync that reads its diverging flag and, on odd
leaves, its U-turn flag together; every doubling adds one more for the
merged tree's U-turn check, and every transition one for its direction
bits.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch

from .hmc import (
    HMCState,
    IntegratorState,
    kinetic_energy,
    leapfrog,
    mass_velocity,
    normal_like,
    sample_momentum,
    uniform_like,
)


class NUTSInfo(NamedTuple):
    accept_prob: torch.Tensor  # mean MH accept prob over visited leaves
    diverging: bool
    depth: int
    num_leaves: int
    energy: torch.Tensor


class _Subtree(NamedTuple):
    leaf: IntegratorState  # last leaf reached
    z_prop: torch.Tensor
    logp_prop: torch.Tensor
    grad_prop: torch.Tensor
    energy_prop: torch.Tensor
    log_weight: torch.Tensor
    r_sum: torch.Tensor
    sum_accept: torch.Tensor
    k: int  # leaves added
    turning: bool
    diverging: bool


def _is_turning(inv_mass, r_left, r_right, r_sum):
    """Generalized U-turn criterion with half-leaf correction."""
    v_left = mass_velocity(inv_mass, r_left)
    v_right = mass_velocity(inv_mass, r_right)
    r_c = r_sum - 0.5 * (r_left + r_right)
    return (torch.dot(v_left, r_c) <= 0.0) | (torch.dot(v_right, r_c) <= 0.0)


def _leaf_to_ckpt_idxs(n: int) -> tuple[int, int]:
    """Checkpoint index range for leaf ``n`` (power-of-two scheme).

    ``idx_max`` = popcount(n >> 1); ``idx_min`` = idx_max - (number of
    trailing one-bits of n) + 1.
    """
    idx_max = bin(n >> 1).count("1")
    trailing_ones = 0
    while n & 1:
        n >>= 1
        trailing_ones += 1
    return idx_max - trailing_ones + 1, idx_max


def _ckpt_turning(inv_mass, r_ckpts, r_sum_ckpts, r_new, r_sum_new, idx_min, idx_max):
    """U-turn of the new leaf against any checkpointed sub-interval.

    The JAX loop stops at the first checkpoint that turns, so its result
    is the OR over ``idx_min..idx_max``; here all of them are checked in
    one batched expression (no per-checkpoint host sync)."""
    if idx_min > idx_max:
        return torch.zeros((), dtype=torch.bool, device=r_new.device)
    r_ck = r_ckpts[idx_min : idx_max + 1]
    sub_r_sum = r_sum_new - r_sum_ckpts[idx_min : idx_max + 1] + r_ck
    v_left = mass_velocity(inv_mass, r_ck)
    v_right = mass_velocity(inv_mass, r_new)
    r_c = sub_r_sum - 0.5 * (r_ck + r_new)
    turning = (torch.sum(v_left * r_c, dim=-1) <= 0.0) | (r_c @ v_right <= 0.0)
    return torch.any(turning)


def _nan_to_neg_inf(delta: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isnan(delta), -math.inf, delta)


def _build_subtree(
    logp_and_grad: Callable,
    boundary: IntegratorState,
    num_new: int,
    signed_step: torch.Tensor,
    inv_mass: torch.Tensor,
    energy0: torch.Tensor,
    generator: Optional[torch.Generator],
    max_depth: int,
    divergence_threshold: float,
) -> _Subtree:
    """Add up to ``num_new`` leaves beyond ``boundary``; stop early on a
    U-turn inside the subtree or a divergence."""
    x = boundary.x
    dim = x.shape[0]
    # Checkpoint stacks, written in place (fresh per subtree).
    r_ckpts = torch.zeros((max_depth + 1, dim), dtype=x.dtype, device=x.device)
    r_sum_ckpts = torch.zeros_like(r_ckpts)

    leaf = boundary
    z_prop, logp_prop, grad_prop, energy_prop = x, boundary.logp, boundary.grad, energy0
    log_weight = torch.full((), -math.inf, dtype=x.dtype, device=x.device)
    r_sum = torch.zeros_like(x)
    sum_accept = torch.zeros((), dtype=x.dtype, device=x.device)
    k, turning, diverging = 0, False, False
    while k < num_new and not turning and not diverging:
        leaf = leapfrog(logp_and_grad, leaf, signed_step, inv_mass)
        energy = -leaf.logp + kinetic_energy(leaf.r, inv_mass)
        delta = _nan_to_neg_inf(energy0 - energy)  # log multinomial weight
        diverging_t = -delta > divergence_threshold
        sum_accept = sum_accept + torch.clamp(torch.exp(delta), max=1.0)

        # Streaming multinomial proposal within the subtree.
        new_log_weight = torch.logaddexp(log_weight, delta)
        take = uniform_like(generator, x) < torch.exp(delta - new_log_weight)
        z_prop = torch.where(take, leaf.x, z_prop)
        logp_prop = torch.where(take, leaf.logp, logp_prop)
        grad_prop = torch.where(take, leaf.grad, grad_prop)
        energy_prop = torch.where(take, energy, energy_prop)
        log_weight = new_log_weight

        r_sum = r_sum + leaf.r
        # Checkpoint on even leaves, U-turn check on odd leaves.
        idx_min, idx_max = _leaf_to_ckpt_idxs(k)
        if k % 2 == 0:
            r_ckpts[idx_max] = leaf.r
            r_sum_ckpts[idx_max] = r_sum
            diverging = bool(diverging_t)
        else:
            turning_t = _ckpt_turning(
                inv_mass, r_ckpts, r_sum_ckpts, leaf.r, r_sum, idx_min, idx_max
            )
            diverging, turning = torch.stack([diverging_t, turning_t]).tolist()
            turning = turning and not diverging
        k += 1
    return _Subtree(
        leaf, z_prop, logp_prop, grad_prop, energy_prop, log_weight, r_sum,
        sum_accept, k, turning, diverging,
    )


def nuts_step(
    logp_and_grad: Callable,
    state: HMCState,
    generator: Optional[torch.Generator],
    *,
    step_size,
    inv_mass: torch.Tensor,
    max_depth: int = 10,
    divergence_threshold: float = 1000.0,
):
    """One NUTS transition.  Returns ``(HMCState, NUTSInfo)``."""
    x = state.x
    r0 = sample_momentum(normal_like(generator, x), inv_mass)
    energy0 = -state.logp + kinetic_energy(r0, inv_mass)
    go_right = (
        torch.rand(max_depth, generator=generator, device=x.device) < 0.5
    ).tolist()

    z_left = z_right = x
    r_left = r_right = r0
    grad_left = grad_right = state.grad
    z_prop, logp_prop, grad_prop, energy_prop = x, state.logp, state.grad, energy0
    log_weight = torch.zeros((), dtype=x.dtype, device=x.device)
    r_sum = r0
    sum_accept = torch.zeros((), dtype=x.dtype, device=x.device)
    num_leaves = 0  # leaves beyond the initial point
    turning = diverging = False
    # Boundary logp is never read by leapfrog (it recomputes after the
    # position update), so a zero placeholder is fine.
    zero = torch.zeros((), dtype=x.dtype, device=x.device)

    depth = 0
    while depth < max_depth and not turning and not diverging:
        right = go_right[depth]
        if right:
            boundary = IntegratorState(z_right, r_right, zero, grad_right)
        else:
            boundary = IntegratorState(z_left, r_left, zero, grad_left)
        # The new subtree mirrors the whole existing trajectory: the total
        # point count (and thus the subtree size) is num_leaves + 1.
        sub = _build_subtree(
            logp_and_grad, boundary, num_leaves + 1,
            step_size if right else -step_size,
            inv_mass, energy0, generator, max_depth, divergence_threshold,
        )
        sum_accept = sum_accept + sub.sum_accept
        num_leaves += sub.k
        if sub.turning or sub.diverging:
            # Subtree turned/diverged: discard its proposal, keep stats.
            turning, diverging = sub.turning, sub.diverging
        else:
            # The subtree's last leaf becomes the new far end.
            if right:
                z_right, r_right, grad_right = sub.leaf.x, sub.leaf.r, sub.leaf.grad
            else:
                z_left, r_left, grad_left = sub.leaf.x, sub.leaf.r, sub.leaf.grad
            # Biased progressive sampling toward the new subtree.
            p_new = torch.clamp(torch.exp(sub.log_weight - log_weight), max=1.0)
            take = uniform_like(generator, x) < p_new
            z_prop = torch.where(take, sub.z_prop, z_prop)
            logp_prop = torch.where(take, sub.logp_prop, logp_prop)
            grad_prop = torch.where(take, sub.grad_prop, grad_prop)
            energy_prop = torch.where(take, sub.energy_prop, energy_prop)
            r_sum = r_sum + sub.r_sum
            turning = bool(_is_turning(inv_mass, r_left, r_right, r_sum))
            log_weight = torch.logaddexp(log_weight, sub.log_weight)
        depth += 1

    new_state = HMCState(x=z_prop, logp=logp_prop, grad=grad_prop)
    info = NUTSInfo(
        accept_prob=sum_accept / max(num_leaves, 1),
        diverging=diverging,
        depth=depth,
        num_leaves=num_leaves,
        energy=energy_prop,
    )
    return new_state, info

"""No-U-Turn Sampler, iterative, eager, all chains in lockstep.

Port of the JAX package's ``samplers/nuts.py``: multinomial NUTS with
biased progressive sampling and the iterative power-of-two checkpoint
scheme for intra-subtree U-turn detection (Hoffman & Gelman 2014;
Betancourt 2017 appendix A.4; the iterative formulation of Phan et al.
2019), with a diagonal or dense mass matrix and the generalized U-turn
criterion with half-leaf correction.

The JAX package runs the chains as ``vmap`` lanes of one program, so its
three ``while_loop``s run under ``vmap``: each loop goes on while any
chain's condition holds, every chain computes each iteration, and a
chain whose own condition has failed keeps its carry.  Here the loops
are Python loops over tensors with a leading chain axis ``C`` that stay
on the device, and a chain that has stopped is frozen with
``torch.where``.  Each leaf is one value+grad evaluation for all chains.
The host cost: every leaf after a subtree's first ends in ONE
device-to-host sync that reads whether any chain is still building, and
every doubling in one more that reads whether any chain goes on; one
sync per leaf for the whole batch, not one per chain.

All the random numbers a transition may use are drawn up front
(:func:`draw_nuts`) and indexed by the tree position they serve, so a
chain consumes the same numbers whether it runs alone or in a batch,
and a test can hand the same draws to both.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch

from .hmc import (
    HMCState,
    IntegratorState,
    is_dense,
    kinetic_energy,
    leapfrog,
    mass_velocity,
    normal_like,
    sample_momentum,
)


class NUTSInfo(NamedTuple):
    accept_prob: torch.Tensor  # (C,) mean MH accept prob over visited leaves
    diverging: torch.Tensor  # (C,) bool
    depth: torch.Tensor  # (C,) doublings, int64
    num_leaves: torch.Tensor  # (C,) leaves beyond the initial point, int64
    energy: torch.Tensor  # (C,)


class NUTSDraws(NamedTuple):
    """The random numbers of one transition, per chain.

    ``u_leaf[:, 2**j - 1 + k]`` decides whether leaf ``k`` of the subtree
    built at doubling ``j`` becomes that subtree's proposal; ``u_merge[:,
    j]`` whether doubling ``j``'s subtree proposal replaces the tree's."""

    z: torch.Tensor  # (C, d) standard normal, the momentum
    go_right: torch.Tensor  # (C, max_depth) bool, direction of each doubling
    u_leaf: torch.Tensor  # (C, 2**max_depth - 1) U(0, 1)
    u_merge: torch.Tensor  # (C, max_depth) U(0, 1)


def draw_nuts(generator: torch.Generator, x: torch.Tensor, max_depth: int) -> NUTSDraws:
    """Every draw a transition of the chains at ``x`` (``(C, d)``) may
    use, in two launches."""
    u = torch.rand(
        (x.shape[0], 2 * max_depth + 2**max_depth - 1),
        generator=generator, dtype=x.dtype, device=x.device,
    )
    return NUTSDraws(
        normal_like(generator, x), u[:, :max_depth] < 0.5, u[:, 2 * max_depth:],
        u[:, max_depth : 2 * max_depth],
    )


def _sel(mask: torch.Tensor, new: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
    """``new`` for the chains in ``mask`` (``(C,)``), ``old`` for the rest."""
    return torch.where(mask.reshape(mask.shape + (1,) * (new.ndim - mask.ndim)), new, old)


class _Subtree(NamedTuple):
    leaf: IntegratorState  # last leaf reached
    z_prop: torch.Tensor
    logp_prop: torch.Tensor
    grad_prop: torch.Tensor
    energy_prop: torch.Tensor
    log_weight: torch.Tensor
    r_sum: torch.Tensor
    sum_accept: torch.Tensor
    k: torch.Tensor  # leaves added
    turning: torch.Tensor
    diverging: torch.Tensor


def _is_turning(inv_mass, r_left, r_right, r_sum):
    """Generalized U-turn criterion with half-leaf correction, per chain."""
    v_left = mass_velocity(inv_mass, r_left)
    v_right = mass_velocity(inv_mass, r_right)
    r_c = r_sum - 0.5 * (r_left + r_right)
    return (torch.sum(v_left * r_c, dim=-1) <= 0.0) | (torch.sum(v_right * r_c, dim=-1) <= 0.0)


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


def _ckpt_turning(inv_mass_ck, r_ckpts, r_sum_ckpts, r_new, r_sum_new, idx_min, idx_max):
    """U-turn of each chain's new leaf against any checkpointed
    sub-interval.

    The chains in lockstep are all at the same leaf, so the checkpoint
    range is one for the batch.  The JAX loop stops at the first
    checkpoint that turns, so its result is the OR over
    ``idx_min..idx_max``; here all of them are checked in one batched
    expression (no per-checkpoint host sync).  ``inv_mass_ck`` is the
    per-chain inverse mass with an axis for the checkpoints."""
    if idx_min > idx_max:
        return torch.zeros(r_new.shape[:1], dtype=torch.bool, device=r_new.device)
    r_ck = r_ckpts[:, idx_min : idx_max + 1]
    sub_r_sum = r_sum_new[:, None] - r_sum_ckpts[:, idx_min : idx_max + 1] + r_ck
    v_left = mass_velocity(inv_mass_ck, r_ck)
    v_right = mass_velocity(inv_mass_ck, r_new[:, None])
    r_c = sub_r_sum - 0.5 * (r_ck + r_new[:, None])
    turning = (torch.sum(v_left * r_c, dim=-1) <= 0.0) | (torch.sum(v_right * r_c, dim=-1) <= 0.0)
    return torch.any(turning, dim=-1)


def _nan_to_neg_inf(delta: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isnan(delta), -math.inf, delta)


def _build_subtree(
    logp_and_grad: Callable,
    boundary: IntegratorState,
    num_new: int,
    live: torch.Tensor,
    signed_step: torch.Tensor,
    inv_mass: torch.Tensor,
    inv_mass_ck: torch.Tensor,
    energy0: torch.Tensor,
    u_leaf: torch.Tensor,
    max_depth: int,
    divergence_threshold: float,
) -> _Subtree:
    """Add up to ``num_new`` leaves beyond ``boundary`` for the ``live``
    chains; a chain stops early on a U-turn inside its subtree or a
    divergence, and the others are not touched."""
    x = boundary.x
    C, dim = x.shape
    # Checkpoint stacks, written in place (fresh per subtree).
    r_ckpts = torch.zeros((C, max_depth + 1, dim), dtype=x.dtype, device=x.device)
    r_sum_ckpts = torch.zeros_like(r_ckpts)

    leaf = boundary
    z_prop, logp_prop, grad_prop, energy_prop = x, boundary.logp, boundary.grad, energy0
    log_weight = torch.full((C,), -math.inf, dtype=x.dtype, device=x.device)
    r_sum = torch.zeros_like(x)
    sum_accept = torch.zeros((C,), dtype=x.dtype, device=x.device)
    k = torch.zeros((C,), dtype=torch.int64, device=x.device)
    turning = torch.zeros((C,), dtype=torch.bool, device=x.device)
    diverging = torch.zeros_like(turning)
    building = live
    for n in range(num_new):
        if n > 0 and not bool(building.any()):  # the leaf's one host sync
            break
        new = leapfrog(logp_and_grad, leaf, signed_step, inv_mass)
        energy = -new.logp + kinetic_energy(new.r, inv_mass)
        delta = _nan_to_neg_inf(energy0 - energy)  # log multinomial weight
        diverging_n = -delta > divergence_threshold

        # Streaming multinomial proposal within the subtree.
        new_log_weight = torch.logaddexp(log_weight, delta)
        take = building & (u_leaf[:, n] < torch.exp(delta - new_log_weight))
        z_prop = _sel(take, new.x, z_prop)
        logp_prop = _sel(take, new.logp, logp_prop)
        grad_prop = _sel(take, new.grad, grad_prop)
        energy_prop = _sel(take, energy, energy_prop)
        sum_accept = _sel(building, sum_accept + torch.clamp(torch.exp(delta), max=1.0), sum_accept)
        log_weight = _sel(building, new_log_weight, log_weight)

        r_sum_n = r_sum + new.r
        # Checkpoint on even leaves, U-turn check on odd leaves.
        idx_min, idx_max = _leaf_to_ckpt_idxs(n)
        if n % 2 == 0:
            r_ckpts[:, idx_max] = _sel(building, new.r, r_ckpts[:, idx_max])
            r_sum_ckpts[:, idx_max] = _sel(building, r_sum_n, r_sum_ckpts[:, idx_max])
            turning_n = torch.zeros_like(diverging_n)
        else:
            turning_n = ~diverging_n & _ckpt_turning(
                inv_mass_ck, r_ckpts, r_sum_ckpts, new.r, r_sum_n, idx_min, idx_max
            )
        r_sum = _sel(building, r_sum_n, r_sum)
        leaf = IntegratorState(*(_sel(building, a, b) for a, b in zip(new, leaf)))
        diverging = _sel(building, diverging_n, diverging)
        turning = _sel(building, turning_n, turning)
        k = k + building
        building = building & ~diverging_n & ~turning_n
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
    draws: Optional[NUTSDraws] = None,
):
    """One NUTS transition of every chain in lockstep.  Returns
    ``(HMCState, NUTSInfo)``.

    ``state`` holds ``(C, d)`` positions; ``logp_and_grad`` takes ``(C,
    d)`` and returns ``((C,), (C, d))``.  ``step_size`` is ``(C,)`` or
    one shared; ``inv_mass`` is ``(C, d)``, ``(C, d, d)`` or one shared
    diagonal ``(d,)``.  ``draws`` (:func:`draw_nuts`) come from
    ``generator`` unless given."""
    x = state.x
    C = x.shape[0]
    if not is_dense(inv_mass, x):
        inv_mass = inv_mass.expand(x.shape)
    inv_mass_ck = inv_mass[:, None]
    if draws is None:
        draws = draw_nuts(generator, x, max_depth)
    eps = torch.as_tensor(step_size, dtype=x.dtype, device=x.device).expand(C)
    r0 = sample_momentum(draws.z, inv_mass)
    energy0 = -state.logp + kinetic_energy(r0, inv_mass)

    z_left = z_right = x
    r_left = r_right = r0
    grad_left = grad_right = state.grad
    z_prop, logp_prop, grad_prop, energy_prop = x, state.logp, state.grad, energy0
    log_weight = torch.zeros((C,), dtype=x.dtype, device=x.device)
    r_sum = r0
    sum_accept = torch.zeros((C,), dtype=x.dtype, device=x.device)
    num_leaves = torch.zeros((C,), dtype=torch.int64, device=x.device)  # beyond the initial point
    depth = torch.zeros_like(num_leaves)
    turning = torch.zeros((C,), dtype=torch.bool, device=x.device)
    diverging = torch.zeros_like(turning)
    active = ~turning
    # Boundary logp is never read by leapfrog (it recomputes after the
    # position update), so a zero placeholder is fine.
    zero = torch.zeros((C,), dtype=x.dtype, device=x.device)

    for j in range(max_depth):
        if j > 0 and not bool(active.any()):  # the doubling's one host sync
            break
        right = draws.go_right[:, j]
        boundary = IntegratorState(
            _sel(right, z_right, z_left), _sel(right, r_right, r_left), zero,
            _sel(right, grad_right, grad_left),
        )
        # Every active chain has 2**j - 1 leaves beyond the initial point:
        # the new subtree mirrors the whole trajectory, 2**j leaves.
        sub = _build_subtree(
            logp_and_grad, boundary, 2**j, active, torch.where(right, eps, -eps),
            inv_mass, inv_mass_ck, energy0, draws.u_leaf[:, 2**j - 1 : 2 ** (j + 1) - 1],
            max_depth, divergence_threshold,
        )
        # Chains that were not active built nothing: k and sum_accept are 0.
        sum_accept = sum_accept + sub.sum_accept
        num_leaves = num_leaves + sub.k
        # A subtree that turned or diverged stops its chain; its proposal
        # is discarded.
        turning = turning | sub.turning
        diverging = diverging | sub.diverging
        merge = active & ~sub.turning & ~sub.diverging
        # The subtree's last leaf becomes the new far end.
        to_right, to_left = merge & right, merge & ~right
        z_right = _sel(to_right, sub.leaf.x, z_right)
        r_right = _sel(to_right, sub.leaf.r, r_right)
        grad_right = _sel(to_right, sub.leaf.grad, grad_right)
        z_left = _sel(to_left, sub.leaf.x, z_left)
        r_left = _sel(to_left, sub.leaf.r, r_left)
        grad_left = _sel(to_left, sub.leaf.grad, grad_left)
        # Biased progressive sampling toward the new subtree.
        p_new = torch.clamp(torch.exp(sub.log_weight - log_weight), max=1.0)
        take = merge & (draws.u_merge[:, j] < p_new)
        z_prop = _sel(take, sub.z_prop, z_prop)
        logp_prop = _sel(take, sub.logp_prop, logp_prop)
        grad_prop = _sel(take, sub.grad_prop, grad_prop)
        energy_prop = _sel(take, sub.energy_prop, energy_prop)
        r_sum = _sel(merge, r_sum + sub.r_sum, r_sum)
        turning = _sel(merge, _is_turning(inv_mass, r_left, r_right, r_sum), turning)
        log_weight = _sel(merge, torch.logaddexp(log_weight, sub.log_weight), log_weight)
        depth = depth + active
        active = active & ~turning & ~diverging

    new_state = HMCState(x=z_prop, logp=logp_prop, grad=grad_prop)
    info = NUTSInfo(
        accept_prob=sum_accept / torch.clamp(num_leaves, min=1).to(x.dtype),
        diverging=diverging,
        depth=depth,
        num_leaves=num_leaves,
        energy=energy_prop,
    )
    return new_state, info

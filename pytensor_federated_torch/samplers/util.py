"""Sampler building blocks: flattening, Welford variance, dual averaging.

Port of the JAX package's ``samplers/util.py``.  The samplers work on
one flat float vector; :func:`flatten_logp` lays parameters out in the
order of ``jax.flatten_util.ravel_pytree`` (leaves in sorted-key order,
each raveled), so flat vectors of the two packages compare element by
element.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from ..utils import tree_leaves, tree_map


def ravel_batch(tree: Any, batch_ndim: int = 1) -> torch.Tensor:
    """Leaves with ``batch_ndim`` leading chain axes, raveled into one
    ``(..., dim)`` tensor in :func:`ravel`'s order."""
    leaves = tree_leaves(tree)
    batch = tuple(leaves[0].shape[:batch_ndim])
    return torch.cat([leaf.reshape(batch + (-1,)) for leaf in leaves], dim=-1)


def ravel(params: Any):
    """``(flat, unravel)`` for a tree of tensors, ``ravel_pytree`` order.

    ``unravel`` also takes a batch of flat vectors ``(..., dim)`` and
    gives leaves with those leading axes."""
    leaves = tree_leaves(params)
    shapes = [tuple(leaf.shape) for leaf in leaves]
    sizes = [math.prod(s) for s in shapes]
    flat = torch.cat([leaf.reshape(-1) for leaf in leaves])

    def unravel(v: torch.Tensor) -> Any:
        parts = iter(torch.split(v, sizes, dim=-1))
        batch = tuple(v.shape[:-1])
        it = iter(shapes)
        return tree_map(lambda _: next(parts).reshape(batch + next(it)), params)

    return flat, unravel


def flatten_logp(logp_fn: Callable[[Any], torch.Tensor], example_params: Any):
    """Return ``(flat_logp, flat_init, unravel)`` over a flat float vector."""
    flat_init, unravel = ravel(example_params)

    def flat_logp(x):
        return logp_fn(unravel(x))

    return flat_logp, flat_init, unravel


class WelfordState(NamedTuple):
    """Streaming mean/variance — mass-matrix adaptation.

    Every field may carry leading chain axes: ``mean`` ``(..., dim)``,
    ``m2`` ``(..., dim)`` (diagonal) or ``(..., dim, dim)`` (dense),
    ``count`` ``(...)``, one accumulator per chain."""

    mean: torch.Tensor
    m2: torch.Tensor
    count: torch.Tensor


def welford_init(
    dim: int,
    dtype=torch.float32,
    *,
    dense: bool = False,
    device: Any = None,
    batch: tuple = (),
) -> WelfordState:
    """``dense=True`` accumulates the full ``(dim, dim)`` second-moment
    matrix (for dense-mass adaptation) instead of the diagonal.
    ``batch`` is the shape of the leading chain axes (``(C,)`` for C
    chains, as ``jax.vmap`` of the JAX function gives)."""
    batch = tuple(batch)
    m2_shape = batch + ((dim, dim) if dense else (dim,))
    return WelfordState(
        mean=torch.zeros(batch + (dim,), dtype=dtype, device=device),
        m2=torch.zeros(m2_shape, dtype=dtype, device=device),
        count=torch.zeros(batch, dtype=dtype, device=device),
    )


def _is_dense(state: WelfordState) -> bool:
    return state.m2.ndim == state.mean.ndim + 1


def welford_update(state: WelfordState, x: torch.Tensor) -> WelfordState:
    count = state.count + 1.0
    delta = x - state.mean
    mean = state.mean + delta / count[..., None]
    if _is_dense(state):
        m2 = state.m2 + delta[..., :, None] * (x - mean)[..., None, :]
    else:
        m2 = state.m2 + delta * (x - mean)
    return WelfordState(mean, m2, count)


def welford_variance(state: WelfordState, *, regularize: bool = True) -> torch.Tensor:
    """Diagonal variance estimate, Stan-style regularized toward unit."""
    var = state.m2 / torch.clamp(state.count - 1.0, min=1.0)[..., None]
    if regularize:
        n = state.count[..., None]
        var = (n / (n + 5.0)) * var + 1e-3 * (5.0 / (n + 5.0))
    return var


def welford_covariance(state: WelfordState, *, regularize: bool = True) -> torch.Tensor:
    """Full covariance estimate from a ``dense=True`` accumulator, shrunk
    toward a small multiple of the identity on the same ``n/(n+5)``
    schedule as :func:`welford_variance`."""
    cov = state.m2 / torch.clamp(state.count - 1.0, min=1.0)[..., None, None]
    if regularize:
        n = state.count[..., None, None]
        dim = state.mean.shape[-1]
        eye = torch.eye(dim, dtype=state.mean.dtype, device=state.mean.device)
        cov = (n / (n + 5.0)) * cov + 1e-3 * (5.0 / (n + 5.0)) * eye
    return cov


class DualAveragingState(NamedTuple):
    """Nesterov dual averaging on log step size (Hoffman & Gelman 2014).

    Elementwise: a ``(C,)`` step size gives one state per chain."""

    log_step: torch.Tensor
    log_step_avg: torch.Tensor
    h_avg: torch.Tensor
    mu: torch.Tensor
    count: torch.Tensor


def da_init(step_size: torch.Tensor) -> DualAveragingState:
    log_step = torch.log(step_size)
    zero = torch.zeros_like(log_step)
    return DualAveragingState(
        log_step=log_step,
        log_step_avg=zero,
        h_avg=zero,
        mu=math.log(10.0) + log_step,
        count=zero,
    )


def da_update(
    state: DualAveragingState,
    accept_prob: torch.Tensor,
    *,
    target: float = 0.8,
    gamma: float = 0.05,
    t0: float = 10.0,
    kappa: float = 0.75,
) -> DualAveragingState:
    count = state.count + 1.0
    w = 1.0 / (count + t0)
    h_avg = (1.0 - w) * state.h_avg + w * (target - accept_prob)
    log_step = state.mu - torch.sqrt(count) / gamma * h_avg
    eta = count ** (-kappa)
    log_step_avg = eta * log_step + (1.0 - eta) * state.log_step_avg
    return DualAveragingState(log_step, log_step_avg, h_avg, state.mu, count)


@dataclasses.dataclass(frozen=True)
class AdaptSchedule:
    """Stan-style three-stage warmup window schedule (static, host-side).

    ``update_mass[i]`` is True at the last step of each slow window —
    the moment the mass matrix refreshes and dual averaging restarts.
    """

    update_mass: np.ndarray  # bool[num_warmup]
    in_slow: np.ndarray  # bool[num_warmup] — collect samples into Welford

    @staticmethod
    def make(
        num_warmup: int,
        *,
        init_buffer: int = 75,
        term_buffer: int = 50,
        base_window: int = 25,
    ) -> "AdaptSchedule":
        update = np.zeros(num_warmup, dtype=bool)
        slow = np.zeros(num_warmup, dtype=bool)
        if num_warmup < 20:
            return AdaptSchedule(update, slow)
        if init_buffer + base_window + term_buffer > num_warmup:
            # Scale buffers down proportionally (Stan's fallback).
            init_buffer = int(0.15 * num_warmup)
            term_buffer = int(0.1 * num_warmup)
        start = init_buffer
        window = base_window
        while start < num_warmup - term_buffer:
            end = min(start + window, num_warmup - term_buffer)
            # If the remaining tail can't fit another window, absorb it.
            if end + window > num_warmup - term_buffer:
                end = num_warmup - term_buffer
            slow[start:end] = True
            update[end - 1] = True
            start = end
            window *= 2
        return AdaptSchedule(update, slow)

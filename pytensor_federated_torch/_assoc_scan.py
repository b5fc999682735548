"""A parallel prefix scan with an associative operator.

PyTorch has no counterpart of ``jax.lax.associative_scan``.  This is the
same odd/even recursion: combine adjacent pairs, scan the half-length
sequence of pair results, then combine those prefixes with the
remaining even elements and interleave.  Every pair is combined in the
order JAX combines it, so float32 rounding follows the JAX package's as
far as the operators allow.  Depth O(log T), static shapes, no host
sync; it runs under ``torch.func.vmap`` (the scan axis is then a
logical axis).
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple

import torch

__all__ = ["associative_scan"]


def _slice(t: torch.Tensor, axis: int, start: int, stop, step: int = 1) -> torch.Tensor:
    index = [slice(None)] * t.ndim
    index[axis] = slice(start, stop, step)
    return t[tuple(index)]


def _interleave(even: torch.Tensor, odd: torch.Tensor, axis: int) -> torch.Tensor:
    """``[e0, o0, e1, o1, ...]`` along ``axis``; ``even`` may be one longer."""
    n_odd = odd.shape[axis]
    pairs = torch.stack([_slice(even, axis, 0, n_odd), odd], dim=axis + 1)
    out = pairs.flatten(axis, axis + 1)
    if even.shape[axis] > n_odd:
        out = torch.cat([out, _slice(even, axis, n_odd, None)], dim=axis)
    return out


def associative_scan(
    fn: Callable[[Tuple[torch.Tensor, ...], Tuple[torch.Tensor, ...]], Sequence[torch.Tensor]],
    elems: Sequence[torch.Tensor],
    reverse: bool = False,
    axis: int = 0,
) -> Tuple[torch.Tensor, ...]:
    """Inclusive scan of the tuple of tensors ``elems`` along ``axis``.

    ``fn(a, b)`` combines two tuples of tensors elementwise along the
    scan axis (earlier ``a``, later ``b``) and must be associative.
    Element ``k`` of the result is ``fn`` folded over elements ``0..k``;
    with ``reverse=True`` over elements ``k..T-1``, the later
    accumulation passed as ``a``, as in JAX.
    """
    elems = tuple(elems)
    if not elems:
        raise ValueError("associative_scan needs at least one tensor")
    axis = axis % elems[0].ndim
    n = elems[0].shape[axis]
    if any(e.shape[axis] != n for e in elems):
        raise ValueError(
            "tensors passed to associative_scan must share the scan axis's "
            f"length (saw: {[tuple(e.shape) for e in elems]})"
        )
    if reverse:
        elems = tuple(torch.flip(e, (axis,)) for e in elems)

    def combine(a, b):
        return tuple(fn(tuple(a), tuple(b)))

    def scan(elems):
        n = elems[0].shape[axis]
        if n < 2:
            return elems
        reduced = combine(
            [_slice(e, axis, 0, n - 1, 2) for e in elems],
            [_slice(e, axis, 1, None, 2) for e in elems],
        )
        odd = scan(reduced)
        if n % 2 == 0:
            even = combine(
                [_slice(e, axis, 0, -1) for e in odd],
                [_slice(e, axis, 2, None, 2) for e in elems],
            )
        else:
            even = combine(odd, [_slice(e, axis, 2, None, 2) for e in elems])
        even = [torch.cat([_slice(e, axis, 0, 1), r], dim=axis) for e, r in zip(elems, even)]
        return tuple(_interleave(e, o, axis) for e, o in zip(even, odd))

    out = scan(elems)
    if reverse:
        out = tuple(torch.flip(e, (axis,)) for e in out)
    return out

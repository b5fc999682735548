"""Typed compute-function contracts, over torch tensors.

Port of the JAX package's ``signatures.py``: the same three ``Callable``
contracts (arrays -> arrays, params -> scalar logp, params -> logp and
one gradient per input) and a static *shape signature*
(:class:`ArraysSpec`).  JAX builds the signature from
``jax.ShapeDtypeStruct``; here :class:`ShapeDtypeStruct` is a small
named tuple of a shape and a ``torch.dtype``.  Host functions behind
these contracts (a remote node, a C library) enter through
:mod:`.ops.blackbox` and :mod:`.ops.fanout`, which need the signature
to type their outputs.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Sequence, Tuple

import torch

Array = torch.Tensor
ArrayLike = Any  # anything torch.as_tensor accepts

#: Arrays in -> arrays out.  The universal compute contract.
ComputeFn = Callable[..., Sequence[Array]]

#: Model parameters -> scalar log-potential.
LogpFn = Callable[..., Array]

#: Model parameters -> (scalar log-potential, gradients w.r.t. every input).
LogpGradFn = Callable[..., Tuple[Array, Tuple[Array, ...]]]


class ShapeDtypeStruct(NamedTuple):
    """The static signature of one array: its shape and dtype."""

    shape: Tuple[int, ...]
    dtype: torch.dtype


#: A static arrays signature: one ShapeDtypeStruct per array.
ArraysSpec = Tuple[ShapeDtypeStruct, ...]


def spec_of(*arrays: ArrayLike) -> ArraysSpec:
    """Return the static signature of concrete arrays."""
    out = []
    for a in arrays:
        a = torch.as_tensor(a)
        out.append(ShapeDtypeStruct(tuple(a.shape), a.dtype))
    return tuple(out)


def scalar_spec(dtype: torch.dtype = torch.float32) -> ShapeDtypeStruct:
    """Signature of a 0-d scalar (the logp output)."""
    return ShapeDtypeStruct((), dtype)


def check_scalar(x: Array, what: str = "logp") -> Array:
    """Check that ``x`` is a scalar (0-d)."""
    if tuple(x.shape) != ():
        raise ValueError(f"{what} must be scalar, got shape {tuple(x.shape)}")
    return x

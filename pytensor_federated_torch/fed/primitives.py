"""Differentiable federated MapReduce: ``fed_map``, ``fed_sum``,
``fed_broadcast`` and ``fed_mean``.

The port of the JAX package's ``fed/primitives.py``.  The federated
algebra — *map* a function over every shard's placed values, *sum*
shard-placed values back to the driver, *broadcast* driver state out to
the shards — keeps its dense semantics here:

- ``fed_map`` is a ``torch.func.vmap`` of the per-shard function over
  the leading shard axis;
- ``fed_sum`` sums over that axis;
- ``fed_broadcast`` repeats a value along a new leading axis of
  ``n_shards`` (an ``expand``, as ``jnp.broadcast_to`` is lazy);
- ``fed_mean`` is the (weighted) mean over shards.

Torch has no primitive registry and no transpose rules.  What the JAX
package's JVP, transpose and batching rules encode, autograd supplies:
the dense forms are differentiable torch operations, ``fed_sum`` and
``fed_broadcast`` are each other's adjoint (the backward of ``expand``
sums, the backward of a sum expands), and a value the per-shard
function closes over receives the sum of every shard's cotangent, as
``torch.func.vmap`` accumulates an unbatched input's gradient.  The same
model runs eagerly, under ``torch.func.vmap`` (a sampler's chain batch)
and under ``torch.func.grad``.

``fed_map_p``, ``fed_sum_p`` and ``fed_broadcast_p`` are named
stand-ins for the JAX package's primitives: the nodes of a
:func:`..fed.program`'s graph point at them (``node.target is
fed_map_p``), as its jaxpr's equations point at the JAX primitives.
While a program records its graph (:mod:`.lowering`), the functions
below add nodes to it instead of computing.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Optional, Sequence

import torch

from ..utils import tree_leaves, tree_map

__all__ = [
    "fed_broadcast",
    "fed_broadcast_p",
    "fed_map",
    "fed_map_p",
    "fed_mean",
    "fed_sum",
    "fed_sum_p",
]


class Primitive:
    """A named stand-in for one of the JAX package's ``fed`` primitives:
    the target of a program graph's node, never called itself."""

    def __init__(self, name: str, *, multiple_results: bool = False) -> None:
        self.name = self.__name__ = name
        self.multiple_results = multiple_results

    def __call__(self, *args: Any, **kwargs: Any) -> Any:
        raise TypeError(
            f"{self.name} is the target of a fed program's graph node; "
            f"call {self.name}() from pytensor_federated_torch.fed instead"
        )

    def __repr__(self) -> str:
        return self.name


fed_map_p = Primitive("fed_map", multiple_results=True)
fed_sum_p = Primitive("fed_sum")
fed_broadcast_p = Primitive("fed_broadcast")

#: ``.recorder``: the program recorder of this thread while it records a
#: graph (set by :mod:`.lowering`).
_STATE = threading.local()


def _recorder() -> Any:
    return getattr(_STATE, "recorder", None)


def _leading_dim(leaves: Sequence[torch.Tensor]) -> int:
    dims = {int(leaf.shape[0]) if leaf.dim() else None for leaf in leaves}
    if len(dims) != 1 or None in dims:
        raise ValueError(
            f"all mapped leaves must share a leading shard axis, got {dims}"
        )
    return dims.pop()


def _unflatten(skeleton: Any, leaves: Sequence[Any]) -> Any:
    """``skeleton``'s containers with its leaves taken from ``leaves``."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), skeleton)


def fed_map(fn: Callable[[Any], Any], data: Any) -> Any:
    """Apply ``fn`` to every shard of ``data``; outputs stacked along a
    leading shards axis.

    ``data`` is a pytree whose leaves carry a leading ``n_shards`` axis;
    ``fn(shard_pytree) -> pytree``.  Values ``fn`` closes over are
    replicated to every shard, and their gradient is the sum of the
    shards' cotangents.  For placements that ship work over the wire
    (``PoolPlacement``), pass everything varying as *mapped* data via
    :func:`fed_broadcast` instead of closing over it: closure values
    never leave the driver.
    """
    leaves = tree_leaves(data)
    if not leaves:
        raise ValueError("fed_map data pytree has no leaves")
    rec = _recorder()
    if rec is not None:
        return rec.fed_map(fn, data)
    leaves = [torch.as_tensor(leaf) for leaf in leaves]
    _leading_dim(leaves)
    skeleton = tree_map(lambda _: None, data)
    return torch.func.vmap(lambda *shard: fn(_unflatten(skeleton, shard)))(*leaves)


def _sum(x: Any) -> torch.Tensor:
    x = torch.as_tensor(x)
    if x.dim() == 0:
        raise ValueError("fed_sum operand must carry a leading shards axis")
    return x.sum(0)


def fed_sum(values: Any) -> Any:
    """Reduce shard-stacked values (leading shards axis) by summation —
    the driver's sum of potentials, the adjoint of :func:`fed_broadcast`."""
    rec = _recorder()
    if rec is not None:
        return tree_map(rec.fed_sum, values)
    return tree_map(_sum, values)


def fed_broadcast(value: Any, n_shards: int) -> Any:
    """Replicate driver state to every shard (stacked along shards) —
    the placement move whose adjoint is :func:`fed_sum`.  Pool
    placements ship ONLY mapped operands, so driver state a pool-placed
    ``fed_map`` needs must arrive through this, not through closure."""
    n = int(n_shards)
    if n < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    rec = _recorder()
    if rec is not None:
        return tree_map(lambda leaf: rec.fed_broadcast(leaf, n), value)
    return tree_map(lambda leaf: _broadcast(torch.as_tensor(leaf), n), value)


def _broadcast(x: torch.Tensor, n: int) -> torch.Tensor:
    return x.expand(n, *x.shape)


def fed_mean(values: Any, weights: Optional[torch.Tensor] = None) -> Any:
    """(Weighted) mean across shards of shard-stacked values.

    ``weights`` must be a 1-D vector with EXACTLY one entry per shard:
    a wrong-length vector that happens to broadcast against trailing
    dimensions would silently weight the wrong axis, so the length is
    validated against the leading shard axis and raises ``ValueError``.
    """
    flat = tree_leaves(values)
    if not flat:
        return values
    n = _leading_dim([torch.as_tensor(leaf) for leaf in flat])
    if weights is None:
        return tree_map(lambda leaf: fed_sum(torch.as_tensor(leaf) / n), values)
    w = torch.as_tensor(weights)
    if w.dim() != 1 or int(w.shape[0]) != n:
        raise ValueError(
            f"weights must be a length-{n} vector (one weight per "
            f"shard), got shape {tuple(w.shape)}"
        )
    w = w / w.sum()

    def wmean(leaf: Any) -> Any:
        leaf = torch.as_tensor(leaf)
        return fed_sum(leaf * w.reshape((-1,) + (1,) * (leaf.dim() - 1)))

    return tree_map(wmean, values)

"""Pack heterogeneous per-shard datasets into one batched layout.

Each federated node owns private data of its own size; a batched device
program wants one static shape, so "each node has different data"
becomes pad-to-max + mask.  The mask rides along as a first-class
tensor; likelihoods multiply by it so padded rows contribute exactly
zero to logp *and* grad.  Same layout and mask semantics as the JAX
package's ``parallel/packing.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import numpy as np
import torch

from ..utils import resolve_device, tree_leaves, tree_map, tree_structure


@dataclasses.dataclass
class ShardedData:
    """Stacked per-shard data with a validity mask.

    ``data`` is a tree whose leaves have shape ``(n_shards, max_len, ...)``;
    ``mask`` is ``(n_shards, max_len)`` float32 with 1.0 on real rows.
    """

    data: Any
    mask: torch.Tensor

    @property
    def n_shards(self) -> int:
        return int(self.mask.shape[0])

    @property
    def max_len(self) -> int:
        return int(self.mask.shape[1])

    def tree(self) -> Any:
        """The tree handed to the sharded evaluator: (data, mask)."""
        return (self.data, self.mask)


def pack_shards(
    shards: Sequence[Any], *, pad_to_multiple: int = 1, device: Any = None
) -> ShardedData:
    """Stack a list of per-shard trees, padding the leading axis to max.

    Each element of ``shards`` is a tree (nested tuples, lists, dicts) of
    arrays whose *leading* axis is that shard's number of observations
    (axes beyond the first must match across shards).  ``pad_to_multiple``
    rounds the padded length up.  Padding and stacking happen in numpy,
    so the packed bytes equal the JAX package's; the result lands on
    ``device`` (``cuda`` unless the caller says otherwise).
    """
    if not shards:
        raise ValueError("need at least one shard")
    dev = resolve_device(device)
    treedef = tree_structure(shards[0])
    for s in shards[1:]:
        if tree_structure(s) != treedef:
            raise ValueError("all shards must share one pytree structure")

    lengths = []
    for s in shards:
        ns = {np.shape(leaf)[0] for leaf in tree_leaves(s)}
        if len(ns) != 1:
            raise ValueError(
                f"leaves of one shard must share a leading axis, got {ns}"
            )
        lengths.append(ns.pop())
    max_len = max(lengths)
    if pad_to_multiple > 1:
        max_len = -(-max_len // pad_to_multiple) * pad_to_multiple

    def pad_leaf(*leaves):
        padded = []
        for leaf in leaves:
            leaf = np.asarray(leaf)
            pad = [(0, max_len - leaf.shape[0])] + [(0, 0)] * (leaf.ndim - 1)
            padded.append(np.pad(leaf, pad))
        return torch.as_tensor(np.stack(padded), device=dev)

    data = tree_map(pad_leaf, shards[0], *shards[1:])
    mask = np.zeros((len(shards), max_len), dtype=np.float32)
    for i, n in enumerate(lengths):
        mask[i, :n] = 1.0
    return ShardedData(data=data, mask=torch.as_tensor(mask, device=dev))

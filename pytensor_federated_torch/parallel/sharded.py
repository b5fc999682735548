"""The sharded evaluator: ``logp(params) = Σ_shards per_shard_logp``.

The port of the JAX package's ``FederatedLogp`` without a mesh: the
per-shard callable is mapped over the leading shard axis of the data
tree with ``torch.func.vmap`` and the per-shard contributions are
summed on the device.  Gradients come from ``torch.autograd`` through
the map and the sum, so one backward pass gives every parameter's
gradient.  The mesh placement, the minibatch estimators and
``sharded_compute`` are not ported yet.
"""

from __future__ import annotations

from typing import Any, Callable, Tuple

import torch

from ..utils import tree_leaves, value_and_grad

# per_shard_logp(params, shard_data) -> scalar logp contribution of one shard.
PerShardLogpFn = Callable[[Any, Any], torch.Tensor]


def _leading_dim(data: Any) -> int:
    leaves = tree_leaves(data)
    if not leaves:
        raise ValueError("data pytree has no leaves")
    dims = {int(leaf.shape[0]) for leaf in leaves}
    if len(dims) != 1:
        raise ValueError(
            f"all data leaves must share a leading shard axis, got {dims}"
        )
    return dims.pop()


class FederatedLogp:
    """Sharded log-potential over a data tree with a leading shard axis.

    ``data`` leaves carry a leading ``n_shards`` axis (build
    heterogeneous shards with :func:`..parallel.packing.pack_shards`).
    """

    def __init__(self, per_shard_logp: PerShardLogpFn, data: Any):
        self.per_shard_logp = per_shard_logp
        self.n_shards = _leading_dim(data)
        self.data = data

    def per_shard_logps(self, params: Any) -> torch.Tensor:
        """Vector of per-shard contributions."""
        return torch.func.vmap(lambda d: self.per_shard_logp(params, d))(self.data)

    def logp(self, params: Any) -> torch.Tensor:
        """Scalar total log-potential."""
        return self.per_shard_logps(params).sum()

    def logp_and_grad(self, params: Any) -> Tuple[torch.Tensor, Any]:
        """(logp, grads) from one forward and one backward pass."""
        return value_and_grad(self.logp, params)

    __call__ = logp

    def logp_batch(self, params_batch: Any) -> torch.Tensor:
        """Evaluate B parameter sets at once: leaves carry a leading batch
        axis; returns ``(B,)`` logps."""
        return torch.func.vmap(self.logp)(params_batch)

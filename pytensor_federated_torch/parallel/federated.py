"""Federated MapReduce API + federated averaging (FedAvg).

The port of the JAX package's ``parallel/federated.py``.  The reference
frames everything as "arrays in -> arrays out per node, summed by the
driver's graph".  This module names that algebra directly, in the style
of DrJAX's MapReduce primitives: ``federated_map`` runs a function over
every shard's private data, ``federated_sum`` / ``federated_mean``
reduce across shards, ``federated_broadcast`` replicates driver state.

They are thin wrappers over :mod:`pytensor_federated_torch.fed`:
single-device calls carry the primitives' dense semantics, and
``mesh=`` routes through :class:`~pytensor_federated_torch.fed.MeshPlacement`.

On top of them, :func:`fedavg` implements federated averaging (McMahan
et al.): per round, every shard takes ``local_steps`` SGD steps from the
broadcast global params on its own data, and the new global params are
the (weighted) mean of the local results.  Shards advance in lockstep
as one vmapped batch (per mesh slot with ``mesh=``), through
:func:`.sharded.sharded_compute`, as in the JAX package.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import torch

from ..utils import tree_leaves, tree_map
from .mesh import SHARDS_AXIS, Mesh
from .sharded import sharded_compute


def federated_map(
    fn: Callable[[Any], Any],
    data: Any,
    *,
    mesh: Optional[Mesh] = None,
    axis: str = SHARDS_AXIS,
) -> Any:
    """Apply ``fn`` to every shard's data; outputs stacked along shards.

    ``fn(shard_data) -> pytree``.  The data-parallel "map": one RPC
    round over the node pool as one batched program.  Calls
    :func:`fed.fed_map`; with ``mesh=`` the call lowers through
    :class:`fed.MeshPlacement` (each slot maps its block on its device).
    """
    from .. import fed

    if mesh is None:
        return fed.fed_map(fn, data)
    placement = fed.MeshPlacement(mesh, axis=axis)
    return fed.program(lambda d: fed.fed_map(fn, d), placement)(data)


def federated_sum(values: Any) -> Any:
    """Reduce shard-stacked values (leading shards axis) by summation —
    the driver-side "sum of potentials".  Calls :func:`fed.fed_sum`,
    whose adjoint is :func:`federated_broadcast`."""
    from ..fed import fed_sum

    return fed_sum(values)


def federated_mean(values: Any, weights: Optional[torch.Tensor] = None) -> Any:
    """(Weighted) mean across shards of shard-stacked values.

    ``weights`` must have exactly one entry per shard; a wrong-length
    vector that merely broadcasts raises ``ValueError`` (it would
    silently weight the wrong axis).
    """
    from ..fed import fed_mean

    return fed_mean(values, weights)


def federated_broadcast(value: Any, n_shards: int) -> Any:
    """Replicate driver state to every shard (stacked along shards).
    Calls :func:`fed.fed_broadcast`, whose adjoint is
    :func:`federated_sum` — the gradient of replicated state is the sum
    of shard cotangents."""
    from ..fed import fed_broadcast

    return fed_broadcast(value, n_shards)


def fedavg(
    local_loss_fn: Callable[[Any, Any], torch.Tensor],
    data: Any,
    init_params: Any,
    *,
    mesh: Optional[Mesh] = None,
    axis: str = SHARDS_AXIS,
    rounds: int = 50,
    local_steps: int = 5,
    learning_rate: float = 0.05,
    weights: Optional[torch.Tensor] = None,
) -> Tuple[Any, torch.Tensor]:
    """Federated averaging over shard-private data.

    ``local_loss_fn(params, shard_data) -> scalar`` is each node's
    private objective.  Returns ``(final_params, loss_history)`` where
    ``loss_history[r]`` is the weighted-mean local loss at the start of
    round ``r``.  ``weights`` (per shard, e.g. observation counts)
    default to uniform; like the JAX package's, they are float32.

    Per round: broadcast global params -> vmapped ``local_steps`` SGD
    steps on every shard -> weighted-mean reduce of the local params.
    """
    leaves = tree_leaves(data)
    n_shards = int(leaves[0].shape[0])
    device = leaves[0].device
    if weights is None:
        w = torch.ones((n_shards,), dtype=torch.float32, device=device) / n_shards
    else:
        w = torch.as_tensor(weights, dtype=torch.float32).to(device)
        w = w / w.sum()

    grad_fn = torch.func.grad(local_loss_fn)

    def local_train(params, shard_data):
        """One shard's round: local_steps of SGD from the global params."""
        loss0 = local_loss_fn(params, shard_data)
        for _ in range(local_steps):
            g = grad_fn(params, shard_data)
            params = tree_map(lambda a, b: a - learning_rate * b, params, g)
        return params, loss0

    # Per-round shard work as one batched map (vmap inside, the weighted
    # reduce outside) — the sharded evaluator's machinery.
    round_map = sharded_compute(local_train, data, mesh=mesh, axis=axis)

    params, history = init_params, []
    for _ in range(rounds):
        local_params, losses = round_map(params)
        params = federated_mean(local_params, w)
        history.append(torch.sum(w * losses))
    return params, torch.stack(history)

"""``fed`` — differentiable federated MapReduce with placement-aware
lowering: ONE program for the device and host lanes.

The port of the JAX package's ``fed/``.  ``fed_map`` / ``fed_sum`` /
``fed_broadcast`` carry dense semantics whose autograd encodes the
federated autodiff identities (:mod:`.primitives`), so one model runs
and differentiates end to end whether its shards live on mesh slots
(:class:`MeshPlacement`), RPC node pools (:class:`PoolPlacement`), or a
mix (:class:`MixedPlacement`) — and the window fusion of independent
remote calls is a planning pass over the program's graph
(:mod:`.batching`).

Quick shape::

    from pytensor_federated_torch import fed

    def model(params):
        pb = fed.fed_broadcast(params, n_shards)
        lps = fed.fed_map(lambda s: shard_logp(s[0], s[1]), (pb, data))
        return fed.fed_sum(lps)

    run = fed.program(model, fed.MeshPlacement(mesh))   # or Pool/Mixed
    value = run(params)                                  # torch.autograd works
"""

from .batching import plan_windows
from .lowering import FederatedLogpGrad, program
from .placements import (
    MapSpec,
    MeshPlacement,
    MixedPlacement,
    Placement,
    PoolPlacement,
    make_node_compute,
)
from .primitives import (
    fed_broadcast,
    fed_broadcast_p,
    fed_map,
    fed_map_p,
    fed_mean,
    fed_sum,
    fed_sum_p,
)

__all__ = [
    "FederatedLogpGrad",
    "MapSpec",
    "MeshPlacement",
    "MixedPlacement",
    "Placement",
    "PoolPlacement",
    "fed_broadcast",
    "fed_broadcast_p",
    "fed_map",
    "fed_map_p",
    "fed_mean",
    "fed_sum",
    "fed_sum_p",
    "make_node_compute",
    "plan_windows",
    "program",
]

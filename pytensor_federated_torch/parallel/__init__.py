"""Mesh, shard packing, the sharded evaluator and the ring collectives."""

from .mesh import (
    CHAINS_AXIS,
    SEQ_AXIS,
    SHARDS_AXIS,
    DeviceLoad,
    Mesh,
    NamedSharding,
    get_load,
    healthy_devices,
    make_mesh,
    single_device_mesh,
)
from .packing import ShardedData, pack_shards
from .ring import (
    ring_all_pairs_sum,
    ring_attention,
    ring_shift,
    seq_sharded_markov_logp,
    shift_right_across_shards,
)
from .sharded import FederatedLogp, NoFederatedShards, sharded_compute

__all__ = [
    "CHAINS_AXIS",
    "SEQ_AXIS",
    "SHARDS_AXIS",
    "DeviceLoad",
    "FederatedLogp",
    "Mesh",
    "NamedSharding",
    "NoFederatedShards",
    "ShardedData",
    "get_load",
    "healthy_devices",
    "make_mesh",
    "pack_shards",
    "ring_all_pairs_sum",
    "ring_attention",
    "ring_shift",
    "seq_sharded_markov_logp",
    "shift_right_across_shards",
    "sharded_compute",
    "single_device_mesh",
]

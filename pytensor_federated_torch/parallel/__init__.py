"""Mesh, shard packing and the sharded evaluator."""

from .mesh import (
    CHAINS_AXIS,
    SEQ_AXIS,
    SHARDS_AXIS,
    DeviceLoad,
    Mesh,
    get_load,
    healthy_devices,
    make_mesh,
    single_device_mesh,
)
from .packing import ShardedData, pack_shards
from .sharded import FederatedLogp, NoFederatedShards, sharded_compute

__all__ = [
    "CHAINS_AXIS",
    "SEQ_AXIS",
    "SHARDS_AXIS",
    "DeviceLoad",
    "FederatedLogp",
    "Mesh",
    "NoFederatedShards",
    "ShardedData",
    "get_load",
    "healthy_devices",
    "make_mesh",
    "pack_shards",
    "sharded_compute",
    "single_device_mesh",
]

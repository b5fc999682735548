"""Mesh, shard packing, the sharded evaluator, the federated MapReduce
API and FedAvg, the ring collectives, the ZeRO, tensor, expert and
Ulysses axes, and the multi-process layer."""

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
from .expert import EXPERTS_AXIS, ExpertShardedMixture
from .federated import (
    fedavg,
    federated_broadcast,
    federated_map,
    federated_mean,
    federated_sum,
)
from .multihost import (
    HeartbeatServer,
    detect_dead_peers,
    initialize_multihost,
    make_multihost_mesh,
    probe_peer,
    remesh_after_failure,
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
from .tensor import TP_AXIS, TensorParallelLogistic
from .ulysses import heads_to_seq, seq_to_heads, ulysses_attention
from .zero import ScatteredGrads, ZeroShardedLogpGrad

__all__ = [
    "CHAINS_AXIS",
    "SEQ_AXIS",
    "SHARDS_AXIS",
    "DeviceLoad",
    "EXPERTS_AXIS",
    "ExpertShardedMixture",
    "FederatedLogp",
    "HeartbeatServer",
    "Mesh",
    "NamedSharding",
    "NoFederatedShards",
    "ScatteredGrads",
    "ShardedData",
    "TP_AXIS",
    "TensorParallelLogistic",
    "ZeroShardedLogpGrad",
    "detect_dead_peers",
    "fedavg",
    "federated_broadcast",
    "federated_map",
    "federated_mean",
    "federated_sum",
    "get_load",
    "heads_to_seq",
    "healthy_devices",
    "initialize_multihost",
    "make_mesh",
    "make_multihost_mesh",
    "pack_shards",
    "probe_peer",
    "remesh_after_failure",
    "ring_all_pairs_sum",
    "ring_attention",
    "ring_shift",
    "seq_sharded_markov_logp",
    "seq_to_heads",
    "shift_right_across_shards",
    "sharded_compute",
    "single_device_mesh",
    "ulysses_attention",
]

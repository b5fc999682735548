"""ZeRO-style sharded optimizer over the replica pool.

Node-owned optimizer state, shard-local Adam updates, versioned
checkpoints, and a lazy param-refresh lane — see :mod:`.sharded` for
the architecture and :mod:`.state` for the shard lifecycle.
"""

from .sharded import ShardedOptimizer, ShardResult, make_update_compute
from .state import (
    ShardState,
    ShardStore,
    StaleShardError,
    parse_stale_error,
    stale_message,
)

__all__ = [
    "ShardResult",
    "ShardState",
    "ShardStore",
    "ShardedOptimizer",
    "StaleShardError",
    "make_update_compute",
    "parse_stale_error",
    "stale_message",
]

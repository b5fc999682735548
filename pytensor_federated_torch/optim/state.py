"""Node-side optimizer-shard lifecycle: versioned checkpoints.

Port of the JAX package's ``optim/state.py``, numpy only, with the same file
names, keys and dtypes, so a JAX node and a torch node can share one
store directory.  A sharded-optimizer node owns ONE contiguous shard of the
flat parameter vector plus that shard's optimizer state.  Both live in
a :class:`ShardStore` — a directory of version-stamped ``.npz``
checkpoints, one file per shard geometry — with two hard rules:

- **Checkpoint BEFORE reply.**  ``make_update_compute`` persists the
  post-update shard before the reply frame leaves the node, so a
  replica killed at any instant leaves the store in one of exactly two
  states: the update never happened (driver retries cleanly) or it is
  durably applied (the retry's version mismatch tells the driver
  "already applied" and it refreshes the slice instead of re-stepping).
  There is no third state — that is the exactly-once story.
- **Version mismatches are LOUD.**  :class:`StaleShardError` is a
  :class:`~..service.npwire.WireError` subclass on purpose: every lane
  already treats WireError as the deterministic, non-retryable
  classification, and the message carries ``holds``/``expected`` so the
  driver can distinguish "already applied" (holds == expected + 1,
  recoverable by refresh) from genuine divergence (anything else,
  unrecoverable — surfaced, never papered over).

The store directory is deliberately SHAREABLE: any replica pointed at
the same root can restore any shard, which is what lets
:class:`~.sharded.ShardedOptimizer` re-bind a dead replica's shard onto
a live one (NodePool failover) without losing optimizer state.

Writes are atomic (``os.replace`` of a same-directory temp file) so a
crash mid-checkpoint leaves the previous version intact, never a torn
file.
"""

from __future__ import annotations

import io
import os
import re
import tempfile
import threading
from typing import Any, List, NamedTuple, Optional, Tuple

import numpy as np

from ..routing.partition import GradPartition, PartitionError
from ..service.npwire import WireError

__all__ = [
    "ShardState",
    "ShardStore",
    "StaleShardError",
    "parse_stale_error",
    "stale_message",
]

_STALE_RE = re.compile(
    r"StaleShardError: shard (\d+)/(\d+) holds version (\d+), "
    r"request expected (\d+)"
)


def stale_message(part: GradPartition, holds: int, expected: int) -> str:
    """The canonical (machine-parseable) stale-shard message.  It
    crosses the wire as in-band error TEXT (``pure_callback`` and the
    RPC error frame both erase exception types), so the format is the
    protocol: :func:`parse_stale_error` must keep matching it."""
    return (
        f"StaleShardError: shard {part.index}/{part.count} holds "
        f"version {holds}, request expected {expected} "
        f"(geometry offset={part.offset} length={part.length} "
        f"total={part.total})"
    )


def parse_stale_error(text: str) -> Optional[Tuple[int, int, int, int]]:
    """Extract ``(index, count, holds, expected)`` from an in-band
    error string, or ``None`` when it is not a stale-shard refusal."""
    m = _STALE_RE.search(text)
    if m is None:
        return None
    return tuple(int(g) for g in m.groups())  # type: ignore[return-value]


class StaleShardError(WireError):
    """A versioned request whose step-version stamp does not match the
    shard's checkpointed version.  ``holds == expected + 1`` means the
    update was durably applied but the reply was lost (recoverable:
    refresh the slice); anything else is divergence and must surface."""

    def __init__(self, part: GradPartition, holds: int, expected: int):
        super().__init__(stale_message(part, holds, expected))
        self.part = part
        self.holds = holds
        self.expected = expected


class ShardState(NamedTuple):
    """One shard's durable state: the monotonic step version, the
    owned parameter slice, and the optimizer-state leaves (tree
    structure is NOT stored — the node re-derives it from its own
    ``optimizer.init`` on a zeros slice, so a checkpoint written by one
    replica restores on any replica running the same optimizer)."""

    version: int
    params: np.ndarray
    opt_leaves: List[np.ndarray]


class ShardStore:
    """Version-stamped shard checkpoints under one directory.

    Keyed by the full shard geometry ``(count, total, index)`` — two
    different partition plans never collide, and a geometry
    disagreement on load is a loud :class:`PartitionError`, never a
    silently mis-sliced restore.  Thread-safe per process (one lock;
    checkpoints are small — O(model/N))."""

    def __init__(self, root: str) -> None:
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)
        self._lock = threading.Lock()

    def _path(self, part: GradPartition) -> str:
        return os.path.join(
            self.root,
            f"shard_{part.count}x{part.total}_{part.index}.npz",
        )

    def save(
        self,
        part: GradPartition,
        version: int,
        params: np.ndarray,
        opt_leaves: List[Any],
    ) -> None:
        """Atomically persist one shard at ``version`` (temp file +
        ``os.replace`` in the same directory — a crash mid-write leaves
        the previous checkpoint intact)."""
        part.validate()
        params = np.asarray(params)
        if params.size != part.length:
            raise PartitionError(
                f"shard {part.index} params carry {params.size} elements "
                f"but the partition declares length {part.length}"
            )
        payload = {
            "version": np.asarray(int(version), np.uint64),
            "geometry": np.asarray(list(part), np.uint64),
            "params": params,
            "n_leaves": np.asarray(len(opt_leaves), np.uint64),
        }
        for i, leaf in enumerate(opt_leaves):
            payload[f"leaf_{i}"] = np.asarray(leaf)
        buf = io.BytesIO()
        np.savez(buf, **payload)
        data = buf.getvalue()
        path = self._path(part)
        with self._lock:
            fd, tmp = tempfile.mkstemp(
                dir=self.root, prefix=".tmp_shard_", suffix=".npz"
            )
            try:
                with os.fdopen(fd, "wb") as f:
                    f.write(data)
                    f.flush()
                    os.fsync(f.fileno())
                os.replace(tmp, path)
            except BaseException:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
                raise

    def load(self, part: GradPartition) -> Optional[ShardState]:
        """The shard's last durable state, or ``None`` when it was
        never checkpointed.  A geometry mismatch between the request
        partition and the stored stamp is loud — it means two
        partition plans collided on one store."""
        part.validate()
        path = self._path(part)
        with self._lock:
            try:
                with open(path, "rb") as f:
                    data = f.read()
            except FileNotFoundError:
                return None
        try:
            with np.load(io.BytesIO(data)) as z:
                stored = tuple(int(v) for v in z["geometry"])
                if stored != tuple(part):
                    raise PartitionError(
                        f"checkpoint geometry {stored} does not match "
                        f"the requested shard {tuple(part)}"
                    )
                n = int(z["n_leaves"])
                return ShardState(
                    version=int(z["version"]),
                    params=np.asarray(z["params"]),
                    opt_leaves=[
                        np.asarray(z[f"leaf_{i}"]) for i in range(n)
                    ],
                )
        except PartitionError:
            raise
        except Exception as e:
            raise WireError(
                f"corrupt shard checkpoint {os.path.basename(path)}: {e}"
            ) from None

    def version(self, part: GradPartition) -> Optional[int]:
        state = self.load(part)
        return None if state is None else state.version

    def drop(self, part: GradPartition) -> None:
        """Forget one shard (tests / chaos teardown)."""
        try:
            os.unlink(self._path(part))
        except FileNotFoundError:
            pass

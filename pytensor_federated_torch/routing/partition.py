"""Gradient partitioning: the shard math behind partition-indexed frames.

The gradient-sharding bandwidth story lives here.  Every remote logp+grad reply
used to ship the FULL gradient, so wire bytes per federated evaluation
scale as ``O(model_size × n_shards)``.  Two mechanisms cut that down,
both built on the partition-index wire block declared in
:mod:`..service.wire_registry` (``PARTITION_STRUCT``; npwire flag bit
64, shm doorbell flag bit 16, npproto extension field 20):

- **Sliced replies** ("scatter"): a request carrying a partition block
  asks the node to return only elements ``[offset, offset + length)``
  of its reply's flat gradient vector — the mechanism that lets a
  gradient larger than one reply frame stream home as several
  partition-indexed slices, reassembled here with loud errors on
  overlap, gaps, duplicates, or shape disagreement (never a silent
  partial sum).
- **Reduced windows** ("reduce"): a batch frame whose OUTER header
  carries a partition block asks the node to partially REDUCE the
  window — sum its items' replies elementwise — and return the sum as
  ``count`` partition-indexed slices.  A width-W pool answering
  n-shard windows this way returns ``W`` partial sums instead of ``n``
  full gradients, and mid-tier aggregator nodes (the tree lowering of
  ``fed_sum``) apply the same reduction over their children, giving
  O(log N) aggregation depth in pool width.

The reply contract both mechanisms share (the **head/tail rule**):
reply array 0 — the logp scalar of the ``[logp, *grads]`` node
contract — is the HEAD and is returned whole (summed under reduce);
reply arrays ``1..`` are the TAIL: raveled, concatenated in order into
one flat vector of ``total`` elements, and sliced.  All tail arrays
must share one dtype (mixed-precision tails would need a silent cast —
refused loudly instead), and the requester's ``total`` must equal the
node's actual flat size, making a driver/node shape disagreement a
wire error instead of a mis-assembled gradient.

Nothing here imports transports; the transports import this module
(the same direction as :mod:`..service.wire_registry`).
"""

from __future__ import annotations

import struct
import threading
from typing import (
    Callable,
    Dict,
    List,
    NamedTuple,
    Optional,
    Sequence,
    Tuple,
)

import numpy as np

from ..service.npwire import WireError
from ..service.wire_registry import PARTITION_STRUCT
from ..telemetry import metrics as _metrics

__all__ = [
    "GradPartition",
    "PartitionError",
    "Reassembler",
    "concat_tail",
    "make_aggregator_compute",
    "pack_partition",
    "plan_partitions",
    "reduce_replies",
    "shard_label",
    "slice_reply",
    "split_tail",
    "tail_layout",
    "unpack_partition",
]

#: Partition-indexed shard items served/consumed, by outcome — the
#: partition lane's goodput instrument (the fleet SLO engine clamps
#: per-shard error deltas at per-shard request deltas with these).
PARTITION_SHARDS = _metrics.counter(
    "pftpu_partition_shards_total",
    "Partition-indexed shard items, by outcome (ok / error)",
    ("outcome",),
)

_PART_STRUCT = struct.Struct(PARTITION_STRUCT)
_U32_MAX = 0xFFFFFFFF
_U64_MAX = 0xFFFFFFFFFFFFFFFF


class PartitionError(WireError):
    """A partition block that cannot describe a valid shard, or a
    reassembly that would be silently wrong (overlap, gap, duplicate,
    shape/dtype disagreement).  A :class:`~..service.npwire.WireError`
    subclass on purpose: every lane already treats WireError as the
    loud, deterministic, close-the-connection classification."""


class GradPartition(NamedTuple):
    """One contiguous shard of a flat gradient vector.

    ``index``/``count`` place the shard among its siblings;
    ``offset``/``length`` are its element range; ``total`` the flat
    vector's full element count.  A plain tuple on purpose — the wire
    codecs accept it positionally (``PARTITION_FIELD_ORDER``)."""

    index: int
    count: int
    offset: int
    length: int
    total: int

    def validate(self) -> "GradPartition":
        if not 0 <= self.index < self.count:
            raise PartitionError(
                f"partition index {self.index} outside 0..{self.count - 1}"
            )
        if self.count > _U32_MAX or self.count < 1:
            raise PartitionError(f"bad partition count {self.count}")
        if min(self.offset, self.length, self.total) < 0 or max(
            self.offset, self.length, self.total
        ) > _U64_MAX:
            raise PartitionError(
                f"partition range out of u64 bounds: {self}"
            )
        if self.offset + self.length > self.total:
            raise PartitionError(
                f"partition slice [{self.offset}, "
                f"{self.offset + self.length}) overruns total {self.total}"
            )
        return self


def pack_partition(part: Sequence[int]) -> bytes:
    """The 32-byte wire form (``PARTITION_STRUCT``) of a partition."""
    p = GradPartition(*part).validate()
    return _PART_STRUCT.pack(*p)


def unpack_partition(buf: bytes, offset: int = 0) -> GradPartition:
    """Decode and validate one partition block at ``offset``."""
    try:
        fields = _PART_STRUCT.unpack_from(buf, offset)
    except struct.error as e:
        raise PartitionError(f"truncated partition block: {e}") from None
    return GradPartition(*fields).validate()


#: Wire size of one partition block.
PARTITION_BLOCK_SIZE = _PART_STRUCT.size


def plan_partitions(total: int, count: int) -> List[GradPartition]:
    """``count`` contiguous shards covering ``[0, total)`` exactly.

    Shards are balanced to within one element; the uneven tail goes to
    the LEADING shards (shard sizes are ``ceil`` then ``floor``), so
    ``plan_partitions(10, 4)`` is ``3+3+2+2``.  Deterministic — both
    ends of a wire derive the same plan from ``(total, count)``."""
    if count < 1:
        raise PartitionError(f"partition count must be >= 1, got {count}")
    if total < 0:
        raise PartitionError(f"negative total {total}")
    base, extra = divmod(total, count)
    out: List[GradPartition] = []
    offset = 0
    for i in range(count):
        length = base + (1 if i < extra else 0)
        out.append(GradPartition(i, count, offset, length, total))
        offset += length
    return out


# ---------------------------------------------------------------------------
# the head/tail reply rule
# ---------------------------------------------------------------------------


def tail_layout(
    arrays: Sequence[np.ndarray],
) -> Tuple[List[Tuple[Tuple[int, ...], int]], int, np.dtype]:
    """Shapes/sizes and flat total of a reply's TAIL (arrays 1..).

    Returns ``([(shape, size), ...], total, dtype)``; loud on an empty
    reply, a non-uniform tail dtype, or a non-inexact tail."""
    if not arrays:
        raise PartitionError(
            "partitioned reply rule needs at least a head array"
        )
    tail = [np.asarray(a) for a in arrays[1:]]
    dtypes = {a.dtype for a in tail}
    if len(dtypes) > 1:
        # Name WHICH tail slot carries which dtype (reply index 1..):
        # "got [...]" alone sends the node author diffing reply shapes
        # by hand; the offender list pins the mismatched output.
        per_slot = ", ".join(
            f"reply[{i + 1}]={a.dtype}" for i, a in enumerate(tail)
        )
        raise PartitionError(
            "partitioned tail arrays must share one dtype, got "
            f"{sorted(str(d) for d in dtypes)} ({per_slot})"
        )
    dtype = dtypes.pop() if dtypes else np.dtype(np.float64)
    layout = [(tuple(a.shape), int(a.size)) for a in tail]
    return layout, sum(s for _sh, s in layout), dtype


def concat_tail(arrays: Sequence[np.ndarray]) -> np.ndarray:
    """The flat tail vector of a reply (arrays 1.. raveled + joined)."""
    tail = [np.ascontiguousarray(a).ravel() for a in arrays[1:]]
    if not tail:
        return np.zeros(0, np.float64)
    return np.concatenate(tail) if len(tail) > 1 else tail[0]


def split_tail(
    flat: np.ndarray, shapes: Sequence[Tuple[int, ...]]
) -> List[np.ndarray]:
    """Inverse of :func:`concat_tail`: carve the flat vector back into
    the tail arrays.  Loud when sizes disagree."""
    flat = np.asarray(flat).ravel()
    sizes = [int(np.prod(s, dtype=np.int64)) for s in shapes]
    if sum(sizes) != flat.size:
        raise PartitionError(
            f"flat vector has {flat.size} elements but shapes "
            f"{list(shapes)} need {sum(sizes)}"
        )
    out: List[np.ndarray] = []
    lo = 0
    for shape, size in zip(shapes, sizes):
        out.append(flat[lo : lo + size].reshape(shape))
        lo += size
    return out


def slice_reply(
    arrays: Sequence[np.ndarray], part: GradPartition
) -> List[np.ndarray]:
    """Server-side scatter: ``[head, tail-slice]`` for one partition.

    The head (array 0) rides whole; the tail is flat-concatenated and
    sliced to the partition's element range.  ``part.total`` must match
    the actual flat size — a driver/node shape disagreement fails here,
    loudly, before any bytes move."""
    part.validate()
    _layout, total, _dtype = tail_layout(arrays)
    if part.total != total:
        raise PartitionError(
            f"partition total {part.total} != reply tail size {total} "
            "(driver/node shape disagreement)"
        )
    flat = concat_tail(arrays)
    return [
        np.asarray(arrays[0]),
        flat[part.offset : part.offset + part.length],
    ]


def reduce_replies(
    replies: Sequence[Sequence[np.ndarray]],
) -> List[np.ndarray]:
    """Partial reduction of a window: elementwise sum of item replies.

    Every reply must agree in arity, shapes, and dtypes — a
    disagreement means the window mixed incompatible computes and a
    sum would be silently wrong, so it raises :class:`PartitionError`
    instead.  Returns ``[head_sum, *tail_sums]`` with the original
    array shapes (slicing to partitions is the caller's move)."""
    if not replies:
        raise PartitionError("cannot reduce an empty window")
    first = [np.asarray(a) for a in replies[0]]
    if not first:
        raise PartitionError("cannot reduce empty replies")
    acc = [a.copy() for a in first]
    for k, reply in enumerate(replies[1:], start=1):
        if len(reply) != len(acc):
            raise PartitionError(
                f"window item {k} replied {len(reply)} arrays, item 0 "
                f"replied {len(acc)} — refusing a ragged reduction"
            )
        for j, a in enumerate(reply):
            a = np.asarray(a)
            if a.shape != acc[j].shape or a.dtype != acc[j].dtype:
                raise PartitionError(
                    f"window item {k} array {j} is "
                    f"{a.dtype}{a.shape}, item 0's is "
                    f"{acc[j].dtype}{acc[j].shape} — refusing a "
                    "silently-casting reduction"
                )
            acc[j] += a
    return acc


# ---------------------------------------------------------------------------
# tree aggregation: the mid-tier node compute
# ---------------------------------------------------------------------------


def make_aggregator_compute(
    child_client: object, *, window: int = 8
) -> "Callable[..., List[np.ndarray]]":
    """The MID-TIER node of a tree aggregation: a compute for
    ``serve_tcp_once``/``serve_shm`` that forwards work to a child
    client (a pinned transport client or a whole
    :class:`~.pooled_client.PooledArraysClient` over the next tier
    down).

    Two lanes, matching the server dispatch:

    - plain/batched frames forward item-by-item
      (``child_client.evaluate``) — the aggregator is transparent for
      non-reduced traffic;
    - a REDUCE window hands the whole item list to the ``.reduce``
      attribute, which forwards it as ONE reduced child window
      (``child_client.evaluate_reduced``) and returns the summed
      ``[head, flat]`` — so a K-ary tree of aggregators reduces
      gradients with O(log N) depth in pool width, each tier's
      upstream link carrying ONE partial sum instead of its subtree's
      every reply (the fan-in story).

    Child failures surface as the child client's own loud
    classifications (transport errors re-queue in the child pool;
    deterministic errors ride in-band up the tree)."""

    def compute(*arrays: np.ndarray) -> List[np.ndarray]:
        return list(child_client.evaluate(*arrays))  # type: ignore[attr-defined]

    def reduce(windows: Sequence[Sequence[np.ndarray]]) -> List[np.ndarray]:
        return list(
            child_client.evaluate_reduced(  # type: ignore[attr-defined]
                windows, window=window
            )
        )

    compute.reduce = reduce  # type: ignore[attr-defined]
    return compute


# ---------------------------------------------------------------------------
# driver-side reassembly
# ---------------------------------------------------------------------------


class _BufferPool:
    """Reassembly buffers keyed by (total, dtype), reused across calls
    — the pin-cache posture applied to the driver's gather side:
    a hot reduce loop reassembles into the same pages every step
    instead of allocating a fresh gradient-sized buffer per call.
    Bounded and lock-guarded; buffers are handed out exclusively and
    returned on the next request for the same key."""

    def __init__(self, max_entries: int = 8) -> None:
        self._max = max_entries
        self._lock = threading.Lock()
        self._free: Dict[Tuple[int, str], np.ndarray] = {}

    def take(self, total: int, dtype: np.dtype) -> np.ndarray:
        key = (int(total), np.dtype(dtype).str)
        with self._lock:
            buf = self._free.pop(key, None)
        if buf is None:
            buf = np.empty(total, dtype)
        return buf

    def give(self, buf: np.ndarray) -> None:
        key = (int(buf.size), buf.dtype.str)
        with self._lock:
            if len(self._free) < self._max:
                self._free[key] = buf


_REASSEMBLY_BUFFERS = _BufferPool()


def shard_label(part: GradPartition, iuid: Optional[str] = None) -> str:
    """The shard identity refusal messages carry:
    the full DECLARED geometry plus — when the transport has one — the
    reply item's wire identity, so a sharded-update refusal names WHICH
    replica's slice broke the reassembly, not just the failure class."""
    label = (
        f"shard {part.index}/{part.count} [declared offset={part.offset}"
        f" length={part.length} total={part.total}"
    )
    if iuid is not None:
        label += f" iuid={iuid}"
    return label + "]"


class Reassembler:
    """Collect partition-indexed slices back into one flat vector.

    The loud half of the scatter mechanism: every ``add`` validates the
    slice against the declared geometry and every anomaly — duplicate
    index, overlapping or out-of-bounds range, wrong slice length,
    disagreeing ``count``/``total``, dtype drift — raises
    :class:`PartitionError` immediately.  ``result()`` raises while any
    element of ``[0, total)`` is uncovered, so a dropped shard can
    never yield a silent partial gradient.

    ``reuse_buffers=True`` draws the flat buffer from a small process
    pool keyed by (total, dtype) and recycles it when the NEXT
    reassembly of the same geometry starts — callers that retain the
    result must copy (the fed executors do; ``result(copy=True)`` is
    the safe default)."""

    def __init__(
        self,
        total: int,
        count: int,
        dtype: np.dtype = np.dtype(np.float64),
        *,
        reuse_buffers: bool = True,
    ) -> None:
        if total < 0 or count < 1:
            raise PartitionError(
                f"bad reassembly geometry total={total} count={count}"
            )
        self.total = int(total)
        self.count = int(count)
        self.dtype = np.dtype(dtype)
        self._reuse = reuse_buffers
        self._buf = (
            _REASSEMBLY_BUFFERS.take(self.total, self.dtype)
            if reuse_buffers
            else np.empty(self.total, self.dtype)
        )
        self._seen: Dict[int, Tuple[int, int]] = {}
        self._iuids: Dict[int, Optional[str]] = {}
        self._covered = 0

    def add(
        self,
        part: GradPartition,
        flat: np.ndarray,
        *,
        iuid: Optional[str] = None,
    ) -> None:
        """Validate and place one slice.  ``iuid`` is the reply item's
        wire identity when the transport carries one — it rides into
        every refusal via :func:`shard_label` so the error names the
        offending replica's slice, not just the failure class."""
        try:
            self._add_checked(part, flat, iuid)
        except PartitionError:
            PARTITION_SHARDS.labels(outcome="error").inc()
            raise
        PARTITION_SHARDS.labels(outcome="ok").inc()

    def _add_checked(
        self,
        part: GradPartition,
        flat: np.ndarray,
        iuid: Optional[str] = None,
    ) -> None:
        part.validate()
        who = shard_label(part, iuid)
        if part.count != self.count or part.total != self.total:
            raise PartitionError(
                f"{who}: geometry ({part.count}, {part.total}) does not "
                f"match the reassembly ({self.count}, {self.total})"
            )
        if part.index in self._seen:
            first = self._iuids.get(part.index)
            raise PartitionError(
                f"duplicate {who}: index already covered "
                f"{self._seen[part.index]}"
                + (f" by iuid={first}" if first is not None else "")
            )
        flat = np.asarray(flat).ravel()
        if flat.size != part.length:
            raise PartitionError(
                f"{who} carries {flat.size} elements but declares "
                f"length {part.length}"
            )
        if flat.size and flat.dtype != self.dtype:
            raise PartitionError(
                f"{who} dtype {flat.dtype} != reassembly dtype "
                f"{self.dtype} — refusing a silent cast"
            )
        for idx, (lo, hi) in self._seen.items():
            if part.offset < hi and lo < part.offset + part.length:
                other = self._iuids.get(idx)
                raise PartitionError(
                    f"{who} range [{part.offset}, "
                    f"{part.offset + part.length}) overlaps shard "
                    f"{idx}'s [{lo}, {hi})"
                    + (f" (iuid={other})" if other is not None else "")
                )
        self._buf[part.offset : part.offset + part.length] = flat
        self._seen[part.index] = (
            part.offset,
            part.offset + part.length,
        )
        self._iuids[part.index] = iuid
        self._covered += part.length

    @property
    def missing(self) -> List[int]:
        """Shard indices not yet added (vs the declared count)."""
        return [i for i in range(self.count) if i not in self._seen]

    def result(self, *, copy: bool = True) -> np.ndarray:
        if self._covered != self.total or len(self._seen) != self.count:
            raise PartitionError(
                f"incomplete reassembly: {self._covered}/{self.total} "
                f"elements from {len(self._seen)}/{self.count} shards "
                f"(missing indices {self.missing}) — refusing a "
                "silent partial gradient"
            )
        out = self._buf.copy() if copy else self._buf
        if self._reuse and copy:
            _REASSEMBLY_BUFFERS.give(self._buf)
        return out

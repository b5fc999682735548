"""Binary ndarray wire format for the host-federation transport.

Re-design of the reference's ``npproto`` protobuf wire format
(reference: npproto/__init__.py:13-22, npproto/utils.py:9-24,
protobufs/npproto/ndarray.proto): any buffer-protocol NumPy array
round-trips as raw data bytes + dtype string + shape.  Differences from
the reference, on purpose:

- Simple length-prefixed framing instead of protobuf — no codegen, no
  betterproto dependency, and the payload bytes are written with a
  single memcpy per array.
- Non-contiguous arrays are made contiguous at encode time instead of
  shipping strides (the reference serializes strides; every consumer
  immediately reshapes anyway, and contiguous payloads are what the
  device wants).
- ``dtype=object`` is rejected loudly.  The reference's README admits
  object dtype "doesn't work" while its test serializes pointers that
  only round-trip in-process (reference: README.md:30,
  test_npproto.py:20) — here it is a hard error.

A message frames N arrays plus a 16-byte correlation uuid (parity with
the reference's uuid field, reference: rpc.py:37-39), an optional
error string, an optional 16-byte telemetry trace id (flag bit 2)
that correlates driver-side and node-side spans of the same call
(:mod:`..telemetry.spans`), and an optional trailing SPANS block (flag
bit 4): a JSON list of completed node-side span trees, piggybacked on
REPLIES so the node's half of a correlated trace travels home on the
very RPC it describes (:mod:`..telemetry.reunion`).  The spans block
sits at the TAIL — after the arrays — so a server can attach it to an
already-encoded reply with :func:`append_spans` (one flag-byte patch +
one append) instead of re-encoding array payloads.  Absent all three,
the frame is byte-identical to the pre-telemetry format; PRESENT, they
require a decoder that knows the flag — npwire peers all live in this
repo and ship in lockstep (a pre-telemetry build would reject a
flagged frame as corrupt, which is this format's loud-failure
contract, not silent skipping).  Cross-implementation forward
compatibility is the npproto codec's job (its field-15 trace id and
field-16 spans ARE skipped by unknown-field rules).

BATCH frames (flag bit 8): one wire message carrying K complete
sub-frames, so a pipelined window pays one transport message and one
syscall each way instead of K (:mod:`.batching` is the server half).
The outer header is the SAME layout as a plain frame — the count field
holds ``n_items`` instead of ``n_arrays`` and the body is
``item_len(u32) + item_bytes`` per item, each item a full npwire frame
with its own uuid/arrays/error.  Error isolation is per item: a
poisoned request fails only its own reply frame.  The outer uuid
correlates the window; the outer trace id (flag 2) is the
AUTHORITATIVE one for the node's span context (items are complete
frames and may redundantly carry their own trace block — this repo's
clients reuse their per-call encodings — which decoders simply
consume and drop); the spans tail (flag 4) attaches to the outer
frame exactly as on a plain reply.  A batch frame is only
ever sent to a peer that advertised the capability (GetLoad ``batch``
field / the TCP probe), so the loud :class:`WireError` a pre-batch
decoder raises on flag 8 is a negotiation bug surfacing, not a
compatibility hazard.  Plain frames are byte-identical with or without
this feature compiled in.

DEADLINE frames (flag bit 16): an 8-byte little-endian float64 after
the trace block carrying the request's REMAINING deadline budget in
seconds (relative, never an absolute timestamp — peer clocks are not
ours; :mod:`.deadline` is the contextvar source and the enforcement
vocabulary).  Servers enforce it at admission: an expired budget is
answered with a :data:`~.deadline.DEADLINE_ERROR_PREFIX` in-band error
and never computed.  Absent a bound deadline the flag stays clear and
the frame is byte-identical to the pre-deadline wire (property-tested).

TENANT frames (flag bit 32): a u16-length-prefixed utf8 tenant id
after the deadline block — the per-tenant identity the gateway tier
(:mod:`..gateway`) meters quotas and weighted-fair service by.  Like
the deadline, it is OPTIONAL metadata: absent a tenant the flag stays
clear and the frame is byte-identical to the pre-tenant wire
(property-tested); servers that do not meter tenancy consume and drop
the block.  :func:`peek_tenant` is the admission-side reader (the
gateway classifies BEFORE paying any decode).

Layout (little-endian):
  message: MAGIC(4s) version(u8) flags(u8) uuid(16s) n_arrays(u32)
           [flags&1 error: len(u32) utf8]
           [flags&2 trace: trace_id(16s)]
           [flags&16 deadline: budget_s(f64)]
           [flags&32 tenant: len(u16) utf8]
           [flags&64 partition: index(u32) count(u32) offset(u64)
                     length(u64) total(u64)]
           [flags&128 version: step_version(u64)]  then per array:
  array:   dtype_len(u16) dtype_str shape_ndim(u8) shape(u64*ndim)
           data_len(u64) data_bytes
  tail:    [flags&4 spans: len(u32) utf8-JSON]
  batch:   same header with flags&8; count = n_items; body is
           item_len(u32) + item_bytes per item (each a full frame);
           same optional error/trace/deadline/tenant blocks and
           spans tail
"""

from __future__ import annotations

import itertools
import json
import os
import struct
import threading
import uuid as uuid_mod
from functools import lru_cache
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
from numpy.lib.format import descr_to_dtype, dtype_to_descr

from ..faultinject import runtime as _fi
from ..telemetry import metrics as _metrics

#: One buffer of a scatter/gather frame: header/metadata bytes, or a
#: zero-copy view of a source array's payload.
Buffer = Union[bytes, memoryview]

#: Payload bytes the transport stack memcpy's, by lane and stage — the
#: instrument behind docs/performance.md's "Zero-copy budget" table.
#: Stages: ``encode_layout`` (non-contiguous input normalized),
#: ``encode_join`` (payload flattened into one contiguous frame),
#: ``decode_copy`` (frame bytes copied out into result arrays),
#: ``arena_write`` (bytes written into a shared-memory arena slot —
#: the shm lane's single copy).  Zero-copy paths (sendmsg vectors,
#: ``copy=False`` decode, arena read views) inc nothing.
WIRE_BYTES_COPIED = _metrics.counter(
    "pftpu_wire_bytes_copied_total",
    "Payload bytes memcpy'd by the transport stack, by lane and stage",
    ("lane", "stage"),
)
_LAYOUT_COPIED = WIRE_BYTES_COPIED.labels(lane="npwire", stage="encode_layout")
_JOIN_COPIED = WIRE_BYTES_COPIED.labels(lane="npwire", stage="encode_join")
_DECODE_COPIED = WIRE_BYTES_COPIED.labels(lane="npwire", stage="decode_copy")

MAGIC = b"NPW1"
_FLAG_ERROR = 1
_FLAG_TRACE = 2
_FLAG_SPANS = 4
_FLAG_BATCH = 8
_FLAG_DEADLINE = 16
_FLAG_TENANT = 32
_FLAG_PARTITION = 64
_FLAG_VERSION = 128
# Every known flag bit, mirrored from service/wire_registry.py (the
# declared source; the graftlint wire-registry rule cross-checks the
# two).  Decoders REJECT any bit outside this mask: an unknown flag
# means the frame carries blocks this build cannot place, and parsing
# around them would be silent mis-parsing — the exact version-skew
# hazard the module docstring's loud-failure contract forbids.
_KNOWN_FLAGS = (
    _FLAG_ERROR | _FLAG_TRACE | _FLAG_SPANS | _FLAG_BATCH
    | _FLAG_DEADLINE | _FLAG_TENANT | _FLAG_PARTITION | _FLAG_VERSION
)
# flags byte offset in the header ("<4sBB...": magic, version, flags)
_FLAGS_OFF = 5
# Header and partition-block structs, preserialized at module level —
# a struct.pack/calcsize with a literal format re-parses the format
# string per call in the hot send path (swept from the client lanes
# too).
_HEADER_STRUCT = struct.Struct("<4sBB16sI")
_HEADER_SIZE = _HEADER_STRUCT.size
_U16 = struct.Struct("<H")
_U32 = struct.Struct("<I")
_U64 = struct.Struct("<Q")
_F64 = struct.Struct("<d")
#: The gradient-partition index block (flag bit 64):
#: index(u32) count(u32) offset(u64) length(u64) total(u64) — layout
#: declared in service/wire_registry.py PARTITION_STRUCT; the
#: semantics (head/tail slice rule, reduction, reassembly) live in
#: routing/partition.py.
_PARTITION_STRUCT = struct.Struct("<IIQQQ")
#: The step-version stamp block (flag bit 128): one u64 after the
#: partition block — layout declared in service/wire_registry.py
#: VERSION_STRUCT; the semantics (monotonic optimizer-step version,
#: stale-shard refusal) live in optim/sharded.py.  Zero is meaningful
#: (the init handshake), so presence rides the flag bit, not the value.
_VERSION_STRUCT = struct.Struct("<Q")


class WireError(ValueError):
    """Malformed or unsupported wire payload."""


# Correlation ids need per-process uniqueness, not cryptographic
# randomness — but ``uuid4()`` draws 16 bytes of real entropy, a
# getrandom(2) syscall that costs tens of microseconds on some hosts
# (measured 37 us in one container: 38% of the shm lane's hot
# path).  A random 10-byte process prefix + pid + 4-byte counter keeps
# ids unique across processes, connections, and 4 billion calls.
_UUID_PREFIX = os.urandom(10) + struct.pack("<H", os.getpid() & 0xFFFF)
_uuid_counter = itertools.count()
_uuid_lock = threading.Lock()


def _reseed_uuid_prefix() -> None:
    """Fork hook: a fork-started worker inherits the parent's prefix
    AND counter, so without reseeding every child would emit the
    parent's exact id stream — re-derive both in the child."""
    global _UUID_PREFIX, _uuid_counter
    _UUID_PREFIX = os.urandom(10) + struct.pack("<H", os.getpid() & 0xFFFF)
    _uuid_counter = itertools.count()


if hasattr(os, "register_at_fork"):  # POSIX only; spawn needs nothing
    os.register_at_fork(after_in_child=_reseed_uuid_prefix)


def fast_uuid() -> bytes:
    """A 16-byte correlation id without the per-call entropy syscall
    (module comment above).  Wire-compatible with ``uuid4().bytes`` —
    every peer treats uuids as opaque 16-byte tokens."""
    with _uuid_lock:
        n = next(_uuid_counter)
    return _UUID_PREFIX + struct.pack("<I", n & 0xFFFFFFFF)


def _check_flags(flags: int) -> None:
    """Reject undeclared flag bits loudly (loud-failure contract)."""
    unknown = flags & ~_KNOWN_FLAGS
    if unknown:
        raise WireError(
            f"unknown flag bits 0x{unknown:02x} "
            f"(known mask 0x{_KNOWN_FLAGS:02x}) — version-skewed peer? "
            "npwire peers must ship in lockstep"
        )


def _encode_tenant(tenant: str) -> bytes:
    """The tenant block (flag bit 32): u16 length + utf8 id.  Loud on
    the shapes that cannot round-trip — the empty id (absent and empty
    must stay distinguishable: absent means "no tenancy metering") and
    ids past the u16 length prefix."""
    raw = tenant.encode("utf-8")
    if not raw:
        raise WireError("tenant id must be non-empty (omit it instead)")
    if len(raw) > 0xFFFF:
        raise WireError(
            f"tenant id too long ({len(raw)} utf8 bytes > 65535)"
        )
    return struct.pack("<H", len(raw)) + raw


def _encode_partition(partition: Sequence[int]) -> bytes:
    """The partition block (flag bit 64): a 5-int sequence in
    ``wire_registry.PARTITION_FIELD_ORDER`` (index, count, offset,
    length, total — ``routing.partition.GradPartition`` is one).  Loud
    on shapes that cannot describe a shard; the SEMANTIC validation
    (plan consistency, reassembly) is routing/partition.py's."""
    try:
        index, count, offset, length, total = (
            int(v) for v in partition
        )
    except (TypeError, ValueError) as e:
        raise WireError(f"partition must be 5 ints: {e}") from None
    if not 0 <= index < count:
        raise WireError(
            f"partition index {index} outside 0..{count - 1}"
        )
    if min(offset, length, total) < 0 or offset + length > total:
        raise WireError(
            f"partition slice [{offset}, {offset + length}) cannot "
            f"cover total {total}"
        )
    try:
        return _PARTITION_STRUCT.pack(index, count, offset, length, total)
    except struct.error as e:
        raise WireError(f"partition out of wire range: {e}") from None


def _decode_partition(buf: bytes, off: int) -> Tuple[tuple, int]:
    """Parse a partition block at ``off`` -> ((5 ints), new_offset)."""
    try:
        fields = _PARTITION_STRUCT.unpack_from(buf, off)
    except struct.error as e:
        raise WireError(f"truncated partition block: {e}") from None
    return fields, off + _PARTITION_STRUCT.size


def _encode_version(version: int) -> bytes:
    """The step-version block (flag bit 128): one u64 stamp.  Loud on
    values the wire cannot carry; the SEMANTICS (monotonicity,
    stale-shard refusal) are optim/sharded.py's."""
    try:
        v = int(version)
    except (TypeError, ValueError) as e:
        raise WireError(f"version must be an int: {e}") from None
    if not 0 <= v < (1 << 64):
        raise WireError(f"version {v} outside u64 range")
    return _VERSION_STRUCT.pack(v)


def _decode_version(buf: bytes, off: int) -> Tuple[int, int]:
    """Parse a version block at ``off`` -> (version, new_offset)."""
    try:
        (version,) = _VERSION_STRUCT.unpack_from(buf, off)
    except struct.error as e:
        raise WireError(f"truncated version block: {e}") from None
    return version, off + _VERSION_STRUCT.size


def _tupleize(descr: object) -> object:
    """JSON round-trip turns descr tuples into lists; restore them
    recursively (field entries are tuples, nested shapes too)."""
    if isinstance(descr, list):
        if descr and isinstance(descr[0], (list, tuple)):
            return [tuple(_tupleize(x) for x in f) for f in descr]
        return tuple(_tupleize(x) for x in descr)
    return descr


@lru_cache(maxsize=256)
def _parse_dtype(dt_bytes: bytes) -> np.dtype:
    # Pure bytes -> dtype, cached: a window of same-typed arrays pays
    # one parse, not one per array (failures are not cached, so every
    # corrupt descriptor stays loud).
    try:
        dt_str = dt_bytes.decode("utf-8")
        if dt_str.startswith("["):
            # JSON-array descr = structured dtype; plain string otherwise.
            return descr_to_dtype(_tupleize(json.loads(dt_str)))
        return np.dtype(dt_str)
    except (ValueError, TypeError, KeyError, SyntaxError) as e:
        # ValueError covers UnicodeDecodeError and json errors too —
        # every corrupt-descriptor shape must surface as WireError.
        # SyntaxError: numpy parses some malformed dtype strings as
        # Python literals (e.g. b"08f" -> "leading zeros..."), found
        # by the descriptor fuzz — without this arm a flipped
        # dtype byte escaped the loud-failure classification.
        raise WireError(f"bad dtype descriptor {dt_bytes!r}: {e}") from None


def normalize_arrays(arrays: Sequence[np.ndarray]) -> List[np.ndarray]:
    """Layout normalization, ONCE at encode entry (shared by the
    contiguous and scatter/gather encoders): every array comes out
    C-contiguous with a wire-legal dtype, so the payload bytes are a
    straight memory image and the scatter/gather path can ship a view
    instead of ``a.tobytes()``.  Fortran-ordered and sliced inputs pay
    exactly one copy here (counted under ``encode_layout``);
    already-contiguous inputs pay none."""
    out: List[np.ndarray] = []
    for a in arrays:
        a = np.asarray(a)
        if a.dtype == object:
            raise WireError(
                "dtype=object arrays cannot cross the wire (they serialize "
                "pointers); use a structured or numeric dtype"
            )
        if not a.flags["C_CONTIGUOUS"]:
            # NB: np.ascontiguousarray promotes 0-d to 1-d, so only call
            # it when actually needed (0-d is always contiguous).
            a = np.ascontiguousarray(a)
            _LAYOUT_COPIED.inc(a.nbytes)
        out.append(a)
    return out


def payload_view(a: np.ndarray) -> Buffer:
    """A zero-copy byte view of a (C-contiguous) array's payload, or a
    ``tobytes()`` copy for the few dtypes that refuse the buffer
    protocol (datetime64/timedelta64) — counted as a layout copy."""
    try:
        mv = memoryview(a)
        return mv if mv.format == "B" and mv.ndim == 1 else mv.cast("B")
    except (ValueError, TypeError, BufferError):
        data = a.tobytes()
        _LAYOUT_COPIED.inc(len(data))
        return data


@lru_cache(maxsize=256)
def _encode_dtype(dtype: np.dtype) -> bytes:
    # dtype_to_descr/descr_to_dtype are the official npy-format
    # helpers: plain dtypes serialize as their ".str" (e.g. "<f4"),
    # structured dtypes as their field descr (JSON-encoded here) —
    # ".str" alone collapses records to opaque void ("|V15").
    # Cached: dtypes are hashable and a workload reuses a handful.
    descr = dtype_to_descr(dtype)
    return (
        descr.encode("ascii")
        if isinstance(descr, str)
        else json.dumps(descr).encode("utf-8")
    )


def encode_arrays_sg(
    arrays: Sequence[np.ndarray],
    *,
    uuid: Optional[bytes] = None,
    error: Optional[str] = None,
    trace_id: Optional[bytes] = None,
    deadline_s: Optional[float] = None,
    tenant: Optional[str] = None,
    partition: Optional[Sequence[int]] = None,
    version: Optional[int] = None,
) -> List[Buffer]:
    """Scatter/gather encode: the same frame as :func:`encode_arrays`
    as a BUFFER VECTOR — header/metadata ``bytes`` interleaved with
    zero-copy ``memoryview`` s of the (normalized) source arrays'
    payloads.  ``b"".join(vector)`` is byte-identical to the
    contiguous encoder's output; a vectored send
    (``socket.sendmsg``, :func:`..service.tcp._sendmsg_all`) skips
    that join entirely, so array bytes go source → kernel with no
    intermediate frame copy.  The caller must keep the source arrays
    alive until the vector is consumed (the views borrow their
    memory).  With a fault plan installed the vector collapses to one
    filtered contiguous buffer — byte-lane chaos needs the whole
    frame in hand."""
    if uuid is None:
        uuid = uuid_mod.uuid4().bytes
    if len(uuid) != 16:
        raise WireError(f"uuid must be 16 bytes, got {len(uuid)}")
    arrays = normalize_arrays(arrays)
    flags = 0
    if error is not None:
        flags |= _FLAG_ERROR
    if trace_id is not None:
        if len(trace_id) != 16:
            raise WireError(
                f"trace_id must be 16 bytes, got {len(trace_id)}"
            )
        flags |= _FLAG_TRACE
    if deadline_s is not None:
        flags |= _FLAG_DEADLINE
    tenant_block = None
    if tenant is not None:
        tenant_block = _encode_tenant(tenant)
        flags |= _FLAG_TENANT
    partition_block = None
    if partition is not None:
        partition_block = _encode_partition(partition)
        flags |= _FLAG_PARTITION
    version_block = None
    if version is not None:
        version_block = _encode_version(version)
        flags |= _FLAG_VERSION
    parts: List[Buffer] = [
        _HEADER_STRUCT.pack(MAGIC, 1, flags, uuid, len(arrays))
    ]
    if error is not None:
        err = error.encode("utf-8")
        parts.append(_U32.pack(len(err)))
        parts.append(err)
    if trace_id is not None:
        parts.append(trace_id)
    if deadline_s is not None:
        parts.append(_F64.pack(float(deadline_s)))
    if tenant_block is not None:
        parts.append(tenant_block)
    if partition_block is not None:
        parts.append(partition_block)
    if version_block is not None:
        parts.append(version_block)
    for a in arrays:
        dt = _encode_dtype(a.dtype)
        parts.append(_U16.pack(len(dt)))
        parts.append(dt)
        parts.append(struct.pack("<B", a.ndim))
        parts.append(struct.pack(f"<{a.ndim}Q", *a.shape))
        parts.append(_U64.pack(a.nbytes))
        if a.nbytes:
            parts.append(payload_view(a))
    if _fi.active_plan is not None:  # chaos seam (faultinject.runtime)
        return [_fi.filter_bytes("npwire.encode", b"".join(parts))]
    return parts


def sg_nbytes(parts: Sequence[Buffer]) -> int:
    """Total byte length of a scatter/gather buffer vector."""
    return sum(
        p.nbytes if isinstance(p, memoryview) else len(p) for p in parts
    )


def encode_arrays(
    arrays: Sequence[np.ndarray],
    *,
    uuid: Optional[bytes] = None,
    error: Optional[str] = None,
    trace_id: Optional[bytes] = None,
    deadline_s: Optional[float] = None,
    tenant: Optional[str] = None,
    partition: Optional[Sequence[int]] = None,
    version: Optional[int] = None,
) -> bytes:
    """Encode arrays (+uuid, +optional error/trace_id/deadline_s/
    tenant/partition/version) into one framed message.  ``trace_id``
    (16 bytes) is the telemetry correlation id; ``deadline_s`` the
    remaining deadline budget (flag bit 16); ``tenant`` the gateway
    tier's per-tenant identity (flag bit 32); ``partition`` the
    gradient-partition index block (flag bit 64, a 5-int sequence —
    routing/partition.py owns the semantics); ``version`` the u64
    step-version stamp (flag bit 128 — optim/sharded.py owns the
    semantics; zero is a meaningful stamp); every optional ``None``
    emits the exact pre-feature frame.  The contiguous form of
    :func:`encode_arrays_sg` — one flattening join, counted under the
    ``encode_join`` copy stage."""
    parts = encode_arrays_sg(
        arrays, uuid=uuid, error=error, trace_id=trace_id,
        deadline_s=deadline_s, tenant=tenant, partition=partition,
        version=version,
    )
    if len(parts) == 1 and isinstance(parts[0], bytes):
        return parts[0]  # chaos path: already joined and filtered
    _JOIN_COPIED.inc(
        sum(p.nbytes for p in parts if isinstance(p, memoryview))
    )
    return b"".join(parts)


def encode_batch(
    items: Sequence[bytes],
    *,
    uuid: Optional[bytes] = None,
    error: Optional[str] = None,
    trace_id: Optional[bytes] = None,
    deadline_s: Optional[float] = None,
    tenant: Optional[str] = None,
    partition: Optional[Sequence[int]] = None,
    version: Optional[int] = None,
) -> bytes:
    """Frame K already-encoded npwire messages as ONE batch message
    (flag bit 8).  ``items`` are complete frames — each keeps its own
    uuid/arrays/error, so replies stay correlated and error-isolated
    per item.  The outer ``uuid`` correlates the window as a whole;
    the outer ``trace_id`` is the authoritative span-context id for
    the batch (an item's own trace block, if present, is consumed and
    dropped by the server); a zero-item batch is legal — it is the
    TCP capability probe.  An OUTER ``partition`` block (flag bit 64)
    turns the window into a REDUCE request: the server sums its items'
    replies and answers ``count`` partition-indexed slices
    (routing/partition.py owns the rule; tcp.py/shm.py serve it).
    The result accepts :func:`append_spans` like any reply frame."""
    if uuid is None:
        uuid = uuid_mod.uuid4().bytes
    if len(uuid) != 16:
        raise WireError(f"uuid must be 16 bytes, got {len(uuid)}")
    flags = _FLAG_BATCH
    if error is not None:
        flags |= _FLAG_ERROR
    if trace_id is not None:
        if len(trace_id) != 16:
            raise WireError(
                f"trace_id must be 16 bytes, got {len(trace_id)}"
            )
        flags |= _FLAG_TRACE
    if deadline_s is not None:
        flags |= _FLAG_DEADLINE
    tenant_block = None
    if tenant is not None:
        tenant_block = _encode_tenant(tenant)
        flags |= _FLAG_TENANT
    partition_block = None
    if partition is not None:
        partition_block = _encode_partition(partition)
        flags |= _FLAG_PARTITION
    version_block = None
    if version is not None:
        version_block = _encode_version(version)
        flags |= _FLAG_VERSION
    parts: List[bytes] = [
        _HEADER_STRUCT.pack(MAGIC, 1, flags, uuid, len(items))
    ]
    if error is not None:
        err = error.encode("utf-8")
        parts.append(_U32.pack(len(err)))
        parts.append(err)
    if trace_id is not None:
        parts.append(trace_id)
    if deadline_s is not None:
        parts.append(_F64.pack(float(deadline_s)))
    if tenant_block is not None:
        parts.append(tenant_block)
    if partition_block is not None:
        parts.append(partition_block)
    if version_block is not None:
        parts.append(version_block)
    for item in items:
        if item[:4] != MAGIC:
            raise WireError("batch items must be complete npwire frames")
        parts.append(_U32.pack(len(item)))
        parts.append(item)
    out = b"".join(parts)
    if _fi.active_plan is not None:  # chaos seam (faultinject.runtime)
        out = _fi.filter_bytes("npwire.encode_batch", out)
    return out


def is_batch_frame(buf: bytes) -> bool:
    """Whether ``buf`` leads with an npwire batch header (flag bit 8).
    A cheap dispatch predicate — full validation happens in
    :func:`decode_batch`."""
    return (
        len(buf) > _FLAGS_OFF
        and buf[:4] == MAGIC
        and bool(buf[_FLAGS_OFF] & _FLAG_BATCH)
    )


def frame_uuid(buf: bytes) -> bytes:
    """The 16-byte correlation uuid at its fixed header offset — the
    cheap read admission rejections need to answer in-band without
    paying a full decode.  Raises :class:`WireError` on a frame too
    short to carry one."""
    if len(buf) < 22 or buf[:4] != MAGIC:
        raise WireError("not an npwire frame")
    return buf[6:22]


def peek_deadline(buf: bytes) -> Optional[float]:
    """The frame's remaining-deadline budget (flag bit 16) in seconds,
    or ``None`` when the flag is clear — WITHOUT decoding arrays.  The
    server-side admission reader: an expired budget must be rejected
    before any decode/compute cost is paid.  Walks only the fixed-
    offset blocks in front of the payload (error, trace), so the cost
    is a handful of bounds checks.  Raises :class:`WireError` on a
    frame whose leading blocks are truncated (the full decoder would
    reject it identically)."""
    try:
        magic, version, flags = struct.unpack_from("<4sBB", buf, 0)
    except struct.error as e:
        raise WireError(f"truncated header: {e}") from None
    if magic != MAGIC:
        raise WireError(f"bad magic {magic!r}")
    _check_flags(flags)
    if not flags & _FLAG_DEADLINE:
        return None
    off = _HEADER_SIZE
    if flags & _FLAG_ERROR:
        try:
            (elen,) = struct.unpack_from("<I", buf, off)
        except struct.error as e:
            raise WireError(f"truncated error block: {e}") from None
        off += 4 + elen
    if flags & _FLAG_TRACE:
        off += 16
    try:
        (budget,) = struct.unpack_from("<d", buf, off)
    except struct.error as e:
        raise WireError(f"truncated deadline block: {e}") from None
    return budget


def peek_tenant(buf: bytes) -> Optional[str]:
    """The frame's tenant id (flag bit 32), or ``None`` when the flag
    is clear — WITHOUT decoding arrays.  The gateway's admission
    reader: quota and fair-queue classification happen before any
    decode cost is paid (the :func:`peek_deadline` posture).  Raises
    :class:`WireError` on a frame whose leading blocks are truncated
    (the full decoder would reject it identically)."""
    try:
        magic, version, flags = struct.unpack_from("<4sBB", buf, 0)
    except struct.error as e:
        raise WireError(f"truncated header: {e}") from None
    if magic != MAGIC:
        raise WireError(f"bad magic {magic!r}")
    _check_flags(flags)
    if not flags & _FLAG_TENANT:
        return None
    off = _HEADER_SIZE
    if flags & _FLAG_ERROR:
        try:
            (elen,) = struct.unpack_from("<I", buf, off)
        except struct.error as e:
            raise WireError(f"truncated error block: {e}") from None
        off += 4 + elen
    if flags & _FLAG_TRACE:
        off += 16
    if flags & _FLAG_DEADLINE:
        off += 8
    try:
        (tlen,) = struct.unpack_from("<H", buf, off)
        off += 2
        if off + tlen > len(buf):
            raise WireError("truncated tenant block")
        return buf[off : off + tlen].decode("utf-8")
    except (struct.error, UnicodeDecodeError) as e:
        raise WireError(f"corrupt tenant block: {e}") from None


def peek_partition(buf: bytes) -> Optional[tuple]:
    """The frame's partition block (flag bit 64) as a 5-int tuple, or
    ``None`` when the flag is clear — WITHOUT decoding arrays, and for
    BOTH plain and batch frames (the block sits in front of the body
    either way).  The server-side dispatch reader: a reduce window
    must be recognized before items are decoded.  Raises
    :class:`WireError` on a frame whose leading blocks are truncated
    (the full decoder would reject it identically)."""
    try:
        magic, version, flags = struct.unpack_from("<4sBB", buf, 0)
    except struct.error as e:
        raise WireError(f"truncated header: {e}") from None
    if magic != MAGIC:
        raise WireError(f"bad magic {magic!r}")
    _check_flags(flags)
    if not flags & _FLAG_PARTITION:
        return None
    off = _HEADER_SIZE
    if flags & _FLAG_ERROR:
        try:
            (elen,) = struct.unpack_from("<I", buf, off)
        except struct.error as e:
            raise WireError(f"truncated error block: {e}") from None
        off += 4 + elen
    if flags & _FLAG_TRACE:
        off += 16
    if flags & _FLAG_DEADLINE:
        off += 8
    if flags & _FLAG_TENANT:
        off = _skip_tenant_block(buf, off)
    part, _off = _decode_partition(buf, off)
    return part


def peek_version(buf: bytes) -> Optional[int]:
    """The frame's step-version stamp (flag bit 128) as an int, or
    ``None`` when the flag is clear — WITHOUT decoding arrays, and for
    BOTH plain and batch frames.  The server-side dispatch reader: a
    versioned update/refresh request must be recognized before arrays
    are decoded (optim/sharded.py owns the semantics; zero is a
    meaningful stamp, which is why absence is ``None``, never 0).
    Raises :class:`WireError` on a frame whose leading blocks are
    truncated (the full decoder would reject it identically)."""
    try:
        magic, version, flags = struct.unpack_from("<4sBB", buf, 0)
    except struct.error as e:
        raise WireError(f"truncated header: {e}") from None
    if magic != MAGIC:
        raise WireError(f"bad magic {magic!r}")
    _check_flags(flags)
    if not flags & _FLAG_VERSION:
        return None
    off = _HEADER_SIZE
    if flags & _FLAG_ERROR:
        try:
            (elen,) = struct.unpack_from("<I", buf, off)
        except struct.error as e:
            raise WireError(f"truncated error block: {e}") from None
        off += 4 + elen
    if flags & _FLAG_TRACE:
        off += 16
    if flags & _FLAG_DEADLINE:
        off += 8
    if flags & _FLAG_TENANT:
        off = _skip_tenant_block(buf, off)
    if flags & _FLAG_PARTITION:
        off += _PARTITION_STRUCT.size
    stamp, _off = _decode_version(buf, off)
    return stamp


def _skip_tenant_block(buf: bytes, off: int) -> int:
    """Consume a tenant block at ``off`` (decoders keep their
    historical tuple shapes; :func:`peek_tenant` is the reader)."""
    try:
        (tlen,) = struct.unpack_from("<H", buf, off)
    except struct.error as e:
        raise WireError(f"truncated tenant block: {e}") from None
    off += 2
    if off + tlen > len(buf):
        raise WireError("truncated tenant block")
    return off + tlen


def decode_batch(
    buf: bytes,
) -> Tuple[List[bytes], bytes, Optional[str], Optional[bytes], Optional[list]]:
    """Decode a batch message -> (items, uuid, error, trace_id, spans).
    ``items`` are the K framed sub-messages, still encoded — decode
    each with :func:`decode_arrays_all` (they may individually carry
    error blocks: per-item failure isolation).  An outer partition
    block (flag bit 64) is consumed and dropped — the reduce-window
    server path reads it with :func:`decode_batch_part`."""
    items, uuid, error, trace_id, spans, _part, _ver = decode_batch_part(
        buf
    )
    return items, uuid, error, trace_id, spans


def decode_batch_part(
    buf: bytes,
) -> Tuple[
    List[bytes],
    bytes,
    Optional[str],
    Optional[bytes],
    Optional[list],
    Optional[tuple],
    Optional[int],
]:
    """Full batch decode -> (items, uuid, error, trace_id, spans,
    partition, version) where ``partition`` is the outer partition
    block's 5-int tuple (flag bit 64; ``None`` when clear) — the
    reduce-window request/reply marker (routing/partition.py) — and
    ``version`` the u64 step-version stamp (flag bit 128; ``None``
    when clear — zero is a meaningful stamp; optim/sharded.py)."""
    if _fi.active_plan is not None:  # chaos seam (faultinject.runtime)
        buf = _fi.filter_bytes("npwire.decode_batch", buf)
    try:
        magic, version, flags, uuid, n = _HEADER_STRUCT.unpack_from(buf, 0)
    except struct.error as e:
        raise WireError(f"truncated header: {e}") from None
    if magic != MAGIC:
        raise WireError(f"bad magic {magic!r}")
    if version != 1:
        raise WireError(f"unsupported version {version}")
    _check_flags(flags)
    if not flags & _FLAG_BATCH:
        raise WireError("not a batch frame (flag bit 8 unset)")
    off = _HEADER_SIZE
    error = None
    if flags & _FLAG_ERROR:
        try:
            (elen,) = struct.unpack_from("<I", buf, off)
            off += 4
            if off + elen > len(buf):
                raise WireError("truncated error block")
            error = buf[off : off + elen].decode("utf-8")
            off += elen
        except (struct.error, UnicodeDecodeError) as e:
            raise WireError(f"truncated error block: {e}") from None
    trace_id = None
    if flags & _FLAG_TRACE:
        if off + 16 > len(buf):
            raise WireError("truncated trace block")
        trace_id = buf[off : off + 16]
        off += 16
    if flags & _FLAG_DEADLINE:
        # Consumed and dropped here: admission reads it pre-decode via
        # peek_deadline (the enforcement point), so the tuple shapes
        # every existing caller depends on stay stable.
        if off + 8 > len(buf):
            raise WireError("truncated deadline block")
        off += 8
    if flags & _FLAG_TENANT:
        # Consumed and dropped (peek_tenant is the gateway-side reader).
        off = _skip_tenant_block(buf, off)
    partition = None
    if flags & _FLAG_PARTITION:
        partition, off = _decode_partition(buf, off)
    step_version = None
    if flags & _FLAG_VERSION:
        step_version, off = _decode_version(buf, off)
    items: List[bytes] = []
    for _ in range(n):
        try:
            (ilen,) = struct.unpack_from("<I", buf, off)
        except struct.error as e:
            raise WireError(f"truncated batch item length: {e}") from None
        off += 4
        item = buf[off : off + ilen]
        if len(item) != ilen:
            raise WireError("truncated batch item")
        if item[:4] != MAGIC:
            raise WireError("batch item is not an npwire frame")
        items.append(item)
        off += ilen
    spans = None
    if flags & _FLAG_SPANS:
        try:
            (slen,) = struct.unpack_from("<I", buf, off)
            off += 4
            if off + slen > len(buf):
                raise WireError("truncated spans block")
            spans = json.loads(buf[off : off + slen].decode("utf-8"))
            off += slen
        except (struct.error, UnicodeDecodeError, ValueError) as e:
            raise WireError(f"corrupt spans block: {e}") from None
        if not isinstance(spans, list):
            raise WireError(
                f"spans block must be a JSON list, got {type(spans).__name__}"
            )
    return items, uuid, error, trace_id, spans, partition, step_version


def append_spans(frame: bytes, spans: Sequence[dict]) -> bytes:
    """Attach a spans tail to an ALREADY-ENCODED frame (flag bit 4).

    The node-side piggyback path: the ``node.evaluate`` span tree only
    finishes after the reply's arrays are encoded (encoding is itself a
    timed stage), so the tree is appended post-hoc — one flag-byte
    patch plus one tail append, no array re-encode.  ``spans`` is a
    list of JSON-friendly span-tree dicts (``Span.to_dict`` shape).
    Raises :class:`WireError` on a frame that is not a bare header or
    already carries a spans tail."""
    if frame[:4] != MAGIC or len(frame) < _FLAGS_OFF + 1:
        raise WireError("append_spans: not an npwire frame")
    flags = frame[_FLAGS_OFF]
    if flags & _FLAG_SPANS:
        raise WireError("append_spans: frame already carries a spans tail")
    # default=str: span ATTRS are free-form user values (numpy scalars
    # included) — a non-JSON-native attr must degrade to its repr, not
    # fail the reply that carries real results.
    payload = json.dumps(list(spans), default=str).encode("utf-8")
    return (
        frame[:_FLAGS_OFF]
        + bytes([flags | _FLAG_SPANS])
        + frame[_FLAGS_OFF + 1 :]
        + struct.pack("<I", len(payload))
        + payload
    )


def decode_arrays(
    buf: bytes, *, copy: bool = True
) -> Tuple[List[np.ndarray], bytes, Optional[str]]:
    """Decode a framed message -> (arrays, uuid, error).

    The historical 3-tuple shape; a frame carrying a trace id or spans
    tail decodes fine (both consumed and dropped).  Use
    :func:`decode_arrays_ex` / :func:`decode_arrays_all` to read them."""
    arrays, uuid, error, _ = decode_arrays_ex(buf, copy=copy)
    return arrays, uuid, error


def decode_arrays_ex(
    buf: bytes, *, copy: bool = True
) -> Tuple[List[np.ndarray], bytes, Optional[str], Optional[bytes]]:
    """Decode a framed message -> (arrays, uuid, error, trace_id); a
    spans tail (flag bit 4) is consumed and dropped."""
    arrays, uuid, error, trace_id, _ = decode_arrays_all(buf, copy=copy)
    return arrays, uuid, error, trace_id


def decode_arrays_all(
    buf: bytes,
    *,
    copy: bool = True,
) -> Tuple[
    List[np.ndarray],
    bytes,
    Optional[str],
    Optional[bytes],
    Optional[list],
]:
    """Full decode -> (arrays, uuid, error, trace_id, spans) where
    ``spans`` is the piggybacked span-tree list (``None`` when the flag
    is unset).  A partition block (flag bit 64) is consumed and
    dropped — partitioned lanes read it with
    :func:`decode_arrays_part`.

    ``copy=True`` (the default, and the historical behavior) returns
    owned writable arrays.  ``copy=False`` returns READ-ONLY
    ``frombuffer`` views into ``buf`` itself — zero payload copies;
    the views keep the whole frame alive, so opt in where the frame is
    short-lived anyway (a server decoding a request it computes on and
    drops) rather than where results are retained."""
    arrays, uuid, error, trace_id, spans, _part, _ver = (
        decode_arrays_part(buf, copy=copy)
    )
    return arrays, uuid, error, trace_id, spans


def decode_arrays_part(
    buf: bytes,
    *,
    copy: bool = True,
) -> Tuple[
    List[np.ndarray],
    bytes,
    Optional[str],
    Optional[bytes],
    Optional[list],
    Optional[tuple],
    Optional[int],
]:
    """:func:`decode_arrays_all` plus the frame's partition block as a
    5-int tuple (flag bit 64; ``None`` when clear) — what the
    partitioned client/server lanes decode replies with
    (routing/partition.py owns the semantics) — and the u64
    step-version stamp (flag bit 128; ``None`` when clear — zero is a
    meaningful stamp; optim/sharded.py owns the semantics)."""
    if _fi.active_plan is not None:  # chaos seam (faultinject.runtime)
        buf = _fi.filter_bytes("npwire.decode", buf)
    try:
        magic, version, flags, uuid, n = _HEADER_STRUCT.unpack_from(buf, 0)
    except struct.error as e:
        raise WireError(f"truncated header: {e}") from None
    if magic != MAGIC:
        raise WireError(f"bad magic {magic!r}")
    if version != 1:
        raise WireError(f"unsupported version {version}")
    _check_flags(flags)
    if flags & _FLAG_BATCH:
        # Loud, not silent: parsing K framed items as arrays would
        # yield garbage.  Batch frames only reach negotiated peers
        # (module docstring), so landing here is a dispatch bug.
        raise WireError(
            "batch frame (flag bit 8); decode with decode_batch"
        )
    off = _HEADER_SIZE
    error = None
    if flags & _FLAG_ERROR:
        try:
            (elen,) = struct.unpack_from("<I", buf, off)
            off += 4
            if off + elen > len(buf):
                raise WireError("truncated error block")
            error = buf[off : off + elen].decode("utf-8")
            off += elen
        except (struct.error, UnicodeDecodeError) as e:
            raise WireError(f"truncated error block: {e}") from None
    trace_id = None
    if flags & _FLAG_TRACE:
        if off + 16 > len(buf):
            raise WireError("truncated trace block")
        trace_id = buf[off : off + 16]
        off += 16
    if flags & _FLAG_DEADLINE:
        # Consumed and dropped (peek_deadline is the admission-side
        # reader; see decode_batch for the rationale).
        if off + 8 > len(buf):
            raise WireError("truncated deadline block")
        off += 8
    if flags & _FLAG_TENANT:
        # Consumed and dropped (peek_tenant is the gateway-side reader).
        off = _skip_tenant_block(buf, off)
    partition = None
    if flags & _FLAG_PARTITION:
        partition, off = _decode_partition(buf, off)
    step_version = None
    if flags & _FLAG_VERSION:
        step_version, off = _decode_version(buf, off)
    arrays: List[np.ndarray] = []
    for _ in range(n):
        try:
            (dtlen,) = struct.unpack_from("<H", buf, off)
            off += 2
            dt = _parse_dtype(buf[off : off + dtlen])
            off += dtlen
            (ndim,) = struct.unpack_from("<B", buf, off)
            off += 1
            shape = struct.unpack_from(f"<{ndim}Q", buf, off)
            off += 8 * ndim
            (dlen,) = struct.unpack_from("<Q", buf, off)
            off += 8
            data_off = off
            if data_off + dlen > len(buf):
                raise WireError("truncated array payload")
            off += dlen
        except struct.error as e:
            raise WireError(f"truncated message: {e}") from None
        try:
            # frombuffer with an explicit offset/count reads the frame
            # in place — no slice copy; ``copy=True`` then pays exactly
            # ONE copy (the historical path paid two: slice + .copy()).
            if dt.itemsize == 0 or dlen % dt.itemsize:
                raise ValueError(
                    f"payload length {dlen} is not a multiple of "
                    f"itemsize {dt.itemsize}"
                )
            arr = np.frombuffer(
                buf, dtype=dt, count=dlen // dt.itemsize, offset=data_off
            ).reshape(shape)
            if copy:
                arr = arr.copy()
                _DECODE_COPIED.inc(dlen)
            arrays.append(arr)
        except ValueError as e:
            # e.g. data_len inconsistent with shape * itemsize
            raise WireError(f"corrupt array payload: {e}") from None
    spans = None
    if flags & _FLAG_SPANS:
        try:
            (slen,) = struct.unpack_from("<I", buf, off)
            off += 4
            if off + slen > len(buf):
                raise WireError("truncated spans block")
            spans = json.loads(buf[off : off + slen].decode("utf-8"))
            off += slen
        except (struct.error, UnicodeDecodeError, ValueError) as e:
            raise WireError(f"corrupt spans block: {e}") from None
        if not isinstance(spans, list):
            raise WireError(
                f"spans block must be a JSON list, got {type(spans).__name__}"
            )
    return arrays, uuid, error, trace_id, spans, partition, step_version

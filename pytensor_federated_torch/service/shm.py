"""Shared-memory arena transport — the zero-copy lane for colocated nodes.

The host-federation transports so far all MOVE the payload: npwire
frames concatenate array bytes, sockets copy them through the kernel,
decoders copy them back out.  For replicas on the SAME host that is
pure waste — the bytes end up in the same physical memory they started
next to.  This module keeps payloads in a shared mmap arena
(:mod:`.arena`) and sends only DESCRIPTORS — ``(slot, delta, length,
generation)`` pointers plus dtype/shape — over a lightweight TCP
"doorbell" channel:

- the driver writes request arrays into its half of the arena pair
  exactly once (arrays it passes repeatedly by identity — per-node
  data constants — are PINNED after their second appearance and never
  copied again: steady-state requests move descriptor bytes only);
- the node builds ``frombuffer`` views straight onto the shared pages
  (zero read copies), computes, writes replies into its half, and
  doorbells the reply descriptors back;
- generation-counted slots (:mod:`.arena`) make every stale, torn, or
  corrupt descriptor a loud :class:`~.npwire.WireError`, never torn
  data — the wire invariant, extended to shared memory.

The doorbell speaks u32-length-prefixed frames like the TCP lane, and
ALSO answers plain npwire frames (:func:`~.tcp.serve_npwire_payload`),
so the replica pool's existing zero-item batch probe — and therefore
`routing.NodePool` health checks, breakers, and failover — work
against an shm node unchanged.  :class:`ShmArraysClient` carries the
full pinned-client surface (``evaluate``, pipelined/batched
``evaluate_many``, ``evaluate_many_partial``, ``get_load``) so a pool
can mix shm replicas with grpc/tcp ones.

Frame layout (little-endian; constants declared in
:mod:`.wire_registry`, cross-checked by the graftlint wire-registry
rule)::

  header: MAGIC("SHM1") version(u8) kind(u8) flags(u8) pad(u8) uuid(16s)
          [flags&1 error: len(u32) utf8]
          [flags&2 trace: trace_id(16s)]
  descriptor (per array): slot(u64) delta(u32) length(u64) gen(u64)
          dtype_len(u16) dtype ndim(u8) shape(u64*ndim)
  bodies: ATTACH ()                    ATTACH_OK (json: req/rep/size/id)
          EVAL (ack_gen u64, n u32, n descriptors)
          REPLY (n u32, n descriptors)        [error rides flags&1]
          EVAL_BATCH (ack_gen u64, k u32, k × [uuid 16s, n u32, descs])
          REPLY_BATCH (k u32, k × [uuid 16s, elen u32, err? | n u32, descs])
          ACK (ack_gen u64)            GETLOAD ()    LOAD (json)
          PING (n u32, descs)          PONG ()       ERROR (flags&1)

Reclamation: request slots are freed by the client when their reply
arrives (the doorbell is lock-step FIFO per connection, so the node is
provably done with them); reply slots are freed by the node when the
client's next frame acknowledges their generations (``ack_gen``
watermark — acks piggyback on every EVAL, and a trailing ACK frame at
the end of each pipelined window releases its final replies without
waiting for the next call).  Telemetry trace ids ride flag bit 2; the spans piggyback
lane is not implemented on this transport (the gRPC/TCP lanes carry
reunion; an shm node is by definition colocated and observable).

No reference-runtime analog: the reference wire is untouched — this is
a driver-local extension.
"""

from __future__ import annotations

import json
import socket
import struct
import threading
import time
import uuid as uuid_mod
import weakref
from functools import lru_cache
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..faultinject import runtime as _fi
from ..telemetry import flightrec as _flightrec
from ..telemetry import spans as _spans
from ..telemetry import watchdog as _watchdog
from . import _node_metrics
from . import _rpc_metrics
from . import deadline as _deadline
from .arena import DEFAULT_ARENA_BYTES, Arena
from .batching import execute_window_sync as _execute_window_sync
from .npwire import (
    WIRE_BYTES_COPIED,
    WireError,
    _encode_dtype,
    _encode_tenant,
    _parse_dtype,
    fast_uuid,
    normalize_arrays,
    payload_view,
)
from .tcp import (
    RemoteComputeError,
    _recv_frame,
    _send_frame,
    serve_npwire_payload,
)

# The partition lane — shard math + loud reassembly rules
# (routing/ never imports service/ at module level, so no cycle).
from ..routing import partition as _partition

__all__ = ["ShmArraysClient", "serve_shm"]

MAGIC = b"SHM1"

# Frame kinds — mirrored from service/wire_registry.py SHMWIRE_KINDS
# (the declared source; graftlint cross-checks).  Decoders REJECT an
# unknown kind: a doorbell peer must ship in lockstep.
_KIND_ATTACH = 1
_KIND_ATTACH_OK = 2
_KIND_EVAL = 3
_KIND_REPLY = 4
_KIND_EVAL_BATCH = 5
_KIND_REPLY_BATCH = 6
_KIND_ACK = 7
_KIND_GETLOAD = 8
_KIND_LOAD = 9
_KIND_PING = 10
_KIND_PONG = 11
_KIND_ERROR = 12

_KNOWN_KINDS = frozenset(range(_KIND_ATTACH, _KIND_ERROR + 1))

# Flag bits — mirrored from service/wire_registry.py SHMWIRE_FLAGS.
_FLAG_ERROR = 1
_FLAG_TRACE = 2
_FLAG_DEADLINE = 4
_FLAG_TENANT = 8
_FLAG_PARTITION = 16
_FLAG_VERSION = 32
_KNOWN_FLAGS = (
    _FLAG_ERROR | _FLAG_TRACE | _FLAG_DEADLINE | _FLAG_TENANT
    | _FLAG_PARTITION | _FLAG_VERSION
)
#: The gradient-partition index block (flag bit 16): same 32-byte
#: layout as the npwire block (wire_registry.PARTITION_STRUCT);
#: routing/partition.py owns the semantics.
_PARTITION_STRUCT = struct.Struct("<IIQQQ")
#: The step-version stamp (flag bit 32): one u64 after the partition
#: block (wire_registry.VERSION_STRUCT); optim/sharded.py owns the
#: semantics (zero is a meaningful stamp — presence is the flag).
_VERSION_STRUCT = struct.Struct("<Q")

_HEADER = struct.Struct("<4sBBBB16s")
#: The arena descriptor — layout declared as SHM_DESC_STRUCT in
#: service/wire_registry.py (field order: slot, delta, length,
#: generation).
_DESC_STRUCT = struct.Struct("<QIQQ")

_BATCH_CHUNK = 32  # requests per EVAL_BATCH frame (tcp.py parity)

# Preserialized packers: literal-format
# struct.pack re-parses the format string per call — hoisted out of
# the hot doorbell send/decode paths.
_U32 = struct.Struct("<I")
_U64 = struct.Struct("<Q")
_QI = struct.Struct("<QI")
_U16 = struct.Struct("<H")
_U8 = struct.Struct("<B")
_F64 = struct.Struct("<d")
#: The empty descriptor block (n=0) — a constant on the reply paths.
_EMPTY_DESCS = _U32.pack(0)

_CALL_S = _rpc_metrics.CALL_S
_RETRIES = _rpc_metrics.RETRIES
_DROPS = _rpc_metrics.DROPS
_BATCH_S = _rpc_metrics.BATCH_S
_WINDOW_DEPTH = _rpc_metrics.WINDOW_DEPTH
_FRAME_REQS = _rpc_metrics.BATCH_FRAME_REQS
_SHM_DECODE_COPIED = WIRE_BYTES_COPIED.labels(lane="shm", stage="decode_copy")


def _check_flags(flags: int) -> None:
    """Reject undeclared flag bits loudly (loud-failure contract)."""
    unknown = flags & ~_KNOWN_FLAGS
    if unknown:
        raise WireError(
            f"unknown shm flag bits 0x{unknown:02x} "
            f"(known mask 0x{_KNOWN_FLAGS:02x}) — version-skewed peer?"
        )


def encode_frame(
    kind: int,
    uuid: bytes,
    body: bytes = b"",
    *,
    error: Optional[str] = None,
    trace_id: Optional[bytes] = None,
    deadline_s: Optional[float] = None,
    tenant: Optional[str] = None,
    partition: Optional[Sequence[int]] = None,
    version: Optional[int] = None,
) -> bytes:
    """One doorbell frame.  Descriptor-only — payload bytes NEVER ride
    the doorbell; they live in the arena.  ``deadline_s`` (flag bit 4)
    carries the request's remaining deadline budget in relative
    seconds (:mod:`.deadline`); ``tenant`` (flag bit 8) the gateway
    tier's per-tenant identity (u16-length utf8, non-empty);
    ``partition`` (flag bit 16) the gradient-partition index block (a
    5-int sequence — routing/partition.py owns the semantics);
    ``version`` (flag bit 32) the u64 step-version stamp
    (optim/sharded.py owns the semantics; zero is meaningful);
    ``None`` for any emits the pre-feature byte-identical frame."""
    if len(uuid) != 16:
        raise WireError(f"uuid must be 16 bytes, got {len(uuid)}")
    flags = 0
    if error is None and trace_id is None and deadline_s is None \
            and tenant is None and partition is None \
            and version is None:
        # Hot-path template: the flag-free frame
        # — every ACK/GETLOAD/PING and most steady-state EVALs — is a
        # prefix join, no per-block branching.
        out = _plain_prefix(kind) + uuid + body
        if _fi.active_plan is not None:  # chaos seam
            out = _fi.filter_bytes("shm.encode", out)
        return out
    parts: List[bytes] = []
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
        # The block layout is byte-identical to npwire's by design —
        # one validator/encoder (npwire._encode_tenant) for both.
        tenant_block = _encode_tenant(tenant)
        flags |= _FLAG_TENANT
    partition_block = None
    if partition is not None:
        partition_block = _encode_partition_block(partition)
        flags |= _FLAG_PARTITION
    version_block = None
    if version is not None:
        version_block = _encode_version_block(version)
        flags |= _FLAG_VERSION
    parts.append(_HEADER.pack(MAGIC, 1, kind, flags, 0, uuid))
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
    parts.append(body)
    out = b"".join(parts)
    if _fi.active_plan is not None:  # chaos seam (faultinject.runtime)
        out = _fi.filter_bytes("shm.encode", out)
    return out


@lru_cache(maxsize=16)
def _plain_prefix(kind: int) -> bytes:
    """Preserialized ``MAGIC ver kind flags=0 pad`` header prefix for
    the flag-free fast path (the uuid follows it)."""
    return _HEADER.pack(MAGIC, 1, kind, 0, 0, b"\0" * 16)[: _HEADER.size - 16]


def _encode_partition_block(partition: Sequence[int]) -> bytes:
    """Validate + pack one partition block — delegated to the single
    validator (:func:`..routing.partition.pack_partition`), so the shm
    and npwire lanes cannot drift apart in what they refuse
    (``PartitionError`` is a ``WireError`` subclass, preserving the
    loud-failure classification)."""
    try:
        return _partition.pack_partition(
            tuple(int(v) for v in partition)
        )
    except WireError:
        raise
    except (TypeError, ValueError) as e:
        raise WireError(f"partition must be 5 ints: {e}") from None


def _encode_version_block(version: int) -> bytes:
    """Validate + pack one step-version block (flag bit 32) — the same
    u64 range check the npwire lane applies, so the two lanes cannot
    drift apart in what they refuse."""
    try:
        v = int(version)
    except (TypeError, ValueError) as e:
        raise WireError(f"version must be an int: {e}") from None
    if not 0 <= v < (1 << 64):
        raise WireError(f"version {v} outside u64 range")
    return _VERSION_STRUCT.pack(v)


def decode_frame(
    buf: bytes,
) -> Tuple[
    int,
    bytes,
    Optional[str],
    Optional[bytes],
    Optional[float],
    Optional[tuple],
    Optional[int],
    int,
    bytes,
]:
    """Decode a doorbell frame header -> ``(kind, uuid, error,
    trace_id, deadline_s, partition, version, body_offset, frame)``;
    kind-specific body parsing is the caller's, offset-based against
    the RETURNED ``frame`` (which is ``buf`` unless the chaos seam
    transformed it — parsing the original after a filtered header
    would silently mix two byte streams).  ``deadline_s`` is the
    remaining deadline budget off the wire (flag bit 4), ``None`` when
    unbounded; ``partition`` the gradient-partition block's 5-int
    tuple (flag bit 16, ``None`` when clear — routing/partition.py
    owns the semantics); ``version`` the u64 step-version stamp (flag
    bit 32, ``None`` when clear — zero is a meaningful stamp;
    optim/sharded.py owns the semantics)."""
    if _fi.active_plan is not None:  # chaos seam (faultinject.runtime)
        buf = _fi.filter_bytes("shm.decode", buf)
    try:
        magic, version, kind, flags, _pad, uuid = _HEADER.unpack_from(buf, 0)
    except struct.error as e:
        raise WireError(f"truncated shm header: {e}") from None
    if magic != MAGIC:
        raise WireError(f"bad shm magic {magic!r}")
    if version != 1:
        raise WireError(f"unsupported shm version {version}")
    if kind not in _KNOWN_KINDS:
        raise WireError(f"unknown shm frame kind {kind}")
    _check_flags(flags)
    off = _HEADER.size
    error = None
    if flags & _FLAG_ERROR:
        try:
            (elen,) = _U32.unpack_from(buf, off)
            off += 4
            if off + elen > len(buf):
                raise WireError("truncated shm error block")
            error = buf[off : off + elen].decode("utf-8")
            off += elen
        except (struct.error, UnicodeDecodeError) as e:
            raise WireError(f"truncated shm error block: {e}") from None
    trace_id = None
    if flags & _FLAG_TRACE:
        if off + 16 > len(buf):
            raise WireError("truncated shm trace block")
        trace_id = buf[off : off + 16]
        off += 16
    deadline_s = None
    if flags & _FLAG_DEADLINE:
        try:
            (deadline_s,) = _F64.unpack_from(buf, off)
        except struct.error as e:
            raise WireError(f"truncated shm deadline block: {e}") from None
        off += 8
    if flags & _FLAG_TENANT:
        # Consumed and dropped — :func:`frame_tenant` is the reader.
        try:
            (tlen,) = _U16.unpack_from(buf, off)
        except struct.error as e:
            raise WireError(f"truncated shm tenant block: {e}") from None
        off += 2
        if off + tlen > len(buf):
            raise WireError("truncated shm tenant block")
        off += tlen
    partition = None
    if flags & _FLAG_PARTITION:
        try:
            partition = _PARTITION_STRUCT.unpack_from(buf, off)
        except struct.error as e:
            raise WireError(
                f"truncated shm partition block: {e}"
            ) from None
        off += _PARTITION_STRUCT.size
    step_version = None
    if flags & _FLAG_VERSION:
        try:
            (step_version,) = _VERSION_STRUCT.unpack_from(buf, off)
        except struct.error as e:
            raise WireError(
                f"truncated shm version block: {e}"
            ) from None
        off += _VERSION_STRUCT.size
    return (
        kind, uuid, error, trace_id, deadline_s, partition,
        step_version, off, buf,
    )


def frame_tenant(buf: bytes) -> Optional[str]:
    """The doorbell frame's tenant id (flag bit 8), or ``None`` when
    the flag is clear — the shm twin of ``npwire.peek_tenant`` (walks
    the same leading blocks ``decode_frame`` does, without the chaos
    seam: a peek must not double-fire byte-lane rules)."""
    try:
        magic, version, _kind, flags, _pad, _uuid = _HEADER.unpack_from(
            buf, 0
        )
    except struct.error as e:
        raise WireError(f"truncated shm header: {e}") from None
    if magic != MAGIC:
        raise WireError(f"bad shm magic {magic!r}")
    _check_flags(flags)
    if not flags & _FLAG_TENANT:
        return None
    off = _HEADER.size
    if flags & _FLAG_ERROR:
        try:
            (elen,) = _U32.unpack_from(buf, off)
        except struct.error as e:
            raise WireError(f"truncated shm error block: {e}") from None
        off += 4 + elen
    if flags & _FLAG_TRACE:
        off += 16
    if flags & _FLAG_DEADLINE:
        off += 8
    try:
        (tlen,) = _U16.unpack_from(buf, off)
        off += 2
        if off + tlen > len(buf):
            raise WireError("truncated shm tenant block")
        return buf[off : off + tlen].decode("utf-8")
    except (struct.error, UnicodeDecodeError) as e:
        raise WireError(f"corrupt shm tenant block: {e}") from None


#: One decoded descriptor: (slot, delta, length, generation, dtype, shape).
Desc = Tuple[int, int, int, int, np.dtype, Tuple[int, ...]]


# graftlint: disable=fault-shim-coverage -- sub-frame helper: chaos reaches these bytes one frame up (encode_frame's shm.encode filter + the shm.descriptor seam)
def encode_descs(descs: Sequence[Desc]) -> bytes:
    """Descriptor block: ``n(u32)`` + one fixed struct + dtype/shape
    per array."""
    parts: List[bytes] = [_U32.pack(len(descs))]
    for slot, delta, length, gen, dtype, shape in descs:
        parts.append(_DESC_STRUCT.pack(slot, delta, length, gen))
        dt = _encode_dtype(dtype)
        parts.append(_U16.pack(len(dt)))
        parts.append(dt)
        parts.append(_U8.pack(len(shape)))
        parts.append(struct.pack(f"<{len(shape)}Q", *shape))
    return b"".join(parts)


# graftlint: disable=fault-shim-coverage -- sub-frame helper: chaos reaches these bytes one frame up (decode_frame's shm.decode filter + the shm.descriptor seam)
def decode_descs(buf: bytes, off: int) -> Tuple[List[Desc], int]:
    """Parse a descriptor block at ``off`` -> (descs, new_offset)."""
    try:
        (n,) = _U32.unpack_from(buf, off)
        off += 4
        descs: List[Desc] = []
        for _ in range(n):
            slot, delta, length, gen = _DESC_STRUCT.unpack_from(buf, off)
            off += _DESC_STRUCT.size
            (dtlen,) = _U16.unpack_from(buf, off)
            off += 2
            dtype = _parse_dtype(buf[off : off + dtlen])
            off += dtlen
            (ndim,) = _U8.unpack_from(buf, off)
            off += 1
            shape = struct.unpack_from(f"<{ndim}Q", buf, off)
            off += 8 * ndim
            descs.append((slot, delta, length, gen, dtype, shape))
    except struct.error as e:
        raise WireError(f"truncated shm descriptor block: {e}") from None
    return descs, off


def _desc_region_offset(
    kind: int,
    trace_id: Optional[bytes],
    deadline_s: Optional[float] = None,
    partition: Optional[Sequence[int]] = None,
    version: Optional[int] = None,
) -> int:
    """Byte offset where an OUTGOING EVAL/EVAL_BATCH frame's
    descriptor region starts (ack watermark preserved — corrupting it
    would fault the RECLAMATION protocol, a different seam) — where
    the ``corrupt_descriptor`` chaos shim starts flipping."""
    off = (
        _HEADER.size
        + (16 if trace_id is not None else 0)
        + (8 if deadline_s is not None else 0)
        + (_PARTITION_STRUCT.size if partition is not None else 0)
        + (_VERSION_STRUCT.size if version is not None else 0)
    )
    if kind == _KIND_EVAL:
        return off + 8  # past ack_gen
    if kind == _KIND_EVAL_BATCH:
        return off + 12  # past ack_gen + item count
    return off


def _read_arena_array(
    arena: Arena, desc: Desc, *, copy: bool
) -> np.ndarray:
    """One descriptor -> numpy array.  ``copy=False`` is a READ-ONLY
    view straight onto the shared pages (validated head+tail before
    return); ``copy=True`` re-validates after the copy so a recycle
    landing mid-copy is detected before the bytes are believed."""
    slot, delta, length, gen, dtype, shape = desc
    view = arena.read_view(slot, delta, length, gen)
    if dtype.itemsize == 0 or length % dtype.itemsize:
        raise WireError(
            f"descriptor length {length} is not a multiple of "
            f"itemsize {dtype.itemsize}"
        )
    try:
        arr = np.frombuffer(
            view, dtype=dtype, count=length // dtype.itemsize
        ).reshape(shape)
    except ValueError as e:
        raise WireError(f"corrupt descriptor shape: {e}") from None
    if copy:
        arr = arr.copy()
        arena.read_view(slot, delta, length, gen)  # no recycle mid-copy
        _SHM_DECODE_COPIED.inc(length)
    else:
        # The mmap is writable; the VIEW must not be — a consumer
        # scribbling on shared pages would corrupt the peer's slot.
        arr.flags.writeable = False
    return arr


def _write_arrays(
    arena: Arena, arrays: Sequence[np.ndarray], *, pinned: bool = False
) -> Tuple[Optional[int], List[Desc]]:
    """Pack arrays into ONE fresh slot -> (slot, descriptors).  The
    single arena write is each payload byte's only copy."""
    if not arrays:
        return None, []
    arrays = normalize_arrays(arrays)
    slot, gen, deltas = arena.write_many(
        [payload_view(a) for a in arrays], pinned=pinned
    )
    descs: List[Desc] = [
        (slot, delta, a.nbytes, gen, a.dtype, tuple(a.shape))
        for a, delta in zip(arrays, deltas)
    ]
    return slot, descs


# ---------------------------------------------------------------------------
# client
# ---------------------------------------------------------------------------


class ShmArraysClient:
    """Arrays-in → arrays-out over a shared-memory arena pair plus one
    persistent doorbell connection.  Sync surface parity with
    :class:`~.tcp.TcpArraysClient` (``evaluate``, pipelined/batched
    ``evaluate_many``, ``evaluate_many_partial``, plus ``get_load`` and
    ``ping``), so the replica pool drives both interchangeably.

    ``pin_arrays`` (default True): an ndarray passed by the SAME object
    identity a second time is promoted to the arena's pinned region —
    written once, referenced by descriptor forever after (per-node data
    constants stop moving bytes entirely).  The contract is that of
    immutable arrays: arrays you pass repeatedly must not change; disable
    with ``pin_arrays=False`` if you mutate request arrays in place.

    ``copy`` (default True): reply arrays are copied out of the arena
    (writable, owned).  ``copy=False`` returns read-only views onto the
    shared pages for SINGLE ``evaluate`` calls — zero-copy, valid until
    the node recycles the reply slot, which the ack watermark defers
    until your NEXT call on this client.  ``evaluate_many`` always
    copies its replies: within a window, acks ride later frames of the
    same call, so a view of an early reply could be recycled before
    the call even returns."""

    def __init__(
        self,
        host: str,
        port: int,
        *,
        retries: int = 2,
        copy: bool = True,
        pin_arrays: bool = True,
        max_inflight_bytes: Optional[int] = None,
        connect_timeout_s: float = 30.0,
        connect_retries: int = 1,
        connect_backoff_s: float = 0.05,
        timeout_s: Optional[float] = None,
    ) -> None:
        """``timeout_s`` bounds each reply read; with an ambient
        deadline bound (:mod:`.deadline`) the read is capped at the
        REMAINING budget regardless, so a node that accepts then never
        replies fails over within the caller's deadline instead of
        blocking until the watchdog fires.  A fired bound closes the
        (desynchronized) doorbell and surfaces as ``TimeoutError`` —
        the transient classification, so pools fail the work over."""
        self.host = host
        self.port = int(port)
        self.retries = int(retries)
        self.copy = bool(copy)
        self.pin_arrays = bool(pin_arrays)
        self.max_inflight_bytes = max_inflight_bytes
        self.timeout_s = None if timeout_s is None else float(timeout_s)
        self.connect_timeout_s = float(connect_timeout_s)
        self.connect_retries = int(connect_retries)
        self.connect_backoff_s = float(connect_backoff_s)
        self._sock: Optional[socket.socket] = None
        self._rfile: Optional[Any] = None
        self._req_arena: Optional[Arena] = None
        self._rep_arena: Optional[Arena] = None
        self._consumed_gen = 0  # ack watermark piggybacked on sends
        # id(array) -> (hit count, weakref) — the promotion trigger.
        # The weakref VERIFIES identity across calls: CPython recycles
        # ids of freed per-call arrays constantly (the fresh-params-
        # every-step pattern), and a bare id counter would promote
        # unrelated arrays into the never-reclaimed pinned region.
        # id(array) -> (descs-per-array entry, strong ref).
        self._pin_hits: Dict[int, Tuple[int, "weakref.ref[np.ndarray]"]] = {}
        self._pinned: Dict[int, Tuple[Desc, np.ndarray]] = {}
        # All-pinned request signature -> (array refs, encoded
        # descriptor block): the steady-state fast path — one dict hit
        # and identity checks instead of re-encoding the same
        # descriptors every item (refs keep ids stable).
        self._block_cache: Dict[
            Tuple[int, ...], Tuple[Tuple[np.ndarray, ...], bytes]
        ] = {}

    @property
    def _peer(self) -> str:
        return f"{self.host}:{self.port}"

    # -- connection / attach ----------------------------------------------

    def _connect(self) -> socket.socket:
        if self._sock is None:
            last_err: Optional[Exception] = None
            for attempt in range(self.connect_retries + 1):
                if attempt:
                    time.sleep(self.connect_backoff_s)
                try:
                    s = socket.create_connection(
                        (self.host, self.port),
                        timeout=self.connect_timeout_s,
                    )
                    break
                except (ConnectionError, OSError) as e:
                    last_err = e
            else:
                raise ConnectionError(
                    f"connect to {self._peer} failed after "
                    f"{self.connect_retries + 1} attempts "
                    f"(timeout {self.connect_timeout_s}s)"
                ) from last_err
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._sock = s
            self._rfile = s.makefile("rb")
            try:
                self._attach()
            except BaseException:
                self.close()
                raise
        return self._sock

    def _attach(self) -> None:
        assert self._sock is not None
        uid = fast_uuid()
        self._send(encode_frame(_KIND_ATTACH, uid))
        kind, ruid, error, _tid, _dl, _part, _ver, off, frame = decode_frame(
            self._read_frame()
        )
        if error is not None:
            raise WireError(f"shm attach refused: {error}")
        if kind != _KIND_ATTACH_OK or ruid != uid:
            raise WireError("shm attach: unexpected reply")
        try:
            (jlen,) = _U32.unpack_from(frame, off)
            spec = json.loads(
                frame[off + 4 : off + 4 + jlen].decode("utf-8")
            )
            req_path, rep_path = spec["req"], spec["rep"]
        except (struct.error, ValueError, KeyError, UnicodeDecodeError) as e:
            raise WireError(f"corrupt shm attach reply: {e}") from None
        self._req_arena = Arena.attach(req_path, writer=True)
        self._rep_arena = Arena.attach(rep_path)
        self._consumed_gen = 0
        _flightrec.record(
            "shm.attach", peer=self._peer, req=req_path, rep=rep_path,
            size=self._req_arena.capacity,
        )

    def _send(self, frame: bytes) -> None:
        assert self._sock is not None
        if _fi.active_plan is not None:  # chaos seam
            _fi.send_frame_through(
                "shm.send", self._sock.sendall, frame, peer=self._peer
            )
        else:
            _send_frame(self._sock, frame)

    def _read_frame(self) -> bytes:
        # Bounded read: the per-call timeout_s knob and the ambient
        # deadline, whichever is tighter, as a TOTAL bound across the
        # header+payload chunks; posture (expired-budget close,
        # TimeoutError close, socket-timeout restore) is the shared
        # _deadline.bounded_reader so the doorbell and the TCP socket
        # lane cannot diverge.
        assert self._rfile is not None
        assert self._sock is not None
        with _deadline.bounded_reader(
            self._sock,
            self._rfile,
            _deadline.recv_budget_s(self.timeout_s),
            self.close,
        ) as read_exact:
            (n,) = _U32.unpack(read_exact(4))
            buf = read_exact(n)
        if _fi.active_plan is not None:  # chaos seam
            buf = _fi.filter_bytes("shm.recv", buf, self._peer)
        return buf

    def close(self) -> None:
        if self._sock is not None:
            try:
                if self._rfile is not None:
                    try:
                        self._rfile.close()
                    except OSError:
                        pass
                self._sock.close()
            finally:
                self._sock = None
                self._rfile = None
        for arena in (self._req_arena, self._rep_arena):
            if arena is not None:
                arena.close()
        self._req_arena = None
        self._rep_arena = None
        self._pin_hits.clear()
        self._pinned.clear()
        self._block_cache.clear()
        self._consumed_gen = 0

    def __del__(self) -> None:  # best-effort, mirrors tcp teardown
        try:
            self.close()
        except Exception:
            pass

    # -- request encoding --------------------------------------------------

    def _maybe_pinned_desc(self, a: np.ndarray) -> Optional[Desc]:
        """The pin cache: returns the array's pinned descriptor when
        the SAME object was written before (zero bytes moved), promotes
        an array on its second sighting, and returns ``None`` for the
        transient path.  A full pinned region degrades gracefully —
        correctness never depends on pinning."""
        if not self.pin_arrays:
            return None
        key = id(a)
        cached = self._pinned.get(key)
        if cached is not None:
            desc, ref = cached
            # An ndarray's data pointer is fixed for the object's
            # lifetime, so identity + size is the whole hit check.
            if ref is a and a.nbytes == desc[2]:
                return desc
            del self._pinned[key]  # invalidated: falls through
        entry = self._pin_hits.get(key)
        # Same id AND same (still-alive) object = a real repeat; a
        # dead/mismatched weakref is id reuse and resets the count.
        hits = 1 if entry is None or entry[1]() is not a else entry[0] + 1
        if hits < 2:
            if len(self._pin_hits) >= 4096:
                # Fresh-array-per-call workloads churn ids without
                # ever repeating: bound the tracker (cheap reset — a
                # genuine constant re-earns its two sightings).
                self._pin_hits.clear()
            self._pin_hits[key] = (hits, weakref.ref(a))
            return None
        self._pin_hits.pop(key, None)
        assert self._req_arena is not None
        try:
            _slot, (desc,) = _write_arrays(
                self._req_arena, [a], pinned=True
            )
        except WireError:
            return None
        self._pinned[key] = (desc, a)
        return desc

    def _encode_request(
        self, arrays: Sequence[np.ndarray]
    ) -> Tuple[List[Desc], Optional[int], int]:
        """Write one request's arrays -> (descriptors in order,
        transient slot to free on reply or None, TRANSIENT payload
        bytes — the in-flight byte-cap contribution; pinned arrays
        consume no ring space and count nothing).  Pinned arrays (same
        object seen before) reuse their existing descriptors — zero
        bytes moved; the rest pack into one fresh transient slot."""
        assert self._req_arena is not None
        descs: List[Optional[Desc]] = [None] * len(arrays)
        transient: List[Tuple[int, np.ndarray]] = []
        for i, raw in enumerate(arrays):
            a = np.asarray(raw)
            pinned = self._maybe_pinned_desc(a)
            if pinned is not None:
                descs[i] = pinned
            else:
                transient.append((i, a))
        slot: Optional[int] = None
        nbytes = 0
        if transient:
            slot, tdescs = _write_arrays(
                self._req_arena, [a for _i, a in transient]
            )
            tdescs = self._request_write_chaos(slot, tdescs)
            for (i, _a), desc in zip(transient, tdescs):
                descs[i] = desc
            nbytes = sum(d[2] for d in tdescs)
        return [d for d in descs if d is not None], slot, nbytes

    def _request_write_chaos(
        self, slot: Optional[int], descs: List[Desc]
    ) -> List[Desc]:
        """The ``shm.arena.write`` chaos seam — the CLIENT-side twin of
        the node's ``shm.arena.reply``: ``truncate_slot`` scribbles the
        request slot's tail (the node's read fails loudly, answered
        in-band), ``stale_generation`` ages the descriptors."""
        if _fi.active_plan is None:
            return descs
        fault = _fi.arena_fault("shm.arena.write", self._peer)
        if fault == "truncate_slot" and slot is not None:
            assert self._req_arena is not None
            self._req_arena.scribble_tail(slot)
        elif fault == "stale_generation":
            descs = [
                (s, d, ln, g + 1, dt, sh)
                for s, d, ln, g, dt, sh in descs
            ]
        return descs

    def _eval_body(self, descs: Sequence[Desc]) -> bytes:
        return _U64.pack(self._consumed_gen) + encode_descs(descs)

    def _apply_descriptor_chaos(
        self,
        frame: bytes,
        kind: int,
        trace_id: Optional[bytes],
        deadline_s: Optional[float] = None,
        partition: Optional[Sequence[int]] = None,
        version: Optional[int] = None,
    ) -> bytes:
        """The ``corrupt_descriptor`` chaos seam: flip bytes inside the
        descriptor block only (header corruption is ``corrupt_bytes``
        at the byte-lane points)."""
        if _fi.active_plan is None:
            return frame
        return _fi.corrupt_descriptor_bytes(
            "shm.descriptor", frame,
            _desc_region_offset(
                kind, trace_id, deadline_s, partition, version
            ),
            peer=self._peer,
        )

    # -- reply decoding ----------------------------------------------------

    def _decode_reply_arrays(
        self, descs: Sequence[Desc], *, force_copy: bool = False
    ) -> List[np.ndarray]:
        """``force_copy`` overrides ``copy=False`` inside pipelined
        windows: acks piggybacked on LATER frames of the same window
        let the node recycle reply slots that earlier results still
        view — zero-copy replies are only safe on the lock-step
        single-evaluate path, whose ack defers to the next call."""
        assert self._rep_arena is not None
        copy = self.copy or force_copy
        out = [
            _read_arena_array(self._rep_arena, d, copy=copy)
            for d in descs
        ]
        if descs:
            self._consumed_gen = max(
                self._consumed_gen, max(d[3] for d in descs)
            )
        return out

    def _free_transient(self, slot: Optional[int]) -> None:
        if slot is not None and self._req_arena is not None:
            self._req_arena.free(slot)

    # -- single evaluation -------------------------------------------------

    def evaluate(
        self,
        *arrays: np.ndarray,
        partition: Optional[Sequence[int]] = None,
    ) -> List[np.ndarray]:
        """One lock-step evaluation; ``partition`` (keyword-only)
        requests the head/tail SLICED reply, tcp.py-evaluate parity."""
        outputs, _ver = self._evaluate_inner(arrays, partition, None)
        return outputs

    def evaluate_versioned(
        self,
        *arrays: np.ndarray,
        partition: Optional[Sequence[int]] = None,
        version: int,
    ) -> Tuple[List[np.ndarray], Optional[int]]:
        """One VERSIONED round trip (the sharded-optimizer lane)
        -> ``(outputs, reply_version)`` —
        tcp.py-evaluate_versioned parity: the node's
        ``versioned_update`` handler answers shard-shaped outputs
        stamped with the NEW version; a stale stamp surfaces as
        :class:`RemoteComputeError` (optim/sharded.py classifies)."""
        return self._evaluate_inner(arrays, partition, version)

    def _evaluate_inner(
        self,
        arrays: Sequence[np.ndarray],
        partition: Optional[Sequence[int]],
        version: Optional[int],
    ) -> Tuple[List[np.ndarray], Optional[int]]:
        with _spans.span("rpc.evaluate", transport="shm"):
            last_err: Optional[Exception] = None
            for attempt in range(self.retries + 1):
                if attempt:
                    _RETRIES.labels(transport="shm").inc()
                    _flightrec.record(
                        "rpc.retry", transport="shm", attempt=attempt
                    )
                t0 = time.perf_counter()
                try:
                    with _spans.span("call"):
                        _deadline.check_remaining("shm evaluate")
                        self._connect()
                        with _spans.span("encode"):
                            uid = fast_uuid()
                            trace_id = (
                                _spans.current_trace_id()
                                if _spans.enabled()
                                else None
                            )
                            budget = _deadline.wire_budget()
                            descs, slot, _nb = self._encode_request(
                                arrays
                            )
                            frame = encode_frame(
                                _KIND_EVAL,
                                uid,
                                self._eval_body(descs),
                                trace_id=trace_id,
                                deadline_s=budget,
                                partition=partition,
                                version=version,
                            )
                            frame = self._apply_descriptor_chaos(
                                frame, _KIND_EVAL, trace_id, budget,
                                partition, version,
                            )
                        self._send(frame)
                        reply = self._read_frame()
                    break
                except (ConnectionError, OSError) as e:
                    last_err = e
                    _DROPS.labels(transport="shm").inc()
                    _flightrec.record(
                        "rpc.drop", transport="shm", peer=self._peer
                    )
                    self.close()
            else:
                raise ConnectionError(
                    f"shm node {self._peer} unreachable after "
                    f"{self.retries + 1} attempts"
                ) from last_err
            with _spans.span("decode"):
                try:
                    outputs, reply_version = self._consume_reply(
                        reply, uid, return_version=True
                    )
                except (RemoteComputeError, _deadline.DeadlineExceeded):
                    # In-band server error (deadline sheds included):
                    # the connection is still correlated — free the
                    # request slot (the node is done with it) and
                    # surface the error, no close.
                    self._free_transient(slot)
                    raise
                except (WireError, RuntimeError):
                    # Corrupt or desynchronized reply: close so the
                    # NEXT call re-attaches cleanly; the error
                    # surfaces loudly.
                    _DROPS.labels(transport="shm").inc()
                    self.close()
                    raise
            self._free_transient(slot)
            _CALL_S.labels(transport="shm", mode="lockstep").observe(
                time.perf_counter() - t0
            )
            return outputs, reply_version

    __call__ = evaluate

    def _consume_reply(
        self,
        reply: bytes,
        uid: bytes,
        *,
        force_copy: bool = False,
        return_version: bool = False,
    ):
        kind, ruid, error, _tid, _dl, _part, _ver, off, reply = decode_frame(reply)
        if kind == _KIND_ERROR:
            raise WireError(f"shm protocol error from node: {error}")
        if kind != _KIND_REPLY:
            raise WireError(
                f"unexpected shm frame kind {kind} (wanted REPLY)"
            )
        if error is not None:
            _flightrec.record(
                "rpc.error", transport="shm", error=error[:200]
            )
            if _deadline.is_deadline_error(error):
                raise _deadline.DeadlineExceeded(error)
            raise RemoteComputeError(error)
        if ruid != uid:
            raise RuntimeError(
                "uuid mismatch: reply does not match request"
            )
        descs, _off = decode_descs(reply, off)
        outputs = self._decode_reply_arrays(descs, force_copy=force_copy)
        if return_version:
            return outputs, _ver
        return outputs

    # -- pipelined / batched windows ---------------------------------------

    def _inflight_cap(self) -> int:
        if self.max_inflight_bytes is not None:
            return int(self.max_inflight_bytes)
        assert self._req_arena is not None
        # The doorbell cannot deadlock on payload bytes (they do not
        # ride it); the cap guards the ARENA — keep in-flight request
        # bytes under half the free transient region so the ring never
        # exhausts mid-window.
        return max(self._req_arena.transient_bytes_free() // 2, 1)

    def evaluate_many(
        self,
        requests: Sequence[Sequence[np.ndarray]],
        *,
        window: int = 8,
        batch: object = "auto",
    ) -> List[List[np.ndarray]]:
        """Pipelined evaluation over the lock-step doorbell; same
        semantics as the TCP lane (FIFO correlation, all-or-nothing
        transport retry, deterministic errors raise after a drain).
        ``batch`` "auto"/True packs ``min(window, 32)`` requests per
        EVAL_BATCH frame — the shm lane always supports batch frames,
        so "auto" and True are equivalent; False sends per-request
        EVAL frames."""
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        if batch != "auto" and batch is not True and batch is not False:
            raise ValueError(
                f"batch must be 'auto', True or False, got {batch!r}"
            )
        requests = list(requests)
        if not requests:
            return []
        with _spans.span(
            "rpc.evaluate_many",
            transport="shm",
            n=len(requests),
            window=window,
        ):
            t0 = time.perf_counter()
            last_err: Optional[Exception] = None
            for attempt in range(self.retries + 1):
                if attempt:
                    _RETRIES.labels(transport="shm").inc()
                    _flightrec.record(
                        "rpc.retry", transport="shm", attempt=attempt,
                        batch=len(requests),
                    )
                try:
                    with _watchdog.armed(
                        "shm.batch_window", n=len(requests), window=window
                    ):
                        if batch is False:
                            results = self._evaluate_many_once(
                                requests, window
                            )
                        else:
                            results = self._evaluate_many_batched_once(
                                requests, window
                            )
                except (ConnectionError, OSError) as e:
                    last_err = e
                    _DROPS.labels(transport="shm").inc()
                    _flightrec.record(
                        "rpc.drop", transport="shm", peer=self._peer
                    )
                    self.close()
                    continue
                except WireError:
                    # Client-side arena failure (e.g. exhaustion) with
                    # frames possibly in flight: the doorbell is
                    # desynchronized — close so the NEXT call starts
                    # clean, and surface the error (deterministic, no
                    # retry).  Reply-decode WireErrors already closed;
                    # close() is idempotent.
                    _DROPS.labels(transport="shm").inc()
                    self.close()
                    raise
                _BATCH_S.labels(transport="shm").observe(
                    time.perf_counter() - t0
                )
                return results
            raise ConnectionError(
                f"shm node {self._peer} unreachable after "
                f"{self.retries + 1} attempts"
            ) from last_err

    def evaluate_many_partial(
        self,
        requests: Sequence[Sequence[np.ndarray]],
        *,
        window: int = 8,
        batch: object = "auto",
    ) -> Tuple[List[Optional[List[np.ndarray]]], Optional[BaseException]]:
        """ONE pipelined pass, no reconnect-retry, partial progress:
        ``(results_with_None_holes, transport_exc_or_None)`` — the
        replica pool's mid-window failover primitive (tcp.py parity)."""
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        if batch != "auto" and batch is not True and batch is not False:
            raise ValueError(
                f"batch must be 'auto', True or False, got {batch!r}"
            )
        requests = list(requests)
        if not requests:
            return [], None
        out: List[Optional[List[np.ndarray]]] = [None] * len(requests)
        with _spans.span(
            "rpc.evaluate_many",
            transport="shm",
            n=len(requests),
            window=window,
            partial=True,
        ):
            t0 = time.perf_counter()
            try:
                with _watchdog.armed(
                    "shm.batch_window", n=len(requests), window=window
                ):
                    if batch is False:
                        self._evaluate_many_once(requests, window, out=out)
                    else:
                        self._evaluate_many_batched_once(
                            requests, window, out=out
                        )
            except (ConnectionError, OSError) as e:
                _DROPS.labels(transport="shm").inc()
                _flightrec.record(
                    "rpc.drop", transport="shm", peer=self._peer
                )
                self.close()
                return out, e
            except WireError:
                _DROPS.labels(transport="shm").inc()
                self.close()  # desynchronized mid-window: start clean
                raise
            _BATCH_S.labels(transport="shm").observe(
                time.perf_counter() - t0
            )
            return out, None

    def evaluate_reduced(
        self,
        requests: Sequence[Sequence[np.ndarray]],
        *,
        window: int = 8,
        slices: int = 1,
        total: Optional[int] = None,
    ) -> List[np.ndarray]:
        """Reduce-scatter evaluation over the doorbell:
        ``[head_sum, flat_tail_sum]`` — the shm twin of
        :meth:`~.tcp.TcpArraysClient.evaluate_reduced` (same window
        semantics, partition blocks on the doorbell's flag bit 16,
        reply slices in index order under the outer uuid)."""
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        if slices < 1:
            raise ValueError(f"slices must be >= 1, got {slices}")
        requests = list(requests)
        if not requests:
            raise _partition.PartitionError(
                "cannot reduce an empty request list"
            )
        with _spans.span(
            "rpc.evaluate_reduced",
            transport="shm",
            n=len(requests),
            slices=slices,
        ):
            t0 = time.perf_counter()
            last_err: Optional[Exception] = None
            for attempt in range(self.retries + 1):
                if attempt:
                    _RETRIES.labels(transport="shm").inc()
                    _flightrec.record(
                        "rpc.retry", transport="shm", attempt=attempt,
                        batch=len(requests),
                    )
                    _deadline.check_remaining("shm reduce retry")
                try:
                    with _watchdog.armed(
                        "shm.reduce_window",
                        n=len(requests),
                        window=window,
                    ):
                        result = self._evaluate_reduced_once(
                            requests, window, slices, total
                        )
                except (ConnectionError, OSError) as e:
                    last_err = e
                    _DROPS.labels(transport="shm").inc()
                    _flightrec.record(
                        "rpc.drop", transport="shm", peer=self._peer
                    )
                    self.close()
                    continue
                except WireError:
                    _DROPS.labels(transport="shm").inc()
                    self.close()
                    raise
                _BATCH_S.labels(transport="shm").observe(
                    time.perf_counter() - t0
                )
                return result
            raise ConnectionError(
                f"shm node {self._peer} unreachable after "
                f"{self.retries + 1} attempts"
            ) from last_err

    def _evaluate_reduced_once(
        self,
        requests: Sequence[Sequence[np.ndarray]],
        window: int,
        slices: int,
        total: Optional[int],
    ) -> List[np.ndarray]:
        self._connect()
        trace_id = _spans.current_trace_id() if _spans.enabled() else None
        chunk = max(1, min(window, _BATCH_CHUNK))
        req_part = (0, slices, 0, 0, 0 if total is None else int(total))
        head: Optional[np.ndarray] = None
        flat: Optional[np.ndarray] = None
        # Lock-step per frame: reduce replies are tiny (one tail per
        # frame regardless of window width), so one-in-flight keeps
        # the drain/reclaim story trivial (tcp.py twin's rationale).
        for start in range(0, len(requests), chunk):
            part_reqs = requests[start : start + chunk]
            outer_uuid = fast_uuid()
            budget = _deadline.wire_budget()
            slots: List[Optional[int]] = []
            item_parts: List[bytes] = []
            for req in part_reqs:
                descs, slot, _nb = self._encode_request(req)
                slots.append(slot)
                item_parts.append(fast_uuid() + encode_descs(descs))
            body = (
                _QI.pack(self._consumed_gen, len(part_reqs))
                + b"".join(item_parts)
            )
            frame = encode_frame(
                _KIND_EVAL_BATCH, outer_uuid, body,
                trace_id=trace_id, deadline_s=budget,
                partition=req_part,
            )
            _FRAME_REQS.labels(transport="shm").observe(len(part_reqs))
            self._send(frame)
            reply = self._read_frame()
            try:
                f_head, f_flat = self._consume_reduce_reply(
                    reply, outer_uuid, slices, total
                )
            except (RemoteComputeError, _deadline.DeadlineExceeded):
                # In-band failure: connection stays correlated — free
                # the frame's slots (the node is done) and surface.
                for slot in slots:
                    self._free_transient(slot)
                raise
            except (WireError, RuntimeError):
                _DROPS.labels(transport="shm").inc()
                self.close()
                raise
            for slot in slots:
                self._free_transient(slot)
            if head is None:
                head, flat = f_head, f_flat
            else:
                if (
                    f_head.shape != head.shape
                    or f_flat.size != flat.size
                ):
                    self.close()
                    raise WireError(
                        "reduce frames disagree on reply geometry"
                    )
                head = head + f_head
                flat = flat + f_flat
        self._send_ack()
        assert head is not None and flat is not None
        return [head, flat]

    def _consume_reduce_reply(
        self,
        reply: bytes,
        outer_uuid: bytes,
        slices: int,
        total: Optional[int],
    ) -> Tuple[np.ndarray, np.ndarray]:
        """One REPLY_BATCH reduce reply -> (head_sum, flat_vector);
        items arrive in partition-index order under the outer uuid
        (the doorbell framing has no per-item partition blocks — both
        ends derive the same plan from (total, count))."""
        kind, ruid, outer_err, _tid, _dl, rpart, _ver, off, reply = (
            decode_frame(reply)
        )
        if kind == _KIND_ERROR:
            raise WireError(f"shm protocol error from node: {outer_err}")
        if kind != _KIND_REPLY_BATCH:
            raise WireError(
                f"unexpected shm frame kind {kind} (wanted REPLY_BATCH)"
            )
        if outer_err is not None:
            if _deadline.is_deadline_error(outer_err):
                raise _deadline.DeadlineExceeded(outer_err)
            raise RemoteComputeError(outer_err)
        if ruid != outer_uuid:
            raise RuntimeError(
                "batch reply does not correlate with its frame"
            )
        if rpart is None:
            raise _partition.PartitionError(
                "reduce reply carries no partition block"
            )
        _i, count, _o, _l, r_total = rpart
        if count != slices or (
            total is not None and r_total != int(total)
        ):
            raise _partition.PartitionError(
                f"reduce reply geometry ({count}, {r_total}) does not "
                f"match the request ({slices}, {total})"
            )
        try:
            (k,) = _U32.unpack_from(reply, off)
            off += 4
        except struct.error as e:
            raise WireError(
                f"truncated shm reduce reply: {e}"
            ) from None
        if k != slices:
            raise _partition.PartitionError(
                f"reduce reply carries {k} slices, requested {slices}"
            )
        plan = _partition.plan_partitions(r_total, slices)
        head: Optional[np.ndarray] = None
        reassembler: Optional[_partition.Reassembler] = None
        for j in range(k):
            iuid = reply[off : off + 16]
            if len(iuid) != 16:
                raise WireError("truncated shm batch item")
            off += 16
            try:
                (elen,) = _U32.unpack_from(reply, off)
            except struct.error as e:
                raise WireError(
                    f"truncated shm batch item: {e}"
                ) from None
            off += 4
            if elen:
                if off + elen > len(reply):
                    raise WireError("truncated shm batch item error")
                raise RemoteComputeError(
                    reply[off : off + elen].decode("utf-8", "replace")
                )
            descs, off = decode_descs(reply, off)
            # Identity = outer uuid + partition index (see the server's
            # construction): catches duplicated or reordered slices
            # even when their lengths agree with the plan.
            if iuid != outer_uuid[:12] + _U32.pack(j):
                raise _partition.PartitionError(
                    "reduce item identity mismatch (duplicated, "
                    "dropped, or reordered shard)"
                )
            arrays = self._decode_reply_arrays(descs, force_copy=True)
            if j == 0:
                if len(arrays) != 2:
                    raise _partition.PartitionError(
                        "reduce reply item 0 must be [head, slice]"
                    )
                head = arrays[0]
                slice_arr = arrays[1]
            else:
                if len(arrays) != 1:
                    raise _partition.PartitionError(
                        "reduce reply items 1.. must be [slice]"
                    )
                slice_arr = arrays[0]
            if reassembler is None:
                reassembler = _partition.Reassembler(
                    r_total,
                    slices,
                    np.asarray(slice_arr).dtype
                    if np.asarray(slice_arr).size
                    else np.dtype(np.float64),
                )
            reassembler.add(
                plan[j], np.asarray(slice_arr), iuid=iuid.hex()
            )
        assert reassembler is not None and head is not None
        return head, reassembler.result()

    def _evaluate_many_once(
        self,
        requests: Sequence[Sequence[np.ndarray]],
        window: int,
        out: Optional[List[Optional[List[np.ndarray]]]] = None,
    ) -> List[Optional[List[np.ndarray]]]:
        self._connect()
        trace_id = _spans.current_trace_id() if _spans.enabled() else None
        n = len(requests)
        results: List[Optional[List[np.ndarray]]] = (
            out if out is not None else [None] * n
        )
        max_inflight = self._inflight_cap()
        pending: List[Tuple[bytes, Optional[int], int]] = []  # uid, slot, bytes
        write_idx = read_idx = 0
        inflight_bytes = 0

        def write_one(i: int) -> int:
            uid = fast_uuid()
            # Transient bytes only: pinned descriptors consume no ring
            # space, and counting them would throttle a pinned
            # workload to lock-step depth (the byte cap guards the
            # ARENA, which only transient slots occupy).
            budget = _deadline.wire_budget()
            descs, slot, nbytes = self._encode_request(requests[i])
            frame = encode_frame(
                _KIND_EVAL, uid, self._eval_body(descs),
                trace_id=trace_id, deadline_s=budget,
            )
            frame = self._apply_descriptor_chaos(
                frame, _KIND_EVAL, trace_id, budget
            )
            self._send(frame)
            pending.append((uid, slot, nbytes))
            return nbytes

        while read_idx < n:
            while write_idx < n and (
                write_idx == read_idx
                or (
                    write_idx - read_idx < window
                    and inflight_bytes < max_inflight
                )
            ):
                inflight_bytes += write_one(write_idx)
                write_idx += 1
            _WINDOW_DEPTH.labels(transport="shm").observe(
                write_idx - read_idx
            )
            reply = self._read_frame()
            uid, slot, nbytes = pending[read_idx]
            inflight_bytes -= nbytes
            try:
                outputs = self._consume_reply(reply, uid, force_copy=True)
            except (RemoteComputeError, _deadline.DeadlineExceeded):
                # Drain in-flight replies so the connection stays
                # correlated for the NEXT call, then surface the
                # deterministic error (no retry) — tcp.py semantics.
                # Deadline sheds are in-band too: the node answered,
                # the connection is healthy.
                try:
                    for _ in range(write_idx - read_idx - 1):
                        self._read_frame()
                except (ConnectionError, OSError):
                    _DROPS.labels(transport="shm").inc()
                    self.close()
                else:
                    self._drain_free(pending, read_idx, write_idx)
                raise
            except (WireError, RuntimeError):
                _DROPS.labels(transport="shm").inc()
                self.close()
                raise
            self._free_transient(slot)
            results[read_idx] = outputs
            read_idx += 1
        self._send_ack()
        return results

    def _send_ack(self) -> None:
        """Fire-and-forget ACK of the consumed-generation watermark —
        sent at the end of a pipelined window so the node reclaims the
        window's final reply slots NOW instead of at this client's
        next call (window replies are always copied, so no view
        outlives the release).  Best-effort: a dead socket surfaces on
        the next call's own path."""
        if self._sock is None:
            return
        try:
            self._send(
                encode_frame(
                    _KIND_ACK,
                    fast_uuid(),
                    _U64.pack(self._consumed_gen),
                )
            )
        except (ConnectionError, OSError):
            self.close()

    def _drain_free(
        self,
        pending: Sequence[Tuple[bytes, Optional[int], int]],
        read_idx: int,
        write_idx: int,
    ) -> None:
        """After a drain, free the transient slots of the drained
        requests (FIFO order: the erroring one first, then the rest)."""
        for k in range(read_idx, write_idx):
            self._free_transient(pending[k][1])

    def _evaluate_many_batched_once(
        self,
        requests: Sequence[Sequence[np.ndarray]],
        window: int,
        out: Optional[List[Optional[List[np.ndarray]]]] = None,
    ) -> List[Optional[List[np.ndarray]]]:
        self._connect()
        trace_id = _spans.current_trace_id() if _spans.enabled() else None
        n = len(requests)
        chunk = max(1, min(window, _BATCH_CHUNK))
        results: List[Optional[List[np.ndarray]]] = (
            out if out is not None else [None] * n
        )
        # (outer_uuid, start, item_uids, transient_slot)
        frames: List[Tuple[bytes, int, List[bytes], Optional[int]]] = []
        max_inflight = self._inflight_cap()
        starts = list(range(0, n, chunk))
        write_idx = read_idx = 0
        inflight: List[int] = []  # request bytes per in-flight frame
        # Frames in flight are capped too: replies consume the NODE's
        # arena until the next frame's ack reclaims them, and an
        # all-pinned workload carries zero in-flight request bytes —
        # the byte cap alone would let the whole request list launch
        # and the unacked replies exhaust the reply arena.
        max_frames = max(2, window // chunk)
        while read_idx < len(starts):
            while write_idx < len(starts) and (
                write_idx == read_idx
                or (
                    write_idx - read_idx < max_frames
                    and sum(inflight) < max_inflight
                )
            ):
                start = starts[write_idx]
                part = requests[start : start + chunk]
                outer_uuid = fast_uuid()
                item_uids: List[bytes] = []
                item_blocks: List[Optional[bytes]] = []
                hole_descs: Dict[int, List[Optional[Desc]]] = {}
                # All transient arrays of the whole frame pack into ONE
                # slot: per-frame FIFO reclamation, one arena write;
                # pinned (repeat-identity) arrays move zero bytes, and
                # an all-pinned request reuses its whole encoded
                # descriptor block from the signature cache.
                flat: List[np.ndarray] = []
                holes: List[Tuple[int, int, int]] = []  # item, pos, flat
                for req in part:
                    item_uids.append(fast_uuid())
                    arrays = [np.asarray(raw) for raw in req]
                    key: Optional[Tuple[int, ...]] = None
                    if self.pin_arrays:
                        key = tuple(map(id, arrays))
                        hit = self._block_cache.get(key)
                        if hit is not None and all(
                            r is a for r, a in zip(hit[0], arrays)
                        ):
                            item_blocks.append(hit[1])
                            continue
                    descs: List[Optional[Desc]] = []
                    has_hole = False
                    for a in arrays:
                        pinned = self._maybe_pinned_desc(a)
                        if pinned is None:
                            holes.append(
                                (len(item_blocks), len(descs), len(flat))
                            )
                            flat.append(a)
                            descs.append(None)
                            has_hole = True
                        else:
                            descs.append(pinned)
                    if has_hole:
                        hole_descs[len(item_blocks)] = descs
                        item_blocks.append(None)
                    else:
                        block = encode_descs(descs)
                        if key is not None:
                            if len(self._block_cache) >= 512:
                                # id-tuple churn from fresh-array
                                # workloads: bound the cache.
                                self._block_cache.clear()
                            self._block_cache[key] = (
                                tuple(arrays), block
                            )
                        item_blocks.append(block)
                slot: Optional[int] = None
                nbytes = 0
                if flat:
                    assert self._req_arena is not None
                    slot, tdescs = _write_arrays(self._req_arena, flat)
                    tdescs = self._request_write_chaos(slot, tdescs)
                    nbytes = sum(d[2] for d in tdescs)
                    for item_i, pos, flat_i in holes:
                        hole_descs[item_i][pos] = tdescs[flat_i]
                for item_i, descs in hole_descs.items():
                    item_blocks[item_i] = encode_descs(
                        [d for d in descs if d is not None]
                    )
                body = (
                    _QI.pack(self._consumed_gen, len(part))
                    + b"".join(
                        uid + block
                        for uid, block in zip(item_uids, item_blocks)
                    )
                )
                budget = _deadline.wire_budget()
                frame = encode_frame(
                    _KIND_EVAL_BATCH, outer_uuid, body,
                    trace_id=trace_id, deadline_s=budget,
                )
                frame = self._apply_descriptor_chaos(
                    frame, _KIND_EVAL_BATCH, trace_id, budget
                )
                _FRAME_REQS.labels(transport="shm").observe(len(part))
                self._send(frame)
                frames.append((outer_uuid, start, item_uids, slot))
                inflight.append(nbytes)
                write_idx += 1
            _WINDOW_DEPTH.labels(transport="shm").observe(
                write_idx - read_idx
            )
            reply = self._read_frame()
            outer_uuid, start, item_uids, slot = frames[read_idx]
            inflight.pop(0)
            first_error: Optional[str] = None
            try:
                kind, ruid, outer_err, _tid, _dl, _part, _ver, off, reply = decode_frame(
                    reply
                )
                if kind == _KIND_ERROR:
                    raise WireError(
                        f"shm protocol error from node: {outer_err}"
                    )
                if kind != _KIND_REPLY_BATCH:
                    raise WireError(
                        f"unexpected shm frame kind {kind} "
                        "(wanted REPLY_BATCH)"
                    )
                first_error = outer_err
                if first_error is None and ruid != outer_uuid:
                    raise RuntimeError(
                        "batch reply does not correlate with its frame"
                    )
                if first_error is None:
                    (k,) = _U32.unpack_from(reply, off)
                    off += 4
                    if k != len(item_uids):
                        raise RuntimeError(
                            "batch reply does not correlate with its "
                            "frame"
                        )
                    for j in range(k):
                        iuid = reply[off : off + 16]
                        if len(iuid) != 16:
                            raise WireError("truncated shm batch item")
                        off += 16
                        try:
                            (elen,) = _U32.unpack_from(reply, off)
                        except struct.error as e:
                            raise WireError(
                                f"truncated shm batch item: {e}"
                            ) from None
                        off += 4
                        if elen:
                            if off + elen > len(reply):
                                raise WireError(
                                    "truncated shm batch item error"
                                )
                            err = reply[off : off + elen].decode(
                                "utf-8", "replace"
                            )
                            off += elen
                            if first_error is None:
                                first_error = err
                            continue
                        descs, off = decode_descs(reply, off)
                        if iuid != item_uids[j]:
                            raise RuntimeError(
                                "uuid mismatch: batch item does not "
                                "match its request"
                            )
                        if first_error is None:
                            results[start + j] = (
                                self._decode_reply_arrays(
                                    descs, force_copy=True
                                )
                            )
            except struct.error as e:
                # Truncated batch reply: classify as WireError (the
                # loud-failure contract) — a raw struct.error would
                # escape every handler and leave the doorbell
                # desynchronized.
                _DROPS.labels(transport="shm").inc()
                self.close()
                raise WireError(
                    f"truncated shm batch reply: {e}"
                ) from None
            except (WireError, RuntimeError):
                _DROPS.labels(transport="shm").inc()
                self.close()
                raise
            if first_error is not None:
                try:
                    for _ in range(write_idx - read_idx - 1):
                        self._read_frame()
                except (ConnectionError, OSError):
                    _DROPS.labels(transport="shm").inc()
                    self.close()
                else:
                    for k2 in range(read_idx, write_idx):
                        self._free_transient(frames[k2][3])
                if _deadline.is_deadline_error(first_error):
                    raise _deadline.DeadlineExceeded(first_error)
                raise RemoteComputeError(first_error)
            self._free_transient(slot)
            read_idx += 1
        self._send_ack()
        return results

    # -- control lanes ------------------------------------------------------

    def get_load(self) -> Optional[dict]:
        """The node's load dict over the doorbell (GETLOAD/LOAD) —
        ``None`` on an undecodable reply (probe-lane verdict)."""
        self._connect()
        uid = fast_uuid()
        self._send(encode_frame(_KIND_GETLOAD, uid))
        reply = self._read_frame()
        try:
            kind, ruid, error, _tid, _dl, _part, _ver, off, reply = decode_frame(reply)
            if kind != _KIND_LOAD or ruid != uid or error is not None:
                return None
            (jlen,) = _U32.unpack_from(reply, off)
            load = json.loads(
                reply[off + 4 : off + 4 + jlen].decode("utf-8")
            )
            return load if isinstance(load, dict) else None
        # A garbled LOAD reply is a FAILED PROBE — None is this lane's
        # loud in-band verdict, same posture as the GetLoad probe.
        except Exception:  # graftlint: disable=wire-loudness -- probe verdict lane
            return None

    def ping(self) -> float:
        """Doorbell round-trip seconds with one EMPTY arena write —
        the shm lane's idle-overhead probe (bench.py ``shm_overhead``
        gate): arena slot write + descriptor frame + node-side slot
        validation + reply, no compute."""
        self._connect()
        assert self._req_arena is not None
        t0 = time.perf_counter()
        slot, descs = _write_arrays(
            self._req_arena, [np.empty(0, np.uint8)]
        )
        uid = fast_uuid()
        self._send(
            encode_frame(_KIND_PING, uid, encode_descs(descs))
        )
        try:
            kind, ruid, error, _tid, _dl, _part, _ver, _off, _frame = decode_frame(
                self._read_frame()
            )
            if kind != _KIND_PONG or ruid != uid:
                raise WireError("shm ping: unexpected reply")
        except (WireError, RuntimeError):
            # Undecodable/desynchronized reply: close so the NEXT call
            # re-attaches cleanly — leaving the ping's transient slot
            # live would poison the FIFO free order forever.
            _DROPS.labels(transport="shm").inc()
            self.close()
            raise
        self._free_transient(slot)
        if error is not None:
            raise WireError(f"shm ping failed on the node: {error}")
        return time.perf_counter() - t0


# ---------------------------------------------------------------------------
# server
# ---------------------------------------------------------------------------


def _load_dict(n_connections: int, transport: str = "shm") -> dict:
    return {
        "n_clients": n_connections,
        "transport": transport,
        "batch": {"max_batch": _BATCH_CHUNK, "queue_depth": 0},
    }


class _ShmConnection:
    """Server half of one doorbell connection: the arena pair, the
    reply-slot reclamation watermark, and the frame dispatch loop."""

    #: What GetLoad reports; the ring lane overrides to "ring".
    _transport = "shm"

    def __init__(
        self,
        conn: socket.socket,
        compute_fn: Callable[..., Sequence[np.ndarray]],
        arena_bytes: int,
        n_connections: Callable[[], int],
    ) -> None:
        self.conn = conn
        self.compute_fn = compute_fn
        self.arena_bytes = arena_bytes
        self.n_connections = n_connections
        self.req_arena: Optional[Arena] = None
        self.rep_arena: Optional[Arena] = None
        self._unlinked = False
        self._live_replies: List[Tuple[int, int]] = []  # (gen, slot)

    # -- arena plumbing ----------------------------------------------------

    def _attach_reply(self, uid: bytes) -> bytes:
        if self.req_arena is None:
            self.req_arena = Arena.create(self.arena_bytes, writer=False)
            self.rep_arena = Arena.create(self.arena_bytes, writer=True)
        spec = json.dumps(
            {
                "req": self.req_arena.path,
                "rep": self.rep_arena.path,
                "size": self.req_arena.capacity,
                "arena_id": uuid_mod.uuid4().hex,
            }
        ).encode("utf-8")
        return encode_frame(
            _KIND_ATTACH_OK, uid, _U32.pack(len(spec)) + spec
        )

    def _unlink_arenas(self) -> None:
        """The peer has proven it mapped the files (it sent a
        post-attach frame): unlink NOW so a SIGKILL'd process leaks
        nothing in /dev/shm."""
        if not self._unlinked and self.req_arena is not None:
            import os as _os

            for arena in (self.req_arena, self.rep_arena):
                if arena is not None:
                    try:
                        _os.unlink(arena.path)
                    except OSError:
                        pass
            self._unlinked = True

    def _reclaim(self, ack_gen: int) -> None:
        """Free reply slots the client acknowledged (FIFO: generations
        are allocation-ordered)."""
        assert self.rep_arena is not None
        while self._live_replies and self._live_replies[0][0] <= ack_gen:
            _gen, slot = self._live_replies.pop(0)
            self.rep_arena.free(slot)

    def _write_reply_arrays(
        self, arrays: Sequence[np.ndarray]
    ) -> List[Desc]:
        assert self.rep_arena is not None
        slot, descs = _write_arrays(self.rep_arena, arrays)
        if _fi.active_plan is not None:  # chaos seam: arena write
            fault = _fi.arena_fault("shm.arena.reply")
            if fault == "truncate_slot" and slot is not None:
                self.rep_arena.scribble_tail(slot)
            elif fault == "stale_generation":
                descs = [
                    (s, d, ln, g + 1, dt, sh)
                    for s, d, ln, g, dt, sh in descs
                ]
        if descs:
            self._live_replies.append((descs[0][3], descs[0][0]))
        elif slot is not None:
            self._live_replies.append((0, slot))
        return descs

    def _request_arrays(self, descs: Sequence[Desc]) -> List[np.ndarray]:
        assert self.req_arena is not None
        # copy=False: the node computes straight on the shared pages —
        # the zero-copy read that is this lane's whole point; the
        # client must not recycle until the reply (FIFO protocol), and
        # if it does anyway the generation check above fails loudly.
        return [
            _read_arena_array(self.req_arena, d, copy=False)
            for d in descs
        ]

    # -- dispatch ----------------------------------------------------------

    def serve(self) -> None:
        conn = self.conn
        try:
            with conn:
                conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                while True:
                    try:
                        payload = _recv_frame(conn)
                    except (ConnectionError, OSError):
                        break
                    if _fi.active_plan is not None:  # chaos seam
                        try:
                            payload = _fi.filter_bytes(
                                "shm.server.recv", payload
                            )
                        except (ConnectionError, OSError):
                            break
                    try:
                        reply = self._one_frame(payload)
                    except _fi.FaultPlanError:
                        raise  # plan-authoring bug: LOUD, not in-band
                    except Exception as e:
                        # An undecodable doorbell frame fails ITS reply
                        # in-band; the connection keeps serving.
                        _flightrec.record(
                            "server.error", stage="decode",
                            wire="shm", transport="shm",
                            error=str(e)[:200],
                        )
                        reply = encode_frame(
                            _KIND_ERROR, b"\0" * 16, error=str(e)
                        )
                    if reply is None:
                        continue
                    try:
                        if _fi.active_plan is not None:  # chaos seam
                            _fi.send_frame_through(
                                "shm.server.send", conn.sendall, reply
                            )
                        else:
                            _send_frame(conn, reply)
                    except (ConnectionError, OSError):
                        break
        finally:
            for arena in (self.req_arena, self.rep_arena):
                if arena is not None:
                    arena.close(unlink=not self._unlinked)

    def _one_frame(self, payload: bytes) -> Optional[bytes]:
        if payload[:4] != MAGIC:
            # npwire fallback lane: the pool's zero-item batch probe,
            # or a plain-frame peer — served with full parity.
            return serve_npwire_payload(
                self.compute_fn, payload, transport="shm"
            )
        (
            kind, uid, _err, trace_id, deadline_s, partition,
            step_version, off, payload,
        ) = decode_frame(
            payload
        )
        if kind == _KIND_ATTACH:
            return self._attach_reply(uid)
        if self.req_arena is None:
            return encode_frame(
                _KIND_ERROR, uid, error="shm frame before ATTACH"
            )
        self._unlink_arenas()
        if kind in (_KIND_EVAL, _KIND_EVAL_BATCH):
            # Admission enforcement: an expired budget is answered in
            # band and never computed (service/deadline.py vocabulary).
            err = _deadline.shed_expired_admission(
                deadline_s, transport="shm"
            )
            if err is not None:
                if kind == _KIND_EVAL:
                    return encode_frame(
                        _KIND_REPLY, uid, encode_descs([]), error=err
                    )
                return encode_frame(
                    _KIND_REPLY_BATCH, uid,
                    _U32.pack(0), error=err,
                )
            _node_metrics.INFLIGHT.inc()
            try:
                with _deadline.budget_scope(deadline_s):
                    if kind == _KIND_EVAL:
                        return self._serve_eval(
                            payload, uid, trace_id, off,
                            partition=partition,
                            version=step_version,
                        )
                    if partition is not None:
                        # Outer partition on a batch frame = a REDUCE
                        # window (routing/partition.py).
                        return self._serve_eval_reduce(
                            payload, uid, trace_id, off, partition
                        )
                    return self._serve_eval_batch(
                        payload, uid, trace_id, off
                    )
            finally:
                _node_metrics.INFLIGHT.dec()
        if kind == _KIND_ACK:
            try:
                (ack,) = _U64.unpack_from(payload, off)
            except struct.error as e:
                raise WireError(f"truncated shm ack: {e}") from None
            self._reclaim(ack)
            return None
        if kind == _KIND_GETLOAD:
            if _fi.active_plan is not None:  # chaos seam: getload lane
                garbage = _fi.getload_filter("shm.server.getload")
                if garbage is not None:
                    return encode_frame(
                        _KIND_LOAD, uid,
                        _U32.pack(len(garbage)) + garbage,
                    )
            spec = json.dumps(
                _load_dict(self.n_connections(), self._transport)
            ).encode("utf-8")
            return encode_frame(
                _KIND_LOAD, uid, _U32.pack(len(spec)) + spec
            )
        if kind == _KIND_PING:
            try:
                descs, _off = decode_descs(payload, off)
                for d in descs:
                    _read_arena_array(self.req_arena, d, copy=False)
            except WireError as e:
                return encode_frame(_KIND_PONG, uid, error=str(e))
            return encode_frame(_KIND_PONG, uid)
        return encode_frame(
            _KIND_ERROR, uid, error=f"unexpected shm frame kind {kind}"
        )

    def _serve_eval(
        self,
        payload: bytes,
        uid: bytes,
        trace_id: Optional[bytes],
        off: int,
        partition: Optional[tuple] = None,
        version: Optional[int] = None,
    ) -> bytes:
        # Same pftpu_server_* families as the gRPC/TCP lanes
        # (_node_metrics) so an shm node aggregates in the fleet view.
        _node_metrics.REQUESTS.labels(method="evaluate").inc()
        t_arrive = time.perf_counter()
        try:
            (ack,) = _U64.unpack_from(payload, off)
            self._reclaim(ack)
            descs, _off = decode_descs(payload, off + 8)
            arrays = self._request_arrays(descs)
        except WireError as e:
            _node_metrics.ERRORS.labels(kind="decode").inc()
            _flightrec.record(
                "server.error", stage="decode", wire="shm",
                transport="shm", error=str(e)[:200],
            )
            return encode_frame(
                _KIND_REPLY, uid, encode_descs([]),
                error=f"decode error: {e}",
            )
        t_decoded = time.perf_counter()
        _node_metrics.DECODE_S.observe(t_decoded - t_arrive)
        with _spans.trace_context(trace_id), _spans.span(
            "node.evaluate", wire="shm", transport="shm"
        ) as root:
            root.set_attr("decode_s", t_decoded - t_arrive)
            reply_version: Optional[int] = None
            try:
                if _fi.active_plan is not None:  # chaos seam
                    _fi.compute_filter("shm.compute")
                with _spans.span("compute") as c_span:
                    t_c0 = time.perf_counter()
                    queue_wait = max(0.0, t_c0 - t_decoded)
                    _node_metrics.QUEUE_S.observe(queue_wait)
                    c_span.set_attr("queue_wait_s", queue_wait)
                    if version is not None:
                        # Versioned sharded-optimizer lane (
                        # tcp.py has the twin dispatch): the handler
                        # owns slicing/versioning, the reply carries
                        # the NEW stamp.
                        handler = getattr(
                            self.compute_fn, "versioned_update", None
                        )
                        if handler is None:
                            raise WireError(
                                "versioned request (flag bit 32) but"
                                " this node's compute has no"
                                " versioned_update handler"
                            )
                        outputs, reply_version = handler(
                            arrays, partition, version
                        )
                        outputs = [np.asarray(o) for o in outputs]
                    else:
                        outputs = [
                            np.asarray(o)
                            for o in self.compute_fn(*arrays)
                        ]
                    _node_metrics.COMPUTE_S.observe(
                        time.perf_counter() - t_c0
                    )
                if partition is not None and version is None:
                    # Sliced reply (routing/partition.py head/tail
                    # rule); geometry disagreement is loud, in-band.
                    outputs = _partition.slice_reply(
                        outputs, _partition.GradPartition(*partition)
                    )
                with _spans.span("encode"):
                    t_e0 = time.perf_counter()
                    rdescs = self._write_reply_arrays(outputs)
                    _node_metrics.ENCODE_S.observe(
                        time.perf_counter() - t_e0
                    )
            except _fi.FaultPlanError:
                raise  # plan-authoring bug: LOUD, never in-band
            except Exception as e:
                _node_metrics.ERRORS.labels(kind="compute").inc()
                _flightrec.record(
                    "server.error", stage="compute", wire="shm",
                    transport="shm", error=str(e)[:200],
                )
                return encode_frame(
                    _KIND_REPLY, uid, encode_descs([]), error=str(e)
                )
        return encode_frame(
            _KIND_REPLY, uid, encode_descs(rdescs), partition=partition,
            version=reply_version,
        )

    def _serve_eval_batch(
        self,
        payload: bytes,
        uid: bytes,
        trace_id: Optional[bytes],
        off: int,
    ) -> bytes:
        _node_metrics.REQUESTS.labels(method="evaluate_batch").inc()
        t_arrive = time.perf_counter()
        try:
            ack, k = _QI.unpack_from(payload, off)
            self._reclaim(ack)
            off += 12
            items: List[Tuple[bytes, Optional[List[Desc]], Optional[str]]] = []
            for _ in range(k):
                iuid = payload[off : off + 16]
                if len(iuid) != 16:
                    raise WireError("truncated shm batch item")
                off += 16
                try:
                    descs, off = decode_descs(payload, off)
                except WireError as e:
                    # Frame-structure damage: cannot resync to later
                    # items — the whole frame fails (outer error).
                    raise WireError(f"batch item: {e}") from None
                items.append((iuid, descs, None))
        except (WireError, struct.error) as e:
            _node_metrics.ERRORS.labels(kind="decode").inc()
            return encode_frame(
                _KIND_REPLY_BATCH, b"\0" * 16,
                _U32.pack(0),
                error=f"decode error: {e}",
            )
        t_decoded = time.perf_counter()
        _node_metrics.DECODE_S.observe(t_decoded - t_arrive)
        with _spans.trace_context(trace_id), _spans.span(
            "node.evaluate_batch", wire="shm", transport="shm", n_items=k
        ):
            if _fi.active_plan is not None:  # chaos seam: compute path
                try:
                    _fi.compute_filter("shm.compute")
                except _fi.FaultPlanError:
                    raise
                except Exception as e:
                    return encode_frame(
                        _KIND_REPLY_BATCH, uid,
                        struct.pack("<I", 0), error=str(e),
                    )
            decoded: List[Tuple[int, List[np.ndarray], bytes]] = []
            item_errors: List[Optional[str]] = [None] * k
            t_i0 = time.perf_counter()
            for i, (iuid, descs, _e) in enumerate(items):
                try:
                    arrays = self._request_arrays(descs or [])
                    decoded.append((i, arrays, iuid))
                except WireError as e:
                    _node_metrics.ERRORS.labels(kind="decode").inc()
                    item_errors[i] = f"decode error: {e}"
            # Per-item arena reads are decode, not queue wait — same
            # attribution rule as the TCP batch lane, so the fleet
            # view names the right stage.
            item_decode_s = time.perf_counter() - t_i0
            _node_metrics.DECODE_S.observe(item_decode_s)
            batch_fn = getattr(self.compute_fn, "batch", None)
            t_c0 = time.perf_counter()
            _node_metrics.QUEUE_S.observe(
                max(0.0, t_c0 - t_decoded - item_decode_s)
            )
            outcomes = _execute_window_sync(
                self.compute_fn,
                batch_fn,
                [arrs for _i, arrs, _u in decoded],
            )
            _node_metrics.COMPUTE_S.observe(time.perf_counter() - t_c0)
            t_e0 = time.perf_counter()
            item_replies: List[bytes] = []
            outcome_by_slot: Dict[int, object] = {
                i: res for (i, _a, _u), res in zip(decoded, outcomes)
            }
            # All reply arrays of the whole batch pack into ONE arena
            # slot — one write, per-item descriptors carve it up.
            flat_outputs: List[np.ndarray] = []
            flat_plan: List[Tuple[int, int, List[np.ndarray]]] = []
            for i in range(k):
                res = outcome_by_slot.get(i)
                if item_errors[i] is not None or res is None:
                    continue
                if isinstance(res, Exception):
                    _node_metrics.ERRORS.labels(kind="compute").inc()
                    _flightrec.record(
                        "server.error", stage="compute", wire="shm",
                        transport="shm", error=str(res)[:200],
                    )
                    item_errors[i] = str(res)
                    continue
                outs = [np.asarray(o) for o in res]
                flat_plan.append((i, len(flat_outputs), outs))
                flat_outputs.extend(outs)
            all_descs: List[Desc] = []
            if flat_outputs:
                all_descs = self._write_reply_arrays(flat_outputs)
            descs_by_item: Dict[int, List[Desc]] = {}
            for i, begin, outs in flat_plan:
                descs_by_item[i] = all_descs[begin : begin + len(outs)]
            for i, (iuid, _d, _e) in enumerate(items):
                err = item_errors[i]
                if err is not None:
                    eb = err.encode("utf-8")
                    item_replies.append(
                        iuid + _U32.pack(len(eb)) + eb
                    )
                else:
                    item_replies.append(
                        iuid
                        + _U32.pack(0)
                        + encode_descs(descs_by_item.get(i, []))
                    )
        body = _U32.pack(k) + b"".join(item_replies)
        _node_metrics.ENCODE_S.observe(time.perf_counter() - t_e0)
        return encode_frame(_KIND_REPLY_BATCH, uid, body)

    def _serve_eval_reduce(
        self,
        payload: bytes,
        uid: bytes,
        trace_id: Optional[bytes],
        off: int,
        partition: tuple,
    ) -> bytes:
        """One REDUCE window over the doorbell (EVAL_BATCH + outer
        partition block): sum the items' replies (head whole, tails
        flat-concatenated — routing/partition.py), answer the sum as
        ``count`` partition-indexed REPLY_BATCH items in INDEX ORDER
        (item 0 = [head, slice 0], items 1.. = [slice i]; the doorbell
        item framing has no per-item flag bits, so order+outer-echo IS
        the correlation — both ends derive the same plan from
        ``(total, count)``).  All-or-nothing: any item failure fails
        the window in-band (no silent partial sums)."""
        _node_metrics.REQUESTS.labels(method="evaluate_reduce").inc()
        t_arrive = time.perf_counter()

        def outer_error(err: str) -> bytes:
            return encode_frame(
                _KIND_REPLY_BATCH, uid, _U32.pack(0), error=err
            )

        try:
            req_part = _partition.GradPartition(*partition).validate()
            ack, k = _QI.unpack_from(payload, off)
            self._reclaim(ack)
            off += 12
            windows: List[List[np.ndarray]] = []
            for _ in range(k):
                iuid = payload[off : off + 16]
                if len(iuid) != 16:
                    raise WireError("truncated shm batch item")
                off += 16
                descs, off = decode_descs(payload, off)
                windows.append(self._request_arrays(descs))
        except (WireError, struct.error) as e:
            _node_metrics.ERRORS.labels(kind="decode").inc()
            return outer_error(f"decode error: {e}")
        t_decoded = time.perf_counter()
        _node_metrics.DECODE_S.observe(t_decoded - t_arrive)
        with _spans.trace_context(trace_id), _spans.span(
            "node.evaluate_reduce", wire="shm", transport="shm",
            n_items=k, count=req_part.count,
        ):
            if _fi.active_plan is not None:  # chaos seam: compute path
                try:
                    _fi.compute_filter("shm.compute")
                except _fi.FaultPlanError:
                    raise
                except Exception as e:
                    return outer_error(str(e))
            try:
                if not windows:
                    raise _partition.PartitionError(
                        "cannot reduce an empty window"
                    )
                reduce_fn = getattr(self.compute_fn, "reduce", None)
                t_c0 = time.perf_counter()
                _node_metrics.QUEUE_S.observe(max(0.0, t_c0 - t_decoded))
                if reduce_fn is not None:
                    summed = [np.asarray(o) for o in reduce_fn(windows)]
                else:
                    outcomes = _execute_window_sync(
                        self.compute_fn,
                        getattr(self.compute_fn, "batch", None),
                        windows,
                    )
                    for res in outcomes:
                        if isinstance(res, Exception):
                            raise res
                    summed = _partition.reduce_replies(outcomes)
                _node_metrics.COMPUTE_S.observe(
                    time.perf_counter() - t_c0
                )
                _layout, total, _dtype = _partition.tail_layout(summed)
                if req_part.total and req_part.total != total:
                    raise _partition.PartitionError(
                        f"partition total {req_part.total} != window "
                        f"tail size {total} (driver/node shape "
                        "disagreement)"
                    )
                t_e0 = time.perf_counter()
                plan = _partition.plan_partitions(total, req_part.count)
                flat = _partition.concat_tail(summed)
                # All slices (plus the head) pack into ONE arena slot;
                # per-item descriptors carve it up, items in index
                # order under the outer uuid.
                flat_outputs: List[np.ndarray] = [np.asarray(summed[0])]
                for p in plan:
                    flat_outputs.append(
                        flat[p.offset : p.offset + p.length]
                    )
                all_descs = self._write_reply_arrays(flat_outputs)
                item_replies: List[bytes] = []
                for j, p in enumerate(plan):
                    descs = [all_descs[1 + j]]
                    if j == 0:
                        descs.insert(0, all_descs[0])
                    # Item identity = outer uuid + the partition index
                    # (doorbell items carry no per-item flag blocks):
                    # a duplicated/reordered slice — even one of equal
                    # length — fails the client's identity check
                    # loudly instead of reassembling silently wrong.
                    item_replies.append(
                        uid[:12]
                        + _U32.pack(p.index)
                        + _U32.pack(0)
                        + encode_descs(descs)
                    )
                    _partition.PARTITION_SHARDS.labels(
                        outcome="ok"
                    ).inc()
                if _fi.active_plan is not None:  # chaos seam: shards
                    item_replies = _fi.shard_filter(
                        "partition.reply", item_replies, block_off=20
                    )
                body = _U32.pack(len(item_replies)) + b"".join(
                    item_replies
                )
                _node_metrics.ENCODE_S.observe(
                    time.perf_counter() - t_e0
                )
                return encode_frame(
                    _KIND_REPLY_BATCH,
                    uid,
                    body,
                    partition=_partition.GradPartition(
                        0, req_part.count, 0, total, total
                    ),
                )
            except _fi.FaultPlanError:
                raise  # plan-authoring bug: LOUD, never in-band
            except Exception as e:
                if isinstance(e, _partition.PartitionError):
                    _partition.PARTITION_SHARDS.labels(
                        outcome="error"
                    ).inc()
                _node_metrics.ERRORS.labels(kind="compute").inc()
                _flightrec.record(
                    "server.error", stage="reduce", wire="shm",
                    transport="shm", error=str(e)[:200],
                )
                return outer_error(str(e))


def serve_shm(
    compute_fn: Callable[..., Sequence[np.ndarray]],
    host: str = "127.0.0.1",
    port: int = 0,
    *,
    ready_callback: Optional[Callable[[int], None]] = None,
    max_connections: Optional[int] = None,
    arena_bytes: int = DEFAULT_ARENA_BYTES,
    concurrent: bool = True,
    _connection_cls: Optional[Callable[..., "_ShmConnection"]] = None,
) -> None:
    """Blocking shm-lane node: doorbell accept loop + one arena pair
    per connection.  Mirrors :func:`~.tcp.serve_tcp_once`'s surface
    (``port=0`` + ``ready_callback``, ``max_connections``,
    ``concurrent``); also answers plain npwire frames, so pool probes
    and npwire peers work without knowing about arenas.  Corrupt
    frames and bad descriptors are answered in-band — a hostile or
    chaos-mangled request must never tear down the node.

    Contract: ``compute_fn`` receives READ-ONLY zero-copy views of the
    request arrays (they ARE the shared pages — that is the lane); a
    compute that mutates its inputs in place must copy first (or serve
    over :func:`~.tcp.serve_tcp_once`, whose default decodes owned
    copies).

    ``_connection_cls`` is a private seam for the ring lane
    (:func:`~.ring.serve_ring`): a factory with ``_ShmConnection``'s
    constructor signature that supplies the per-connection handler."""
    active = [0]
    lock = threading.Lock()
    conn_cls = _ShmConnection if _connection_cls is None else _connection_cls

    def n_connections() -> int:
        with lock:
            return active[0]

    def run(conn: socket.socket) -> None:
        with lock:
            active[0] += 1
        try:
            conn_cls(
                conn, compute_fn, arena_bytes, n_connections
            ).serve()
        finally:
            with lock:
                active[0] -= 1

    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as srv:
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind((host, port))
        srv.listen(16)
        if ready_callback is not None:
            ready_callback(srv.getsockname()[1])
        served = 0
        while max_connections is None or served < max_connections:
            conn, _ = srv.accept()
            served += 1
            if concurrent:
                threading.Thread(
                    target=run, args=(conn,), daemon=True
                ).start()
            else:
                run(conn)

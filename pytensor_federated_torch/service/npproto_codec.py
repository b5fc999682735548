"""Hand-rolled proto3 codec for the REFERENCE wire format.

The reference speaks protobuf over gRPC (reference:
protobufs/npproto/ndarray.proto:7-12, protobufs/service.proto:6-19,
rpc.py:31-72 via betterproto/grpclib).  npwire (this package's native
framing) is deliberately different — but a migrating user must be able
to point THIS client at an unmodified reference node pool, and a
reference client at this package's nodes.  This module implements
exactly the four message types those two .proto files define, as plain
proto3 wire-format encode/decode with no codegen and no protobuf
dependency:

    npproto.ndarray   data(1: bytes) dtype(2: string)
                      shape(3: repeated int64) strides(4: repeated int64)
    InputArrays       items(1: repeated ndarray) uuid(2: string)
    OutputArrays      items(1: repeated ndarray) uuid(2: string)

plus FOUR extension fields this package emits and understands:
``trace_id(15: bytes)`` on InputArrays — the 16-byte telemetry
correlation id (:mod:`..telemetry.spans`); ``spans(16: bytes)`` on
OutputArrays — a JSON list of the node's completed span trees for
that call, piggybacked on the reply so the driver can reunite both
halves of the trace (:mod:`..telemetry.reunion`);
``batch_items(17: repeated bytes)`` — K nested InputArrays/
OutputArrays messages making the message a BATCH frame (one RPC
message per pipelined window, the npproto twin of npwire flag bit 8;
:func:`encode_batch_msg`); ``error(14: string)`` — a per-item
compute/decode error INSIDE a batch reply item, the isolation channel
the reference schema lacks (outside batches npproto errors still
surface as gRPC aborts, unchanged); and ``deadline_s(18: double)`` —
the request's remaining deadline budget in relative seconds
(:mod:`.deadline`; the npproto twin of npwire flag bit 16, enforced at
server admission); and ``tenant_id(19: string)`` — the gateway tier's
per-tenant identity (:mod:`..gateway.fairness`; the npproto twin of
npwire flag bit 32); and ``partition(20: message)`` — the
gradient-partition index block (``routing/partition.py``; the npproto
twin of npwire flag bit 64): a nested message of varint sub-fields
``index(1) count(2) offset(3) length(4) total(5)``
(``wire_registry.NPPROTO_PARTITION_FIELDS``).  Fields 14-20 are
unknown to the
reference schema, so an unmodified reference peer skips them by wire
type (the standard proto3 forward-compatibility rule, property-tested
against the official runtime); they cost nothing when absent — and a
reference peer never RECEIVES a batch frame at all: clients only
coalesce toward a server whose GetLoad advertised the capability.
    GetLoadParams     (empty)
    GetLoadResult     n_clients(1: int32) percent_cpu(2: float)
                      percent_ram(3: float)

Wire-format notes (proto3 spec):

- varints are little-endian base-128; int32/int64 negatives are
  10-byte two's-complement varints (NOT zigzag — that is sint*).
- repeated int64 accepts BOTH packed (len-delimited, the proto3
  default emitted here) and unpacked (one varint per element) forms on
  decode, as the spec requires of parsers.
- unknown fields are skipped by wire type (forward compatibility);
  truncated/overlong/invalid payloads raise :class:`~.npwire.WireError`
  loudly — same failure contract as npwire (property-tested).
- encoding is canonical: fields in ascending number order, packed
  repeats, nothing emitted for empty/default scalars — byte-identical
  to the official protobuf encoder for these messages (cross-checked
  against the google.protobuf runtime in tests when available).

ndarray conversion semantics match the reference helpers
(reference: npproto/utils.py:9-24): ``dtype=str(arr.dtype)``,
``data=bytes(arr.data)``, shape and strides in element/byte units; on
decode the array is materialized from (buffer, dtype, shape, strides).
``dtype=object`` is rejected loudly — the reference ships pointers that
only round-trip in-process (reference: README.md:30, test_npproto.py:20);
here it is the same hard error npwire raises.
"""

from __future__ import annotations

import json
import struct
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..faultinject import runtime as _fi
from .npwire import WireError

__all__ = [
    "encode_ndarray",
    "decode_ndarray",
    "encode_arrays_msg",
    "decode_arrays_msg",
    "decode_arrays_msg_ex",
    "decode_arrays_msg_all",
    "decode_arrays_msg_full",
    "encode_batch_msg",
    "decode_batch_msg",
    "has_batch_items",
    "peek_deadline_msg",
    "peek_tenant_msg",
    "peek_partition_msg",
    "peek_version_msg",
    "append_spans_msg",
    "encode_get_load_result",
    "decode_get_load_result",
    "GETLOAD_PARAMS",
]

# GetLoadParams has no fields: its canonical encoding is empty.
GETLOAD_PARAMS = b""

_WT_VARINT = 0
_WT_I64 = 1
_WT_LEN = 2
_WT_I32 = 5


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------


def _encode_varint(value: int) -> bytes:
    """Unsigned base-128 varint (callers pre-map negatives)."""
    if value < 0:
        raise WireError(f"varint must be non-negative, got {value}")
    out = bytearray()
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _encode_int64(value: int) -> bytes:
    """int32/int64 field encoding: negatives as 64-bit two's complement."""
    if not -(1 << 63) <= value < (1 << 64):
        raise WireError(f"int64 out of range: {value}")
    return _encode_varint(value & 0xFFFFFFFFFFFFFFFF)


def _decode_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    start = pos
    while True:
        if pos >= len(buf):
            raise WireError(f"truncated varint at byte {start}")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 63:
            raise WireError(f"overlong varint at byte {start}")


def _to_int64(raw: int) -> int:
    """Interpret a decoded varint as a signed 64-bit value."""
    return raw - (1 << 64) if raw >= (1 << 63) else raw


def _tag(field: int, wire_type: int) -> bytes:
    return _encode_varint((field << 3) | wire_type)


def _len_field(field: int, payload: bytes) -> bytes:
    return _tag(field, _WT_LEN) + _encode_varint(len(payload)) + payload


def _decode_tag(buf: bytes, pos: int) -> Tuple[int, int, int]:
    raw, pos = _decode_varint(buf, pos)
    field, wire_type = raw >> 3, raw & 0x7
    if field == 0:
        raise WireError(f"illegal field number 0 at byte {pos}")
    return field, wire_type, pos


def _decode_len(buf: bytes, pos: int) -> Tuple[bytes, int]:
    n, pos = _decode_varint(buf, pos)
    end = pos + n
    if end > len(buf):
        raise WireError(
            f"length-delimited field overruns buffer ({end} > {len(buf)})"
        )
    return buf[pos:end], end


def _skip(buf: bytes, pos: int, wire_type: int) -> int:
    """Skip an unknown field's payload (forward compatibility)."""
    if wire_type == _WT_VARINT:
        _, pos = _decode_varint(buf, pos)
        return pos
    if wire_type == _WT_I64:
        if pos + 8 > len(buf):
            raise WireError("truncated fixed64 field")
        return pos + 8
    if wire_type == _WT_LEN:
        _, pos = _decode_len(buf, pos)
        return pos
    if wire_type == _WT_I32:
        if pos + 4 > len(buf):
            raise WireError("truncated fixed32 field")
        return pos + 4
    raise WireError(f"unsupported wire type {wire_type}")


def _decode_repeated_int64(
    buf: bytes, pos: int, wire_type: int, into: List[int]
) -> int:
    """One occurrence of a repeated int64 field: packed or unpacked."""
    if wire_type == _WT_LEN:  # packed
        payload, pos = _decode_len(buf, pos)
        p = 0
        while p < len(payload):
            raw, p = _decode_varint(payload, p)
            into.append(_to_int64(raw))
        return pos
    if wire_type == _WT_VARINT:  # unpacked
        raw, pos = _decode_varint(buf, pos)
        into.append(_to_int64(raw))
        return pos
    raise WireError(f"repeated int64 field with wire type {wire_type}")


# ---------------------------------------------------------------------------
# partition sub-message (extension field 20)
# ---------------------------------------------------------------------------


def _encode_partition_msg(partition: Sequence[int]) -> bytes:
    """The nested partition message: varint sub-fields in
    ``wire_registry.NPPROTO_PARTITION_FIELDS`` order (index=1,
    count=2, offset=3, length=4, total=5); proto3-canonical — zero
    values are omitted."""
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
    out = bytearray()
    for num, val in enumerate((index, count, offset, length, total), 1):
        if val:
            out += _tag(num, _WT_VARINT) + _encode_varint(val)
    return bytes(out)


def _decode_partition_msg(raw: bytes) -> Tuple[int, int, int, int, int]:
    """Inverse of :func:`_encode_partition_msg`; unknown sub-fields
    are skipped (proto3 posture), absent ones default to zero."""
    vals = [0, 0, 0, 0, 0]
    pos = 0
    while pos < len(raw):
        field, wt, pos = _decode_tag(raw, pos)
        if 1 <= field <= 5 and wt == _WT_VARINT:
            v, pos = _decode_varint(raw, pos)
            vals[field - 1] = v
        else:
            pos = _skip(raw, pos, wt)
    return (vals[0], vals[1], vals[2], vals[3], vals[4])


# ---------------------------------------------------------------------------
# npproto.ndarray
# ---------------------------------------------------------------------------


def encode_ndarray(arr: np.ndarray) -> bytes:
    """numpy -> npproto.ndarray bytes (reference: npproto/utils.py:9-16)."""
    arr = np.asarray(arr)
    if arr.dtype.hasobject:
        raise WireError(
            "dtype=object cannot cross the wire (the reference serializes "
            "in-process pointers here; this codec rejects it loudly)"
        )
    # The reference wire carries dtype as str(dtype) and reconstructs
    # with np.dtype(s) (reference: npproto/utils.py:12,22) — structured
    # dtypes don't survive that round trip (str() gives a repr np.dtype
    # rejects), on EITHER end.  Fail here, loudly, not remotely.
    try:
        if np.dtype(str(arr.dtype)) != arr.dtype:
            raise TypeError("round-trip changed the dtype")
    except TypeError as e:
        raise WireError(
            f"dtype {arr.dtype!r} does not survive the reference wire's "
            f"str()/np.dtype() round trip ({e}); the native npwire codec "
            "ships structured dtypes via their full descr instead"
        ) from None
    out = bytearray()
    # NOT np.ascontiguousarray: that promotes 0-d arrays to 1-d, and
    # the strides field must stay consistent with the true shape.
    contig = arr if arr.flags.c_contiguous else arr.copy(order="C")
    data = contig.tobytes()
    # proto3 canonical: default-valued (empty) scalar fields are not
    # serialized — matches the official encoder byte for byte.
    if data:
        out += _len_field(1, data)
    out += _len_field(2, str(arr.dtype).encode("utf-8"))
    # contiguous data => contiguous strides, consistent with the shape
    if arr.shape:
        packed = b"".join(_encode_int64(s) for s in arr.shape)
        out += _len_field(3, packed)
    if contig.strides:
        packed = b"".join(_encode_int64(s) for s in contig.strides)
        out += _len_field(4, packed)
    return bytes(out)


def decode_ndarray(buf: bytes) -> np.ndarray:
    """npproto.ndarray bytes -> numpy (reference: npproto/utils.py:19-24)."""
    data: Optional[bytes] = None
    dtype_str = ""
    shape: List[int] = []
    strides: List[int] = []
    pos = 0
    while pos < len(buf):
        field, wt, pos = _decode_tag(buf, pos)
        if field == 1 and wt == _WT_LEN:
            data, pos = _decode_len(buf, pos)
        elif field == 2 and wt == _WT_LEN:
            raw, pos = _decode_len(buf, pos)
            try:
                dtype_str = raw.decode("utf-8")
            except UnicodeDecodeError as e:
                raise WireError(f"bad dtype string: {e}") from None
        elif field == 3:
            pos = _decode_repeated_int64(buf, pos, wt, shape)
        elif field == 4:
            pos = _decode_repeated_int64(buf, pos, wt, strides)
        else:
            pos = _skip(buf, pos, wt)
    try:
        dtype = np.dtype(dtype_str or "float64")
    except TypeError as e:
        raise WireError(f"bad dtype {dtype_str!r}: {e}") from None
    if dtype.hasobject:
        raise WireError("dtype=object cannot cross the wire")
    if any(s < 0 for s in shape):
        raise WireError(f"negative dimension in shape {shape}")
    try:
        return np.ndarray(
            buffer=data if data is not None else b"",
            shape=shape,
            dtype=dtype,
            strides=strides or None,
        ).copy()  # own the memory; the input buffer may be reused
    except (ValueError, TypeError) as e:
        raise WireError(
            f"inconsistent ndarray (shape={shape}, dtype={dtype_str!r}, "
            f"strides={strides}, {len(data or b'')} data bytes): {e}"
        ) from None


# ---------------------------------------------------------------------------
# InputArrays / OutputArrays (identical layout)
# ---------------------------------------------------------------------------


def encode_arrays_msg(
    arrays: Sequence[np.ndarray],
    uuid: str,
    *,
    trace_id: Optional[bytes] = None,
    error: Optional[str] = None,
    deadline_s: Optional[float] = None,
    tenant: Optional[str] = None,
    partition: Optional[Sequence[int]] = None,
    version: Optional[int] = None,
) -> bytes:
    """InputArrays/OutputArrays: repeated ndarray items + string uuid
    (reference: service.proto:6-19; uuid is the correlation id the
    reference's client checks, rpc.py:37-39).  ``trace_id`` emits the
    telemetry extension field 15 (module docstring); ``error`` emits
    the per-item error extension field 14 — only used on items INSIDE
    a batch reply, where the gRPC-abort channel cannot isolate one
    poisoned request; ``deadline_s`` emits the remaining-deadline
    extension field 18 (fixed64 double, relative seconds); ``tenant``
    emits the gateway tier's tenant-id extension field 19 (utf8
    string, non-empty); ``partition`` emits the gradient-partition
    extension field 20 (nested message — routing/partition.py owns the
    semantics); ``version`` emits the step-version extension field 21
    (varint u64 — optim/sharded.py owns the semantics; emitted even
    at 0, because field PRESENCE marks a versioned message and the
    zero stamp is the init handshake).  All ``None`` keeps the message
    byte-identical to the official encoder's output."""
    out = bytearray()
    for a in arrays:
        out += _len_field(1, encode_ndarray(a))
    if uuid:
        out += _len_field(2, uuid.encode("utf-8"))
    if error is not None:
        out += _len_field(14, error.encode("utf-8"))
    if trace_id is not None:
        if len(trace_id) != 16:
            raise WireError(
                f"trace_id must be 16 bytes, got {len(trace_id)}"
            )
        out += _len_field(15, trace_id)
    if deadline_s is not None:
        out += _tag(18, _WT_I64) + struct.pack("<d", float(deadline_s))
    if tenant is not None:
        if not tenant:
            raise WireError(
                "tenant id must be non-empty (omit it instead)"
            )
        out += _len_field(19, tenant.encode("utf-8"))
    if partition is not None:
        out += _len_field(20, _encode_partition_msg(partition))
    if version is not None:
        out += _tag(21, _WT_VARINT) + _encode_varint(
            _check_version(version)
        )
    if _fi.active_plan is not None:  # chaos seam (faultinject.runtime)
        return _fi.filter_bytes("npproto.encode", bytes(out))
    return bytes(out)


def _check_version(version: int) -> int:
    """Validate a step-version stamp for field 21 (varint u64)."""
    try:
        v = int(version)
    except (TypeError, ValueError) as e:
        raise WireError(f"version must be an int: {e}") from None
    if not 0 <= v < (1 << 64):
        raise WireError(f"version {v} outside u64 range")
    return v


def encode_batch_msg(
    items: Sequence[bytes],
    uuid: str,
    *,
    trace_id: Optional[bytes] = None,
    deadline_s: Optional[float] = None,
    tenant: Optional[str] = None,
    partition: Optional[Sequence[int]] = None,
    version: Optional[int] = None,
) -> bytes:
    """Frame K already-encoded InputArrays/OutputArrays messages as ONE
    batch message (extension field 17) — the npproto twin of
    :func:`..npwire.encode_batch`.  The outer uuid correlates the
    window; each nested item keeps its own uuid (and, on replies, its
    own field-14 error), so failure isolation is per item.  Only sent
    to peers that advertised the capability via GetLoad — a reference
    runtime would skip field 17 and see an empty message, which is why
    negotiation gates the send."""
    out = bytearray()
    if uuid:
        out += _len_field(2, uuid.encode("utf-8"))
    if trace_id is not None:
        if len(trace_id) != 16:
            raise WireError(
                f"trace_id must be 16 bytes, got {len(trace_id)}"
            )
        out += _len_field(15, trace_id)
    if deadline_s is not None:
        out += _tag(18, _WT_I64) + struct.pack("<d", float(deadline_s))
    if tenant is not None:
        if not tenant:
            raise WireError(
                "tenant id must be non-empty (omit it instead)"
            )
        out += _len_field(19, tenant.encode("utf-8"))
    if partition is not None:
        out += _len_field(20, _encode_partition_msg(partition))
    if version is not None:
        out += _tag(21, _WT_VARINT) + _encode_varint(
            _check_version(version)
        )
    for item in items:
        out += _len_field(17, item)
    if _fi.active_plan is not None:  # chaos seam (faultinject.runtime)
        return _fi.filter_bytes("npproto.encode_batch", bytes(out))
    return bytes(out)


def has_batch_items(buf: bytes) -> bool:
    """Whether a message carries batch items (field 17) at top level —
    the server's cheap batch-vs-plain dispatch (tags are skipped, no
    ndarray decode happens)."""
    pos = 0
    try:
        while pos < len(buf):
            field, wt, pos = _decode_tag(buf, pos)
            if field == 17 and wt == _WT_LEN:
                return True
            pos = _skip(buf, pos, wt)
    except WireError:
        return False
    return False


def peek_deadline_msg(buf: bytes) -> Optional[float]:
    """The message's remaining-deadline budget (field 18, fixed64
    double, relative seconds), or ``None`` when absent — a skip-walk
    like :func:`has_batch_items`, so server admission can enforce the
    deadline before paying any ndarray decode.  Raises
    :class:`~.npwire.WireError` on structurally broken messages (the
    full decoder would reject them identically)."""
    pos = 0
    while pos < len(buf):
        field, wt, pos = _decode_tag(buf, pos)
        if field == 18 and wt == _WT_I64:
            if pos + 8 > len(buf):
                raise WireError("truncated deadline_s field")
            (budget,) = struct.unpack_from("<d", buf, pos)
            return budget
        pos = _skip(buf, pos, wt)
    return None


def peek_tenant_msg(buf: bytes) -> Optional[str]:
    """The message's tenant id (field 19, utf8 string), or ``None``
    when absent — a skip-walk like :func:`peek_deadline_msg`, so the
    gateway can meter quotas before paying any ndarray decode.  Raises
    :class:`~.npwire.WireError` on structurally broken messages."""
    pos = 0
    while pos < len(buf):
        field, wt, pos = _decode_tag(buf, pos)
        if field == 19 and wt == _WT_LEN:
            raw, pos = _decode_len(buf, pos)
            try:
                return raw.decode("utf-8")
            except UnicodeDecodeError as e:
                raise WireError(f"bad tenant id string: {e}") from None
        pos = _skip(buf, pos, wt)
    return None


def peek_partition_msg(buf: bytes) -> Optional[Tuple[int, int, int, int, int]]:
    """The message's partition block (field 20) as a 5-int tuple, or
    ``None`` when absent — a skip-walk like :func:`peek_deadline_msg`,
    so the partitioned server lanes can dispatch before any ndarray
    decode.  Raises :class:`~.npwire.WireError` on structurally broken
    messages."""
    pos = 0
    while pos < len(buf):
        field, wt, pos = _decode_tag(buf, pos)
        if field == 20 and wt == _WT_LEN:
            raw, pos = _decode_len(buf, pos)
            return _decode_partition_msg(raw)
        pos = _skip(buf, pos, wt)
    return None


def peek_version_msg(buf: bytes) -> Optional[int]:
    """The message's step-version stamp (field 21, varint u64) as an
    int, or ``None`` when absent — a skip-walk like
    :func:`peek_deadline_msg`, so the versioned sharded-optimizer lane
    (optim/sharded.py) can dispatch before any ndarray decode.  Zero
    is a meaningful stamp, which is why absence is ``None``, never 0.
    Raises :class:`~.npwire.WireError` on structurally broken
    messages."""
    pos = 0
    while pos < len(buf):
        field, wt, pos = _decode_tag(buf, pos)
        if field == 21 and wt == _WT_VARINT:
            raw, pos = _decode_varint(buf, pos)
            return raw
        pos = _skip(buf, pos, wt)
    return None


def decode_batch_msg(
    buf: bytes,
) -> Tuple[List[bytes], str, Optional[bytes], Optional[list]]:
    """Decode a batch message -> (items, uuid, trace_id, spans);
    ``items`` are the nested messages still encoded (decode each with
    :func:`decode_arrays_msg_full`)."""
    if _fi.active_plan is not None:  # chaos seam (faultinject.runtime)
        buf = _fi.filter_bytes("npproto.decode_batch", buf)
    items: List[bytes] = []
    uuid = ""
    trace_id: Optional[bytes] = None
    spans: Optional[list] = None
    pos = 0
    while pos < len(buf):
        field, wt, pos = _decode_tag(buf, pos)
        if field == 17 and wt == _WT_LEN:
            item, pos = _decode_len(buf, pos)
            items.append(item)
        elif field == 2 and wt == _WT_LEN:
            raw, pos = _decode_len(buf, pos)
            try:
                uuid = raw.decode("utf-8")
            except UnicodeDecodeError as e:
                raise WireError(f"bad uuid string: {e}") from None
        elif field == 15 and wt == _WT_LEN:
            raw, pos = _decode_len(buf, pos)
            trace_id = raw if len(raw) == 16 else None
        elif field == 16 and wt == _WT_LEN:
            raw, pos = _decode_len(buf, pos)
            try:
                parsed = json.loads(raw.decode("utf-8"))
            except (UnicodeDecodeError, ValueError):
                parsed = None  # tolerant: sidecar only, never the payload
            spans = parsed if isinstance(parsed, list) else None
        elif field == 18 and wt == _WT_I64:
            # deadline_s: consumed and dropped here — admission reads
            # it pre-decode via peek_deadline_msg, keeping this tuple
            # shape stable for every existing caller.
            if pos + 8 > len(buf):
                raise WireError("truncated deadline_s field")
            pos += 8
        elif field == 19 and wt == _WT_LEN:
            # tenant_id: consumed and dropped (peek_tenant_msg is the
            # gateway-side reader; same posture as deadline_s).
            _raw, pos = _decode_len(buf, pos)
        elif field == 20 and wt == _WT_LEN:
            # partition: consumed and dropped (peek_partition_msg is
            # the partition-lane reader; same posture as deadline_s).
            _raw, pos = _decode_len(buf, pos)
        elif field == 21 and wt == _WT_VARINT:
            # version: consumed and dropped (peek_version_msg is the
            # sharded-optimizer-lane reader; same posture as deadline_s).
            _raw, pos = _decode_varint(buf, pos)
        else:
            pos = _skip(buf, pos, wt)
    return items, uuid, trace_id, spans


def append_spans_msg(buf: bytes, spans: Sequence[dict]) -> bytes:
    """Attach the spans extension (field 16, JSON) to an already-encoded
    OutputArrays message.  Proto3 fields may appear in any order, so
    appending a length-delimited field to valid message bytes yields a
    valid message — the node-side piggyback needs no re-encode (mirror
    of :func:`..npwire.append_spans`)."""
    # default=str: free-form span attrs (numpy scalars included) must
    # degrade to their repr, never fail the reply (npwire.append_spans
    # has the same posture).
    return buf + _len_field(
        16, json.dumps(list(spans), default=str).encode("utf-8")
    )


def decode_arrays_msg(buf: bytes) -> Tuple[List[np.ndarray], str]:
    """The historical 2-tuple shape — a trace id (field 15) or spans
    (field 16) is skipped like any unknown field.  Use
    :func:`decode_arrays_msg_ex` / :func:`decode_arrays_msg_all`."""
    arrays, uuid, _ = decode_arrays_msg_ex(buf)
    return arrays, uuid


def decode_arrays_msg_ex(
    buf: bytes,
) -> Tuple[List[np.ndarray], str, Optional[bytes]]:
    """Decode InputArrays/OutputArrays -> (arrays, uuid, trace_id);
    a spans field is consumed and dropped."""
    arrays, uuid, trace_id, _ = decode_arrays_msg_all(buf)
    return arrays, uuid, trace_id


def decode_arrays_msg_all(
    buf: bytes,
) -> Tuple[List[np.ndarray], str, Optional[bytes], Optional[list]]:
    """The historical 4-tuple -> (arrays, uuid, trace_id, spans); a
    per-item error field (14, batch items only) is dropped."""
    arrays, uuid, _error, trace_id, spans = decode_arrays_msg_full(buf)
    return arrays, uuid, trace_id, spans


def decode_arrays_msg_full(
    buf: bytes,
) -> Tuple[List[np.ndarray], str, Optional[str], Optional[bytes], Optional[list]]:
    """Full decode -> (arrays, uuid, error, trace_id, spans): ``spans``
    is the piggybacked span-tree list (field 16; ``None`` when absent
    or unparseable — a garbled instrumentation sidecar must not fail
    the RPC that carried real results); ``error`` is the per-item
    failure channel (field 14) batch reply items carry."""
    if _fi.active_plan is not None:  # chaos seam (faultinject.runtime)
        buf = _fi.filter_bytes("npproto.decode", buf)
    arrays: List[np.ndarray] = []
    uuid = ""
    error: Optional[str] = None
    trace_id: Optional[bytes] = None
    spans: Optional[list] = None
    pos = 0
    while pos < len(buf):
        field, wt, pos = _decode_tag(buf, pos)
        if field == 1 and wt == _WT_LEN:
            item, pos = _decode_len(buf, pos)
            arrays.append(decode_ndarray(item))
        elif field == 2 and wt == _WT_LEN:
            raw, pos = _decode_len(buf, pos)
            try:
                uuid = raw.decode("utf-8")
            except UnicodeDecodeError as e:
                raise WireError(f"bad uuid string: {e}") from None
        elif field == 14 and wt == _WT_LEN:
            raw, pos = _decode_len(buf, pos)
            try:
                error = raw.decode("utf-8")
            except UnicodeDecodeError as e:
                raise WireError(f"bad error string: {e}") from None
        elif field == 15 and wt == _WT_LEN:
            raw, pos = _decode_len(buf, pos)
            # Tolerant on length: a future sender might widen the id;
            # only the exact 16-byte form correlates spans here.
            trace_id = raw if len(raw) == 16 else None
        elif field == 16 and wt == _WT_LEN:
            raw, pos = _decode_len(buf, pos)
            try:
                parsed = json.loads(raw.decode("utf-8"))
            except (UnicodeDecodeError, ValueError):
                parsed = None  # tolerant: sidecar only, never the payload
            spans = parsed if isinstance(parsed, list) else None
        elif field == 18 and wt == _WT_I64:
            # deadline_s: consumed and dropped (peek_deadline_msg is
            # the admission-side reader; see decode_batch_msg).
            if pos + 8 > len(buf):
                raise WireError("truncated deadline_s field")
            pos += 8
        elif field == 19 and wt == _WT_LEN:
            # tenant_id: consumed and dropped (peek_tenant_msg is the
            # gateway-side reader; see decode_batch_msg).
            _raw, pos = _decode_len(buf, pos)
        elif field == 20 and wt == _WT_LEN:
            # partition: consumed and dropped (peek_partition_msg is
            # the partition-lane reader; see decode_batch_msg).
            _raw, pos = _decode_len(buf, pos)
        elif field == 21 and wt == _WT_VARINT:
            # version: consumed and dropped (peek_version_msg is the
            # sharded-optimizer-lane reader; see decode_batch_msg).
            _raw, pos = _decode_varint(buf, pos)
        else:
            pos = _skip(buf, pos, wt)
    return arrays, uuid, error, trace_id, spans


# ---------------------------------------------------------------------------
# GetLoadResult
# ---------------------------------------------------------------------------


# GetLoad chaos injects at the LANE point (server.getload via
# getload_filter, which swaps the whole reply for GETLOAD_GARBAGE) —
# this pair deliberately carries no byte seam of its own.
# graftlint: disable=fault-shim-coverage -- GetLoad lane injects via getload_filter
def encode_get_load_result(
    n_clients: int, percent_cpu: float, percent_ram: float
) -> bytes:
    out = bytearray()
    if n_clients:
        out += _tag(1, _WT_VARINT) + _encode_int64(n_clients)
    if percent_cpu:
        out += _tag(2, _WT_I32) + struct.pack("<f", percent_cpu)
    if percent_ram:
        out += _tag(3, _WT_I32) + struct.pack("<f", percent_ram)
    return bytes(out)


# graftlint: disable=fault-shim-coverage -- GetLoad lane injects via getload_filter
def decode_get_load_result(buf: bytes) -> dict:
    """Decode a ``GetLoadResult`` (service.proto:24-31).

    The empty buffer is the legitimate all-defaults encoding (proto3
    writers omit default fields) and decodes to the zero load.  A
    NON-empty buffer containing no known field, however, is rejected as
    :class:`WireError`: proto3's unknown-field leniency would otherwise
    decode arbitrary garbage to the all-zero — i.e. maximally
    attractive — load and silently skew pool balancing.  Schema-evolved
    replies (new fields alongside at least one known field, at any byte
    position) still decode fine.
    """
    n_clients, percent_cpu, percent_ram = 0, 0.0, 0.0
    known = False
    pos = 0
    while pos < len(buf):
        field, wt, pos = _decode_tag(buf, pos)
        if field == 1 and wt == _WT_VARINT:
            raw, pos = _decode_varint(buf, pos)
            val = _to_int64(raw)
            if not -(1 << 31) <= val < (1 << 31):
                raise WireError(f"n_clients out of int32 range: {val}")
            n_clients = val
            known = True
        elif field == 2 and wt == _WT_I32:
            if pos + 4 > len(buf):
                raise WireError("truncated percent_cpu")
            (percent_cpu,) = struct.unpack_from("<f", buf, pos)
            pos += 4
            known = True
        elif field == 3 and wt == _WT_I32:
            if pos + 4 > len(buf):
                raise WireError("truncated percent_ram")
            (percent_ram,) = struct.unpack_from("<f", buf, pos)
            pos += 4
            known = True
        else:
            pos = _skip(buf, pos, wt)
    if buf and not known:
        raise WireError("GetLoadResult decoded to unknown fields only")
    return {
        "n_clients": n_clients,
        "percent_cpu": percent_cpu,
        "percent_ram": percent_ram,
    }

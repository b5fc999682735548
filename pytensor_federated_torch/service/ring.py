"""Zero-syscall colocated lane: seqlock'd descriptor rings in the arena.

The shm lane (:mod:`.shm`) moved PAYLOAD bytes out of the kernel, but
every evaluate still pays a TCP doorbell round-trip (~66 µs in this
container) just to exchange a DESCRIPTOR frame.  This module embeds two
fixed-capacity SPSC descriptor rings in the version-2 arena mapping
(:mod:`.arena`) — a submission ring in the request arena (client
produces, node consumes) and a completion ring in the reply arena (node
produces, client consumes) — so a steady-state evaluate moves both the
request and the reply descriptor frames through shared memory with
**zero syscalls**: both ends spin a bounded, adaptive budget and only
then park on a futex word (a small ``ctypes`` syscall shim with a
pure-Python ``threading.Event``/sleep-poll fallback), and the producer
issues a ``FUTEX_WAKE`` only when the consumer has declared itself
parked via the waiting word.

Ring layout (constants declared in :mod:`.wire_registry`, cross-checked
by the graftlint wire-registry rule).  The 64-byte ring header lives at
arena offset 64, the records at offset 128::

  header: produced(u64) consumed(u64) futex(u32) waiting(u32)
          epoch(u32) capacity(u32) record_bytes(u32)
  record: seq(u64) length(u32) reserved(u32) payload(record_bytes-16)

Seqlock protocol — the arena slot-generation discipline, applied to
ring records so torn, stale, recycled, and out-of-bounds reads stay
loud :class:`~.npwire.WireError`\\ s (the wire invariant):

- the record at ring position ``p`` (``slot = p % capacity``) is
  stamped ``2p+1`` before its payload is written (mid-write) and
  ``2p+2`` after (committed), so sequences increase monotonically
  across wraparound laps and a recycled or scribbled record is
  DETECTABLE, never silently re-read;
- a consumer at position ``p`` accepts exactly ``2p+2``; a lower
  same-slot sequence (older lap, or mid-write) means *wait*; any other
  value — a future lap, a wrong-slot residue, a zero after the first
  lap — raises ``WireError``;
- after copying a record's payload the sequence is RE-checked, so a
  recycle landing mid-copy is detected before the bytes are believed.

Frames larger than one record's payload span K consecutive records
(record 0 carries the TOTAL length; continuations their chunk length).
The producer commits records in order and publishes ``produced`` once
after all K; the consumer keys readiness off record 0 and waits
bounded for continuations — a producer dying mid-span surfaces as a
classified ``TimeoutError``, never a hang.

Liveness: the ring's PRODUCER owns the epoch word (stamped 1 by the
arena creator's :func:`init_ring_header`, zeroed on clean close with a
final wake), so a parked consumer observes peer departure; abrupt death
(SIGKILL) is covered by the bounded park slice plus the client's
doorbell EOF probe — a dead peer is a classified transient
(``ConnectionError``), never a hang.  The TCP
doorbell remains the attach channel, the fallback when a ring is full
or a frame cannot fit, and the pool-probe lane: a ring-attached socket
still answers plain npwire frames unchanged.

Header words are read/written as aligned 8/4-byte stores through the
shared mapping; on every supported platform those are single-copy
atomic in practice, and the seqlock re-check converts any torn read
into a loud retry or ``WireError`` rather than silent corruption.
"""

from __future__ import annotations

import ctypes
import json
import math
import platform
import select
import socket
import struct
import threading
import time
import uuid as uuid_mod
from collections import deque
from typing import Callable, Deque, Dict, Optional, Sequence, Set, Tuple

import numpy as np

from ..faultinject import runtime as _fi
from ..telemetry import flightrec as _flightrec
from . import deadline as _deadline
from .arena import DEFAULT_ARENA_BYTES, Arena
from .npwire import WireError, fast_uuid
from .shm import (
    MAGIC,
    ShmArraysClient,
    _KIND_ACK,
    _KIND_ATTACH,
    _KIND_ATTACH_OK,
    _KIND_ERROR,
    _ShmConnection,
    _U32,
    _U64,
    decode_frame,
    encode_frame,
    serve_shm,
)

__all__ = [
    "Ring",
    "RingArraysClient",
    "serve_ring",
    "init_ring_header",
    "futex_available",
    "syscall_counts",
    "reset_syscall_counts",
    "DEFAULT_RING_SLOTS",
    "DEFAULT_RING_RECORD_BYTES",
]

# Ring constants — mirrored from service/wire_registry.py (the declared
# source; graftlint's wire-registry rule cross-checks these literals).
_RING_HEADER_STRUCT = struct.Struct("<QQIIIII")
_RING_DESC_STRUCT = struct.Struct("<QII")
_RING_HEADER_OFFSET = 64
_RING_RECORDS_OFFSET = 128
_RING_FUTEX_WORD_OFFSET = 16
_RING_WAITING_WORD_OFFSET = 20
_RING_EPOCH_WORD_OFFSET = 24

# Absolute word offsets inside the mapping (header base + field).
_PRODUCED_OFF = _RING_HEADER_OFFSET
_CONSUMED_OFF = _RING_HEADER_OFFSET + 8
_FUTEX_OFF = _RING_HEADER_OFFSET + _RING_FUTEX_WORD_OFFSET
_WAITING_OFF = _RING_HEADER_OFFSET + _RING_WAITING_WORD_OFFSET
_EPOCH_OFF = _RING_HEADER_OFFSET + _RING_EPOCH_WORD_OFFSET
_CAPACITY_OFF = _RING_HEADER_OFFSET + 28
_RECORD_BYTES_OFF = _RING_HEADER_OFFSET + 32

_RECORD_HEADER_BYTES = _RING_DESC_STRUCT.size  # seq + length + reserved
_LEN_STRUCT = struct.Struct("<II")  # length, reserved (record header tail)
_U32S = struct.Struct("<I")

#: Default ring geometry: 64 records x 4 KiB = 256 KiB of descriptor
#: space per direction — descriptor frames are small (payloads live in
#: the arena slots), so 64 in-flight frames outruns any pipelined
#: window the byte cap admits.
DEFAULT_RING_SLOTS = 64
DEFAULT_RING_RECORD_BYTES = 4096

#: Maximum single futex park before re-checking liveness (closing flag,
#: epoch word, peer probe, ambient deadline): a dead peer that never
#: wakes us is detected within one slice, never hung on.
_PARK_SLICE_S = 0.05
#: Producer backoff while the completion ring is full (server side —
#: the same-channel reply rule forbids switching a ring reply to TCP).
_PRODUCE_POLL_S = 0.0005
#: Server-side bound on producing one reply into a full completion
#: ring; a client that stopped draining for this long is gone.
_REPLY_PRODUCE_TIMEOUT_S = 60.0

# ---------------------------------------------------------------------------
# futex shim (+ syscall accounting)
# ---------------------------------------------------------------------------

_FUTEX_WAIT = 0
_FUTEX_WAKE = 1
# Per-arch syscall numbers; futexes on a SHARED mapping are keyed on
# (inode, offset), so no FUTEX_PRIVATE_FLAG — the wait/wake pair works
# across processes and across two mappings of the same file.
_FUTEX_NR = {
    "x86_64": 202,
    "aarch64": 98,
    "riscv64": 98,
    "i386": 240,
    "i686": 240,
    "armv7l": 240,
}.get(platform.machine())

#: Instrumented syscall accounting: every kernel entry this lane can
#: make on the descriptor path goes through the shim below, so
#: ``syscall_counts()`` IS the steady-state syscalls/eval measurement
#: (strace is not available in this container; bench/suite corroborate
#: with getrusage voluntary-context-switch deltas).
_syscall_counts: Dict[str, int] = {
    "futex_wait": 0,
    "futex_wake": 0,
    "fallback_poll": 0,
}


def syscall_counts() -> Dict[str, int]:
    """Snapshot of the ring lane's wait/wake syscall counters."""
    return dict(_syscall_counts)


def reset_syscall_counts() -> None:
    for k in _syscall_counts:
        _syscall_counts[k] = 0


class _Timespec(ctypes.Structure):
    _fields_ = [("tv_sec", ctypes.c_long), ("tv_nsec", ctypes.c_long)]


_libc: Optional[ctypes.CDLL] = None
_futex_broken = False


def _get_libc() -> Optional[ctypes.CDLL]:
    global _libc, _futex_broken
    if _libc is None and not _futex_broken:
        try:
            lib = ctypes.CDLL(None, use_errno=True)
            lib.syscall  # probe: raises AttributeError on exotic libcs
            _libc = lib
        except (OSError, AttributeError):
            _futex_broken = True
    return _libc


def futex_available() -> bool:
    """True when the real futex syscall shim is usable on this
    platform; False routes waits through the pure-Python fallback
    (same-process ``threading.Event`` + bounded cross-process poll)."""
    return _FUTEX_NR is not None and _get_libc() is not None


# Same-process fallback wake channel, keyed by (arena path, word
# offset): both mappings of one arena share the event.  A peer in a
# DIFFERENT process never sees the event — its waits degrade to the
# bounded <=2 ms poll, which is slow but correct.
_event_registry: Dict[Tuple[str, int], threading.Event] = {}
_event_lock = threading.Lock()


def _fallback_event(path: str, off: int) -> threading.Event:
    with _event_lock:
        ev = _event_registry.get((path, off))
        if ev is None:
            ev = threading.Event()
            _event_registry[(path, off)] = ev
        return ev


# ---------------------------------------------------------------------------
# ring header init + the Ring
# ---------------------------------------------------------------------------


def init_ring_header(arena: Arena) -> None:
    """Stamp a freshly created version-2 arena's ring header: zeroed
    counters, epoch 1, and the geometry words mirroring the arena file
    header.  CREATOR side, exactly once, BEFORE the peer attaches —
    :class:`Ring` constructors only VALIDATE the header (a stamp at
    construction time could clobber the peer consumer's counters)."""
    if arena.ring_slots <= 0:
        raise WireError("arena has no ring region (version-1 layout)")
    _RING_HEADER_STRUCT.pack_into(
        arena.mm,
        _RING_HEADER_OFFSET,
        0,  # produced
        0,  # consumed
        0,  # futex
        0,  # waiting
        1,  # epoch (0 = closed/never initialized)
        arena.ring_slots,
        arena.ring_record_bytes,
    )


class Ring:
    """One SPSC seqlock ring embedded in an arena mapping.  Exactly one
    ``role="producer"`` end and one ``role="consumer"`` end exist per
    ring (the submission ring's producer is the client, the completion
    ring's producer is the node).  Module docstring for the protocol;
    every corrupt observation raises :class:`~.npwire.WireError`."""

    def __init__(
        self,
        arena: Arena,
        *,
        role: str,
        chaos_point: Optional[str] = None,
        chaos_peer: Optional[str] = None,
    ) -> None:
        if role not in ("producer", "consumer"):
            raise ValueError(f"role must be producer/consumer, got {role!r}")
        if arena.ring_slots <= 0:
            raise WireError(
                "arena has no ring region (version-1 layout?) — "
                "ring transport needs Arena.create(ring_slots=...)"
            )
        self._arena = arena
        self._mm = arena.mm
        self._path = arena.path
        self.role = role
        self._chaos_point = chaos_point
        self._chaos_peer = chaos_peer
        try:
            (
                _produced, _consumed, _futex, _waiting,
                epoch, cap, rb,
            ) = _RING_HEADER_STRUCT.unpack_from(self._mm, _RING_HEADER_OFFSET)
        except struct.error as e:
            raise WireError(f"truncated ring header: {e}") from None
        if cap != arena.ring_slots or rb != arena.ring_record_bytes:
            raise WireError(
                f"ring header geometry {cap} x {rb} contradicts the "
                f"arena file header {arena.ring_slots} x "
                f"{arena.ring_record_bytes} — corrupt or foreign mapping"
            )
        if epoch == 0:
            raise WireError(
                "ring header epoch is 0 — never initialized or the "
                "producer already closed"
            )
        self.slots = cap
        self.record_bytes = rb
        self.payload_cap = rb - _RECORD_HEADER_BYTES
        self._epoch = epoch
        #: Local position mirror: produced count (producer role) or
        #: consumed count (consumer role).  Rings are per-connection
        #: and both ends start at 0 — no resume protocol.
        self._pos = 0
        self._spin_budget = 100
        self._closed = False
        # Persistent ctypes view of the futex word for the syscall
        # (byref needs an addressable object).  This EXPORTS the mmap
        # buffer — close() releases it so the arena mapping can drop.
        self._c_futex: Optional[ctypes.c_uint32] = (
            ctypes.c_uint32.from_buffer(self._mm, _FUTEX_OFF)
            if futex_available()
            else None
        )

    # -- producer ----------------------------------------------------------

    def try_produce(self, frame: bytes) -> bool:
        """Write one frame into the ring (spanning records as needed)
        and wake a parked consumer.  Returns False — caller falls back
        to the doorbell — when the ring lacks space or the frame can
        never fit; never blocks."""
        if self._closed:
            raise WireError("ring closed")
        total = len(frame)
        if total == 0:
            raise WireError("empty ring frame")
        cap = self.payload_cap
        nrec = -(-total // cap)
        if nrec > self.slots:
            return False  # permanently too big: doorbell territory
        consumed = _U64.unpack_from(self._mm, _CONSUMED_OFF)[0]
        if self._pos + nrec - consumed > self.slots:
            return False  # full: transient, doorbell fallback
        fault = None
        if _fi.active_plan is not None and self._chaos_point is not None:
            fault = _fi.ring_record_fault(self._chaos_point, self._chaos_peer)
        mm = self._mm
        off_in = 0
        for i in range(nrec):
            pos = self._pos + i
            rec = _RING_RECORDS_OFFSET + (pos % self.slots) * self.record_bytes
            chunk = frame[off_in : off_in + cap]
            _U64.pack_into(mm, rec, 2 * pos + 1)  # mid-write stamp
            _LEN_STRUCT.pack_into(
                mm, rec + 8, total if i == 0 else len(chunk), 0
            )
            mm[rec + 16 : rec + 16 + len(chunk)] = chunk
            commit = 2 * pos + 2
            if i == nrec - 1:
                if fault == "torn_ring_word":
                    # Chaos: the last record stays mid-write forever —
                    # the consumer's bounded wait must classify it.
                    off_in += len(chunk)
                    continue
                if fault == "stale_generation":
                    commit = 2 * (pos + self.slots) + 2  # future lap
            _U64.pack_into(mm, rec, commit)
            off_in += len(chunk)
        self._pos += nrec
        _U64.pack_into(mm, _PRODUCED_OFF, self._pos)
        self._wake()
        return True

    def produce_blocking(
        self,
        frame: bytes,
        *,
        timeout_s: Optional[float] = None,
        closing: Optional[Callable[[], bool]] = None,
    ) -> None:
        """Produce, waiting (bounded poll) for ring space — the node's
        reply path, where the same-channel rule forbids a doorbell
        fallback.  Raises ``TimeoutError`` when the consumer never
        drains and ``WireError`` when the frame can never fit."""
        if len(frame) > self.payload_cap * self.slots:
            raise WireError(
                f"ring frame of {len(frame)} bytes exceeds the ring's "
                f"{self.payload_cap * self.slots}-byte capacity"
            )
        t_end = math.inf if timeout_s is None else time.monotonic() + timeout_s
        while not self.try_produce(frame):
            if closing is not None and closing():
                raise ConnectionError("ring closing")
            if time.monotonic() >= t_end:
                raise TimeoutError(
                    "ring full: consumer stopped draining the "
                    "completion ring"
                )
            time.sleep(_PRODUCE_POLL_S)

    def _wake(self) -> None:
        """Publish-then-wake: bump the futex word FIRST (a concurrent
        parker's value check then fails fast), issue the syscall only
        when the waiting word says someone is parked — the zero-syscall
        steady state."""
        if _fi.active_plan is not None:  # chaos seam: delayed wake
            _fi.ring_wake_fault("ring.wake", self._chaos_peer)
        mm = self._mm
        val = _U32S.unpack_from(mm, _FUTEX_OFF)[0]
        _U32S.pack_into(mm, _FUTEX_OFF, (val + 1) & 0xFFFFFFFF)
        if _U32S.unpack_from(mm, _WAITING_OFF)[0]:
            self._futex_wake()

    def _futex_wake(self) -> None:
        if self._c_futex is not None:
            lib = _get_libc()
            assert lib is not None
            _syscall_counts["futex_wake"] += 1
            lib.syscall(
                _FUTEX_NR, ctypes.byref(self._c_futex), _FUTEX_WAKE,
                0x7FFFFFFF, None, 0, 0,
            )
        else:
            _fallback_event(self._path, _FUTEX_OFF).set()

    # -- consumer ----------------------------------------------------------

    def recv(
        self,
        *,
        timeout_s: Optional[float] = None,
        peer_check: Optional[Callable[[], None]] = None,
        closing: Optional[Callable[[], bool]] = None,
    ) -> bytes:
        """Consume the next frame.  ``timeout_s=None`` waits
        indefinitely for a FRAME but still re-checks ``closing``, the
        epoch word, and ``peer_check`` every park slice — the unbounded
        posture is bounded-per-slice, so a dead peer is a classified
        ``ConnectionError`` within one slice, never a hang."""
        t_end = (
            math.inf if timeout_s is None else time.monotonic() + timeout_s
        )
        pos = self._pos
        self._wait_ready(pos, t_end, peer_check, closing, mid_span=False)
        mm = self._mm
        cap = self.payload_cap
        rec0 = _RING_RECORDS_OFFSET + (pos % self.slots) * self.record_bytes
        total, _reserved = _LEN_STRUCT.unpack_from(mm, rec0 + 8)
        if total == 0 or total > cap * self.slots:
            raise WireError(
                f"ring frame length {total} out of bounds "
                f"(ring holds at most {cap * self.slots})"
            )
        nrec = -(-total // cap)
        out = bytearray(total)
        off_out = 0
        for i in range(nrec):
            p = pos + i
            if i:
                # Continuations commit after record 0 was observed
                # ready: bounded wait — a producer dying mid-span is a
                # loud TimeoutError, not a hang.
                self._wait_ready(p, t_end, peer_check, closing, mid_span=True)
            rec = _RING_RECORDS_OFFSET + (p % self.slots) * self.record_bytes
            want = min(cap, total - off_out)
            if i:
                clen, _r = _LEN_STRUCT.unpack_from(mm, rec + 8)
                if clen != want:
                    raise WireError(
                        f"ring span continuation {i} declares {clen} "
                        f"bytes, expected {want}"
                    )
            out[off_out : off_out + want] = mm[rec + 16 : rec + 16 + want]
            seq = _U64.unpack_from(mm, rec)[0]
            if seq != 2 * p + 2:
                raise WireError(
                    f"ring record {p} recycled mid-copy (seq {seq})"
                )
            off_out += want
        self._pos = pos + nrec
        _U64.pack_into(mm, _CONSUMED_OFF, self._pos)
        return bytes(out)

    def _wait_ready(
        self,
        pos: int,
        t_end: float,
        peer_check: Optional[Callable[[], None]],
        closing: Optional[Callable[[], bool]],
        *,
        mid_span: bool,
    ) -> None:
        """Adaptive spin-then-park until record ``pos`` commits.  The
        spin budget grows (+8, cap 200) on spin hits and halves per
        park, so a same-core pair (this container has ONE core — a
        spinning consumer starves its producer) decays toward
        park-first while a true two-core pair stays in the spin-hit
        zero-syscall regime."""
        mm = self._mm
        rec = _RING_RECORDS_OFFSET + (pos % self.slots) * self.record_bytes
        want = 2 * pos + 2
        spin = self._spin_budget
        parked = False
        while True:
            seq = _U64.unpack_from(mm, rec)[0]
            if seq == want:
                if not parked and spin < self._spin_budget:
                    # The record committed WHILE we spun: spinning pays
                    # on this topology (a true second core) — grow.  A
                    # hit after a park means the peer needed our core
                    # (1-core/GIL lock-step): the halving below stands,
                    # decaying toward park-first with zero GIL burn.
                    self._spin_budget = min(self._spin_budget + 8, 200)
                return
            self._check_seq(seq, pos)
            produced = _U64.unpack_from(mm, _PRODUCED_OFF)[0]
            if produced > pos:
                # The producer publishes ``produced`` strictly AFTER
                # committing every record stamp it covers, so a
                # published-but-uncommitted record cannot be a slow
                # producer — it is a torn or scribbled seqlock word.
                # Re-read once: the commit may have landed between our
                # two loads (stamp first, counter second is the only
                # benign interleaving).
                if _U64.unpack_from(mm, rec)[0] == want:
                    continue
                raise WireError(
                    f"ring record {pos} published (produced={produced}) "
                    f"but its seqlock word reads {seq} — torn write "
                    "never committed"
                )
            if closing is not None and closing():
                raise ConnectionError("ring closing")
            epoch = _U32S.unpack_from(mm, _EPOCH_OFF)[0]
            if epoch == 0:
                raise ConnectionError(
                    "ring peer closed (epoch zeroed)"
                )
            if epoch != self._epoch:
                raise WireError(
                    f"ring epoch changed {self._epoch} -> {epoch} — "
                    "foreign remap or reinitialized header"
                )
            now = time.monotonic()
            if now >= t_end:
                if mid_span:
                    raise TimeoutError(
                        f"ring frame torn mid-span: record {pos} never "
                        "committed within the deadline"
                    )
                raise TimeoutError("ring recv timed out")
            if spin > 0:
                spin -= 1
                continue
            self._park(rec, want, min(_PARK_SLICE_S, t_end - now))
            parked = True
            if peer_check is not None:
                peer_check()
            self._spin_budget //= 2

    def _check_seq(self, seq: int, pos: int) -> None:
        """Classify a not-ready sequence observation: legal values are
        0 on the first lap, and same-slot mid-write/committed stamps of
        earlier-or-current positions.  Everything else is loud."""
        want = 2 * pos + 2
        if seq > want:
            raise WireError(
                f"ring record {pos} recycled: seq {seq} is past the "
                f"expected {want} — wraparound reuse or a scribbled "
                "seqlock word"
            )
        if seq == 0:
            if pos < self.slots:
                return  # first lap: record never written yet
            raise WireError(
                f"ring record {pos} zeroed after the first lap"
            )
        q = (seq - 1) // 2 if seq % 2 else (seq - 2) // 2
        if q % self.slots != pos % self.slots:
            raise WireError(
                f"ring record {pos}: seq {seq} belongs to slot "
                f"{q % self.slots}, expected {pos % self.slots}"
            )

    def _park(self, rec: int, want: int, max_wait_s: float) -> None:
        """One bounded park on the futex word: read value, declare
        waiting, RE-check the record (the lost-wake guard: a producer
        that committed between our check and the wait bumped the word,
        so the wait returns immediately), wait at most one slice."""
        if max_wait_s <= 0:
            return
        mm = self._mm
        val = _U32S.unpack_from(mm, _FUTEX_OFF)[0]
        _U32S.pack_into(mm, _WAITING_OFF, 1)
        try:
            if _U64.unpack_from(mm, rec)[0] == want:
                return  # lost-wake guard: committed while we armed
            if _U32S.unpack_from(mm, _EPOCH_OFF)[0] != self._epoch:
                return  # peer closed/changed: outer loop classifies
            if self._c_futex is not None:
                self._futex_wait(val, max_wait_s)
            else:
                ev = _fallback_event(self._path, _FUTEX_OFF)
                ev.clear()
                if _U64.unpack_from(mm, rec)[0] == want:
                    return
                _syscall_counts["fallback_poll"] += 1
                # Cross-process peers never set our event: the wait
                # degrades to a bounded poll, still never a hang.
                ev.wait(min(max_wait_s, 0.002))
        finally:
            _U32S.pack_into(mm, _WAITING_OFF, 0)

    def _futex_wait(self, expected: int, timeout_s: float) -> None:
        lib = _get_libc()
        assert lib is not None and self._c_futex is not None
        sec = int(timeout_s)
        ts = _Timespec(sec, int((timeout_s - sec) * 1e9))
        _syscall_counts["futex_wait"] += 1
        # EAGAIN (value changed), ETIMEDOUT, EINTR are all benign —
        # the caller's loop re-reads the record either way.
        lib.syscall(
            _FUTEX_NR, ctypes.byref(self._c_futex), _FUTEX_WAIT,
            expected, ctypes.byref(ts), 0, 0,
        )

    # -- teardown ----------------------------------------------------------

    def close(self) -> None:
        """Producer: zero the epoch word and wake the peer (a parked
        consumer classifies the departure as ``ConnectionError``
        immediately).  Both roles release the ctypes buffer export so
        the arena mapping can actually close."""
        if self._closed:
            return
        self._closed = True
        try:
            if self.role == "producer":
                _U32S.pack_into(self._mm, _EPOCH_OFF, 0)
                val = _U32S.unpack_from(self._mm, _FUTEX_OFF)[0]
                _U32S.pack_into(self._mm, _FUTEX_OFF, (val + 1) & 0xFFFFFFFF)
                self._futex_wake()
        except (ValueError, struct.error):
            pass  # mapping already gone
        finally:
            self._c_futex = None


# ---------------------------------------------------------------------------
# client
# ---------------------------------------------------------------------------


class RingArraysClient(ShmArraysClient):
    """:class:`~.shm.ShmArraysClient` whose descriptor frames ride the
    arena rings instead of the TCP doorbell.  Full surface parity is
    inherited — evaluate, pipelined/batched ``evaluate_many``,
    ``evaluate_many_partial``, reduce windows, ``get_load`` (incl.
    ``b"telemetry"``), ``ping`` — because every frame funnels through
    ``_send``/``_read_frame``, which this class reroutes.

    Channel discipline: each sent frame is tagged with the channel it
    took ("ring", or "tcp" when the ring was full/absent), and replies
    are read from the SAME channel in send order — the node answers on
    the channel a request arrived on, and each channel is individually
    FIFO, so correlation survives mixed fallback traffic.  Attaching to
    a plain shm node degrades gracefully: no ring spec in ATTACH_OK
    means every frame takes the doorbell, behavior identical to the
    parent class."""

    def __init__(self, host: str, port: int, **kwargs: object) -> None:
        super().__init__(host, port, **kwargs)  # type: ignore[arg-type]
        self._sub_ring: Optional[Ring] = None  # we produce (requests)
        self._com_ring: Optional[Ring] = None  # we consume (replies)
        self._chan_tags: Deque[str] = deque()
        # Contiguous-floor ack state: the node's two dispatch lanes
        # (ring thread + doorbell loop) complete replies out of client
        # read order, so the parent's max-watermark ack could release
        # a reply slot we have not read yet.  We ack only the floor of
        # contiguously-seen generations — monotone, never early.
        self._gen_seen: Set[int] = set()
        self._gen_floor = 0

    # -- attach ------------------------------------------------------------

    def _attach(self) -> None:
        assert self._sock is not None
        uid = fast_uuid()
        want = json.dumps({"ring": 1}).encode("utf-8")
        self._send(
            encode_frame(_KIND_ATTACH, uid, _U32.pack(len(want)) + want)
        )
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
        ring_spec = spec.get("ring")
        if ring_spec:
            # Header geometry is validated against the arena file
            # header by the Ring constructor — a mismatch is loud.
            self._sub_ring = Ring(
                self._req_arena, role="producer",
                chaos_point="ring.record", chaos_peer=self._peer,
            )
            self._com_ring = Ring(self._rep_arena, role="consumer")
            _flightrec.record(
                "ring.attach", peer=self._peer,
                slots=self._sub_ring.slots,
                record_bytes=self._sub_ring.record_bytes,
            )
        else:
            _flightrec.record(
                "ring.fallback", peer=self._peer, reason="no-ring-peer"
            )
        _flightrec.record(
            "shm.attach", peer=self._peer, req=req_path, rep=rep_path,
            size=self._req_arena.capacity,
        )

    # -- channel routing ---------------------------------------------------

    @staticmethod
    def _expects_reply(frame: bytes) -> bool:
        # Header layout: magic(4) version(1) kind(1) ... — ACK is the
        # only client frame with no reply; tagging it would desync the
        # per-channel FIFO correlation.
        return not (
            len(frame) >= 6 and frame[:4] == MAGIC and frame[5] == _KIND_ACK
        )

    def _send(self, frame: bytes) -> None:
        ring = self._sub_ring
        if ring is not None:
            out = frame
            if _fi.active_plan is not None:  # chaos seam
                out = _fi.filter_bytes("ring.send", out, self._peer)
            try:
                sent = ring.try_produce(out)
            except WireError:
                self.close()
                raise
            if sent:
                if self._expects_reply(frame):
                    self._chan_tags.append("ring")
                return
            _flightrec.record(
                "ring.fallback", peer=self._peer, reason="ring-full",
                bytes=len(frame),
            )
        super()._send(frame)
        if self._expects_reply(frame):
            self._chan_tags.append("tcp")

    def _read_frame(self) -> bytes:
        tag = self._chan_tags.popleft() if self._chan_tags else "tcp"
        if tag != "ring" or self._com_ring is None:
            return super()._read_frame()
        budget = _deadline.recv_budget_s(self.timeout_s)
        if budget is None:
            # Doorbell-lane parity: a plain-socket read with no ambient
            # deadline is still bounded by the connect-era socket
            # timeout; the ring wait must not be looser than that, or a
            # producer that dies torn parks this consumer forever.
            budget = self.connect_timeout_s
        try:
            buf = self._com_ring.recv(
                timeout_s=budget, peer_check=self._peer_dead_check
            )
        except (TimeoutError, WireError, ConnectionError):
            # Same posture as the doorbell's bounded_reader: the
            # channel is desynchronized — close so the next call
            # re-attaches cleanly; the error classification (transient
            # timeout / loud wire / dead peer) surfaces unchanged.
            self.close()
            raise
        if _fi.active_plan is not None:  # chaos seam
            buf = _fi.filter_bytes("ring.recv", buf, self._peer)
        return buf

    def _peer_dead_check(self) -> None:
        """Abrupt-death probe run once per park slice: a SIGKILL'd node
        never zeroes its epoch, but the kernel closes its doorbell
        socket — EOF there classifies the parked wait as a transient
        ``ConnectionError`` instead of a deadline-long stall."""
        s = self._sock
        if s is None:
            raise ConnectionError("ring: doorbell closed underneath")
        try:
            # Zero-timeout readability poll (MSG_DONTWAIT alone would
            # make a timeout-mode socket block its full timeout in
            # CPython's sock_call retry loop).
            readable, _, _ = select.select([s], [], [], 0)
            if not readable:
                return  # open and quiet: peer alive
            # graftlint: disable=fault-shim-coverage,unbounded-wait -- non-blocking liveness peek (select said readable), not a data seam
            data = s.recv(1, socket.MSG_PEEK)
        except OSError as e:
            raise ConnectionError(f"ring: doorbell dead: {e}") from None
        if data == b"":
            raise ConnectionError("ring: peer closed the doorbell (EOF)")
        # Buffered bytes = a tcp-channel reply for a later tagged read.

    # -- contiguous-floor acks --------------------------------------------

    def _decode_reply_arrays(
        self, descs: Sequence[tuple], *, force_copy: bool = False
    ):
        if self._com_ring is None:
            return super()._decode_reply_arrays(descs, force_copy=force_copy)
        before = self._consumed_gen
        out = super()._decode_reply_arrays(descs, force_copy=force_copy)
        # Replace the parent's max-watermark with the contiguous floor
        # (arena generations are dense: +1 per slot write), so a
        # later-generation reply read first never acks an unread
        # earlier one.  Worst case a never-seen generation stalls the
        # floor — loud arena exhaustion on the node, never corruption.
        for d in descs:
            if d[3] > self._gen_floor:
                self._gen_seen.add(d[3])
        while self._gen_floor + 1 in self._gen_seen:
            self._gen_floor += 1
            self._gen_seen.discard(self._gen_floor)
        self._consumed_gen = max(before, self._gen_floor)
        return out

    # -- teardown ----------------------------------------------------------

    def close(self) -> None:
        sub, com = self._sub_ring, self._com_ring
        self._sub_ring = self._com_ring = None
        for r in (sub, com):
            if r is not None:
                try:
                    r.close()  # producer side zeroes epoch + wakes
                except Exception:
                    pass
        self._chan_tags.clear()
        self._gen_seen.clear()
        self._gen_floor = 0
        super().close()


# ---------------------------------------------------------------------------
# server
# ---------------------------------------------------------------------------


class _RingConnection(_ShmConnection):
    """Server half of one ring-capable connection: the doorbell serve
    loop runs unchanged (attach channel, npwire pool probes, tcp
    fallback traffic), and a second thread consumes the submission
    ring.  Both lanes funnel through ``_one_frame`` under one dispatch
    lock — the arenas, reply watermark, and compute are single-writer.
    Replies go out on the channel their request arrived on."""

    _transport = "ring"

    def __init__(
        self,
        conn: socket.socket,
        compute_fn: Callable[..., Sequence[np.ndarray]],
        arena_bytes: int,
        n_connections: Callable[[], int],
        *,
        ring_slots: int = DEFAULT_RING_SLOTS,
        ring_record_bytes: int = DEFAULT_RING_RECORD_BYTES,
    ) -> None:
        super().__init__(conn, compute_fn, arena_bytes, n_connections)
        self._ring_slots = int(ring_slots)
        self._ring_record_bytes = int(ring_record_bytes)
        self._dispatch_lock = threading.Lock()
        self._sub_ring: Optional[Ring] = None  # we consume (requests)
        self._com_ring: Optional[Ring] = None  # we produce (replies)
        self._ring_thread: Optional[threading.Thread] = None
        self._closing = threading.Event()
        self._ring_wanted = False

    # -- attach negotiation ------------------------------------------------

    @staticmethod
    def _peek_ring_request(payload: bytes) -> bool:
        """Does this pre-attach ATTACH frame request a ring?  Manual
        flag-free header walk — a ``decode_frame`` call here would
        double-fire the chaos byte seams (the ``frame_tenant``
        precedent)."""
        if len(payload) < 28 or payload[5] != _KIND_ATTACH or payload[6]:
            return False
        try:
            (jlen,) = _U32.unpack_from(payload, 24)
            spec = json.loads(payload[28 : 28 + jlen].decode("utf-8"))
        except (struct.error, ValueError, UnicodeDecodeError):
            return False
        return bool(isinstance(spec, dict) and spec.get("ring"))

    def _one_frame(self, payload: bytes) -> Optional[bytes]:
        if (
            self.req_arena is None
            and len(payload) >= 6
            and payload[:4] == MAGIC
        ):
            self._ring_wanted = self._peek_ring_request(payload)
        with self._dispatch_lock:
            return super()._one_frame(payload)

    def _attach_reply(self, uid: bytes) -> bytes:
        if self.req_arena is not None or not self._ring_wanted:
            # Plain client (no ring spec in ATTACH) or re-attach:
            # graceful degradation to the parent's doorbell-only lane.
            return super()._attach_reply(uid)
        self.req_arena = Arena.create(
            self.arena_bytes, writer=False,
            ring_slots=self._ring_slots,
            ring_record_bytes=self._ring_record_bytes,
        )
        self.rep_arena = Arena.create(
            self.arena_bytes, writer=True,
            ring_slots=self._ring_slots,
            ring_record_bytes=self._ring_record_bytes,
        )
        # The creator stamps both headers BEFORE the peer can map them;
        # Ring constructors (both sides) only validate.
        init_ring_header(self.req_arena)
        init_ring_header(self.rep_arena)
        self._sub_ring = Ring(self.req_arena, role="consumer")
        self._com_ring = Ring(
            self.rep_arena, role="producer", chaos_point="ring.record"
        )
        self._ring_thread = threading.Thread(
            target=self._ring_loop, daemon=True, name="pftpu-ring-serve"
        )
        self._ring_thread.start()
        _flightrec.record(
            "ring.attach", slots=self._ring_slots,
            record_bytes=self._ring_record_bytes,
        )
        spec = json.dumps(
            {
                "req": self.req_arena.path,
                "rep": self.rep_arena.path,
                "size": self.req_arena.capacity,
                "arena_id": uuid_mod.uuid4().hex,
                "ring": {
                    "slots": self._ring_slots,
                    "record_bytes": self._ring_record_bytes,
                },
            }
        ).encode("utf-8")
        return encode_frame(
            _KIND_ATTACH_OK, uid, _U32.pack(len(spec)) + spec
        )

    # -- the ring lane -----------------------------------------------------

    def _ring_loop(self) -> None:
        sub, com = self._sub_ring, self._com_ring
        assert sub is not None and com is not None
        closing = self._closing.is_set
        try:
            while not closing():
                # graftlint: disable=unbounded-wait -- server idle state (tcp.py::_recv_exact parity); Ring.recv re-checks closing/epoch every park slice
                frame = sub.recv(closing=closing)
                if _fi.active_plan is not None:  # chaos seam
                    frame = _fi.filter_bytes("ring.server.recv", frame)
                try:
                    reply = self._one_frame(frame)
                except _fi.FaultPlanError:
                    raise  # plan-authoring bug: LOUD, not in-band
                except Exception as e:
                    # Undecodable ring frames fail THEIR reply in-band;
                    # the lane keeps serving (doorbell-loop parity).
                    _flightrec.record(
                        "server.error", stage="decode", wire="ring",
                        transport="shm", error=str(e)[:200],
                    )
                    reply = encode_frame(
                        _KIND_ERROR, b"\0" * 16, error=str(e)
                    )
                if reply is None:
                    continue  # ACK frames answer nothing
                if _fi.active_plan is not None:  # chaos seam
                    reply = _fi.filter_bytes("ring.server.send", reply)
                com.produce_blocking(
                    reply,
                    timeout_s=_REPLY_PRODUCE_TIMEOUT_S,
                    closing=closing,
                )
        except (ConnectionError, OSError):
            pass  # peer gone / closing: normal teardown
        except (WireError, TimeoutError) as e:
            # Ring-protocol integrity lost (torn/stale/recycled record,
            # undrained completion ring): LOUD, then tear the
            # connection down — the client reads EOF/epoch-0 and
            # classifies a transient.
            _flightrec.record("ring.server.error", error=str(e)[:200])
        finally:
            self._closing.set()
            try:
                # Kick the doorbell loop so the whole connection (and
                # its arenas) tears down with the ring lane.
                self.conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass

    # -- teardown ----------------------------------------------------------

    def serve(self) -> None:
        try:
            super().serve()
        finally:
            self._closing.set()
            if self._com_ring is not None:
                try:
                    self._com_ring.close()  # epoch 0 + wake: unpark peer
                except Exception:
                    pass
            if self._ring_thread is not None:
                self._ring_thread.join(timeout=2.0)
            if self._sub_ring is not None:
                try:
                    self._sub_ring.close()
                except Exception:
                    pass
            self._sub_ring = self._com_ring = None
            # The parent's finally closed the arenas while ring ctypes
            # exports kept the mappings alive (tolerated BufferError);
            # with the rings closed, close again to actually release.
            for arena in (self.req_arena, self.rep_arena):
                if arena is not None:
                    arena.close(unlink=not self._unlinked)


def serve_ring(
    compute_fn: Callable[..., Sequence[np.ndarray]],
    host: str = "127.0.0.1",
    port: int = 0,
    *,
    ready_callback: Optional[Callable[[int], None]] = None,
    max_connections: Optional[int] = None,
    arena_bytes: int = DEFAULT_ARENA_BYTES,
    concurrent: bool = True,
    ring_slots: int = DEFAULT_RING_SLOTS,
    ring_record_bytes: int = DEFAULT_RING_RECORD_BYTES,
) -> None:
    """Blocking ring-lane node: :func:`~.shm.serve_shm`'s accept loop
    with ring-capable connections.  Plain shm clients, npwire pool
    probes, and the pool's zero-item batch probe all work unchanged
    (the doorbell socket is still answered); ring clients negotiate
    the rings in their ATTACH frame.  Same compute contract as
    ``serve_shm`` (read-only zero-copy request views)."""

    def _make(
        conn: socket.socket,
        fn: Callable[..., Sequence[np.ndarray]],
        ab: int,
        nc: Callable[[], int],
    ) -> _ShmConnection:
        return _RingConnection(
            conn, fn, ab, nc,
            ring_slots=ring_slots, ring_record_bytes=ring_record_bytes,
        )

    serve_shm(
        compute_fn,
        host,
        port,
        ready_callback=ready_callback,
        max_connections=max_connections,
        arena_bytes=arena_bytes,
        concurrent=concurrent,
        _connection_cls=_make,
    )

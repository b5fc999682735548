"""Generation-counted mmap ring arena — the zero-copy payload plane.

One :class:`Arena` is a shared-memory file mapped by BOTH sides of a
(driver, replica) pair: the owning side allocates slots and writes
array bytes into them EXACTLY ONCE; the peer reads the same physical
pages through descriptors ``(slot, delta, length, generation)`` that
ride the lightweight doorbell channel (:mod:`.shm`) instead of the
payload.  The arena itself is transport-agnostic: it knows nothing
about sockets, frames, or numpy dtypes — only aligned slots, a ring
allocator, and the generation protocol below.

Slot layout (all little-endian, at arena offset ``slot``)::

    head:    generation(u64) payload_length(u64)
    payload: payload_length bytes (arrays packed 8-aligned at deltas)
    tail:    generation(u64)

The generation protocol is what makes recycled and torn slots LOUD
instead of silently wrong (the wire invariant):

- the writer stamps head (generation, length), copies the payload,
  then stamps the tail generation — so a slot whose write never
  finished (process death, chaos ``truncate_slot``) has a mismatched
  tail and every read of it raises :class:`~.npwire.WireError`;
- generations increase monotonically per arena, so a descriptor held
  across a slot recycle (a late reader, chaos ``stale_generation``)
  sees a head generation that no longer matches and fails loudly —
  never torn data;
- :meth:`Arena.read_bytes` re-validates head AND tail after copying,
  so even a recycle that lands mid-copy is detected before the bytes
  are believed.

Allocation is two regions in one mapping: a FIFO ring for transient
request/reply slots (freed strictly in allocation order — the doorbell
protocol is lock-step FIFO, so replies release request slots in
order), and a pinned region growing down from the top for arrays the
owner writes once and references forever (the driver's per-node data
constants — "same-host replicas shouldn't move bytes at all").  The
two watermarks colliding is an explicit :class:`~.npwire.WireError`,
never an overwrite.

Version-2 arenas reserve a RING REGION between the file
header and the slot space: a 64-byte ring header plus ``ring_slots``
fixed-size seqlock'd records — the zero-syscall descriptor ring
(:mod:`.ring`) that replaces the TCP doorbell round-trip for colocated
pairs.  The arena knows only the geometry (it shifts the slot floor
and validates bounds); :mod:`.ring` owns the record protocol.
Version-1 files (``ring_slots == 0``) attach unchanged.

The backing file lives in ``/dev/shm`` when available (tmpfs — the
bytes never touch a disk) and the server unlinks it as soon as the
peer has mapped it, so a SIGKILL'd process leaks nothing.
"""

from __future__ import annotations

import mmap
import os
import struct
import tempfile
import threading
from collections import deque
from typing import Deque, List, Optional, Sequence, Tuple, Union

from .npwire import WIRE_BYTES_COPIED, WireError

__all__ = ["Arena", "ARENA_MAGIC", "DEFAULT_ARENA_BYTES"]

ARENA_MAGIC = b"PFA1"
#: Default per-direction arena capacity.  Generous relative to any
#: pipelined window so the ring never wraps onto live slots in normal
#: operation; tmpfs pages are allocated lazily, so an idle arena costs
#: only what was actually written.
DEFAULT_ARENA_BYTES = 64 * 1024 * 1024

_FILE_HEADER = struct.Struct("<4sBxxxQ")  # magic, version, capacity
#: Version-2 header: v1 fields + the ring geometry.  The
#: ring region layout itself (header words, record seqlocks) is
#: declared in service/wire_registry.py and owned by service/ring.py.
_FILE_HEADER_V2 = struct.Struct("<4sBxxxQII")  # + ring_slots, record_bytes
_HEADER_SIZE = 64  # file header, padded to one alignment unit
_RING_HEADER_BYTES = 64  # ring header, padded to one alignment unit
_SLOT_HEAD = struct.Struct("<QQ")  # generation, payload_length
_SLOT_TAIL = struct.Struct("<Q")  # generation (truncation/torn guard)
_ALIGN = 64

_ARENA_WRITE = WIRE_BYTES_COPIED.labels(lane="shm", stage="arena_write")
_ARENA_READ = WIRE_BYTES_COPIED.labels(lane="shm", stage="decode_copy")


def _align(n: int) -> int:
    return (n + _ALIGN - 1) & ~(_ALIGN - 1)


def _bytes_view(buf: Union[bytes, bytearray, memoryview]) -> memoryview:
    """A flat unsigned-byte view of any C-contiguous buffer (numpy
    arrays included) — what ``mmap`` slice assignment needs."""
    mv = memoryview(buf)
    if mv.format == "B" and mv.ndim == 1:
        return mv
    return mv.cast("B")


def arena_dir() -> str:
    """Directory for arena backing files: tmpfs when available."""
    if os.path.isdir("/dev/shm") and os.access("/dev/shm", os.W_OK):
        return "/dev/shm"
    return tempfile.gettempdir()


class Arena:
    """One mapped arena (module docstring for the slot/generation
    protocol).  Construct with :meth:`create` (the allocating owner)
    or :meth:`attach` (the reading peer); both sides may read, only
    the owner allocates and writes."""

    def __init__(
        self,
        path: str,
        mm: mmap.mmap,
        capacity: int,
        *,
        owner: bool,
        ring_slots: int = 0,
        ring_record_bytes: int = 0,
    ) -> None:
        self.path = path
        self.mm = mm
        self.capacity = capacity
        self.owner = owner
        self.ring_slots = ring_slots
        self.ring_record_bytes = ring_record_bytes
        # Slot space starts past the file header AND the ring region
        # (v1 arenas: ring_slots == 0, the floor is the header alone).
        self.data_floor = _HEADER_SIZE + (
            _RING_HEADER_BYTES + ring_slots * ring_record_bytes
            if ring_slots
            else 0
        )
        # One long-lived view: read_view slices this instead of
        # re-exporting the mmap's buffer per call (hot-path cost).
        self._mv = memoryview(mm)
        self._lock = threading.Lock()
        self._next_gen = 1  # 0 is reserved: fresh pages read as gen 0
        # Transient FIFO ring over [data_floor, _pin_floor).
        self._head = self.data_floor
        self._tail = self.data_floor
        self._live: Deque[Tuple[int, int]] = deque()  # (slot, total)
        self._pin_floor = capacity  # pinned region grows DOWN from here

    # -- construction -----------------------------------------------------

    @classmethod
    def create(
        cls,
        capacity: int = DEFAULT_ARENA_BYTES,
        *,
        path: Optional[str] = None,
        writer: bool = True,
        ring_slots: int = 0,
        ring_record_bytes: int = 4096,
    ) -> "Arena":
        """Create and map a fresh arena file of ``capacity`` data
        bytes.  ``writer=False`` creates the file but leaves slot
        allocation to the peer (the server creates BOTH arenas of a
        pair; the client allocates in the request one).
        ``ring_slots > 0`` reserves the version-2 descriptor-ring
        region (:mod:`.ring`); ``ring_record_bytes`` must be a
        positive multiple of the 64-byte alignment unit so the slot
        floor stays aligned."""
        if ring_slots:
            if ring_record_bytes <= 0 or ring_record_bytes % _ALIGN:
                raise WireError(
                    f"ring_record_bytes {ring_record_bytes} must be a "
                    f"positive multiple of {_ALIGN}"
                )
            floor = _HEADER_SIZE + _RING_HEADER_BYTES + (
                ring_slots * ring_record_bytes
            )
        else:
            floor = _HEADER_SIZE
        if capacity < floor + _ALIGN:
            raise WireError(f"arena capacity {capacity} is below one slot")
        if path is None:
            fd, path = tempfile.mkstemp(
                prefix="pftpu-arena-", suffix=".shm", dir=arena_dir()
            )
        else:
            fd = os.open(path, os.O_RDWR | os.O_CREAT | os.O_EXCL, 0o600)
        try:
            os.ftruncate(fd, capacity)
            mm = mmap.mmap(fd, capacity)
        finally:
            os.close(fd)
        if ring_slots:
            mm[: _FILE_HEADER_V2.size] = _FILE_HEADER_V2.pack(
                ARENA_MAGIC, 2, capacity, ring_slots, ring_record_bytes
            )
        else:
            mm[: _FILE_HEADER.size] = _FILE_HEADER.pack(
                ARENA_MAGIC, 1, capacity
            )
        return cls(
            path, mm, capacity, owner=writer,
            ring_slots=ring_slots,
            ring_record_bytes=ring_record_bytes if ring_slots else 0,
        )

    @classmethod
    def attach(cls, path: str, *, writer: bool = False) -> "Arena":
        """Map an existing arena file created by the peer.
        ``writer=True`` takes the allocation role (exactly one side of
        a pair may hold it — the doorbell protocol assigns the request
        arena's to the client, the reply arena's to the server)."""
        fd = os.open(path, os.O_RDWR)
        try:
            size = os.fstat(fd).st_size
            if size < _HEADER_SIZE:
                raise WireError(f"arena file {path!r} is truncated")
            mm = mmap.mmap(fd, size)
        finally:
            os.close(fd)
        magic, version, capacity = _FILE_HEADER.unpack_from(mm, 0)
        ring_slots = 0
        ring_record_bytes = 0
        if magic != ARENA_MAGIC:
            mm.close()
            raise WireError(f"bad arena magic {magic!r} in {path!r}")
        if version == 2:
            (
                _magic, _ver, capacity, ring_slots, ring_record_bytes,
            ) = _FILE_HEADER_V2.unpack_from(mm, 0)
            floor = _HEADER_SIZE + _RING_HEADER_BYTES + (
                ring_slots * ring_record_bytes
            )
            if (
                ring_slots <= 0
                or ring_record_bytes <= 0
                or ring_record_bytes % _ALIGN
                or floor + _ALIGN > size
            ):
                mm.close()
                raise WireError(
                    f"corrupt arena ring geometry in {path!r}: "
                    f"{ring_slots} x {ring_record_bytes}-byte records "
                    f"do not fit {size} bytes"
                )
        elif version != 1:
            mm.close()
            raise WireError(f"unsupported arena version {version}")
        if capacity != size:
            mm.close()
            raise WireError(
                f"arena header declares {capacity} bytes but the file "
                f"holds {size}"
            )
        return cls(
            path, mm, capacity, owner=writer,
            ring_slots=ring_slots, ring_record_bytes=ring_record_bytes,
        )

    def close(self, *, unlink: bool = False) -> None:
        """Drop the mapping (and optionally the file).  If zero-copy
        views into the arena are still alive the OS mapping survives
        until they die — close never invalidates handed-out views."""
        try:
            self._mv.release()
        except BufferError:
            pass  # exported sub-views keep it alive; gc releases it
        try:
            self.mm.close()
        except BufferError:
            # numpy views exported from the mapping are still alive;
            # the mapping is released when the last view is collected.
            pass
        if unlink:
            try:
                os.unlink(self.path)
            except OSError:
                pass

    # -- allocation (owner side) ------------------------------------------

    def _alloc(self, total: int, *, pinned: bool) -> int:
        """One aligned region of ``total`` bytes; raises WireError when
        the arena cannot hold it (LOUD — never overwrite live slots)."""
        if pinned:
            floor = self._pin_floor - _align(total)
            # The floor must clear the HIGHEST live byte, not just the
            # ring pointers: in a wrapped ring the slot starting at
            # ``tail`` extends past it, and head/tail alone let the
            # pinned region land inside an in-flight slot (reproduced: a pinned promotion
            # mid-window corrupted request bytes the node was
            # computing on).
            limit = self._head
            for s, t in self._live:
                if s + t > limit:
                    limit = s + t
            if floor < limit or floor < self.data_floor:
                raise WireError(
                    f"arena exhausted: pinned region cannot grow by "
                    f"{total} bytes (capacity {self.capacity})"
                )
            self._pin_floor = floor
            return floor
        total = _align(total)
        if not self._live:
            self._head = self._tail = self.data_floor
        elif self._head == self._tail:
            # head == tail is ambiguous: empty OR exactly full.  Live
            # slots resolve it — the ring is FULL (an exact-fit
            # allocation landed flush against the oldest live slot),
            # and the branch below would otherwise hand out the live
            # region again and overwrite in-flight payloads.
            raise WireError(
                f"arena exhausted: ring exactly full "
                f"({len(self._live)} live slots) — the in-flight "
                "window outran reclamation"
            )
        if self._tail <= self._head:
            if self._head + total <= self._pin_floor:
                slot = self._head
                self._head += total
            elif self._live and self.data_floor + total <= self._tail:
                slot = self.data_floor  # wrap
                self._head = self.data_floor + total
            else:
                raise WireError(
                    f"arena exhausted: {total} bytes do not fit "
                    f"(capacity {self.capacity}, "
                    f"{len(self._live)} live slots) — the in-flight "
                    "window outran reclamation"
                )
        else:
            if self._head + total <= self._tail:
                slot = self._head
                self._head += total
            else:
                raise WireError(
                    f"arena exhausted: {total} bytes do not fit "
                    f"(capacity {self.capacity}, "
                    f"{len(self._live)} live slots) — the in-flight "
                    "window outran reclamation"
                )
        self._live.append((slot, total))
        return slot

    def write_many(
        self,
        buffers: Sequence[Union[bytes, bytearray, memoryview]],
        *,
        pinned: bool = False,
    ) -> Tuple[int, int, List[int]]:
        """Pack ``buffers`` 8-aligned into ONE freshly allocated slot;
        returns ``(slot, generation, deltas)`` where ``deltas[i]`` is
        buffer *i*'s offset inside the slot payload.  Each byte is
        copied exactly once — from the source buffer into the shared
        pages the peer will read in place."""
        if not self.owner:
            raise WireError("only the arena owner allocates slots")
        views = [_bytes_view(b) for b in buffers]
        deltas: List[int] = []
        length = 0
        for v in views:
            deltas.append(length)
            length += (v.nbytes + 7) & ~7  # 8-align every array start
        total = _SLOT_HEAD.size + length + _SLOT_TAIL.size
        with self._lock:
            slot = self._alloc(total, pinned=pinned)
            gen = self._next_gen
            self._next_gen += 1
        mm = self.mm
        _SLOT_HEAD.pack_into(mm, slot, gen, length)
        base = slot + _SLOT_HEAD.size
        copied = 0
        for v, delta in zip(views, deltas):
            if v.nbytes:
                mm[base + delta : base + delta + v.nbytes] = v
                copied += v.nbytes
        _SLOT_TAIL.pack_into(mm, base + length, gen)
        if copied:
            _ARENA_WRITE.inc(copied)
        return slot, gen, deltas

    def free(self, slot: int) -> None:
        """Release the OLDEST live transient slot (FIFO — the doorbell
        protocol replies in order, so out-of-order release is a
        protocol bug and raises)."""
        with self._lock:
            if not self._live or self._live[0][0] != slot:
                raise WireError(
                    f"arena free out of order: slot {slot} is not the "
                    "oldest live slot"
                )
            _, total = self._live.popleft()
            self._tail = self._live[0][0] if self._live else self._head
        # The slot's pages stay intact until recycled by a later
        # allocation — a late reader sees its (still matching)
        # generation until then, and a LOUD mismatch after.

    def live_slots(self) -> int:
        with self._lock:
            return len(self._live)

    def transient_bytes_free(self) -> int:
        """Largest transient allocation currently guaranteed to fit —
        the client's in-flight byte-cap input."""
        with self._lock:
            if not self._live:
                return max(
                    0, self._pin_floor - self.data_floor - 2 * _ALIGN
                )
            if self._head == self._tail:
                return 0  # exactly full (live slots resolve the tie)
            if self._tail < self._head:
                return max(
                    0,
                    max(
                        self._pin_floor - self._head,
                        self._tail - self.data_floor,
                    ) - 2 * _ALIGN,
                )
            return max(0, self._tail - self._head - 2 * _ALIGN)

    # -- reading (either side) --------------------------------------------

    def _validate(self, slot: int, delta: int, length: int, gen: int) -> int:
        """Bounds + generation checks; returns the payload base offset."""
        if slot < self.data_floor or slot + _SLOT_HEAD.size > self.capacity:
            raise WireError(
                f"descriptor slot {slot} out of arena bounds "
                f"(slot space starts at {self.data_floor})"
            )
        if slot % 8 or delta % 8:
            raise WireError(
                f"descriptor misaligned (slot {slot}, delta {delta})"
            )
        head_gen, payload_len = _SLOT_HEAD.unpack_from(self.mm, slot)
        base = slot + _SLOT_HEAD.size
        if base + payload_len + _SLOT_TAIL.size > self.capacity:
            raise WireError(
                f"slot {slot} declares {payload_len} payload bytes past "
                "the arena end"
            )
        if head_gen != gen:
            raise WireError(
                f"stale descriptor: slot {slot} is generation {head_gen}, "
                f"descriptor expects {gen} (slot recycled?)"
            )
        if delta + length > payload_len:
            raise WireError(
                f"descriptor range [{delta}, {delta + length}) exceeds "
                f"slot {slot}'s {payload_len}-byte payload"
            )
        (tail_gen,) = _SLOT_TAIL.unpack_from(self.mm, base + payload_len)
        if tail_gen != gen:
            raise WireError(
                f"torn slot {slot}: tail generation {tail_gen} != "
                f"{gen} — the write never completed"
            )
        return base

    def read_view(
        self, slot: int, delta: int, length: int, gen: int
    ) -> memoryview:
        """Zero-copy view of a descriptor's bytes, validated (head AND
        tail generation) before return.  Valid until the slot is
        recycled — under the doorbell protocol, until the reply for
        the frame that carried the descriptor is sent."""
        base = self._validate(slot, delta, length, gen)
        return self._mv[base + delta : base + delta + length]

    def read_bytes(self, slot: int, delta: int, length: int, gen: int) -> bytes:
        """Copy a descriptor's bytes out, with the generation
        RE-validated after the copy so a recycle landing mid-copy is
        detected before the bytes are believed."""
        base = self._validate(slot, delta, length, gen)
        data = bytes(self.mm[base + delta : base + delta + length])
        self._validate(slot, delta, length, gen)  # no recycle mid-copy
        if length:
            _ARENA_READ.inc(length)
        return data

    # -- chaos hooks (fault injection / tests only) ------------------------

    def scribble_tail(self, slot: int) -> None:
        """Corrupt a slot's tail generation — the ``truncate_slot``
        chaos fault: the slot now reads as a write that never
        finished.  Test/fault-injection use only."""
        _, payload_len = _SLOT_HEAD.unpack_from(self.mm, slot)
        off = slot + _SLOT_HEAD.size + payload_len
        (tail_gen,) = _SLOT_TAIL.unpack_from(self.mm, off)
        _SLOT_TAIL.pack_into(self.mm, off, tail_gen ^ 0xDEAD)

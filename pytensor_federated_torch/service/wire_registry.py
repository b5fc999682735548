"""The single declared source of wire-format constants.

Three implementations speak this repo's wire formats — the npwire
codec (:mod:`.npwire`), the hand-rolled proto3 codec
(:mod:`.npproto_codec`), and the C++ node (``native/cpp_node.cpp``) —
and each necessarily carries its own literals (the C++ file cannot
import Python).  This module is the DECLARATION those literals are
checked against: the ``wire-registry`` graftlint rule
(:mod:`..analysis.rules_wire`) cross-parses all three implementations
and fails CI on any flag bit or field number that is undeclared here,
collides with another declaration, or lacks its decoder-side
rejection/dispatch arm.  Adding a wire feature therefore starts HERE;
the checker then points at every implementation that has not caught
up.

Nothing in this module imports anything, so any layer (including the
analysis package, which must not drag jax in for a wire check) can
read it.

npwire flag bits
----------------
One byte of flags in the frame header (npwire.py module docstring has
the full layout).  Every bit must be listed: the decoders reject a
frame whose flags contain any bit outside :data:`NPWIRE_KNOWN_FLAGS`
— the loud-failure contract that makes a version-skewed peer an error
instead of silent mis-parsing.

npproto field numbers
---------------------
Field numbers per proto3 message, including the four extension fields
(14-17) this package adds to the reference schema.  Unknown fields are
SKIPPED on decode (proto3 forward compatibility — deliberately the
opposite posture of npwire flags), so the decoder-side obligation
checked for each declared field is a dispatch arm, not a rejection.
"""

from __future__ import annotations

__all__ = [
    "NPWIRE_FLAGS",
    "NPWIRE_KNOWN_FLAGS",
    "NPPROTO_FIELDS",
    "NPPROTO_EXTENSION_FIELDS",
    "PARTITION_STRUCT",
    "PARTITION_FIELD_ORDER",
    "VERSION_STRUCT",
    "NPPROTO_PARTITION_FIELDS",
    "SHMWIRE_KINDS",
    "SHMWIRE_FLAGS",
    "SHMWIRE_KNOWN_FLAGS",
    "SHM_DESC_STRUCT",
    "SHM_DESC_FIELD_ORDER",
    "RING_HEADER_STRUCT",
    "RING_HEADER_FIELD_ORDER",
    "RING_DESC_STRUCT",
    "RING_DESC_FIELD_ORDER",
    "RING_HEADER_OFFSET",
    "RING_RECORDS_OFFSET",
    "RING_FUTEX_WORD_OFFSET",
    "RING_WAITING_WORD_OFFSET",
    "RING_EPOCH_WORD_OFFSET",
    "GETLOAD_PAYLOADS",
    "LINALG_OP_STRUCT",
    "LINALG_OP_FIELD_ORDER",
    "LINALG_TILE_STRUCT",
    "LINALG_TILE_FIELD_ORDER",
    "LINALG_OPCODES",
]

#: npwire frame flag bits, by canonical name.  npwire.py spells these
#: ``_FLAG_<NAME>``; native/cpp_node.cpp spells them ``kFlag<Name>``.
NPWIRE_FLAGS = {
    "ERROR": 1,     # in-band error string block follows the header
    "TRACE": 2,     # 16-byte telemetry trace id block
    "SPANS": 4,     # JSON span-tree tail (reply piggyback)
    "BATCH": 8,     # count field is n_items; body is nested frames
    "DEADLINE": 16,  # f64 remaining-budget block (service/deadline.py)
    "TENANT": 32,   # u16-len utf8 tenant id block (gateway/fairness.py)
    "PARTITION": 64,  # gradient-partition index block (routing/partition.py)
    "VERSION": 128,  # u64 monotonic step-version stamp (optim/sharded.py)
}

#: The full known-flags mask every npwire decoder must enforce
#: (``flags & ~KNOWN`` is a WireError, not a skip).
NPWIRE_KNOWN_FLAGS = 0
for _bit in NPWIRE_FLAGS.values():
    NPWIRE_KNOWN_FLAGS |= _bit
del _bit

#: proto3 field numbers by message.  ``arrays_msg`` covers InputArrays
#: and OutputArrays (identical layout, reference service.proto:6-19);
#: fields >= 14 are this package's extensions (npproto_codec.py module
#: docstring documents each).
NPPROTO_FIELDS = {
    "ndarray": {
        "data": 1,
        "dtype": 2,
        "shape": 3,
        "strides": 4,
    },
    "arrays_msg": {
        "items": 1,
        "uuid": 2,
        "error": 14,        # per-item error inside a batch reply
        "trace_id": 15,     # 16-byte telemetry correlation id
        "spans": 16,        # JSON span trees, reply piggyback
        "batch_items": 17,  # nested messages: the batch frame marker
        "deadline_s": 18,   # fixed64 double: remaining deadline budget
        "tenant_id": 19,    # utf8 string: per-tenant identity (gateway/)
        "partition": 20,    # nested message: gradient-partition index
                            # block (routing/partition.py; sub-fields in
                            # NPPROTO_PARTITION_FIELDS)
        "version": 21,      # varint u64: monotonic step-version stamp
                            # (optim/sharded.py; emitted explicitly even
                            # at 0 — field PRESENCE marks a versioned
                            # frame, so the zero stamp cannot be elided)
    },
    "get_load_result": {
        "n_clients": 1,
        "percent_cpu": 2,
        "percent_ram": 3,
    },
}

#: The extension field numbers (unknown to the reference schema; a
#: reference peer skips them by wire type).  Kept as an explicit set so
#: the checker can demand a decode dispatch arm for each — we must
#: never emit a field we cannot read back.
NPPROTO_EXTENSION_FIELDS = frozenset(
    n for n in NPPROTO_FIELDS["arrays_msg"].values() if n >= 14
)

#: shm doorbell frame kinds (``service/shm.py`` spells these
#: ``_KIND_<NAME>``).  The zero-copy lane's doorbell channel carries
#: DESCRIPTOR frames — ``(slot, delta, length, generation)`` pointers
#: into a mmap arena — instead of payload bytes; this table is the one
#: declared source of the frame-kind byte, cross-checked against the
#: implementation by the graftlint wire-registry rule.  Decoders REJECT
#: an unknown kind (same loud-failure posture as npwire flags: the
#: doorbell peers ship in lockstep).
SHMWIRE_KINDS = {
    "ATTACH": 1,       # client -> server: open the arena pair
    "ATTACH_OK": 2,    # server -> client: JSON {req,rep,size,arena_id}
    "EVAL": 3,         # one request: descriptor list into the req arena
    "REPLY": 4,        # one reply: descriptor list into the rep arena
    "EVAL_BATCH": 5,   # K requests in one doorbell frame (batch-frame analog)
    "REPLY_BATCH": 6,  # K replies, per-item error isolation
    "ACK": 7,          # reply-arena reclamation watermark (generation)
    "GETLOAD": 8,      # load probe request
    "LOAD": 9,         # JSON load reply
    "PING": 10,        # empty-arena-write doorbell round-trip probe
    "PONG": 11,        # ping reply
    "ERROR": 12,       # frame-level in-band error (undecodable frame)
}

#: shm doorbell frame flag bits (``service/shm.py`` spells these
#: ``_FLAG_<NAME>``).  Deliberately a SUBSET of the npwire flags with
#: the same bit assignments; the spans/batch features ride dedicated
#: frame kinds instead of flag bits on this lane.
SHMWIRE_FLAGS = {
    "ERROR": 1,     # in-band error string block follows the uuid
    "TRACE": 2,     # 16-byte telemetry trace id block
    "DEADLINE": 4,  # f64 remaining-budget block (service/deadline.py)
    "TENANT": 8,    # u16-len utf8 tenant id block (gateway/fairness.py)
    "PARTITION": 16,  # gradient-partition index block (routing/partition.py)
    "VERSION": 32,  # u64 monotonic step-version stamp (optim/sharded.py)
}

#: The full known-flags mask every shm decoder must enforce
#: (``flags & ~KNOWN`` is a WireError, not a skip).
SHMWIRE_KNOWN_FLAGS = 0
for _bit in SHMWIRE_FLAGS.values():
    SHMWIRE_KNOWN_FLAGS |= _bit
del _bit

#: The arena descriptor: one fixed-layout struct per array, pointing at
#: bytes that never ride the doorbell.  ``slot`` is the arena offset of
#: the slot HEADER (whose generation the reader validates before and
#: after touching payload bytes), ``delta`` the array's byte offset
#: inside the slot's payload (several arrays may share one slot — the
#: scatter/gather packing), ``length`` the payload byte length, and
#: ``generation`` the slot generation the descriptor was minted
#: against — a recycled or torn slot fails loudly as WireError.  The
#: struct format and field order are declared here so the graftlint
#: wire-registry rule can pin the implementation's literals to them.
SHM_DESC_STRUCT = "<QIQQ"
SHM_DESC_FIELD_ORDER = ("slot", "delta", "length", "generation")

#: The gradient-partition index block: one fixed-layout
#: struct describing which contiguous slice of a flat gradient vector
#: a frame carries (or requests).  ``index``/``count`` place the shard
#: among its siblings; ``offset``/``length`` are the element range of
#: the slice inside the flat vector; ``total`` is the flat vector's
#: full element count — the cross-check that makes a driver/node shape
#: disagreement a loud error instead of a silently mis-assembled
#: gradient.  On npwire the block rides flag bit 64 after the tenant
#: block; on the shm doorbell, flag bit 16 in the same position; on
#: npproto it is extension field 20, a nested message whose sub-field
#: numbers are :data:`NPPROTO_PARTITION_FIELDS` (a reference runtime
#: skips the whole field by wire type).  ``routing/partition.py`` owns
#: the semantics (slice/reduce rules, reassembly).
PARTITION_STRUCT = "<IIQQQ"
PARTITION_FIELD_ORDER = ("index", "count", "offset", "length", "total")

#: The step-version stamp: a monotonic u64 counting
#: optimizer updates applied to one gradient shard, carried on update
#: and param-refresh frames so a stale optimizer-state shard is a loud
#: ``WireError``-family refusal (``optim.StaleShardError``), never a
#: silently stale moment buffer.  On npwire the stamp rides flag bit
#: 128 as 8 little-endian bytes after the partition block; on the shm
#: doorbell, flag bit 32 in the same position; on npproto it is
#: extension field 21, a varint a reference runtime skips by wire
#: type.  Zero is a meaningful stamp (the init handshake), so every
#: codec signals the feature by PRESENCE (flag bit / field), never by
#: value.  ``optim/sharded.py`` owns the semantics (version check,
#: exactly-once update, restore-or-refuse).
VERSION_STRUCT = "<Q"

#: Sub-field numbers of the npproto partition message (field 20).
NPPROTO_PARTITION_FIELDS = {
    "index": 1,
    "count": 2,
    "offset": 3,
    "length": 4,
    "total": 5,
}

#: The in-arena descriptor ring: the zero-syscall colocated
#: lane embeds one SPSC ring per arena — submissions in the request
#: arena (client produces, node consumes), completions in the reply
#: arena (node produces, client consumes).  Records carry complete shm
#: doorbell frames (the SHMWIRE kinds/flags/blocks above, verbatim —
#: the ring is a CHANNEL, not a new frame format), so the preserialized
#: deadline/partition/version templates ride unchanged.  The layouts
#: below are declared here first; ``service/ring.py`` mirrors them and
#: the graftlint wire-registry rule pins the implementation literals.
#:
#: Ring header (one per arena, 64 bytes at arena offset
#: :data:`RING_HEADER_OFFSET`)::
#:
#:     produced(u64)  consumed(u64)  futex(u32)  waiting(u32)
#:     epoch(u32)     capacity(u32)  record_bytes(u32)
#:
#: ``produced``/``consumed`` are the two SPSC positions (each written
#: by exactly one side); ``futex`` is the consumer's park word (the
#: producer bumps it per commit and FUTEX_WAKEs only when ``waiting``
#: is set — the zero-syscall steady state); ``epoch`` is the liveness
#: word (nonzero while the ring is attached, zeroed on clean close so
#: a parked peer wakes to a classified ``ConnectionError``, never a
#: hang); ``capacity``/``record_bytes`` cross-check the arena file
#: header's ring geometry.
RING_HEADER_STRUCT = "<QQIIIII"
RING_HEADER_FIELD_ORDER = (
    "produced", "consumed", "futex", "waiting",
    "epoch", "capacity", "record_bytes",
)

#: One ring record header (records start at arena offset
#: :data:`RING_RECORDS_OFFSET`, each ``record_bytes`` wide; the frame
#: payload follows the 16-byte header inside the record).  ``seq`` is
#: the seqlock word: position ``p`` commits as ``2*p + 2``, is mid-
#: write as ``2*p + 1`` — like the arena slot generations, a torn,
#: stale, recycled, or scribbled record is a LOUD ``WireError`` (or a
#: bounded wait that times out as a classified transient), never a
#: wrong-answer descriptor.  ``length`` is the TOTAL frame length on a
#: frame's first record and the chunk length on continuation records
#: (frames larger than one record span consecutive records).
RING_DESC_STRUCT = "<QII"
RING_DESC_FIELD_ORDER = ("seq", "length", "reserved")

#: Arena byte offset of the ring header (immediately after the 64-byte
#: arena file header) and of record 0 (one alignment unit later).
RING_HEADER_OFFSET = 64
RING_RECORDS_OFFSET = 128

#: Byte offsets of the futex / waiting / epoch words INSIDE the ring
#: header — the futex shim addresses these words directly, so the
#: offsets are wire constants like any struct layout.
RING_FUTEX_WORD_OFFSET = 16
RING_WAITING_WORD_OFFSET = 20
RING_EPOCH_WORD_OFFSET = 24

#: GetLoad request payloads.  Both wire schemas define an EMPTY
#: GetLoad request, so every non-empty payload is an in-repo extension
#: riding the npwire-JSON GetLoad lane (server.py ``get_load``; the
#: npproto reply schema is fixed at its three fields and ignores
#: these).  Unknown payloads degrade to the plain load reply —
#: deliberately the proto3 skip posture, not the npwire flag-rejection
#: posture, because the payload selects reply ENRICHMENT, never a
#: different decode of the request.  Declared here so a new pull lane
#: starts in the registry like every other wire feature.
GETLOAD_PAYLOADS = {
    "LOAD": b"",            # plain load reply (both schemas)
    "TRACES": b"traces",    # + recent span trees (trace reunion pull)
    "TELEMETRY": b"telemetry",  # + full telemetry snapshot + flightrec
                                # tail + node wall clock (fleet collector)
}

#: Blocked linear algebra headers.  The ``linalg`` block
#: store is an ordinary arrays-in/arrays-out compute — tiles ride the
#: existing npwire/npproto/shm/ring frames unchanged, so no new flag
#: bits or field numbers exist.  What IS wire format is the two packed
#: headers the driver and the block-store node must agree on, carried
#: as the leading ``uint8`` request arrays of every linalg operation.
#: They are declared here and IMPORTED by ``linalg/blocks.py`` (one
#: source, drift impossible by construction — unlike the C++/cross-
#: codec tables above there is exactly one implementation).
#:
#: Operation header (first request array of every block-store call)::
#:
#:     opcode(u32)  step(u32)  count(u32)  flags(u32)
#:
#: ``opcode`` is a :data:`LINALG_OPCODES` value; ``step`` is the outer
#: factorization index ``k`` where one applies; ``count`` is the number
#: of (tile-header, tile) pairs or coordinate rows that follow;
#: ``flags`` is reserved (must be zero — the node refuses nonzero, the
#: npwire unknown-flag posture).
LINALG_OP_STRUCT = "<IIII"
LINALG_OP_FIELD_ORDER = ("opcode", "step", "count", "flags")

#: Tile header (precedes each shipped tile)::
#:
#:     grid_rows(u32) grid_cols(u32) row(u32) col(u32) rows(u64) cols(u64)
#:
#: ``grid_rows``/``grid_cols`` bind the tile to ONE block layout —
#: a driver/node geometry disagreement is a loud ``BlockError``
#: (⊂ ``WireError``), never a silently mis-placed tile; ``rows``/
#: ``cols`` are the tile's own extent, cross-checked against both the
#: layout's ``tile_shape(row, col)`` and the shipped array's shape.
LINALG_TILE_STRUCT = "<IIIIQQ"
LINALG_TILE_FIELD_ORDER = (
    "grid_rows", "grid_cols", "row", "col", "rows", "cols",
)

#: Block-store opcodes (``linalg/service.py`` owns the semantics).
#: Values are frozen wire constants: a driver built against one table
#: revision talking to a node built against another must fail loudly
#: (unknown opcode -> in-band BlockError), never run the wrong op.
LINALG_OPCODES = {
    "PUT": 1,          # store tiles: [op, (tile_hdr, tile)*] -> [stored]
    "GET": 2,          # fetch tiles: [op, coords i64 (n,2)] -> [tiles...]
    "GEMM_PANEL": 3,   # stateless partial product: [op, a, b] -> [a @ b]
    "CHOL_PANEL": 4,   # factor step k on the owner of block-row k:
                       # [op(k)] -> [L_kk, own_rows i64, L_ik...]
    "TRSM_PANEL": 5,   # panel solve on a non-owner: [op(k), L_kk]
                       # -> [own_rows i64, L_ik...]
    "SYRK_UPDATE": 6,  # trailing update: [op(k), rows i64, L_ik...]
                       # -> [n_updated]
    "RESET": 7,        # drop every stored tile -> [n_dropped]
    "STATS": 8,        # -> [n_tiles, n_bytes] (tests/accounting)
}

"""Fault-injection runtime: plan installation + the injection primitives.

One module-global ``active_plan`` is the whole disabled-path story:
every shim in the I/O stack guards itself with
``if _fi.active_plan is not None`` — a single attribute load — so a
process with no plan installed pays nothing measurable (bench.py's
``faultinject_overhead`` gate holds that line).  With a plan installed,
each injection point calls one of the primitives below; the primitive
asks the plan (:meth:`~.plan.FaultPlan.decide`) whether a rule fires
and applies the fault.

Every fired fault emits a ``fault.<kind>`` flight-recorder event
carrying the plan id, rule index, injection point, and (ambient) trace
id — so an incident bundle shows *what chaos did* right next to *how
the system reacted* (:mod:`..telemetry.flightrec`).

Cross-process activation: ``PFTPU_FAULT_PLAN=<path|inline-json>`` is
read once at import (the service stack imports this package), so a
subprocess node spawned with the variable set runs its half of the
schedule with zero code changes — how chaos reaches across real
process boundaries.  A malformed plan raises at import: a chaos run
whose plan silently failed to load would "pass" by testing nothing.

Applicability by injection point (the wired-in points; shims pass the
names, plans match them with fnmatch patterns):

========================  ==============================================
point                     primitive / applicable kinds
========================  ==============================================
``tcp.send``              :func:`send_frame_through` — all byte +
``tcp.server.send``       process kinds (mid-frame stall/truncate live
                          here: the frame is split at ``cut_frac``)
``tcp.recv``              :func:`filter_bytes` — delay, stall,
``tcp.server.recv``       truncate_frame, corrupt_bytes, drop,
``grpc.send``/``recv``    disconnect, kill_process
``npwire.encode/decode``  :func:`filter_bytes` (codec seams; also
``npwire.*_batch``        ``npproto.encode/decode``)
``grpc.server.reply``     interpreted in service/server.py (async lane:
                          delay, stall, drop→UNAVAILABLE abort,
                          duplicate_reply, truncate, corrupt, kill)
``server.compute``        :func:`compute_filter` (+ ``_async``) —
                          delay, slow_compute (seeded per-call delay),
                          stall, compute_error, kill_process
``server.compute_batch``  :func:`mangle_batch_result` —
                          compute_wrong_shape
``server.getload``        :func:`getload_filter` — getload_garbage,
                          delay
``shm.server.getload``    :func:`getload_filter` (shm doorbell LOAD
                          lane; garbage must fail the probe loudly)
``pool.probe``            :func:`probe_filter` — drop/disconnect (force
                          a failed probe), delay
``shm.send``/``recv``     :func:`send_frame_through` /
``shm.server.send``       :func:`filter_bytes` — the doorbell channel:
``shm.server.recv``       all byte + process kinds, plus
                          ``corrupt_descriptor`` via
                          :func:`corrupt_descriptor_bytes` at the
                          ``shm.descriptor`` point
``shm.arena.write``       :func:`arena_fault` — truncate_slot,
``shm.arena.reply``       stale_generation, delay, kill_process (the
                          arena-side kinds; :mod:`..service.shm`
                          applies the returned kind to the slot it
                          just wrote)
``shm.compute``           :func:`compute_filter` (same kinds as
                          ``server.compute``)
``partition.reply``       :func:`shard_filter` — drop_shard,
                          dup_shard, corrupt_shard (the reduce-reply
                          slice list, before it is framed; the
                          driver's reassembler must refuse every
                          shape loudly)
``ring.send``/``recv``    :func:`filter_bytes` — the ring record byte
``ring.server.send``      lanes (delay, stall, truncate_frame,
``ring.server.recv``      corrupt_bytes, drop, disconnect,
                          kill_process), plus ``corrupt_descriptor``
                          via :func:`corrupt_descriptor_bytes` at the
                          same points (frame header bytes inside the
                          record payload)
``ring.record``           :func:`ring_record_fault` — torn_ring_word,
                          stale_generation, delay, kill_process (the
                          seqlock-word kinds; :mod:`..service.ring`
                          applies the returned kind to the record it
                          just committed)
``ring.wake``             :func:`ring_wake_fault` — ring_stall, delay
                          (delays the producer's futex wake; the
                          parked consumer's lost-wake guard must
                          still make progress)
========================  ==============================================
"""

from __future__ import annotations

import os
import signal
import struct
import threading
import time
from typing import Callable, List, Optional

from ..telemetry import flightrec as _flightrec
from .plan import FaultPlan, FaultRule

__all__ = [
    "active_plan",
    "install",
    "uninstall",
    "install_from_env",
    "decide",
    "filter_bytes",
    "filter_bytes_async",
    "call_shimmed_async",
    "send_frame_through",
    "compute_filter",
    "compute_filter_async",
    "mangle_batch_result",
    "getload_filter",
    "getload_filter_async",
    "probe_filter",
    "probe_filter_async",
    "arena_fault",
    "corrupt_descriptor_bytes",
    "shard_filter",
    "version_filter",
    "refresh_filter",
    "ring_record_fault",
    "ring_wake_fault",
    "snapshot",
]

ENV_VAR = "PFTPU_FAULT_PLAN"

#: The installed plan, or ``None`` (the shipping default).  Shims read
#: this attribute directly as their fast-path guard.
active_plan: Optional[FaultPlan] = None

_lock = threading.Lock()

#: Header region a ``corrupt_bytes`` fault may touch: npwire
#: magic(4)+version(1)+flags(1)+uuid(16)+count(4) = 26 bytes.  Staying
#: inside it guarantees the damage is LOUD (bad magic / bad version /
#: uuid mismatch / insane count) — flipping array payload bytes would
#: be silent corruption the wire format carries no checksum against,
#: which is a different (known) property, not what chaos verifies.
_CORRUPT_REGION = 26


class FaultPlanError(RuntimeError):
    """A fault rule fired at a point that cannot express its kind —
    a plan authoring bug, surfaced loudly instead of skipped."""


def install(plan: FaultPlan) -> Optional[FaultPlan]:
    """Install ``plan`` process-wide; returns the previous plan."""
    global active_plan
    with _lock:
        prev = active_plan
        active_plan = plan
    _flightrec.record(
        "fault.plan_installed", plan=plan.plan_id, n_rules=len(plan.rules)
    )
    return prev


def uninstall() -> Optional[FaultPlan]:
    """Remove the installed plan (idempotent); returns it."""
    global active_plan
    with _lock:
        prev = active_plan
        active_plan = None
    if prev is not None:
        _flightrec.record(
            "fault.plan_uninstalled",
            plan=prev.plan_id,
            total_fires=prev.total_fires,
        )
    return prev


def install_from_env() -> Optional[FaultPlan]:
    """Install the plan named by ``$PFTPU_FAULT_PLAN`` (inline JSON or
    a file path); returns it, or ``None`` when the variable is unset.
    Called once at package import — the subprocess activation lane."""
    spec = os.environ.get(ENV_VAR)
    if not spec:
        return None
    plan = FaultPlan.from_spec(spec)
    install(plan)
    return plan


def snapshot() -> Optional[dict]:
    """The active plan's :meth:`~.plan.FaultPlan.snapshot`, or ``None``
    — what :func:`..telemetry.watchdog.write_incident_bundle` embeds."""
    plan = active_plan
    return plan.snapshot() if plan is not None else None


def decide(point: str, peer: Optional[str] = None) -> Optional[FaultRule]:
    """Ask the active plan whether a fault fires here; records the
    ``fault.<kind>`` flight event for a fired rule.  ``None`` when no
    plan is installed or nothing fires."""
    plan = active_plan
    if plan is None:
        return None
    rule = plan.decide(point, peer)
    if rule is not None:
        attrs = {"plan": plan.plan_id, "rule": rule.index, "point": point}
        if peer is not None:
            attrs["peer"] = peer
        _flightrec.record(f"fault.{rule.kind}", **attrs)
    return rule


def _corrupt(rule: FaultRule, buf: bytes) -> bytes:
    """Flip 1-3 header-region bytes, chosen by the rule's seeded RNG."""
    if not buf:
        return buf
    hi = min(len(buf), _CORRUPT_REGION)
    rng = rule._rng
    out = bytearray(buf)
    for _ in range(min(3, hi)):
        i = rng.randrange(hi) if rng is not None else 0
        out[i] ^= 0xFF
    return bytes(out)


def _kill_now(point: str) -> None:
    # SIGKILL, not sys.exit: the fault models abrupt process death —
    # no atexit hooks, no socket lingering, exactly like the real thing.
    os.kill(os.getpid(), signal.SIGKILL)


def apply_to_bytes(rule: FaultRule, buf: bytes, point: str) -> bytes:
    """Apply a byte-lane fault to an in-hand buffer (codec seams and
    recv paths, where "mid-frame" has no transport meaning): may sleep,
    mutate, raise :class:`ConnectionError`, or kill the process.

    SYNC callers only — the delay/stall kinds ``time.sleep``.  Async
    callers handle those kinds with ``await asyncio.sleep`` first
    (:func:`filter_bytes_async`, ``server._fi_reply_filter``) and
    delegate the rest to :func:`transform_bytes`, which never sleeps —
    the split keeps every blocking primitive off loop-reachable paths
    (graftflow ``async-blocking``)."""
    kind = rule.kind
    if kind == "delay":
        time.sleep(rule.delay_s)
        return buf
    if kind == "stall":
        time.sleep(rule.stall_s)
        return buf
    return transform_bytes(rule, buf, point)


def transform_bytes(rule: FaultRule, buf: bytes, point: str) -> bytes:
    """The sleep-free byte-lane kinds: mutate, raise, or kill — safe
    from any context, event loop included."""
    kind = rule.kind
    if kind in ("drop", "disconnect"):
        raise ConnectionError(f"faultinject[{kind}] at {point}")
    if kind == "truncate_frame":
        return buf[: rule.cut_at(len(buf))]
    if kind == "corrupt_bytes":
        return _corrupt(rule, buf)
    if kind == "kill_process":
        _kill_now(point)
    raise FaultPlanError(f"fault kind {kind!r} not applicable at {point}")


def filter_bytes(point: str, buf: bytes, peer: Optional[str] = None) -> bytes:
    """The generic byte-lane shim (codec encode/decode seams and the
    sync TCP recv path).  Sleeps BLOCK the calling thread — async call
    sites must use :func:`filter_bytes_async` instead."""
    rule = decide(point, peer)
    if rule is None:
        return buf
    return apply_to_bytes(rule, buf, point)


async def filter_bytes_async(
    point: str, buf: bytes, peer: Optional[str] = None
) -> bytes:
    """Async twin of :func:`filter_bytes` for the grpc.aio lane:
    delay/stall are awaited so a chaos-slowed message behaves like a
    slow network, not a frozen driver — concurrent in-window RPCs and
    the hedge timer on the same event loop keep running."""
    rule = decide(point, peer)
    if rule is None:
        return buf
    if rule.kind in ("delay", "stall"):
        import asyncio

        await asyncio.sleep(
            rule.delay_s if rule.kind == "delay" else rule.stall_s
        )
        return buf
    return transform_bytes(rule, buf, point)


async def call_shimmed_async(fn, *args, inline: bool = True, **kwargs):
    """Call a sync function that HOLDS chaos seams (codec
    ``filter_bytes`` points, the vectorized ``mangle_batch_result``
    seam) from a coroutine without ever blocking the event loop.

    ``inline=True`` is the production fast path: a direct call, taken
    only while NO fault plan is active.  With a plan installed — or
    with ``inline=False`` (callers that always want the executor
    handoff, e.g. the non-inline batcher) — the call runs in the
    loop's default executor, so a sync shim's delay/stall sleeps a
    worker thread and a chaos-slowed frame behaves like a slow
    network, not a frozen driver.

    This exists because graftflow's transitive ``async-blocking`` rule
    found the event-loop-blocking bug class three frames down: async handlers
    call the sync codecs inline, and the codecs hold ``filter_bytes``
    seams whose delay kinds ``time.sleep`` (tests:
    test_faultinject.py ``TestCallShimmedAsync``).

    The executor call carries the CALLER's contextvars
    (``copy_context``): the codecs read the ambient telemetry trace id
    (``spans.current_trace_id``), and a bare worker thread would
    silently encode ``trace_id=None`` exactly during chaos runs —
    the same convention as routing/pooled_client's executor hops."""
    if inline and active_plan is None:
        return fn(*args, **kwargs)
    import asyncio
    import contextvars
    from functools import partial

    loop = asyncio.get_running_loop()
    ctx = contextvars.copy_context()
    return await loop.run_in_executor(
        None, ctx.run, partial(fn, *args, **kwargs)
    )


def send_frame_through(
    point: str,
    sendall: Callable[[bytes], None],
    payload: bytes,
    peer: Optional[str] = None,
) -> None:
    """Send one u32-length-prefixed frame with injection — the TCP
    lane's send shim, where mid-frame faults are physically real:
    ``stall`` transmits the frame's first ``cut_frac`` bytes, sleeps,
    then finishes; ``truncate_frame`` transmits the head and resets the
    connection; ``duplicate_reply`` transmits the frame twice."""
    rule = decide(point, peer)
    prefix = struct.pack("<I", len(payload))
    if rule is None:
        sendall(prefix + payload)
        return
    kind = rule.kind
    if kind == "delay":
        time.sleep(rule.delay_s)
        sendall(prefix + payload)
    elif kind == "disconnect":
        raise ConnectionError(f"faultinject[disconnect] at {point}")
    elif kind == "drop":
        # The frame is discarded AND the connection resets: a lost
        # frame over a connection that stays silently healthy would
        # hang a lock-step peer forever — that failure mode is `stall`
        # (bounded, watchdog-visible) by design.
        raise ConnectionError(f"faultinject[drop] at {point}")
    elif kind == "truncate_frame":
        data = prefix + payload
        sendall(data[: 4 + rule.cut_at(len(payload))])
        raise ConnectionError(f"faultinject[truncate_frame] at {point}")
    elif kind == "stall":
        data = prefix + payload
        k = 4 + rule.cut_at(len(payload))
        sendall(data[:k])
        time.sleep(rule.stall_s)
        sendall(data[k:])
    elif kind == "corrupt_bytes":
        sendall(prefix + _corrupt(rule, payload))
    elif kind == "duplicate_reply":
        sendall(prefix + payload + prefix + payload)
    elif kind == "kill_process":
        _kill_now(point)
    else:
        raise FaultPlanError(f"fault kind {kind!r} not applicable at {point}")


def compute_filter(point: str = "server.compute", peer: Optional[str] = None) -> None:
    """Node compute-path shim (sync lanes): ``compute_error`` raises —
    the caller's normal error handling turns it into an in-band error
    reply / status abort; delay/stall sleep (``slow_compute`` draws a
    seeded per-call delay — the degraded-replica model); kill kills."""
    rule = decide(point, peer)
    if rule is None:
        return
    kind = rule.kind
    if kind == "delay":
        time.sleep(rule.delay_s)
    elif kind == "slow_compute":
        time.sleep(rule.draw_delay_s())
    elif kind == "stall":
        time.sleep(rule.stall_s)
    elif kind == "compute_error":
        raise RuntimeError(
            rule.error or f"faultinject[compute_error] at {point}"
        )
    elif kind == "kill_process":
        _kill_now(point)
    else:
        raise FaultPlanError(f"fault kind {kind!r} not applicable at {point}")


async def compute_filter_async(
    point: str = "server.compute", peer: Optional[str] = None
) -> None:
    """Async twin of :func:`compute_filter` for the grpc.aio server —
    sleeps are awaited so a stalled compute does not freeze the event
    loop (GetLoad and sibling streams keep serving, exactly like a real
    slow compute in the executor)."""
    rule = decide(point, peer)
    if rule is None:
        return
    kind = rule.kind
    if kind in ("delay", "stall", "slow_compute"):
        import asyncio

        await asyncio.sleep(
            rule.draw_delay_s()
            if kind == "slow_compute"
            else (rule.delay_s if kind == "delay" else rule.stall_s)
        )
    elif kind == "compute_error":
        raise RuntimeError(
            rule.error or f"faultinject[compute_error] at {point}"
        )
    elif kind == "kill_process":
        _kill_now(point)
    else:
        raise FaultPlanError(f"fault kind {kind!r} not applicable at {point}")


def mangle_batch_result(point: str, outs: List[object]) -> List[object]:
    """The vectorized-compute seam: ``compute_wrong_shape`` drops one
    result so the batch returns K-1 outputs for K requests — the
    malformed-batch signature the scalar-fallback isolation path
    (service/batching.py) must absorb without corrupting any reply."""
    rule = decide(point)
    if rule is None:
        return outs
    if rule.kind == "compute_wrong_shape":
        return list(outs)[:-1]
    if rule.kind == "delay":
        time.sleep(rule.delay_s)
        return outs
    raise FaultPlanError(f"fault kind {rule.kind!r} not applicable at {point}")


#: Valid-but-unknown-fields-only protobuf (field 31, len 3): the exact
#: shape proto3 leniency would decode to an all-zero — maximally
#: attractive — load if the GetLoad guard were missing; also not JSON.
GETLOAD_GARBAGE = b"\xfa\x01\x03xyz"


def getload_filter(point: str = "server.getload") -> Optional[bytes]:
    """GetLoad shim: returns replacement reply bytes for
    ``getload_garbage`` (``None`` = serve the real reply); ``delay``
    sleeps."""
    rule = decide(point)
    if rule is None:
        return None
    if rule.kind == "getload_garbage":
        return GETLOAD_GARBAGE
    if rule.kind == "delay":
        time.sleep(rule.delay_s)
        return None
    raise FaultPlanError(f"fault kind {rule.kind!r} not applicable at {point}")


async def getload_filter_async(point: str = "server.getload") -> Optional[bytes]:
    """Async twin of :func:`getload_filter` for the grpc.aio GetLoad
    handler: a ``delay`` rule is awaited, so a chaos-slowed load reply
    behaves like a slow node — concurrent Evaluate streams on the same
    event loop keep serving (the event-loop-blocking bug class,
    caught by the ``async-blocking`` graftlint rule)."""
    rule = decide(point)
    if rule is None:
        return None
    if rule.kind == "getload_garbage":
        return GETLOAD_GARBAGE
    if rule.kind == "delay":
        import asyncio

        await asyncio.sleep(rule.delay_s)
        return None
    raise FaultPlanError(f"fault kind {rule.kind!r} not applicable at {point}")


def arena_fault(point: str, peer: Optional[str] = None) -> Optional[str]:
    """SHM arena-side shim: returns the fired arena kind
    (``truncate_slot`` / ``stale_generation``) for the caller to apply
    to the slot it controls — the fault needs arena knowledge the
    runtime does not have, so :mod:`..service.shm` executes it at the
    write site.  ``delay`` sleeps here (sync lane); ``kill_process``
    kills; ``None`` = no fault."""
    rule = decide(point, peer)
    if rule is None:
        return None
    kind = rule.kind
    if kind in ("truncate_slot", "stale_generation"):
        return kind
    if kind == "delay":
        time.sleep(rule.delay_s)
        return None
    if kind in ("drop", "disconnect"):
        raise ConnectionError(f"faultinject[{kind}] at {point}")
    if kind == "kill_process":
        _kill_now(point)
    raise FaultPlanError(f"fault kind {kind!r} not applicable at {point}")


def corrupt_descriptor_bytes(
    point: str, buf: bytes, desc_off: int, peer: Optional[str] = None
) -> bytes:
    """``corrupt_descriptor`` shim for shm doorbell frames: flips 1-3
    bytes INSIDE the descriptor block (``desc_off`` onward — offsets,
    lengths, generations, dtype bits), which is exactly the damage the
    arena reader's generation/bounds validation must classify as
    :class:`~..service.npwire.WireError`, never a torn or silently
    wrong array.  Frame-header kinds stay with :func:`filter_bytes`."""
    rule = decide(point, peer)
    if rule is None:
        return buf
    if rule.kind != "corrupt_descriptor":
        raise FaultPlanError(
            f"fault kind {rule.kind!r} not applicable at {point}"
        )
    if desc_off >= len(buf):
        return buf
    rng = rule._rng
    out = bytearray(buf)
    span = len(buf) - desc_off
    for _ in range(min(3, span)):
        i = desc_off + (rng.randrange(span) if rng is not None else 0)
        out[i] ^= 0xFF
    return bytes(out)


def ring_record_fault(point: str, peer: Optional[str] = None) -> Optional[str]:
    """Ring record-side shim: returns the fired seqlock-word
    kind (``torn_ring_word`` / ``stale_generation``) for
    :mod:`..service.ring` to apply to the record it just committed —
    the fault needs ring-geometry knowledge (slot position, sequence
    residue) the runtime does not have.  ``delay`` sleeps here (sync
    lane); ``kill_process`` kills; ``None`` = no fault."""
    rule = decide(point, peer)
    if rule is None:
        return None
    kind = rule.kind
    if kind in ("torn_ring_word", "stale_generation"):
        return kind
    if kind == "delay":
        time.sleep(rule.delay_s)
        return None
    if kind in ("drop", "disconnect"):
        raise ConnectionError(f"faultinject[{kind}] at {point}")
    if kind == "kill_process":
        _kill_now(point)
    raise FaultPlanError(f"fault kind {kind!r} not applicable at {point}")


def ring_wake_fault(point: str, peer: Optional[str] = None) -> None:
    """``ring.wake`` shim: delays the producer's futex wake
    AFTER the record is published (``ring_stall`` sleeps ``stall_s``,
    ``delay`` sleeps ``delay_s``).  Deliberately NOT a loud fault: the
    record is committed, so the consumer's bounded park / lost-wake
    re-check must consume it regardless — chaos verifies liveness, not
    an error classification.  ``kill_process`` kills (wake never
    arrives: the peer-death path)."""
    rule = decide(point, peer)
    if rule is None:
        return
    kind = rule.kind
    if kind == "ring_stall":
        time.sleep(rule.stall_s)
        return
    if kind == "delay":
        time.sleep(rule.delay_s)
        return
    if kind == "kill_process":
        _kill_now(point)
    raise FaultPlanError(f"fault kind {kind!r} not applicable at {point}")


def shard_filter(
    point: str,
    items: List[bytes],
    *,
    block_off: int = 0,
    block_len: int = 32,
    peer: Optional[str] = None,
) -> List[bytes]:
    """Partition reduce-reply shim: mangle the slice list a
    server is about to frame, so the DRIVER's reassembly loudness is
    what chaos verifies.  ``drop_shard`` removes a seeded slice (the
    reassembler's missing-index refusal); ``dup_shard`` replaces one
    slice with a copy of a sibling (duplicate + missing — both loud);
    ``corrupt_shard`` flips bytes inside one slice's partition/
    descriptor block — the ``block_len`` bytes at ``block_off``, NEVER
    payload bytes (payload damage would be silent; geometry damage is
    guaranteed loud: overlap/out-of-bounds/count drift).  ``delay``
    sleeps (sync server lanes only)."""
    rule = decide(point, peer)
    if rule is None or not items:
        return items
    kind = rule.kind
    rng = rule._rng
    idx = rng.randrange(len(items)) if rng is not None else 0
    if kind == "drop_shard":
        return [it for j, it in enumerate(items) if j != idx]
    if kind == "dup_shard":
        out = list(items)
        out[(idx + 1) % len(out)] = out[idx]
        return out
    if kind == "corrupt_shard":
        victim = bytearray(items[idx])
        span = min(block_len, len(victim) - block_off)
        if span > 0:
            for _ in range(min(3, span)):
                i = block_off + (
                    rng.randrange(span) if rng is not None else 0
                )
                victim[i] ^= 0xFF
        out = list(items)
        out[idx] = bytes(victim)
        return out
    if kind == "delay":
        time.sleep(rule.delay_s)
        return items
    raise FaultPlanError(f"fault kind {kind!r} not applicable at {point}")


def version_filter(
    point: str, version: int, peer: Optional[str] = None
) -> int:
    """Sharded-optimizer version-stamp shim: a
    ``stale_param_version`` rule TWISTS the step-version stamp the
    driver is about to put on an update request, so the node's version
    check refuses it — what chaos verifies is the driver's recovery
    classification (a refusal whose ``holds`` equals the driver's own
    version means NO step happened; the driver must not count it
    accepted).  ``delay`` sleeps (driver-side sync lane)."""
    rule = decide(point, peer)
    if rule is None:
        return version
    if rule.kind == "stale_param_version":
        # Twist DOWN when possible (the classic lost-driver-state
        # shape); a version-0 stamp twists up instead (u64 wire).
        return version - 1 if version > 0 else version + 1
    if rule.kind == "delay":
        time.sleep(rule.delay_s)
        return version
    raise FaultPlanError(f"fault kind {rule.kind!r} not applicable at {point}")


def refresh_filter(point: str, peer: Optional[str] = None) -> None:
    """Param-refresh lane shim: a ``drop_param_refresh``
    rule raises :class:`ConnectionError` in place of the refresh call —
    a dropped refresh is a TRANSIENT transport failure (the shard stays
    at its old version; the next step's already-applied recovery
    retries the refresh), never a silent stale parameter read."""
    rule = decide(point, peer)
    if rule is None:
        return
    if rule.kind == "drop_param_refresh":
        raise ConnectionError(
            f"fault injection: dropped param refresh at {point}"
        )
    if rule.kind == "delay":
        time.sleep(rule.delay_s)
        return
    raise FaultPlanError(f"fault kind {rule.kind!r} not applicable at {point}")


def probe_filter(peer: str, point: str = "pool.probe") -> bool:
    """Pool probe-lane shim: ``False`` forces the probe to be recorded
    as failed without dialing (``drop``/``disconnect``); ``delay``
    sleeps then proceeds; ``True`` = probe normally."""
    rule = decide(point, peer)
    if rule is None:
        return True
    if rule.kind in ("drop", "disconnect"):
        return False
    if rule.kind == "delay":
        time.sleep(rule.delay_s)
        return True
    raise FaultPlanError(f"fault kind {rule.kind!r} not applicable at {point}")


async def probe_filter_async(peer: str, point: str = "pool.probe") -> bool:
    """Async twin of :func:`probe_filter` for the gRPC probe lane:
    a ``delay`` rule is awaited so a chaos-slowed probe does not freeze
    the pool's event loop — sibling probes in the same ``gather`` and
    in-flight calls keep running (the event-loop-blocking bug
    class, caught by the ``async-blocking`` graftlint rule)."""
    rule = decide(point, peer)
    if rule is None:
        return True
    if rule.kind in ("drop", "disconnect"):
        return False
    if rule.kind == "delay":
        import asyncio

        await asyncio.sleep(rule.delay_s)
        return True
    raise FaultPlanError(f"fault kind {rule.kind!r} not applicable at {point}")

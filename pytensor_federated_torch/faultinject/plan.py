"""Deterministic, seed-driven fault schedules.

A :class:`FaultPlan` is a serializable list of :class:`FaultRule` s —
*what* chaos to inject (the fault kind), *where* (an injection-point
pattern plus an optional peer filter), and *when* (nth matching call,
every-k-th call, or seeded probability).  The plan is pure data: it
holds no sockets, no threads, and imports nothing heavier than the
stdlib, so the SAME plan object (or its JSON form) drives the driver
process, a subprocess node (``PFTPU_FAULT_PLAN``, see
:mod:`.runtime`), and — for the delay/disconnect/truncate subset — the
C++ node's ``--fault-plan`` flag via :meth:`FaultPlan.native_spec`.

Determinism contract: a plan is a pure function of its construction
arguments.  Probabilistic rules draw from a per-rule ``random.Random``
seeded from ``(plan seed, rule index)``, and nth/every rules count
*matching calls at their injection point*, so replaying the same
workload under the same plan replays the same faults.  (Across
concurrently-served connections the interleaving of matches is the
scheduler's, as in any real system — the *schedule* is deterministic,
the invariants chaos checks must hold under any interleaving.)

Fault kinds (the vocabulary every shim understands — see
:mod:`.runtime` for per-point applicability):

==================  =======================================================
kind                injected behavior
==================  =======================================================
delay               sleep ``delay_s`` then proceed (slow network / node)
drop                discard the frame and reset the connection (a lost
                    frame whose transport subsequently notices; a lost
                    frame over a *silently healthy* connection is
                    ``stall``)
disconnect          fail with ``ConnectionError`` before any bytes move
truncate_frame      emit/keep only the first ``cut_frac`` of the frame's
                    bytes, then reset — the mid-frame kill
corrupt_bytes       flip bytes in the frame's HEADER region (magic /
                    flags / uuid), guaranteeing a loud decode or
                    correlation failure rather than silent data damage
stall               transmit part of the frame, sleep ``stall_s`` (the
                    watchdog-visible wedge), then finish — bounded on
                    purpose so a chaos run always terminates
duplicate_reply     send the reply twice (desynchronizes a lock-step
                    stream; the uuid correlation must catch it)
compute_error       the node's compute raises (in-band error reply /
                    non-retryable status — the deterministic-failure
                    classification path)
slow_compute        the node's compute takes a SEEDED per-call delay,
                    drawn uniformly from ``[0, delay_s]`` by the
                    rule's own RNG — the degraded-replica model the
                    overload chaos lane stalls a pool with (every
                    call slower, none failing: deadlines and
                    admission control must do the shedding)
compute_wrong_shape the node's VECTORIZED batch compute returns the
                    wrong result count (the scalar-fallback isolation
                    path must absorb it)
getload_garbage     GetLoad answers undecodable bytes (the probe lane
                    must fail the probe, not balance toward zero load)
kill_process        ``SIGKILL`` the current process at the injection
                    point (mid-frame process death)
corrupt_descriptor  flip bytes inside a shm doorbell frame's descriptor
                    block (offset/len/generation/dtype bits) — the
                    arena reader must fail loudly, never read a wrong
                    or torn slot (shm lane only)
truncate_slot       scribble the arena slot's tail generation after the
                    payload write — the slot reads as a write that
                    never completed (shm lane only)
stale_generation    age the descriptor's generation so it no longer
                    matches the slot — the recycled-slot race, forced
                    (shm lane only)
drop_shard          remove one partition-indexed slice from a reduce
                    reply (the reassembler must refuse the incomplete
                    gradient loudly, never return a partial sum)
dup_shard           replace one reduce-reply slice with a copy of a
                    sibling (duplicate index + missing index — both
                    loud reassembly refusals)
corrupt_shard       flip bytes inside a reduce-reply slice's partition
                    block (geometry lies: overlap / out-of-bounds /
                    count drift — every shape a loud WireError)
torn_ring_word      leave a ring record's seqlock word mid-write (odd
                    sequence, never committed) — the consumer's bounded
                    wait must classify it as a loud transient timeout,
                    never spin forever or read the torn payload
                    (ring lane only)
ring_stall          delay the producer's futex wake after publishing a
                    ring record — NOT a loud fault: the parked waiter's
                    re-check / bounded park must still consume the
                    record (tests the lost-wake guard, ring lane only)
==================  =======================================================
"""

from __future__ import annotations

import fnmatch
import json
import random
import threading
import uuid as uuid_mod
from typing import Any, Dict, List, Optional, Sequence

__all__ = ["FAULT_KINDS", "FaultRule", "FaultPlan"]

FAULT_KINDS = frozenset(
    {
        "delay",
        "drop",
        "disconnect",
        "truncate_frame",
        "corrupt_bytes",
        "stall",
        "duplicate_reply",
        "compute_error",
        "slow_compute",
        "compute_wrong_shape",
        "getload_garbage",
        "kill_process",
        "corrupt_descriptor",
        "truncate_slot",
        "stale_generation",
        "drop_shard",
        "dup_shard",
        "corrupt_shard",
        "stale_param_version",
        "drop_param_refresh",
        "torn_ring_word",
        "ring_stall",
    }
)

#: Rules translatable to the C++ node's ``--fault-plan`` flag.
NATIVE_KINDS = frozenset({"delay", "disconnect", "truncate_frame"})


class FaultRule:
    """One fault: kind + match predicates + parameters + live counters.

    Predicates (all optional, AND-combined):

    - ``point``: fnmatch pattern over the injection-point name
      (``"tcp.send"``, ``"server.*"``; default ``"*"``).
    - ``peer``: substring of the peer address (``"127.0.0.1:9001"``)
      — pins a rule to one replica.
    - ``nth``: fire on exactly the nth matching call (1-based).
    - ``every``: fire on every ``every``-th matching call.
    - ``prob``: fire with this probability, drawn from the rule's own
      seeded RNG.

    Without nth/every/prob the rule fires on every match.  ``max_fires``
    bounds total fires (default 1 for ``nth`` rules, unbounded
    otherwise — pass explicitly to override).
    """

    __slots__ = (
        "kind", "point", "peer", "nth", "every", "prob", "max_fires",
        "delay_s", "stall_s", "cut_frac", "error", "index", "matches",
        "fires", "_rng",
    )

    def __init__(
        self,
        kind: str,
        *,
        point: str = "*",
        peer: Optional[str] = None,
        nth: Optional[int] = None,
        every: Optional[int] = None,
        prob: Optional[float] = None,
        max_fires: Optional[int] = None,
        delay_s: float = 0.05,
        stall_s: float = 2.0,
        cut_frac: float = 0.5,
        error: Optional[str] = None,
    ) -> None:
        if kind not in FAULT_KINDS:
            raise ValueError(
                f"unknown fault kind {kind!r}; known: {sorted(FAULT_KINDS)}"
            )
        if nth is not None and nth < 1:
            raise ValueError(f"nth is 1-based, got {nth}")
        if every is not None and every < 1:
            raise ValueError(f"every must be >= 1, got {every}")
        if prob is not None and not 0.0 <= prob <= 1.0:
            raise ValueError(f"prob must be in [0, 1], got {prob}")
        if not 0.0 <= cut_frac <= 1.0:
            raise ValueError(f"cut_frac must be in [0, 1], got {cut_frac}")
        self.kind = kind
        self.point = point
        self.peer = peer
        self.nth = nth
        self.every = every
        self.prob = prob
        self.max_fires = (
            max_fires if max_fires is not None else (1 if nth else None)
        )
        self.delay_s = float(delay_s)
        self.stall_s = float(stall_s)
        self.cut_frac = float(cut_frac)
        self.error = error
        self.index = -1  # set by the owning plan
        self.matches = 0
        self.fires = 0
        self._rng: Optional[random.Random] = None

    def _bind(self, index: int, seed: int) -> None:
        self.index = index
        self._rng = random.Random(f"{seed}:{index}")

    def matches_site(self, point: str, peer: Optional[str]) -> bool:
        if not fnmatch.fnmatchcase(point, self.point):
            return False
        if self.peer is not None and (peer is None or self.peer not in peer):
            return False
        return True

    def should_fire(self, allow: bool = True) -> bool:
        """Consume one match (caller already checked the site) and
        decide whether this occurrence fires.  Counters advance even
        when a fire is vetoed by ``max_fires`` — or by ``allow=False``
        (an earlier rule already fired for this call: exactly one fault
        per call, so ``fires`` counts faults actually APPLIED) — so
        nth/every stay anchored to the workload, not to prior fires."""
        self.matches += 1
        if not allow:
            return False
        if self.max_fires is not None and self.fires >= self.max_fires:
            return False
        if self.nth is not None and self.matches != self.nth:
            return False
        if self.every is not None and self.matches % self.every != 0:
            return False
        if self.prob is not None:
            rng = self._rng or random.Random(self.index)
            if rng.random() >= self.prob:
                return False
        self.fires += 1
        return True

    def draw_delay_s(self) -> float:
        """``slow_compute``'s per-call delay: uniform over
        ``[0, delay_s]`` from the rule's seeded RNG, so the SAME plan
        replays the same latency profile while individual calls still
        vary (a constant-delay replica is `delay`; this models a
        degraded one)."""
        rng = self._rng or random.Random(self.index)
        return rng.random() * self.delay_s

    def cut_at(self, length: int) -> int:
        """Byte offset for truncate/stall splits: at least 1 byte in,
        at most length-1 (a zero-byte or full-length "truncation" would
        be a no-op or a disconnect, not a mid-frame event)."""
        if length <= 1:
            return length
        return min(max(int(length * self.cut_frac), 1), length - 1)

    # -- (de)serialization -------------------------------------------------

    _FIELDS = (
        "kind", "point", "peer", "nth", "every", "prob", "max_fires",
        "delay_s", "stall_s", "cut_frac", "error",
    )

    def to_dict(self) -> Dict[str, Any]:
        d = {}
        for f in self._FIELDS:
            v = getattr(self, f)
            if v is not None and not (f == "point" and v == "*"):
                d[f] = v
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "FaultRule":
        unknown = set(d) - set(cls._FIELDS)
        if unknown:
            raise ValueError(f"unknown FaultRule fields: {sorted(unknown)}")
        if "kind" not in d:
            raise ValueError("FaultRule needs a 'kind'")
        kw = dict(d)
        kind = kw.pop("kind")
        return cls(kind, **kw)

    def snapshot(self) -> Dict[str, Any]:
        """Rule spec plus live counters (for incident bundles)."""
        d = self.to_dict()
        d["index"] = self.index
        d["matches"] = self.matches
        d["fires"] = self.fires
        if self.max_fires is not None:
            d["remaining"] = max(0, self.max_fires - self.fires)
        return d

    def __repr__(self) -> str:  # debugging / chaos_run logs
        return f"FaultRule({self.to_dict()!r})"


class FaultPlan:
    """A seeded, serializable schedule of faults.

    ``decide(point, peer)`` is the single runtime entry: it consumes
    one match on every rule whose predicates cover the site and returns
    the first rule that fires (or ``None``).  Thread-safe — injection
    points are hit from event loops, worker threads, and the pool's
    probe thread alike.
    """

    def __init__(
        self,
        rules: Sequence[FaultRule],
        *,
        seed: int = 0,
        plan_id: Optional[str] = None,
    ) -> None:
        self.seed = int(seed)
        self.plan_id = plan_id or f"plan-{self.seed}-{uuid_mod.uuid4().hex[:6]}"
        self.rules: List[FaultRule] = list(rules)
        self._lock = threading.Lock()
        for i, rule in enumerate(self.rules):
            rule._bind(i, self.seed)

    def decide(self, point: str, peer: Optional[str] = None) -> Optional[FaultRule]:
        """First rule that fires at this site, advancing every covering
        rule's match counter; ``None`` when nothing fires.  At most ONE
        rule fires per call — ``fires`` counts faults actually applied,
        which is what the chaos harness's telemetry-accounting
        invariant reconciles against ``fault.*`` events."""
        fired: Optional[FaultRule] = None
        with self._lock:
            for rule in self.rules:
                if not rule.matches_site(point, peer):
                    continue
                if rule.should_fire(allow=fired is None):
                    fired = rule
        return fired

    @property
    def total_fires(self) -> int:
        with self._lock:
            return sum(r.fires for r in self.rules)

    # -- (de)serialization -------------------------------------------------

    def to_dict(self) -> Dict[str, Any]:
        return {
            "plan_id": self.plan_id,
            "seed": self.seed,
            "rules": [r.to_dict() for r in self.rules],
        }

    def to_json(self) -> str:
        return json.dumps(self.to_dict())

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "FaultPlan":
        if not isinstance(d, dict) or "rules" not in d:
            raise ValueError("FaultPlan JSON needs a 'rules' list")
        return cls(
            [FaultRule.from_dict(r) for r in d["rules"]],
            seed=d.get("seed", 0),
            plan_id=d.get("plan_id"),
        )

    @classmethod
    def from_json(cls, text: str) -> "FaultPlan":
        return cls.from_dict(json.loads(text))

    @classmethod
    def from_spec(cls, spec: str) -> "FaultPlan":
        """``PFTPU_FAULT_PLAN`` parser: inline JSON (leading ``{``) or a
        path to a JSON file."""
        spec = spec.strip()
        if spec.startswith("{"):
            return cls.from_json(spec)
        with open(spec, "r", encoding="utf-8") as fh:
            return cls.from_json(fh.read())

    def snapshot(self) -> Dict[str, Any]:
        """Plan id + per-rule spec/counters/remaining — what an incident
        bundle embeds so chaos-triggered bundles are self-describing."""
        with self._lock:
            return {
                "plan_id": self.plan_id,
                "seed": self.seed,
                "total_fires": sum(r.fires for r in self.rules),
                "rules": [r.snapshot() for r in self.rules],
            }

    def native_spec(self) -> str:
        """The delay/disconnect/truncate subset as the C++ node's
        compact ``--fault-plan`` string: comma-separated
        ``delay:<nth>:<ms>`` / ``disconnect:<nth>`` /
        ``truncate:<nth>:<frac_percent>`` entries (nth counts frames
        served by the node, process-wide).  Rules of other kinds — or
        without an ``nth`` anchor — are skipped: the native node only
        implements the cross-language minimum."""
        parts = []
        for rule in self.rules:
            if rule.kind not in NATIVE_KINDS or rule.nth is None:
                continue
            if rule.kind == "delay":
                parts.append(f"delay:{rule.nth}:{int(rule.delay_s * 1e3)}")
            elif rule.kind == "disconnect":
                parts.append(f"disconnect:{rule.nth}")
            else:
                parts.append(
                    f"truncate:{rule.nth}:{int(rule.cut_frac * 100)}"
                )
        return ",".join(parts)

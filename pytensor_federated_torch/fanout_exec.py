"""Pure scheduling core of the fused federated apply — no pytensor needed.

``ParallelFederatedOp.perform`` (fusion.py) must fan N member performs
out over pinned threads, slice the concatenated input/output-storage
lists per member, let every member settle, and surface the first
failure loudly.  Those are exactly the parts most likely to be wrong —
and pytensor cannot be installed in every environment this repo is
developed in — so they live here, importable and testable without
pytensor; fusion.py keeps only the literal
pytensor API calls.

Contracts (mirroring the reference's ``ParallelAsyncOp.perform``,
reference: op_async.py:107-132):

- wall-clock = max member latency, not the sum (members run
  concurrently; they are host/network calls that release the GIL);
- member ``i`` runs on the SAME thread every evaluation (gRPC/asyncio
  client state caches per (token, pid, thread, loop) — a migrating
  member would re-dial its channels each call);
- on failure, every member still settles before the first exception
  (in member order) is raised — cancelling mid-flight would leave
  sibling storages half-set.
"""

from __future__ import annotations

import contextvars
import threading
import time
import weakref
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from .telemetry import flightrec as _flightrec
from .telemetry import metrics as _metrics
from .telemetry import spans as _tspans

__all__ = [
    "CoalescingCaller",
    "MemberExecutorPool",
    "PartitionedCaller",
    "member_spans",
    "run_members",
]

# Fanout instrumentation (metric catalog: docs/observability.md).  The
# straggler gap — max minus min member latency within one fanout — is
# THE number that says how much of the "wall-clock = max member" budget
# is lost to imbalance (the per-stage accounting DrJAX-style MapReduce
# analyses center on).
_FANOUT_WIDTH = _metrics.histogram(
    "pftpu_fanout_width",
    "Members per fused fanout evaluation",
    buckets=_metrics.DEFAULT_COUNT_BUCKETS,
)
_MEMBER_S = _metrics.histogram(
    "pftpu_fanout_member_seconds", "Per-member latency within a fanout"
)
_STRAGGLER_S = _metrics.histogram(
    "pftpu_fanout_straggler_seconds",
    "Straggler gap per fanout: slowest member minus fastest",
)


def _shutdown_all(executors: List[ThreadPoolExecutor]) -> None:
    # Module-level (not a bound method) so weakref.finalize holds no
    # reference back to the pool it is finalizing.
    for ex in executors:
        ex.shutdown(wait=False)


class MemberExecutorPool:
    """One persistent single-thread executor per member, lazily created.

    Persistence pins member ``i`` to one thread for the life of the
    pool; ``weakref.finalize`` shuts the threads down when the pool is
    garbage-collected, so churn of compiled functions no longer leaks
    threads for the process lifetime.  ``shutdown()`` may also be called explicitly;
    idempotent either way.
    """

    def __init__(self, n_members: int, name: str = "pft-fused"):
        self._n = int(n_members)
        self._name = name
        self._lock = threading.Lock()
        self._executors: List[ThreadPoolExecutor] | None = None
        self._finalizer = None
        self._closed = False

    def _ensure(self) -> List[ThreadPoolExecutor]:
        if self._closed:
            # Without this, shutdown() before first use is a no-op and a
            # later submit would silently resurrect the pool (eager
            # ThreadPoolExecutors raised here; preserve that contract).
            raise RuntimeError("pool is shut down")
        execs = self._executors
        if execs is None:
            with self._lock:
                execs = self._executors
                if execs is None:
                    execs = [
                        ThreadPoolExecutor(
                            max_workers=1,
                            thread_name_prefix=f"{self._name}-{i}",
                        )
                        for i in range(self._n)
                    ]
                    self._executors = execs
                    self._finalizer = weakref.finalize(
                        self, _shutdown_all, execs
                    )
        return execs

    @property
    def size(self) -> int:
        return self._n

    def submit(self, i: int, fn: Callable, /, *args, **kwargs):
        return self._ensure()[i].submit(fn, *args, **kwargs)

    def shutdown(self) -> None:
        self._closed = True
        if self._finalizer is not None:
            self._finalizer()  # runs _shutdown_all at most once

    @property
    def alive(self) -> bool:
        return self._finalizer is not None and self._finalizer.alive


_COALESCED_CALLS = _metrics.histogram(
    "pftpu_fanout_coalesced_calls",
    "Member evaluations coalesced into one batched node call",
    buckets=_metrics.DEFAULT_COUNT_BUCKETS,
)


class CoalescingCaller:
    """Coalesce concurrent single evaluations into one batched call.

    The driver-side twin of the server's micro-batcher, for the fanout
    geometry: when several fanout members target the SAME node, each
    member thread's ``evaluate(*arrays)`` lands here, the first
    arrival becomes the window leader, and the whole group goes out as
    ONE ``evaluate_many`` — which the transport packs into one wire
    batch frame when the node advertises support (client.py / tcp.py),
    so W same-node members pay one round-trip instead of W.

    ``evaluate_many``: a callable taking a list of request tuples and
    returning one result per request, in order — e.g.
    ``lambda reqs: client.evaluate_many(reqs, window=w)`` for any of
    the transport clients or typed adapters.  ``width`` is the
    expected group size (the number of members sharing the node): the
    leader dispatches the moment the window is full, so a complete
    fanout pays ZERO added wait; ``max_wait_s`` bounds the wait when
    the group arrives ragged (a straggler past it simply leads the
    next window — correctness is unaffected, only coalescing width).

    Error semantics: the window is one transport call, so a failure
    raises in EVERY coalesced member (the per-member isolation lives
    server-side: a poisoned input fails only its own reply item, and
    ``evaluate_many`` surfaces the first error without retry).
    """

    def __init__(
        self,
        evaluate_many: Callable[[list], list],
        *,
        width: int,
        max_wait_s: float = 0.002,
    ):
        if width < 1:
            raise ValueError(f"width must be >= 1, got {width}")
        self._evaluate_many = evaluate_many
        self._width = int(width)
        self._max_wait_s = float(max_wait_s)
        self._cond = threading.Condition()
        self._pending: List[dict] = []  # {"args", "event", "result", "error"}
        # One window in flight at a time: a straggler that became the
        # NEXT window's leader must not drive ``evaluate_many``
        # concurrently with the previous leader — the transport
        # clients are single-connection lock-step objects, not
        # thread-safe (tcp.py), so overlapping windows would
        # interleave frames on one socket.
        self._dispatch_lock = threading.Lock()

    def evaluate(self, *arrays) -> list:
        slot = {
            "args": tuple(arrays),
            "event": threading.Event(),
            "result": None,
            "error": None,
        }
        with self._cond:
            self._pending.append(slot)
            leader = len(self._pending) == 1
            if not leader:
                self._cond.notify_all()
        if leader:
            self._lead()
        # Followers (and the leader, whose own slot _lead() filled)
        # wait for their slot to settle.
        slot["event"].wait()
        if slot["error"] is not None:
            raise slot["error"]
        return slot["result"]

    __call__ = evaluate

    def _lead(self) -> None:
        deadline = time.perf_counter() + self._max_wait_s
        with self._cond:
            while len(self._pending) < self._width:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                self._cond.wait(remaining)
            group, self._pending = self._pending, []
        # try/finally around EVERYTHING after the group pop: if the
        # events were not guaranteed to set, a leader failure (even a
        # BaseException like KeyboardInterrupt delivered to its
        # thread) would leave every follower blocked forever in
        # event.wait() — a silent wedge, the exact failure class this
        # codebase's watchdog exists to prevent.
        try:
            with self._dispatch_lock:
                _COALESCED_CALLS.observe(len(group))
                with _tspans.span(
                    "fanout.coalesced_call", width=len(group)
                ):
                    results = self._evaluate_many(
                        [s["args"] for s in group]
                    )
                    if len(results) != len(group):
                        raise RuntimeError(
                            f"evaluate_many returned {len(results)} "
                            f"results for {len(group)} coalesced requests"
                        )
                    for s, r in zip(group, results):
                        s["result"] = r
        except BaseException as e:
            for s in group:
                if s["result"] is None:
                    s["error"] = (
                        e
                        if isinstance(e, Exception)
                        else RuntimeError(
                            f"coalesced window leader aborted: {e!r}"
                        )
                    )
            if not isinstance(e, Exception):
                raise  # KeyboardInterrupt & co. still surface in the leader
        finally:
            for s in group:
                s["event"].set()


_PARTITIONED_SLICES = _metrics.histogram(
    "pftpu_fanout_partitioned_slices",
    "Partition-indexed slice fetches per oversized-reply evaluation",
    buckets=_metrics.DEFAULT_COUNT_BUCKETS,
)


class PartitionedCaller:
    """Fetch a member's oversized reply as partition-indexed slices.

    The fanout layer's half of "gradients larger than one
    reply frame": a member whose gradient exceeds what one reply frame
    should carry (transport frame caps, arena slot sizes) wraps its
    client here — ``evaluate(*arrays)`` issues ``count`` sliced
    requests (the head/tail rule, ``partition=`` on the pinned
    clients), reassembles them with the loud
    :class:`~.routing.partition.Reassembler` rules, and returns
    ``[head, *tail]`` with the original tail shapes restored (or
    ``[head, flat]`` when ``tail_shapes`` is not given).

    The node recomputes per slice — this trades compute for frame
    size, the right trade exactly when a reply cannot ride one frame;
    for per-item bandwidth reduction use the reduce windows
    (``evaluate_reduced``) instead.
    """

    def __init__(
        self,
        client: object,
        *,
        total: int,
        max_slice_elems: int,
        tail_shapes: Optional[Sequence[Tuple[int, ...]]] = None,
    ) -> None:
        from .routing import partition as _gradpart

        if max_slice_elems < 1:
            raise ValueError(
                f"max_slice_elems must be >= 1, got {max_slice_elems}"
            )
        self._gradpart = _gradpart
        self._client = client
        self.total = int(total)
        self.count = max(
            1, -(-self.total // int(max_slice_elems))
        )  # ceil
        self.tail_shapes = (
            None if tail_shapes is None else [tuple(s) for s in tail_shapes]
        )
        if self.tail_shapes is not None:
            declared = sum(
                int(np.prod(s, dtype=np.int64)) for s in self.tail_shapes
            )
            if declared != self.total:
                raise _gradpart.PartitionError(
                    f"tail_shapes cover {declared} elements, total "
                    f"declares {self.total}"
                )

    def evaluate(self, *arrays) -> list:
        gp = self._gradpart
        plan = gp.plan_partitions(self.total, self.count)
        _PARTITIONED_SLICES.observe(len(plan))
        head = None
        reassembler = None
        with _tspans.span(
            "fanout.partitioned_call", count=self.count, total=self.total
        ):
            for part in plan:
                reply = self._client.evaluate(*arrays, partition=part)
                if len(reply) != 2:
                    raise gp.PartitionError(
                        f"sliced reply must be [head, slice], got "
                        f"{len(reply)} arrays"
                    )
                head = reply[0]
                sl = np.asarray(reply[1])
                if reassembler is None:
                    reassembler = gp.Reassembler(
                        self.total,
                        self.count,
                        sl.dtype if sl.size else np.dtype(np.float64),
                    )
                reassembler.add(part, sl)
        assert reassembler is not None
        flat = reassembler.result()
        if self.tail_shapes is None:
            return [head, flat]
        return [head, *gp.split_tail(flat, self.tail_shapes)]

    __call__ = evaluate


def member_spans(counts: Sequence[int]) -> List[Tuple[int, int]]:
    """``[(lo, hi), ...]`` slices of a concatenated list per member."""
    spans = []
    lo = 0
    for c in counts:
        spans.append((lo, lo + c))
        lo += c
    return spans


def run_members(
    member_fns: Sequence[Callable[[list, list], None]],
    in_counts: Sequence[int],
    out_counts: Sequence[int],
    inputs: Sequence,
    output_storage: list,
    pool: MemberExecutorPool,
    node_pool=None,
) -> None:
    """Fan the members out; write results through ``output_storage``.

    ``member_fns[i](sub_inputs, sub_storage)`` receives member ``i``'s
    slice of ``inputs`` and the live (aliased, not copied) slice of
    ``output_storage`` — members write results into their own cells and
    never see a sibling's.  All members settle before the first failure
    (in member order) is raised.

    ``node_pool`` (a :class:`~pytensor_federated_tpu.routing.NodePool`,
    optional) routes member failures through the pool's retry/failover
    policy: a member raising a TRANSIENT error
    (``node_pool.is_transient`` — transport trouble, never a
    deterministic compute error) is re-run up to
    ``node_pool.member_retries`` times with the pool's jittered
    backoff between attempts.  Members built over that pool's
    :class:`~pytensor_federated_tpu.routing.PooledArraysClient` pick a
    DIFFERENT healthy replica on the re-run (the failed one's breaker
    just recorded the failure), so the retry is a failover, not an
    instant replay against the dead node.  Member storage writes are
    idempotent (each attempt overwrites the member's own cells), so a
    retried member cannot corrupt a sibling's slice.  Without a pool
    the plain contract stands: the first member error surfaces
    immediately after all members settle.
    """
    n = len(member_fns)
    if not (n == len(in_counts) == len(out_counts)):
        raise ValueError(
            f"member/count arity mismatch: {n} fns, "
            f"{len(in_counts)} in_counts, {len(out_counts)} out_counts"
        )
    if sum(in_counts) != len(inputs):
        raise ValueError(
            f"members consume {sum(in_counts)} inputs, got {len(inputs)}"
        )
    if sum(out_counts) != len(output_storage):
        raise ValueError(
            f"members produce {sum(out_counts)} outputs, storage has "
            f"{len(output_storage)}"
        )
    if pool.size < n:
        # An undersized pool would IndexError mid-submission, leaving
        # already-submitted members writing storage while the caller
        # handles the error — exactly the half-settled state the
        # settle-all contract forbids.  Validate up front instead.
        raise ValueError(
            f"pool has {pool.size} member executors but {n} members"
        )
    in_spans = member_spans(in_counts)
    out_spans = member_spans(out_counts)
    telemetry_on = _tspans.enabled()
    durations: List[float] = [0.0] * n if telemetry_on else []

    max_attempts = 1 + (
        max(0, int(node_pool.member_retries)) if node_pool is not None else 0
    )

    def call_member(idx: int, sub_inputs: list, sub_storage: list) -> None:
        """One member evaluation, re-run through the pool's retry
        policy on transient failures (no pool: exactly one attempt).
        Each re-run is amplification and spends from the pool's retry
        budget (``allow_retry``): a window that fans W members into a
        sick pool must degrade to W attempts, not W × retries."""
        for attempt in range(max_attempts):
            try:
                member_fns[idx](sub_inputs, sub_storage)
                return
            except Exception as e:
                if (
                    attempt + 1 >= max_attempts
                    or node_pool is None
                    or not node_pool.is_transient(e)
                    or not node_pool.allow_retry("member_retry")
                ):
                    raise
                _flightrec.record(
                    "fanout.member_retry",
                    idx=idx,
                    attempt=attempt + 1,
                    error=f"{type(e).__name__}: {e}"[:200],
                )
                node_pool.backoff_sleep(attempt)

    def make_run(idx: int):
        def run():
            ilo, ihi = in_spans[idx]
            olo, ohi = out_spans[idx]
            sub_storage = output_storage[olo:ohi]
            if telemetry_on:
                t0 = time.perf_counter()
            with _tspans.span("fanout.member", idx=idx):
                call_member(idx, list(inputs[ilo:ihi]), sub_storage)
            if telemetry_on:
                # Written pre-settle, read post-settle: the futures
                # barrier below orders the write before the read, so no
                # lock is needed despite the cross-thread handoff.
                durations[idx] = time.perf_counter() - t0
                _MEMBER_S.observe(durations[idx])
            # output_storage cells are single-element lists in the
            # pytensor calling convention; the slice above aliases those
            # inner lists, so member writes of sub_storage[j][0] are
            # already visible.  Guard against a member REBINDING a cell
            # (sub_storage[j] = [...]) instead of writing through it,
            # which the aliasing would silently drop:
            for j, cell in enumerate(sub_storage):
                if output_storage[olo + j] is not cell:
                    raise RuntimeError(
                        f"member {idx} rebound storage cell {j} instead "
                        "of writing cell[0]"
                    )

        return run

    with _tspans.span("fanout", width=n) as f_span:
        _FANOUT_WIDTH.observe(n)
        if telemetry_on:
            # ContextVars do NOT cross thread-pool boundaries on their
            # own; each member runs under a COPY of the caller's
            # context (one copy per member — a Context is not
            # re-entrant across concurrent threads), so member spans
            # parent under this fanout span and inherit its trace id.
            futures = [
                pool.submit(
                    i, contextvars.copy_context().run, make_run(i)
                )
                for i in range(n)
            ]
        else:
            futures = [pool.submit(i, make_run(i)) for i in range(n)]
        errs = [f.exception() for f in futures]
        if telemetry_on and n and not any(e is not None for e in errs):
            # Only clean fanouts rate the gap: a failed member's slot
            # never got its duration written, and max-minus-0.0 would
            # pollute exactly the imbalance histogram this feeds.
            gap = max(durations) - min(durations)
            _STRAGGLER_S.observe(gap)
            f_span.set_attr("straggler_gap_s", gap)
        for idx, e in enumerate(errs):
            if e is not None:
                # Black-box note BEFORE the raise: which member of how
                # wide a fanout failed, with siblings already settled
                # (flight-record taxonomy: fanout.member_error).
                _flightrec.record(
                    "fanout.member_error",
                    idx=idx,
                    width=n,
                    error=f"{type(e).__name__}: {e}"[:200],
                )
                raise e

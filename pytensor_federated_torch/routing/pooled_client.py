"""`PooledArraysClient`: the transport-client surface over a replica pool.

The facade that makes a :class:`~.pool.NodePool` drop-in wherever a
pinned transport client went before — the same
``evaluate``/``evaluate_many`` (sync + async) surface as
:class:`~pytensor_federated_torch.service.client.ArraysToArraysServiceClient`
and :class:`~pytensor_federated_torch.service.tcp.TcpArraysClient`, with
three behaviors neither pinned client can express:

- **Routing**: every call picks its replica through the pool's policy
  (power-of-two-choices over advertised queue depth by default) and
  skips tripped breakers.
- **Hedged requests** (``hedge=True``, for idempotent computes): if
  the primary replica has not replied by the pool's observed
  latency-quantile deadline, the SAME request fires at a second
  replica; first reply wins, the loser is cancelled (gRPC lane — its
  connection is dropped so the lock-step stream cannot desynchronize)
  or abandoned (TCP lane — a sync socket call cannot be interrupted;
  its late reply is consumed and discarded on its own connection).
- **Mid-window failover**: ``evaluate_many`` spreads the request list
  over healthy replicas (shares weighted by observed per-request
  EWMA latency, so an alive-but-slow replica organically receives
  less work) and, when a replica dies mid-window, re-queues the
  UN-REPLIED tail of its pipelined window onto the survivors — the
  replies that already arrived are kept, nothing is double-assigned,
  and each shard still rides the pinned client's machinery (wire batch frames
  when advertised, in-flight byte caps, error drains) because the
  per-replica pass IS the existing client's
  ``evaluate_many_partial``.

Failure semantics mirror the pinned clients': transport trouble fails
over (and feeds the breaker); deterministic server errors — in-band
npwire error replies, ``RemoteComputeError``, non-retryable gRPC
status codes — raise immediately without burning a failover, because
the same inputs would fail identically on every replica.

Telemetry: calls run under ``pool.evaluate`` / ``pool.evaluate_many``
root spans with one ``pool.attempt`` / ``pool.window`` child per
replica attempt (attr ``replica``), so the trace of a failed-over or
hedged call shows every replica it touched; node-side span trees from
each attempt reunite under the same trace id as usual
(:mod:`~pytensor_federated_torch.telemetry.reunion`).
"""

from __future__ import annotations

import asyncio
import contextlib
import contextvars
import math
import threading
import time
from functools import lru_cache
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..telemetry import flightrec as _flightrec
from ..telemetry import spans as _spans
from . import partition as _gradpart
from .pool import (
    NodePool,
    Replica,
    _POOL_FAILOVERS,
    _POOL_HEDGES,
)

__all__ = ["PooledArraysClient"]


class _LatencyRing:
    """Bounded ring of recent per-call latencies with an empirical
    quantile — the hedge-deadline estimator.  Tiny (128 floats) and
    lock-guarded; a sort per hedge decision is noise next to an RPC."""

    def __init__(self, capacity: int = 128) -> None:
        self._cap = capacity
        self._values: List[float] = []
        self._idx = 0
        self._lock = threading.Lock()

    def record(self, value: float) -> None:
        with self._lock:
            if len(self._values) < self._cap:
                self._values.append(value)
            else:
                self._values[self._idx] = value
                self._idx = (self._idx + 1) % self._cap

    def quantile(self, q: float, *, min_samples: int = 8) -> Optional[float]:
        with self._lock:
            if len(self._values) < min_samples:
                return None
            ordered = sorted(self._values)
        rank = min(len(ordered) - 1, int(math.ceil(q * len(ordered))) - 1)
        return ordered[max(rank, 0)]


def _grpc_classifier() -> tuple:
    """``(AioRpcError, _is_retryable)`` of the gRPC lane, or ``(None,
    None)`` where there is none.  The port carries no gRPC lane yet
    (:mod:`..service._grpc_lane`): no replica can raise an
    ``AioRpcError``, so every failure is classified by its Python
    type, and ``grpc`` is never imported."""
    return None, None


@lru_cache(maxsize=1)
def _deadline_exceeded() -> type:
    """Resolve DeadlineExceeded once (hot-path import hoist)."""
    from ..service.deadline import DeadlineExceeded

    return DeadlineExceeded


def _is_transport_error(exc: BaseException) -> bool:
    """Transport trouble (failover-worthy) vs deterministic failure.
    Matches the pinned clients' classification: ConnectionError/OSError
    always transport; AioRpcError by status code; RemoteComputeError
    and other RuntimeErrors are the request's own fault."""
    aio_error, is_retryable = _grpc_classifier()
    if aio_error is not None and isinstance(exc, aio_error):
        return is_retryable(exc)
    return isinstance(exc, (ConnectionError, OSError))


def _is_deadline(exc: BaseException) -> bool:
    """Whether the failure is the CALLER's spent deadline budget —
    which says nothing about the replica's health either way (the
    fail-fast guard can fire before a single byte is sent), so routing
    must book NEITHER a success nor a failure for it."""
    return isinstance(exc, _deadline_exceeded())


class PooledArraysClient:
    """Pool-routed evaluation client (module docstring for semantics).

    ``pool``: a pre-built :class:`NodePool`, or a sequence of
    ``(host, port)`` addresses — the latter constructs an owned pool
    (forwarding ``transport=``/``policy=``/etc. via ``pool_kwargs``)
    whose probe loop ``close()`` stops.

    ``hedge=True`` enables hedged single evaluations once enough
    latency samples exist; ``hedge_quantile`` sets the fire deadline
    (default p95 of this client's observed call latencies) and
    ``hedge_min_wait_s`` floors it.  Hedging re-executes the compute
    on a second replica — only enable it for idempotent computes
    (logp evaluations are; anything with server-side state is not).
    """

    def __init__(
        self,
        pool: object,
        *,
        hedge: bool = False,
        hedge_quantile: float = 0.95,
        hedge_min_wait_s: float = 0.001,
        **pool_kwargs: object,
    ) -> None:
        if isinstance(pool, NodePool):
            if pool_kwargs:
                raise ValueError(
                    "pool_kwargs only apply when constructing the pool "
                    "from addresses; pass them to NodePool instead"
                )
            self.pool = pool
            self._owns_pool = False
        else:
            self.pool = NodePool(pool, **pool_kwargs)
            self._owns_pool = True
        self.hedge = bool(hedge)
        self.hedge_quantile = float(hedge_quantile)
        self.hedge_min_wait_s = float(hedge_min_wait_s)
        self._latency = _LatencyRing()

    def close(self) -> None:
        """Stop probing / close clients on an OWNED pool (a shared
        pool outlives any one facade and is left untouched)."""
        if self._owns_pool:
            self.pool.close()

    # -- per-replica calls ------------------------------------------------

    async def _call_replica(
        self, replica: Replica, arrays: Sequence
    ) -> list:
        client = self.pool.client_for(replica)
        replica.inflight += 1  # the local load signal (policies.py)
        try:
            if replica.transport == "grpc":
                return await client.evaluate_async(*arrays)
            loop = asyncio.get_running_loop()
            ctx = contextvars.copy_context()  # spans cross the worker
            return await loop.run_in_executor(
                self.pool.executor_for(replica),
                lambda: ctx.run(client.evaluate, *arrays),
            )
        finally:
            replica.inflight -= 1

    async def _window_replica(
        self, replica: Replica, reqs: Sequence, window: int, batch: object
    ) -> Tuple[list, Optional[BaseException], float]:
        """One partial pipelined pass on one replica ->
        ``(results_with_None_tail, transport_exc_or_None, wall_s)``.
        Deterministic server errors raise out of here."""
        client = self.pool.client_for(replica)
        t0 = time.perf_counter()
        replica.inflight += len(reqs)  # the local load signal
        try:
            with _spans.span(
                "pool.window", replica=replica.address, n=len(reqs)
            ):
                if replica.transport == "grpc":
                    partial, exc = (
                        await client.evaluate_many_partial_async(
                            reqs, window=window, batch=batch
                        )
                    )
                else:
                    loop = asyncio.get_running_loop()
                    ctx = contextvars.copy_context()
                    partial, exc = await loop.run_in_executor(
                        self.pool.executor_for(replica),
                        lambda: ctx.run(
                            client.evaluate_many_partial,
                            reqs,
                            window=window,
                            batch=batch,
                        ),
                    )
        finally:
            replica.inflight -= len(reqs)
        return partial, exc, time.perf_counter() - t0

    # -- single evaluation (+ hedging) ------------------------------------

    def _hedge_deadline_s(self) -> Optional[float]:
        if not self.hedge:
            return None
        q = self._latency.quantile(self.hedge_quantile)
        if q is None:
            return None
        return max(q, self.hedge_min_wait_s)

    async def _cancel_loser(self, task: asyncio.Task, replica: Replica) -> None:
        task.cancel()
        with contextlib.suppress(BaseException):
            await task
        # The loser's outcome is UNKNOWN (abandoned mid-flight): give
        # back any half-open probe token it held instead of recording a
        # verdict — leaving it claimed would park the breaker in
        # half-open forever when no probe loop runs.
        replica.breaker.release()
        if replica.transport == "grpc" and replica.client is not None:
            # A cancelled lock-step stream call may have written its
            # request without reading the reply — the connection is
            # desynchronized.  Drop it so the replica's next call
            # reconnects cleanly.  (TCP losers run to completion on
            # their own worker thread and stay correlated.)
            with contextlib.suppress(Exception):
                await replica.client._drop_privates()

    async def _attempt(
        self, replica: Replica, arrays: Sequence, exclude: Sequence
    ) -> Tuple[list, float, Replica]:
        """One (possibly hedged) attempt: returns
        ``(outputs, wall_s, serving_replica)``; transport errors and
        server errors raise to the failover loop."""
        t0 = time.perf_counter()
        deadline = self._hedge_deadline_s()
        with _spans.span("pool.attempt", replica=replica.address):
            if deadline is None:
                result = await self._call_replica(replica, arrays)
                return result, time.perf_counter() - t0, replica
            primary: asyncio.Task = asyncio.ensure_future(
                self._call_replica(replica, arrays)
            )
            done, _ = await asyncio.wait({primary}, timeout=deadline)
            if primary in done:
                return primary.result(), time.perf_counter() - t0, replica
            # A hedge re-executes the compute: it spends from the
            # pool's retry budget FIRST, so a sick pool stops hedging
            # before hedges become half its traffic (budget checked
            # before pick — a denied hedge must not burn a half-open
            # probe token).
            if not self.pool.allow_retry("hedge"):
                return await primary, time.perf_counter() - t0, replica
            hedged = self.pool.pick(
                1, exclude=set(exclude) | {replica.address}
            )
            if not hedged:
                # No replica to hedge onto (single-replica pool, or
                # everything else excluded/breaker-open): nothing
                # amplified, so give the token back — otherwise a
                # sustained slow patch drains the bucket with zero
                # hedges fired and later denies REAL failovers.
                self.pool.retry_budget.refund()
                return await primary, time.perf_counter() - t0, replica
            hedge_replica = hedged[0]
            _POOL_HEDGES.labels(outcome="fired").inc()
            _flightrec.record(
                "pool.hedge",
                primary=replica.address,
                hedge=hedge_replica.address,
                deadline_s=round(deadline, 6),
            )
            with _spans.span(
                "pool.attempt", replica=hedge_replica.address, hedge=True
            ):
                hedge_task: asyncio.Task = asyncio.ensure_future(
                    self._call_replica(hedge_replica, arrays)
                )
                tasks = {primary: replica, hedge_task: hedge_replica}
                first_exc: Optional[BaseException] = None
                while tasks:
                    done, _ = await asyncio.wait(
                        tasks, return_when=asyncio.FIRST_COMPLETED
                    )
                    for task in done:
                        task_replica = tasks.pop(task)
                        try:
                            result = task.result()
                        except BaseException as e:  # noqa: BLE001
                            # Only TRANSPORT trouble feeds the breaker:
                            # a deterministic server error is the
                            # request's own fault and would fail
                            # identically on a healthy replica (which
                            # DID serve it — a success for routing).
                            # A spent DEADLINE is neither: give back
                            # the probe token without an outcome.
                            if _is_deadline(e):
                                task_replica.breaker.release()
                            elif _is_transport_error(e):
                                self.pool.record_result(task_replica, False)
                            else:
                                self.pool.record_result(task_replica, True)
                            # Mark as already-recorded so the failover
                            # loop does not book a second breaker hit
                            # for the same failure when this re-raises.
                            e._pftpu_recorded = True  # type: ignore[attr-defined]
                            if not _is_transport_error(e) or not tasks:
                                for other, other_replica in tasks.items():
                                    await self._cancel_loser(
                                        other, other_replica
                                    )
                                raise
                            first_exc = first_exc or e
                            continue
                        for other, other_replica in list(tasks.items()):
                            tasks.pop(other)
                            await self._cancel_loser(other, other_replica)
                        _POOL_HEDGES.labels(
                            outcome=(
                                "won"
                                if task_replica is hedge_replica
                                else "lost"
                            )
                        ).inc()
                        return (
                            result,
                            time.perf_counter() - t0,
                            task_replica,
                        )
                raise first_exc  # both attempts failed on transport

    async def evaluate_async(self, *arrays: np.ndarray) -> List[np.ndarray]:
        """Evaluate one request through the pool with breaker-aware
        failover (and hedging when enabled)."""
        with _spans.span(
            "pool.evaluate", transport=self.pool.transport
        ) as root:
            exclude: set = set()
            last_exc: Optional[BaseException] = None
            charged = False
            while True:
                picked = self.pool.pick(1, exclude=exclude)
                if not picked:
                    if charged:
                        # The granted token bought a re-pick that
                        # found no replica: nothing amplified — give
                        # it back (the hedge no-replica posture).
                        self.pool.retry_budget.refund()
                    break
                charged = False
                replica = picked[0]
                try:
                    result, wall, served_by = await self._attempt(
                        replica, arrays, exclude
                    )
                except BaseException as e:  # noqa: BLE001
                    recorded = getattr(e, "_pftpu_recorded", False)
                    if _is_deadline(e):
                        # The CALLER's budget died — says nothing
                        # about the replica (the fail-fast guard can
                        # fire before a byte is sent): book neither
                        # outcome, just give back the breaker/probe
                        # token pick() acquired.
                        if not recorded:
                            replica.breaker.release()
                        root.set_attr("error", "deadline")
                        raise
                    if not _is_transport_error(e):
                        # Deterministic server failure: the request's
                        # own fault — no failover (it would fail
                        # identically everywhere), and the replica DID
                        # serve it, so routing books a SUCCESS (which
                        # also closes a half-open probe instead of
                        # leaking its token).
                        if not recorded:
                            self.pool.record_result(replica, True)
                        root.set_attr("error", "server")
                        raise
                    if not recorded:
                        self.pool.record_result(replica, False)
                    last_exc = e
                    exclude.add(replica.address)
                    _POOL_FAILOVERS.labels(
                        transport=self.pool.transport
                    ).inc()
                    _flightrec.record(
                        "pool.failover",
                        replica=replica.address,
                        error=f"{type(e).__name__}: {e}"[:200],
                    )
                    # Each failover re-pick is amplification and spends
                    # from the retry budget: exhausted = this call gets
                    # no further attempts (degrade to one-attempt-per-
                    # call instead of multiplying a sick pool's load).
                    if not self.pool.allow_retry("failover"):
                        root.set_attr("error", "transport")
                        raise
                    charged = True
                    continue
                self.pool.record_result(served_by, True, latency_s=wall)
                self._latency.record(wall)
                return result
            root.set_attr("error", "transport")
            raise last_exc if last_exc is not None else ConnectionError(
                f"no available replicas in pool "
                f"({len(self.pool)} registered)"
            )

    def evaluate(self, *arrays: np.ndarray) -> List[np.ndarray]:
        """Sync wrapper over :meth:`evaluate_async`."""
        from ..utils import get_event_loop

        return get_event_loop().run_until_complete(
            self.evaluate_async(*arrays)
        )

    __call__ = evaluate

    # -- pipelined batch with spread + mid-window failover ----------------

    # A replica only joins a spread window if it can serve at least one
    # request within ~this multiple of the window's makespan-balanced
    # wall; slower than that, its presence only ADDS tail latency (its
    # one-request shard outlives everyone else's whole shard).
    _STRAGGLER_SLACK = 1.5

    def _partition(
        self, pending: List[int], replicas: List[Replica], window: int
    ) -> List[Tuple[Replica, List[int]]]:
        """Contiguous shards of ``pending``, sized makespan-balanced by
        each replica's observed speed: replica ``i`` serves
        ``W / ewma_i`` requests where ``W = n / Σ(1/ewma)`` is the wall
        at which all shards finish together.  Unmeasured replicas get
        the mean measured weight so new capacity still receives work.
        A replica whose SINGLE-request cost exceeds the balanced wall
        (times a slack factor) sits the window out — an
        order-of-magnitude-degraded replica would otherwise stretch
        every window to its own latency for one request's worth of
        help.  Contiguity keeps each shard a well-formed pipelined
        window for batch-frame packing."""
        measured = [
            1.0 / r.ewma_latency_s
            for r in replicas
            if r.ewma_latency_s
        ]
        default_w = (sum(measured) / len(measured)) if measured else 1.0
        n = len(pending)

        def weights_of(group: Sequence[Replica]) -> List[float]:
            return [
                (1.0 / r.ewma_latency_s) if r.ewma_latency_s else default_w
                for r in group
            ]

        weights = weights_of(replicas)
        total_w = sum(weights) or float(len(replicas))
        balanced_wall = n / total_w  # seconds, in EWMA units
        kept = [
            r
            for r, w in zip(replicas, weights)
            if r.ewma_latency_s is None
            or r.ewma_latency_s <= balanced_wall * self._STRAGGLER_SLACK
        ]
        if kept:
            replicas = kept
            weights = weights_of(replicas)
            total_w = sum(weights) or float(len(replicas))
        # Floor + remainder-to-fastest: floor so a near-zero share
        # genuinely rounds to nothing, remainder biased to the fastest
        # replicas so the leftovers land where they finish soonest.
        sizes = [int(n * w / total_w) for w in weights]
        order = sorted(
            range(len(replicas)), key=lambda i: -weights[i]
        )
        i = 0
        while sum(sizes) < n:
            sizes[order[i % len(order)]] += 1
            i += 1
        shards: List[Tuple[Replica, List[int]]] = []
        start = 0
        for replica, size in zip(replicas, sizes):
            if size > 0:
                shards.append((replica, pending[start : start + size]))
                start += size
        return shards

    async def evaluate_many_async(
        self,
        requests: Sequence[Sequence[np.ndarray]],
        *,
        window: int = 8,
        batch: object = "auto",
    ) -> List[List[np.ndarray]]:
        """Pipelined evaluation of MANY requests, spread over the
        pool's healthy replicas, with mid-window failover: a replica
        dying mid-pass costs only the un-replied tail of ITS shard,
        which re-queues onto the survivors.  Each per-replica shard
        runs the existing pipelined machinery (`evaluate_many`'s
        windowing, byte caps, and wire batch frames when the replica
        advertises them), so the pinned client's semantics hold per shard."""
        requests = list(requests)
        n = len(requests)
        if n == 0:
            return []
        results: List[Optional[List[np.ndarray]]] = [None] * n
        with _spans.span(
            "pool.evaluate_many",
            transport=self.pool.transport,
            n=n,
            window=window,
        ) as root:
            pending = list(range(n))
            exclude: set = set()
            last_exc: Optional[BaseException] = None
            while pending:
                k = max(1, math.ceil(len(pending) / max(1, window)))
                replicas = self.pool.pick(k, exclude=exclude)
                if not replicas:
                    root.set_attr("error", "transport")
                    raise (
                        last_exc
                        if last_exc is not None
                        else ConnectionError(
                            f"no available replicas in pool "
                            f"({len(self.pool)} registered) with "
                            f"{len(pending)} requests un-replied"
                        )
                    )
                shards = self._partition(pending, replicas, window)
                # A replica picked (breaker-acquired) but then benched
                # by the partitioner — straggler rule, or a zero-sized
                # share — must give back its half-open probe token:
                # it never gets a call to resolve the probe.
                sharded = {id(r) for r, _ in shards}
                for replica in replicas:
                    if id(replica) not in sharded:
                        replica.breaker.release()
                outcomes = await asyncio.gather(
                    *(
                        self._window_replica(
                            replica,
                            [requests[i] for i in shard],
                            window,
                            batch,
                        )
                        for replica, shard in shards
                    ),
                    return_exceptions=True,
                )
                new_pending: List[int] = []
                server_exc: Optional[BaseException] = None
                budget_spent = False
                granted = 0
                for (replica, shard), out in zip(shards, outcomes):
                    if isinstance(out, BaseException):
                        # evaluate_many_partial returns transport
                        # trouble — an exception here is a
                        # deterministic server/decode error: the
                        # replica is healthy (it served the request),
                        # so routing books a SUCCESS — which also
                        # resolves a half-open probe instead of
                        # leaking its token.  A spent DEADLINE is
                        # neither outcome (the guard can fire before a
                        # byte is sent): release the token instead.
                        # Every sibling shard has settled (gather with
                        # return_exceptions), so raising is
                        # orphan-free.
                        if _is_deadline(out):
                            replica.breaker.release()
                        else:
                            self.pool.record_result(replica, True)
                        server_exc = server_exc or out
                        continue
                    partial, exc, wall = out
                    served = 0
                    for idx, res in zip(shard, partial):
                        if res is not None:
                            results[idx] = res
                            served += 1
                        else:
                            new_pending.append(idx)
                    if exc is None:
                        self.pool.record_result(
                            replica,
                            True,
                            latency_s=wall,
                            n_requests=max(1, len(shard)),
                        )
                    else:
                        last_exc = exc
                        self.pool.record_result(replica, False)
                        exclude.add(replica.address)
                        _POOL_FAILOVERS.labels(
                            transport=self.pool.transport
                        ).inc()
                        _flightrec.record(
                            "pool.failover",
                            replica=replica.address,
                            requeued=len(shard) - served,
                            error=f"{type(exc).__name__}: {exc}"[:200],
                        )
                        # Re-queuing a failed shard's tail is
                        # amplification: one budget spend per failed
                        # replica WITH a tail to re-queue (a replica
                        # that failed after serving its whole shard
                        # amplifies nothing); exhausted = the tail
                        # surfaces its transport error instead of
                        # another round.
                        if served < len(shard):
                            if self.pool.allow_retry("failover"):
                                granted += 1
                            else:
                                budget_spent = True
                if server_exc is not None:
                    if granted:
                        # The round aborts: tokens granted to sibling
                        # shards bought no re-queue — give them back
                        # (the hedge no-replica path's posture).
                        self.pool.retry_budget.refund(granted)
                    root.set_attr("error", "server")
                    raise server_exc
                if budget_spent and new_pending:
                    if granted:
                        self.pool.retry_budget.refund(granted)
                    root.set_attr("error", "transport")
                    raise (
                        last_exc
                        if last_exc is not None
                        else ConnectionError(
                            "retry budget exhausted with "
                            f"{len(new_pending)} requests un-replied"
                        )
                    )
                new_pending.sort()
                pending = new_pending
            return results  # type: ignore[return-value]

    def evaluate_many(
        self,
        requests: Sequence[Sequence[np.ndarray]],
        *,
        window: int = 8,
        batch: object = "auto",
    ) -> List[List[np.ndarray]]:
        """Sync wrapper over :meth:`evaluate_many_async`."""
        from ..utils import get_event_loop

        return get_event_loop().run_until_complete(
            self.evaluate_many_async(requests, window=window, batch=batch)
        )

    # -- reduce-scatter windows --------------------------------------------

    async def _reduce_replica(
        self,
        replica: Replica,
        reqs: Sequence,
        window: int,
        slices: int,
        total: Optional[int],
    ) -> Tuple[Optional[np.ndarray], Optional[np.ndarray], List[int], float]:
        """One replica's reduce pass -> ``(head, flat, unserved_local
        _indices, wall_s)``.  tcp/shm lanes ride the wire reduce window
        (all-or-nothing per replica: a transport failure re-queues the
        whole shard); grpc replicas — which have no reduce wire — fall
        back to ``evaluate_many_partial_async`` plus a DRIVER-side
        reduction, keeping the answered items' partial sum and
        re-queuing only the holes (bytes are not saved on that lane,
        but a mixed pool stays correct).  Deterministic server errors
        raise out of here."""
        client = self.pool.client_for(replica)
        t0 = time.perf_counter()
        replica.inflight += len(reqs)
        try:
            with _spans.span(
                "pool.reduce_window",
                replica=replica.address,
                n=len(reqs),
            ):
                if replica.transport == "grpc":
                    partial, exc = (
                        await client.evaluate_many_partial_async(
                            reqs, window=window, batch="auto"
                        )
                    )
                    served = [
                        r for r in partial if r is not None
                    ]
                    holes = [
                        i for i, r in enumerate(partial) if r is None
                    ]
                    if exc is not None and not holes:
                        holes = list(range(len(reqs)))
                        served = []
                    head = flat = None
                    if served:
                        summed = _gradpart.reduce_replies(served)
                        head = np.asarray(summed[0])
                        flat = _gradpart.concat_tail(summed)
                        if total is not None and flat.size != int(total):
                            raise _gradpart.PartitionError(
                                f"grpc reduce tail size {flat.size} != "
                                f"declared total {total}"
                            )
                    return head, flat, holes, time.perf_counter() - t0
                loop = asyncio.get_running_loop()
                ctx = contextvars.copy_context()
                try:
                    head, flat = await loop.run_in_executor(
                        self.pool.executor_for(replica),
                        lambda: ctx.run(
                            client.evaluate_reduced,
                            reqs,
                            window=window,
                            slices=slices,
                            total=total,
                        ),
                    )
                except (ConnectionError, OSError):
                    # All-or-nothing wire window: the whole shard
                    # re-queues (holes = everything).
                    return (
                        None,
                        None,
                        list(range(len(reqs))),
                        time.perf_counter() - t0,
                    )
                return head, flat, [], time.perf_counter() - t0
        finally:
            replica.inflight -= len(reqs)

    async def evaluate_reduced_async(
        self,
        requests: Sequence[Sequence[np.ndarray]],
        *,
        window: int = 8,
        slices: int = 1,
        total: Optional[int] = None,
    ) -> List[np.ndarray]:
        """Reduce-scatter evaluation through the pool:
        ``[head_sum, flat_tail_sum]`` over ALL requests.

        Requests spread over healthy replicas exactly like
        :meth:`evaluate_many_async` (EWMA-weighted shards), but each
        replica answers its shard as ONE partition-indexed partial sum
        (wire reduce windows on tcp/shm; a driver-side reduction on
        grpc replicas, so MIXED pools stay correct), and the driver
        sums the partials — reply bytes scale with POOL WIDTH, not
        request count.  A replica failing mid-round re-queues only its
        un-reduced shard onto the survivors, charging the retry budget
        once per failed replica WITH a tail (the ``evaluate_many``
        refund posture); deterministic errors raise immediately —
        a partial sum is never silently returned."""
        requests = list(requests)
        if not requests:
            raise _gradpart.PartitionError(
                "cannot reduce an empty request list"
            )
        head: Optional[np.ndarray] = None
        flat: Optional[np.ndarray] = None
        with _spans.span(
            "pool.evaluate_reduced",
            transport=self.pool.transport,
            n=len(requests),
            slices=slices,
        ) as root:
            pending = list(range(len(requests)))
            exclude: set = set()
            last_exc: Optional[BaseException] = None
            while pending:
                k = max(1, math.ceil(len(pending) / max(1, window)))
                replicas = self.pool.pick(k, exclude=exclude)
                if not replicas:
                    root.set_attr("error", "transport")
                    raise (
                        last_exc
                        if last_exc is not None
                        else ConnectionError(
                            f"no available replicas in pool "
                            f"({len(self.pool)} registered) with "
                            f"{len(pending)} requests un-reduced"
                        )
                    )
                shards = self._partition(pending, replicas, window)
                sharded = {id(r) for r, _ in shards}
                for replica in replicas:
                    if id(replica) not in sharded:
                        replica.breaker.release()
                outcomes = await asyncio.gather(
                    *(
                        self._reduce_replica(
                            replica,
                            [requests[i] for i in shard],
                            window,
                            slices,
                            total,
                        )
                        for replica, shard in shards
                    ),
                    return_exceptions=True,
                )
                new_pending: List[int] = []
                budget_spent = False
                granted = 0
                server_exc: Optional[BaseException] = None
                for (replica, shard), out in zip(shards, outcomes):
                    if isinstance(out, BaseException):
                        # Deterministic server/geometry error: the
                        # replica DID serve (routing books a success);
                        # a spent deadline books neither.
                        if _is_deadline(out):
                            replica.breaker.release()
                        else:
                            self.pool.record_result(replica, True)
                        server_exc = server_exc or out
                        continue
                    r_head, r_flat, holes, wall = out
                    if r_head is not None:
                        assert r_flat is not None
                        if head is None:
                            head, flat = r_head, r_flat
                        elif (
                            r_head.shape != head.shape
                            or r_flat.size != flat.size
                        ):
                            server_exc = server_exc or (
                                _gradpart.PartitionError(
                                    "replicas disagree on reply "
                                    "geometry"
                                )
                            )
                            self.pool.record_result(replica, True)
                            continue
                        else:
                            head = head + r_head
                            flat = flat + r_flat
                    if not holes:
                        self.pool.record_result(
                            replica,
                            True,
                            latency_s=wall,
                            n_requests=max(1, len(shard)),
                        )
                        continue
                    # Transport failure with a tail to re-queue: one
                    # budget spend per failed replica (the
                    # evaluate_many posture — nothing charged for a
                    # replica that served its whole shard).
                    last_exc = last_exc or ConnectionError(
                        f"replica {replica.address} failed "
                        f"{len(holes)} reduce requests"
                    )
                    self.pool.record_result(replica, False)
                    exclude.add(replica.address)
                    _POOL_FAILOVERS.labels(
                        transport=self.pool.transport
                    ).inc()
                    _flightrec.record(
                        "pool.failover",
                        replica=replica.address,
                        requeued=len(holes),
                        error="reduce window transport failure",
                    )
                    new_pending.extend(shard[i] for i in holes)
                    if self.pool.allow_retry("failover"):
                        granted += 1
                    else:
                        budget_spent = True
                if server_exc is not None:
                    if granted:
                        self.pool.retry_budget.refund(granted)
                    root.set_attr("error", "server")
                    raise server_exc
                if budget_spent and new_pending:
                    if granted:
                        self.pool.retry_budget.refund(granted)
                    root.set_attr("error", "transport")
                    raise (
                        last_exc
                        if last_exc is not None
                        else ConnectionError(
                            "retry budget exhausted with "
                            f"{len(new_pending)} requests un-reduced"
                        )
                    )
                new_pending.sort()
                pending = new_pending
            assert head is not None and flat is not None
            return [head, flat]

    def evaluate_reduced(
        self,
        requests: Sequence[Sequence[np.ndarray]],
        *,
        window: int = 8,
        slices: int = 1,
        total: Optional[int] = None,
    ) -> List[np.ndarray]:
        """Sync wrapper over :meth:`evaluate_reduced_async`."""
        from ..utils import get_event_loop

        return get_event_loop().run_until_complete(
            self.evaluate_reduced_async(
                requests, window=window, slices=slices, total=total
            )
        )

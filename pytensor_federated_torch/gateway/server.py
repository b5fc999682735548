"""The gateway accept tier: one address, thousands of downstream
connections, a few upstream windows.

This is the front door that turns a replica pool into a *service*:
downstream clients speak the exact npwire/TCP
framing they already speak to a node (``u32 length + npwire frame``,
:mod:`..service.tcp`), so a :class:`~..service.tcp.TcpArraysClient`
pointed at the gateway works unchanged — including the zero-item
batch-frame capability probe and pipelined ``evaluate_many``.  Behind
the accept loop, the gateway re-multiplexes every connection's
requests into a small number of upstream BATCH-FRAME windows against a
:class:`~..routing.pool.NodePool` — the driver-side twin of the node's
MicroBatcher: thousands of downstream sockets, a handful of upstream
syscalls.  On a node whose compute is vectorized (``device_compute_fn(
..., batched=True)`` over the linear-regression kernel), one upstream
window is one chain-batched kernel launch.

Design points:

- **Zero payload decode.**  Requests pass through as opaque npwire
  frames: admission reads only the cheap fixed-offset peeks
  (:func:`~..service.npwire.peek_deadline`,
  :func:`~..service.npwire.peek_tenant`,
  :func:`~..service.npwire.frame_uuid`), and upstream windows nest the
  original frames via :func:`~..service.npwire.encode_batch`.  Replies
  route back by per-item uuid, still encoded.
- **Deadline propagation.**  An arriving frame's remaining budget is
  pinned to an absolute monotonic instant; expired work is shed
  IN-BAND (the :mod:`..service.deadline` classification) at arrival,
  again pre-coalesce when it expires in the queue, and the upstream
  frame is restamped with the window's best remaining budget so node
  admission sees truth, not the client's stale stamp.
- **Per-tenant fairness.**  :mod:`.fairness` meters quotas and orders
  dispatch (DRR); denials are loud in-band errors naming the tenant.
- **Per-connection FIFO replies.**  Downstream clients correlate
  replies by order + uuid (the lock-step npwire contract), so each
  connection has a writer coroutine that emits replies strictly in
  request-arrival order even though upstream windows complete out of
  order.
- **Byte-capped coalescing.**  A window closes at ``frame_items``
  requests or :data:`WINDOW_BYTE_CAP` bytes (the transport stack's
  32 KiB in-flight cap) — whichever comes first; mid-batch upstream
  errors fail only their own window, with one budgeted failover
  attempt through the pool (:meth:`~..routing.pool.NodePool.allow_retry`).

Every wait is bounded: downstream payload reads, upstream round-trips, and reply
futures all sit under ``asyncio.wait_for``; only the idle
next-request header wait is unbounded, exactly like the node's own
frame loop.
"""

from __future__ import annotations

import asyncio
import struct
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from ..faultinject import runtime as _fi
from ..routing.pool import NodePool, Replica
from ..service import deadline as _deadline
from ..service.npwire import (
    WireError,
    decode_batch,
    encode_arrays,
    encode_batch,
    fast_uuid,
    frame_uuid,
    is_batch_frame,
    peek_deadline,
    peek_partition,
    peek_tenant,
)
from ..telemetry import flightrec as _flightrec
from ..telemetry import metrics as _metrics
from .fairness import (
    GATEWAY_REQUESTS,
    GATEWAY_SHED,
    TenantFairness,
    overload_error,
)

__all__ = ["GatewayServer", "GatewayThread", "serve_gateway"]

#: Upstream window byte cap — the same 32 KiB in-flight bound the
#: pipelined transport clients enforce (service/tcp.py), so a window
#: of coalesced requests can never deadlock a node's socket buffers.
WINDOW_BYTE_CAP = 32 * 1024

#: One per-connection reply-channel entry: (builder resolving to the
#: reply payload, fallback building a well-formed in-band error frame
#: with the request's own uuid/kind should the builder outrun the
#: reply ceiling).
_ReplyEntry = Tuple[Callable[[], Any], Callable[[], bytes]]

_GATEWAY_CONNECTIONS = _metrics.gauge(
    "pftpu_gateway_connections",
    "Downstream connections currently held by the gateway",
)
_GATEWAY_WINDOW_REQS = _metrics.histogram(
    "pftpu_gateway_window_requests",
    "Requests coalesced into one upstream window frame",
    buckets=(1, 2, 4, 8, 16, 32, 64),
)
_GATEWAY_UPSTREAM_S = _metrics.histogram(
    "pftpu_gateway_upstream_seconds",
    "Upstream window round-trip latency",
)
_GATEWAY_QUEUE_WAIT_S = _metrics.histogram(
    "pftpu_gateway_queue_wait_seconds",
    "Time a request spends in the fair queue before dispatch",
)


class _Pending:
    """One downstream request riding the gateway: the still-encoded
    frame, its admission metadata, and the future its reply lands on."""

    __slots__ = (
        "frame", "uuid", "tenant", "deadline_mono", "enq_t", "future",
        "attempts",
    )

    def __init__(
        self,
        frame: bytes,
        uuid: bytes,
        tenant: str,
        deadline_mono: Optional[float],
        future: "asyncio.Future[bytes]",
    ) -> None:
        self.frame = frame
        self.uuid = uuid
        self.tenant = tenant
        self.deadline_mono = deadline_mono
        self.enq_t = time.monotonic()
        self.future = future
        self.attempts = 0

    def remaining_s(self, now: float) -> Optional[float]:
        if self.deadline_mono is None:
            return None
        return self.deadline_mono - now


class _Upstream:
    """One upstream connection: lock-step batch-frame windows against a
    single replica (the npwire FIFO contract — one window in flight per
    connection; parallelism comes from the pool's width)."""

    def __init__(
        self, host: str, port: int, connect_timeout_s: float
    ) -> None:
        self.host = host
        self.port = port
        self.connect_timeout_s = connect_timeout_s
        self._reader: Optional[asyncio.StreamReader] = None
        self._writer: Optional[asyncio.StreamWriter] = None
        self._lock = asyncio.Lock()

    async def _connect(self) -> None:
        if self._writer is None:
            self._reader, self._writer = await asyncio.wait_for(
                asyncio.open_connection(self.host, self.port),
                timeout=self.connect_timeout_s,
            )

    async def close(self) -> None:
        writer = self._writer
        self._reader = None
        self._writer = None
        if writer is not None:
            try:
                writer.close()
                await writer.wait_closed()
            except (ConnectionError, OSError):
                pass

    async def window(self, frame: bytes, timeout_s: float) -> bytes:
        """One batch frame out, one batch reply back.  A failure of any
        kind closes the connection (desynchronized by definition) and
        re-raises for the caller's failover logic."""
        async with self._lock:
            try:
                await self._connect()
                assert self._reader is not None
                assert self._writer is not None
                if _fi.active_plan is not None:  # chaos seam
                    frame = await _fi.filter_bytes_async(
                        "gateway.upstream.send", frame,
                        f"{self.host}:{self.port}",
                    )
                self._writer.write(struct.pack("<I", len(frame)) + frame)
                await asyncio.wait_for(
                    self._writer.drain(), timeout=timeout_s
                )
                hdr = await asyncio.wait_for(
                    self._reader.readexactly(4), timeout=timeout_s
                )
                (n,) = struct.unpack("<I", hdr)
                reply = await asyncio.wait_for(
                    self._reader.readexactly(n), timeout=timeout_s
                )
                if _fi.active_plan is not None:  # chaos seam
                    reply = await _fi.filter_bytes_async(
                        "gateway.upstream.recv", reply,
                        f"{self.host}:{self.port}",
                    )
                return reply
            except Exception:
                await self.close()
                raise


class GatewayServer:
    """The front door: accept downstream npwire connections, coalesce
    into upstream pool windows, with per-tenant fairness.

    ``pool``: the upstream :class:`~..routing.pool.NodePool` (tcp/shm
    replicas answer the batch-frame protocol; the gateway speaks raw
    npwire regardless of the replica's registered transport client).
    ``fairness``: a :class:`~.fairness.TenantFairness` (default: no
    quotas, equal weights).  ``default_tenant`` labels frames carrying
    no tenant block.  ``frame_items``/``window_byte_cap`` bound one
    upstream window; ``upstream_timeout_s`` bounds each upstream
    round-trip; ``reply_timeout_s`` is the per-request ceiling after
    which a queued reply future is answered with an in-band error
    (belt-and-suspenders: every path that can resolve it is already
    bounded).

    ``denial_pause_s`` is DENIAL PACING: after a frame from a
    connection is quota/backlog-denied, the accept loop pauses that
    one connection's reads for the interval before taking its next
    frame.  Without it a flooding tenant converts the gateway's own
    denial throughput into a DoS vector — every denied frame still
    costs the loop a peek and a reply, so a deep pipelined flood of
    denials crowds out well-behaved tenants' frames on the shared
    loop.  The pause scales with the number of denials the frame drew
    (a BATCH frame of K denied items pays ~K pauses, capped at
    :data:`MAX_DENIAL_PAUSE_S` — otherwise wrapping the flood in
    batch frames would amortize one pause across hundreds of
    denials), so a denied connection degrades to roughly
    ``1/denial_pause_s`` REQUESTS/s however framed (and kernel TCP
    backpressure stalls its sender), while connections that are never
    denied never pause.

    ``downstream_frame_timeout_s`` bounds reading ONE frame's payload
    after its length prefix arrives (a peer that goes silent
    mid-frame) — deliberately its own knob: tuning the upstream
    window bound must not silently disconnect slow downstream
    senders."""

    #: Ceiling on one accumulated denial pause — reads must always
    #: make progress so the connection can drain and close.
    MAX_DENIAL_PAUSE_S = 5.0

    def __init__(
        self,
        pool: NodePool,
        *,
        host: str = "127.0.0.1",
        port: int = 0,
        fairness: Optional[TenantFairness] = None,
        default_tenant: str = "default",
        frame_items: int = 32,
        window_byte_cap: int = WINDOW_BYTE_CAP,
        upstream_timeout_s: float = 30.0,
        reply_timeout_s: float = 120.0,
        connect_timeout_s: float = 5.0,
        max_dispatch_tasks: int = 8,
        backlog: int = 1024,
        denial_pause_s: float = 0.05,
        downstream_frame_timeout_s: float = 30.0,
    ) -> None:
        self.pool = pool
        self.host = host
        self.port = int(port)
        self.fairness = fairness or TenantFairness()
        self.default_tenant = default_tenant
        self.frame_items = int(frame_items)
        self.window_byte_cap = int(window_byte_cap)
        self.upstream_timeout_s = float(upstream_timeout_s)
        self.reply_timeout_s = float(reply_timeout_s)
        self.connect_timeout_s = float(connect_timeout_s)
        self.max_dispatch_tasks = int(max_dispatch_tasks)
        self.backlog = int(backlog)
        self.denial_pause_s = float(denial_pause_s)
        self.downstream_frame_timeout_s = float(downstream_frame_timeout_s)
        self._server: Optional[asyncio.AbstractServer] = None
        self._dispatcher: Optional["asyncio.Task[None]"] = None
        self._work = asyncio.Event()
        self._stopping = False
        self._upstreams: Dict[str, _Upstream] = {}
        self._tasks: "set[asyncio.Task[Any]]" = set()
        # Rolling counters the autoscaler differences into rates.
        self.stats: Dict[str, int] = {
            "accepted": 0, "ok": 0, "shed": 0, "denied": 0, "failed": 0,
        }

    # -- lifecycle --------------------------------------------------------

    async def start(self) -> int:
        """Bind and serve; returns the bound port."""
        # A 10k-connection front door must not refuse a connect burst
        # at the kernel's default SYN backlog.
        self._server = await asyncio.start_server(
            self._handle_conn, self.host, self.port,
            backlog=self.backlog,
        )
        self.port = self._server.sockets[0].getsockname()[1]
        self._dispatcher = asyncio.get_running_loop().create_task(
            self._dispatch_loop()
        )
        _flightrec.record(
            "gateway.started", addr=f"{self.host}:{self.port}",
            replicas=len(self.pool),
        )
        return self.port

    async def stop(self) -> None:
        self._stopping = True
        self._work.set()
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
        if self._dispatcher is not None:
            self._dispatcher.cancel()
            try:
                await self._dispatcher
            except (asyncio.CancelledError, Exception):
                pass
        for task in list(self._tasks):
            task.cancel()
        for upstream in self._upstreams.values():
            await upstream.close()
        self._upstreams.clear()
        _flightrec.record("gateway.stopped")

    def signals(self) -> Dict[str, float]:
        """The autoscaler's observation surface: queue depth + rolling
        outcome counters (difference across calls for rates)."""
        out: Dict[str, float] = {
            "queue_depth": float(self.fairness.queue.depth()),
        }
        out.update({k: float(v) for k, v in self.stats.items()})
        return out

    # -- downstream: accept + reply ordering ------------------------------

    async def _handle_conn(
        self,
        reader: asyncio.StreamReader,
        writer: asyncio.StreamWriter,
    ) -> None:
        _GATEWAY_CONNECTIONS.inc()
        # FIFO reply channel: entries are (builder, fallback) pairs —
        # the builder resolves to the reply payload in strict
        # request-arrival order; the fallback builds a WELL-FORMED
        # in-band error frame (right uuid, right frame kind) should
        # the builder outrun the reply ceiling.
        replies: "asyncio.Queue[Optional[_ReplyEntry]]" = (
            asyncio.Queue()
        )
        writer_task = asyncio.get_running_loop().create_task(
            self._conn_writer(writer, replies)
        )
        self._tasks.add(writer_task)
        writer_task.add_done_callback(self._tasks.discard)
        try:
            while not self._stopping:
                try:
                    # Idle wait for the NEXT request: unbounded on
                    # purpose, like the node's own frame loop; the
                    # mid-frame payload read below is bounded.
                    hdr = await reader.readexactly(4)
                    (n,) = struct.unpack("<I", hdr)
                    payload = await asyncio.wait_for(
                        reader.readexactly(n),
                        timeout=self.downstream_frame_timeout_s,
                    )
                except (
                    asyncio.IncompleteReadError,
                    asyncio.TimeoutError,
                    ConnectionError,
                    OSError,
                ):
                    break
                if _fi.active_plan is not None:  # chaos seam
                    try:
                        payload = await _fi.filter_bytes_async(
                            "gateway.recv", payload
                        )
                    except (ConnectionError, OSError):
                        break
                denied_before = self.stats["denied"]
                await self._ingest(payload, replies)
                pause = self._denial_pause_for(
                    self.stats["denied"] - denied_before
                )
                if pause > 0:
                    # Denial pacing (class docstring): this connection
                    # just drew denials — read its next frame at a
                    # trickle so a flood of denials cannot crowd the
                    # loop; never-denied connections never pause.
                    await asyncio.sleep(pause)
        finally:
            await replies.put(None)  # writer drains then exits
            try:
                await asyncio.wait_for(writer_task, timeout=5.0)
            except (asyncio.TimeoutError, asyncio.CancelledError):
                writer_task.cancel()
            except (ConnectionError, OSError):
                pass
            try:
                writer.close()
            except (ConnectionError, OSError):
                pass
            _GATEWAY_CONNECTIONS.dec()

    async def _conn_writer(
        self,
        writer: asyncio.StreamWriter,
        replies: "asyncio.Queue[Optional[_ReplyEntry]]",
    ) -> None:
        """Emit replies in strict arrival order; each entry's awaitable
        is bounded by ``reply_timeout_s``, and a fired ceiling answers
        with the entry's own fallback frame — the request's real uuid
        and frame kind, so the downstream client reads a correlated
        in-band error instead of desynchronizing on a zeroed one."""
        while True:
            entry = await replies.get()
            if entry is None:
                return
            factory, fallback = entry
            try:
                payload = await asyncio.wait_for(
                    factory(), timeout=self.reply_timeout_s
                )
            except asyncio.TimeoutError:
                GATEWAY_SHED.labels(reason="reply_timeout").inc()
                self.stats["failed"] += 1
                payload = fallback()
            try:
                writer.write(struct.pack("<I", len(payload)) + payload)
                await writer.drain()
            except (ConnectionError, OSError):
                # Downstream left; keep draining entries so pending
                # futures don't leak unobserved-exception warnings.
                continue

    # -- admission --------------------------------------------------------

    def _denial_pause_for(self, denied_delta: int) -> float:
        """The read pause one frame's denials earn: per-denial, so a
        batch frame of K denied items pays ~K pauses instead of
        amortizing one pause across the whole flood (class docstring);
        capped so the connection always keeps draining."""
        if self.denial_pause_s <= 0 or denied_delta <= 0:
            return 0.0
        return min(
            self.denial_pause_s * denied_delta, self.MAX_DENIAL_PAUSE_S
        )

    def _shed_reply(
        self, frame: bytes, *, batch: bool, error: str
    ) -> bytes:
        try:
            uid = frame_uuid(frame)
        except WireError:
            uid = b"\0" * 16
        if batch:
            return encode_batch([], uuid=uid, error=error)
        return encode_arrays([], uuid=uid, error=error)

    async def _ingest(
        self,
        payload: bytes,
        replies: "asyncio.Queue[Optional[_ReplyEntry]]",
    ) -> None:
        """Admit one downstream frame: probe echo, per-item admission
        for batch frames, plain admission otherwise.  Always enqueues
        exactly ONE reply entry, preserving arrival order."""

        def immediate(payload_bytes: bytes) -> "_ReplyEntry":
            async def done() -> bytes:
                return payload_bytes
            return done, lambda: payload_bytes

        if is_batch_frame(payload):
            try:
                items, outer_uuid, _err, _tid, _sp = decode_batch(payload)
            except WireError as e:
                GATEWAY_REQUESTS.labels(outcome="bad_frame").inc()
                await replies.put(immediate(self._shed_reply(
                    payload, batch=True, error=f"decode error: {e}"
                )))
                return
            try:
                reduce_part = peek_partition(payload)
            except WireError:
                reduce_part = None
            if reduce_part is not None:
                # A REDUCE window (outer partition block):
                # the gateway coalesces PER ITEM across tenants, which
                # would silently decompose the caller's partial-sum
                # contract — refuse loudly instead (reduce windows
                # ride direct tcp/shm pools or aggregator trees).
                GATEWAY_REQUESTS.labels(outcome="bad_frame").inc()
                await replies.put(immediate(encode_batch(
                    [], uuid=outer_uuid,
                    error=(
                        "partition reduce windows are not served "
                        "through the gateway (dial a tcp/shm pool or "
                        "an aggregator tree directly)"
                    ),
                )))
                return
            if not items:
                # The capability/liveness probe: answer it ourselves —
                # the gateway IS batch-capable by construction.
                await replies.put(immediate(
                    encode_batch([], uuid=outer_uuid)
                ))
                return
            futures = [
                self._admit_item(item) for item in items
            ]

            async def gather_batch() -> bytes:
                parts = await asyncio.gather(*futures)
                return encode_batch(list(parts), uuid=outer_uuid)

            def batch_fallback() -> bytes:
                return encode_batch(
                    [], uuid=outer_uuid,
                    error=overload_error(
                        "*", "gateway reply ceiling exceeded"
                    ),
                )

            await replies.put((gather_batch, batch_fallback))
            return
        fut = self._admit_item(payload)
        try:
            uid = frame_uuid(payload)
        except WireError:
            uid = b"\0" * 16  # fut already resolved with the decode error

        def plain_fallback(uid: bytes = uid) -> bytes:
            return encode_arrays(
                [], uuid=uid,
                error=overload_error(
                    "*", "gateway reply ceiling exceeded"
                ),
            )

        await replies.put(((lambda: fut), plain_fallback))

    def _admit_item(self, frame: bytes) -> "asyncio.Future[bytes]":
        """Admission for ONE request frame -> future of its reply frame
        (resolved immediately for sheds/denials)."""
        loop = asyncio.get_running_loop()
        future: "asyncio.Future[bytes]" = loop.create_future()
        self.stats["accepted"] += 1
        try:
            uid = frame_uuid(frame)
            budget = peek_deadline(frame)
            tenant = peek_tenant(frame) or self.default_tenant
        except WireError as e:
            GATEWAY_REQUESTS.labels(outcome="bad_frame").inc()
            future.set_result(self._shed_reply(
                frame, batch=False, error=f"decode error: {e}"
            ))
            return future
        if budget is not None and budget <= 0.0:
            # Expired before the gateway ever saw it: shed pre-queue.
            GATEWAY_SHED.labels(reason="expired_arrival").inc()
            GATEWAY_REQUESTS.labels(outcome="shed_expired").inc()
            self.stats["shed"] += 1
            _flightrec.record(
                "gateway.shed", reason="expired_arrival", tenant=tenant
            )
            future.set_result(encode_arrays(
                [], uuid=uid,
                error=_deadline.deadline_error(
                    "budget spent before gateway admission"
                ),
            ))
            return future
        denial = self.fairness.admit(tenant)
        if denial is not None:
            self.stats["denied"] += 1
            future.set_result(
                encode_arrays([], uuid=uid, error=denial)
            )
            return future
        GATEWAY_REQUESTS.labels(outcome="admitted").inc()
        deadline_mono = (
            None if budget is None else time.monotonic() + budget
        )
        self.fairness.queue.push(
            tenant, _Pending(frame, uid, tenant, deadline_mono, future)
        )
        self._work.set()
        return future

    # -- upstream dispatch ------------------------------------------------

    async def _dispatch_loop(self) -> None:
        """Drain the fair queue into upstream windows.  One collection
        loop; windows run as concurrent tasks bounded by
        ``max_dispatch_tasks`` (parallelism across replicas)."""
        sem = asyncio.Semaphore(self.max_dispatch_tasks)
        while not self._stopping:
            window = self._collect_window()
            if not window:
                self._work.clear()
                try:
                    # Bounded idle tick so shutdown is never waited on
                    # forever (unbounded-wait posture).
                    await asyncio.wait_for(self._work.wait(), timeout=0.5)
                except asyncio.TimeoutError:
                    pass
                continue
            await sem.acquire()
            task = asyncio.get_running_loop().create_task(
                self._run_window(window, sem)
            )
            self._tasks.add(task)
            task.add_done_callback(self._tasks.discard)

    def _collect_window(self) -> List[_Pending]:
        """Pop up to ``frame_items``/``window_byte_cap`` of fair-queued
        work, shedding entries whose deadline expired while queued
        (pre-coalesce: expired work must never ride an upstream
        window)."""
        window: List[_Pending] = []
        nbytes = 0
        now = time.monotonic()
        while len(window) < self.frame_items:
            popped = self.fairness.queue.pop()
            if popped is None:
                break
            _tenant, item = popped
            pending = item  # type: ignore[assignment]
            assert isinstance(pending, _Pending)
            remaining = pending.remaining_s(now)
            if remaining is not None and remaining <= 0.0:
                GATEWAY_SHED.labels(reason="expired_queued").inc()
                GATEWAY_REQUESTS.labels(outcome="shed_expired").inc()
                self.stats["shed"] += 1
                _flightrec.record(
                    "gateway.shed", reason="expired_queued",
                    tenant=pending.tenant,
                )
                if not pending.future.done():
                    pending.future.set_result(encode_arrays(
                        [], uuid=pending.uuid,
                        error=_deadline.deadline_error(
                            "budget spent in the gateway queue"
                        ),
                    ))
                continue
            _GATEWAY_QUEUE_WAIT_S.observe(now - pending.enq_t)
            if window and nbytes + len(pending.frame) > self.window_byte_cap:
                # Byte cap reached: the entry leads the NEXT window —
                # head re-insert, so the tenant's own FIFO order holds
                # and a large frame cannot be deferred forever behind
                # its smaller siblings.
                self.fairness.queue.push_front(pending.tenant, pending)
                break
            window.append(pending)
            nbytes += len(pending.frame)
        return window

    def _upstream_for(self, replica: Replica) -> _Upstream:
        upstream = self._upstreams.get(replica.address)
        if upstream is None:
            upstream = self._upstreams[replica.address] = _Upstream(
                replica.host, replica.port, self.connect_timeout_s
            )
        return upstream

    def _window_budget_s(self, window: Sequence[_Pending]) -> Optional[float]:
        """The batch frame's outer deadline stamp: the window's BEST
        remaining budget (min would shed viable work with one expired
        sibling; expired items were already shed pre-coalesce)."""
        now = time.monotonic()
        remains = [
            r for r in (p.remaining_s(now) for p in window) if r is not None
        ]
        if len(remains) < len(window):
            return None  # an unbounded item keeps the window admitted
        return max(remains) if remains else None

    async def _run_window(
        self, window: List[_Pending], sem: asyncio.Semaphore
    ) -> None:
        try:
            await self._run_window_inner(window)
        finally:
            sem.release()
            if self.fairness.queue.depth():
                self._work.set()

    async def _run_window_inner(self, window: List[_Pending]) -> None:
        """Send one coalesced window upstream and route the per-item
        replies home; on transport failure, one budgeted failover
        attempt through the pool, then loud in-band errors."""
        excluded: List[str] = []
        for attempt in range(2):
            picked = self.pool.pick(1, exclude=excluded)
            if not picked:
                self._fail_window(
                    window,
                    overload_error(
                        "*", "no upstream replica available; retry later"
                    ),
                    reason="no_upstream",
                )
                return
            replica = picked[0]
            budget = self._window_budget_s(window)
            outer_uuid = fast_uuid()
            frame = encode_batch(
                [p.frame for p in window],
                uuid=outer_uuid,
                deadline_s=budget,
            )
            _GATEWAY_WINDOW_REQS.observe(len(window))
            timeout = self.upstream_timeout_s
            if budget is not None:
                timeout = min(timeout, budget + 1.0)
            t0 = time.perf_counter()
            try:
                reply = await self._upstream_for(replica).window(
                    frame, timeout
                )
                items, ruid, outer_err, _tid, _sp = decode_batch(reply)
            except (
                WireError,
                asyncio.TimeoutError,
                asyncio.IncompleteReadError,
                ConnectionError,
                OSError,
            ) as e:
                self.pool.record_result(replica, False)
                _flightrec.record(
                    "gateway.upstream_failed",
                    replica=replica.address,
                    error=f"{type(e).__name__}: {str(e)[:120]}",
                )
                excluded.append(replica.address)
                if attempt == 0 and self.pool.allow_retry(
                    "gateway_failover"
                ):
                    continue
                self._fail_window(
                    window,
                    overload_error(
                        "*",
                        f"upstream {replica.address} failed "
                        f"({type(e).__name__}); retry later",
                    ),
                    reason="upstream_failed",
                )
                return
            latency = time.perf_counter() - t0
            _GATEWAY_UPSTREAM_S.observe(latency)
            self.pool.record_result(
                replica, True, latency_s=latency, n_requests=len(window)
            )
            if outer_err is not None or ruid != outer_uuid:
                # Outer-level failure (node admission shed, decode
                # error): cover the whole window in-band.
                err = outer_err or "upstream reply did not correlate"
                self._fail_window(window, err, reason="upstream_error")
                return
            by_uuid: Dict[bytes, bytes] = {}
            for item in items:
                try:
                    by_uuid[frame_uuid(item)] = item
                except WireError:
                    continue
            for pending in window:
                reply_item = by_uuid.get(pending.uuid)
                if reply_item is None:
                    reply_item = encode_arrays(
                        [], uuid=pending.uuid,
                        error="gateway: upstream reply missing this item",
                    )
                    self.stats["failed"] += 1
                else:
                    self.stats["ok"] += 1
                if not pending.future.done():
                    pending.future.set_result(reply_item)
            return

    def _fail_window(
        self, window: Sequence[_Pending], error: str, *, reason: str
    ) -> None:
        GATEWAY_SHED.labels(reason=reason).inc()
        for pending in window:
            self.stats["failed"] += 1
            if not pending.future.done():
                pending.future.set_result(
                    encode_arrays(
                        [], uuid=pending.uuid, error=error
                    )
                )


class GatewayThread:
    """Run a :class:`GatewayServer` on a dedicated event-loop thread —
    the embedding tests, benchmarks, and the chaos harness use (the
    gateway is asyncio-native; the rest of the harness usually is
    not).  ``start()`` blocks until the port is bound."""

    def __init__(self, pool: NodePool, **kwargs: Any) -> None:
        self.pool = pool
        self.kwargs = kwargs
        self.server: Optional[GatewayServer] = None
        self.port: Optional[int] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._thread: Optional[threading.Thread] = None
        self._ready = threading.Event()
        self._error: Optional[BaseException] = None

    def start(self, timeout_s: float = 30.0) -> int:
        self._thread = threading.Thread(
            target=self._run, name="pftpu-gateway", daemon=True
        )
        self._thread.start()
        if not self._ready.wait(timeout_s):
            raise RuntimeError("gateway thread did not come up")
        if self._error is not None:
            raise RuntimeError(
                f"gateway failed to start: {self._error}"
            ) from self._error
        assert self.port is not None
        return self.port

    def _run(self) -> None:
        loop = asyncio.new_event_loop()
        self._loop = loop
        asyncio.set_event_loop(loop)
        self.server = GatewayServer(self.pool, **self.kwargs)

        async def main() -> None:
            try:
                self.port = await self.server.start()  # type: ignore[union-attr]
            except BaseException as e:  # startup failure -> caller
                self._error = e
                raise
            finally:
                self._ready.set()

        try:
            loop.run_until_complete(main())
            loop.run_forever()
        except BaseException:
            pass
        finally:
            try:
                loop.close()
            except Exception:
                pass

    def stop(self, timeout_s: float = 10.0) -> None:
        loop = self._loop
        if loop is None or not loop.is_running():
            return

        async def shutdown() -> None:
            if self.server is not None:
                await self.server.stop()
            asyncio.get_running_loop().stop()

        asyncio.run_coroutine_threadsafe(shutdown(), loop)
        if self._thread is not None:
            self._thread.join(timeout=timeout_s)

    def __enter__(self) -> "GatewayThread":
        self.start()
        return self

    def __exit__(self, *exc: object) -> None:
        self.stop()


def serve_gateway(
    replicas: Sequence[Tuple[str, int]],
    host: str = "127.0.0.1",
    port: int = 0,
    *,
    ready_callback: Optional[Callable[[int], None]] = None,
    pool_kwargs: Optional[Dict[str, Any]] = None,
    **kwargs: Any,
) -> None:
    """Blocking gateway entry point for subprocess deployment (the
    chaos harness and bench configs spawn this): builds a TCP
    :class:`~..routing.pool.NodePool` over ``replicas``, starts the
    background probe loop, and serves forever."""
    pool = NodePool(
        list(replicas), transport="tcp", **(pool_kwargs or {})
    )
    pool.start()

    async def main() -> None:
        server = GatewayServer(pool, host=host, port=port, **kwargs)
        bound = await server.start()
        if ready_callback is not None:
            ready_callback(bound)
        # graftlint: disable=unbounded-spin -- sleeping forever IS the idle state of a blocking serve_* entrypoint; the gateway's lanes are deadline-bounded
        while True:
            await asyncio.sleep(3600.0)

    asyncio.run(main())

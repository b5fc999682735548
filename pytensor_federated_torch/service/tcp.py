"""Plain-TCP transport for the npwire format — the cross-language lane.

The gRPC service (:mod:`.server`/:mod:`.client`) is the batteries-
included host-federation transport; this module is the *minimal* one: a
u32-length-prefixed npwire frame over a TCP socket.  Its purpose is the
capability the reference only gestures at — "the model implementation
could be C++" (reference: README.md:34-35): ``native/cpp_node.cpp``
implements this exact protocol with zero Python, and
:class:`TcpArraysClient` drives it from the driver process.

Frame layout: ``u32 little-endian payload length`` + npwire payload
(see :mod:`.npwire` for the payload layout).  Requests and replies are
lock-step per connection — the same one-in-flight pattern the reference
uses on its bidirectional streams (reference: service.py:150-158).
"""

from __future__ import annotations

import socket
import struct
import time
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from ..faultinject import runtime as _fi
from ..telemetry import flightrec as _flightrec
from ..telemetry import reunion as _reunion
from ..telemetry import spans as _spans
from ..telemetry import watchdog as _watchdog
from . import _node_metrics
from . import _rpc_metrics
from . import deadline as _deadline
from .batching import execute_window_sync as _execute_window_sync
from .npwire import (
    WireError,
    append_spans,
    fast_uuid,
    decode_arrays_all,
    decode_arrays_ex,
    decode_arrays_part,
    decode_batch,
    decode_batch_part,
    encode_arrays,
    encode_arrays_sg,
    encode_batch,
    frame_uuid,
    is_batch_frame,
    peek_deadline,
    peek_partition,
    sg_nbytes,
)

# The partition lane: shard math + loud reassembly rules.
# routing/ deliberately never imports service/ at module level, so this
# upward import cannot cycle (the same direction wire_registry rides).
from ..routing import partition as _partition

__all__ = ["TcpArraysClient", "serve_tcp_once", "RemoteComputeError"]

# Same metric families as the gRPC lane (client.py), labeled
# transport="tcp" so both lanes aggregate on one dashboard
# (metric catalog: docs/observability.md).
_CALL_S = _rpc_metrics.CALL_S
_RETRIES = _rpc_metrics.RETRIES
_DROPS = _rpc_metrics.DROPS
_BATCH_S = _rpc_metrics.BATCH_S
_WINDOW_DEPTH = _rpc_metrics.WINDOW_DEPTH
_FRAME_REQS = _rpc_metrics.BATCH_FRAME_REQS


class RemoteComputeError(RuntimeError):
    """The remote node replied with an error payload."""


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    chunks = []
    while n > 0:
        # graftlint: disable=unbounded-wait -- server frame loop: waiting for the NEXT request is the node's idle state, bounded only by the peer disconnecting
        b = sock.recv(n)
        if not b:
            raise ConnectionError("peer closed mid-frame")
        chunks.append(b)
        n -= len(b)
    return b"".join(chunks)


# Preserialized header packers: the u32 length
# prefix rides every frame each way, and struct.pack with a literal
# format re-parses the format string per call in the hot send path —
# swept from the client lanes.
_U32 = struct.Struct("<I")

# Linux IOV_MAX is 1024; stay under it so one sendmsg never fails
# with EMSGSIZE however many frames a burst coalesces.
_IOV_CHUNK = 512


def _sendmsg_all(sock: socket.socket, parts) -> None:
    """Send a buffer vector with ``socket.sendmsg`` — the scatter/
    gather syscall: the kernel gathers the views directly, so nothing
    is concatenated in userspace (the copy ``b"".join`` used to pay).
    Handles partial sends (a filled send buffer can accept any byte
    count) and chunks the vector under IOV_MAX."""
    mvs = []
    for p in parts:
        mv = p if isinstance(p, memoryview) else memoryview(p)
        if mv.format != "B" or mv.ndim != 1:
            # Byte-format views only: the partial-send arithmetic below
            # slices by BYTES, and a typed view slices by elements.
            mv = mv.cast("B")
        mvs.append(mv)
    start = 0
    while start < len(mvs):
        chunk = mvs[start : start + _IOV_CHUNK]
        while chunk:
            sent = sock.sendmsg(chunk)
            while chunk and sent >= chunk[0].nbytes:
                sent -= chunk[0].nbytes
                chunk.pop(0)
            if sent:
                chunk[0] = chunk[0][sent:]
        start += _IOV_CHUNK


def _send_frame(sock: socket.socket, payload: bytes) -> None:
    # Header + payload as one sendmsg vector: no copy-to-prepend.
    _sendmsg_all(sock, (_U32.pack(len(payload)), payload))


def _send_frame_vec(sock: socket.socket, parts, nbytes: int) -> None:
    """One length-prefixed frame from a scatter/gather buffer vector
    (``encode_arrays_sg`` output): the u32 header and every piece ride
    a single ``sendmsg``, so array payloads go source → kernel with no
    intermediate frame copy."""
    _sendmsg_all(sock, [_U32.pack(nbytes), *parts])


def _recv_frame(sock: socket.socket) -> bytes:
    (n,) = _U32.unpack(_recv_exact(sock, 4))
    return _recv_exact(sock, n)


def _serve_send(conn: socket.socket, payload: bytes) -> None:
    """Server-side frame send, routed through the chaos seam
    (``tcp.server.send``) when a fault plan is installed."""
    if _fi.active_plan is not None:
        _fi.send_frame_through("tcp.server.send", conn.sendall, payload)
    else:
        _send_frame(conn, payload)


class TcpArraysClient:
    """Arrays-in → arrays-out over one persistent TCP connection.

    API parity with :class:`.client.ArraysToArraysServiceClient`'s sync
    surface: ``evaluate(*arrays) -> [arrays]`` with uuid correlation
    checking and lazy (re)connection.  ``retries`` reconnects on a dead
    socket — the failover analog for a single fixed peer (reference:
    service.py:408-416 rebalances across a pool; a TCP peer is pinned).
    """

    def __init__(
        self,
        host: str,
        port: int,
        *,
        retries: int = 2,
        max_inflight_bytes: Optional[int] = None,
        connect_timeout_s: float = 30.0,
        connect_retries: int = 1,
        connect_backoff_s: float = 0.05,
        timeout_s: Optional[float] = None,
        tenant: Optional[str] = None,
    ):
        """``max_inflight_bytes`` caps the pipelined window's in-flight
        REQUEST bytes (deadlock guard, see ``evaluate_many``).  The
        default (None) is ADAPTIVE: at least the classic 32 KiB, grown
        to fit a few copies of the first encoded request — so a
        workload whose single request exceeds 32 KiB does not silently
        degrade to lock-step — and clamped to the socket's send-buffer
        size (the actual deadlock boundary).

        ``connect_timeout_s`` bounds each initial-connect attempt (the
        old hard-coded 30 s, now a knob: a pool sweeping replicas wants
        sub-second verdicts); ``connect_retries`` re-attempts a failed
        connect with a ``connect_backoff_s`` pause between tries —
        exhaustion raises :class:`ConnectionError`, which every caller
        (the retry loop here, the replica pool's ``is_transient``)
        classifies as transport trouble, so failover proceeds cleanly.

        ``timeout_s`` bounds each reply read; with an ambient deadline
        bound (:mod:`.deadline`) the read is ALSO capped at the
        remaining budget, so a node that accepts then never replies
        fails over within the caller's deadline instead of blocking
        until the watchdog fires.  A fired bound closes the
        (desynchronized) connection and surfaces as ``TimeoutError`` —
        an ``OSError``, i.e. the transient classification every retry
        loop and pool already fails over on.

        ``tenant`` stamps every request with a tenant id (npwire flag
        bit 32) — the identity the gateway tier meters quotas and
        weighted-fair service by; ``None`` (the default) keeps every
        frame byte-identical to the pre-tenant wire."""
        self.host = host
        self.port = int(port)
        self.retries = retries
        self.tenant = tenant
        self.max_inflight_bytes = max_inflight_bytes
        self.timeout_s = None if timeout_s is None else float(timeout_s)
        self.connect_timeout_s = float(connect_timeout_s)
        self.connect_retries = int(connect_retries)
        self.connect_backoff_s = float(connect_backoff_s)
        self._sock: Optional[socket.socket] = None
        self._rfile = None  # buffered reader over _sock
        # Per-connection batch-frame capability (None = not probed).
        self._batch_ok: Optional[bool] = None

    @property
    def _peer(self) -> str:
        return f"{self.host}:{self.port}"

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
            # Buffered reads: a frame costs one length + one payload
            # read from the buffer instead of 2+ raw recv syscalls.
            self._rfile = s.makefile("rb")
        return self._sock

    def _read_frame(self) -> bytes:
        # Bounded read: the per-call timeout_s knob and the ambient
        # deadline, whichever is tighter, as a TOTAL bound across the
        # header+payload chunks; posture (expired-budget close,
        # TimeoutError close, socket-timeout restore) is the shared
        # _deadline.bounded_reader so the shm doorbell cannot diverge.
        assert self._sock is not None and self._rfile is not None
        with _deadline.bounded_reader(
            self._sock,
            self._rfile,
            _deadline.recv_budget_s(self.timeout_s),
            self.close,
        ) as read_exact:
            (n,) = _U32.unpack(read_exact(4))
            return read_exact(n)

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
                # Re-probe after reconnect: the peer may have been
                # replaced by a build without (or with) batch support.
                self._batch_ok = None

    def __del__(self):  # best-effort, mirrors client.py teardown
        try:
            self.close()
        except Exception:
            pass

    def evaluate(
        self,
        *arrays: np.ndarray,
        partition: Optional[Sequence[int]] = None,
    ) -> List[np.ndarray]:
        """One lock-step evaluation.  ``partition`` (keyword-only, a
        5-int sequence) requests the head/tail SLICED reply — the
        reply is ``[head, slice]`` with the block echoed; geometry
        disagreement surfaces as :class:`RemoteComputeError`
        (routing/partition.py owns the rule)."""
        outputs, _ver = self._evaluate_inner(arrays, partition, None)
        return outputs

    def evaluate_versioned(
        self,
        *arrays: np.ndarray,
        partition: Optional[Sequence[int]] = None,
        version: int,
    ) -> Tuple[List[np.ndarray], Optional[int]]:
        """One VERSIONED round trip (the sharded-optimizer
        lane) -> ``(outputs, reply_version)``.  The request
        carries ``version`` as its u64 step stamp (flag bit 128;
        zero is meaningful — the init handshake) and ``partition``
        as the owned-shard geometry; the node's ``versioned_update``
        handler answers shard-shaped outputs stamped with the NEW
        version.  A stale stamp surfaces as
        :class:`RemoteComputeError` carrying the node's loud
        refusal (optim/sharded.py classifies it)."""
        return self._evaluate_inner(arrays, partition, version)

    def _evaluate_inner(
        self,
        arrays: Sequence[np.ndarray],
        partition: Optional[Sequence[int]],
        version: Optional[int],
    ) -> Tuple[List[np.ndarray], Optional[int]]:
        with _spans.span("rpc.evaluate", transport="tcp"):
            with _spans.span("encode"):
                uid = fast_uuid()
                trace_id = (
                    _spans.current_trace_id() if _spans.enabled() else None
                )
                _deadline.check_remaining("tcp evaluate")
                # Scatter/gather encode: the frame stays a buffer
                # vector (header bytes + views of the input arrays)
                # until sendmsg hands the pieces to the kernel — no
                # contiguous-frame copy.  ``norm`` outlives the send,
                # so the views stay valid across retries.
                norm = [np.asarray(a) for a in arrays]
                request = encode_arrays_sg(
                    norm,
                    uuid=uid,
                    trace_id=trace_id,
                    deadline_s=_deadline.wire_budget(),
                    tenant=self.tenant,
                    partition=partition,
                    version=version,
                )
                request_len = sg_nbytes(request)
            last_err: Optional[Exception] = None
            for attempt in range(self.retries + 1):
                if attempt:
                    _RETRIES.labels(transport="tcp").inc()
                    _flightrec.record(
                        "rpc.retry", transport="tcp", attempt=attempt
                    )
                    # A spent budget must stop the reconnect loop: a
                    # retry past it can only add load, never an answer
                    # the caller is still waiting for.
                    _deadline.check_remaining("tcp retry")
                    # Restamp the REMAINING budget: re-sending the
                    # attempt-0 frame would advertise the budget as it
                    # stood before the failed attempts burned wall
                    # time, so the server would admit (and the batcher
                    # keep) work whose caller is closer to giving up
                    # than the wire claims.
                    budget = _deadline.wire_budget()
                    if budget is not None:
                        request = encode_arrays_sg(
                            norm,
                            uuid=uid,
                            trace_id=trace_id,
                            deadline_s=budget,
                            tenant=self.tenant,
                            partition=partition,
                            version=version,
                        )
                        request_len = sg_nbytes(request)
                t0 = time.perf_counter()
                try:
                    with _spans.span("call"):
                        sock = self._connect()
                        if _fi.active_plan is not None:  # chaos seam
                            _fi.send_frame_through(
                                "tcp.send", sock.sendall,
                                b"".join(request),
                                peer=self._peer,
                            )
                        else:
                            _send_frame_vec(sock, request, request_len)
                        reply = self._read_frame()
                        if _fi.active_plan is not None:  # chaos seam
                            reply = _fi.filter_bytes(
                                "tcp.recv", reply, self._peer
                            )
                    break
                except (ConnectionError, OSError) as e:
                    last_err = e
                    _DROPS.labels(transport="tcp").inc()
                    _flightrec.record(
                        "rpc.drop", transport="tcp",
                        peer=f"{self.host}:{self.port}",
                    )
                    self.close()
            else:
                raise ConnectionError(
                    f"node {self.host}:{self.port} unreachable after "
                    f"{self.retries + 1} attempts"
                ) from last_err
            with _spans.span("decode"):
                try:
                    (
                        outputs, reply_uid, error, _tid, node_spans,
                        _rpart, reply_version,
                    ) = decode_arrays_part(reply)
                except Exception:
                    # Corrupt reply: close so the NEXT call reconnects
                    # cleanly instead of trusting a connection whose
                    # framing already lied once — same posture as the
                    # pipelined pass; the WireError surfaces loudly.
                    _DROPS.labels(transport="tcp").inc()
                    self.close()
                    raise
                if node_spans:
                    _reunion.ingest(node_spans)
            _CALL_S.labels(transport="tcp", mode="lockstep").observe(
                time.perf_counter() - t0
            )
            if error is not None:
                _flightrec.record(
                    "rpc.error", transport="tcp", error=error[:200]
                )
                if _deadline.is_deadline_error(error):
                    raise _deadline.DeadlineExceeded(error)
                raise RemoteComputeError(error)
            if reply_uid != uid:
                # A mismatched reply means this connection is
                # desynchronized (e.g. stale frames left by an aborted
                # batch) — close it so the NEXT call reconnects cleanly
                # instead of reading stale frames forever, matching
                # _evaluate_many_once.
                _DROPS.labels(transport="tcp").inc()
                self.close()
                raise RuntimeError(
                    "uuid mismatch: reply does not match request"
                )
            return outputs, reply_version

    __call__ = evaluate

    # Default in-flight REQUEST bytes cap: keeps every sendall
    # completable so the pipelining loop always reaches its read —
    # without it, a write-only burst can fill both sockets' buffers
    # against a server blocked sending replies nobody reads (the same
    # deadlock geometry as HTTP/2 flow control on the gRPC lane,
    # client.py).  The EFFECTIVE cap is _inflight_cap(): constructor
    # knob, else adaptively sized from the first encoded request.
    _DEFAULT_INFLIGHT_BYTES = 32 * 1024

    def _inflight_cap(self, first_frame_len: int) -> int:
        """Effective in-flight byte cap for one pipelined pass."""
        if self.max_inflight_bytes is not None:
            return int(self.max_inflight_bytes)
        # Adaptive default: room for ~4 copies of the first request so
        # large-array workloads still overlap, clamped to HALF the
        # reported socket send buffer — Linux getsockopt(SO_SNDBUF)
        # returns the doubled bookkeeping value with only about half
        # usable for payload, and the cap's whole job is "every
        # sendall completable", so the clamp must undershoot.
        cap = max(self._DEFAULT_INFLIGHT_BYTES, 4 * first_frame_len)
        try:
            sndbuf = self._connect().getsockopt(
                socket.SOL_SOCKET, socket.SO_SNDBUF
            )
            if sndbuf > 1:
                # No floor after this clamp: an operator-shrunk send
                # buffer must WIN (a cap above it re-opens the
                # deadlock); a cap below one frame just degrades to
                # the proven-safe lock-step mode via the lone-frame
                # disjunct.
                cap = min(cap, sndbuf // 2)
        except OSError:
            pass
        return max(cap, 1)

    def _probe_batch(self) -> bool:
        """One-shot capability negotiation: a ZERO-item batch frame is
        the probe.  A batch-aware peer echoes an empty batch reply
        with the probe's uuid; a pre-batch peer (old C++ node) parses
        the frame as zero arrays or answers a decode-error frame —
        either way not a batch frame, so the answer is False and the
        client never coalesces toward it.  Cached per connection
        (``close()`` resets it)."""
        if self._batch_ok is None:
            sock = self._connect()
            uid = fast_uuid()
            _send_frame(sock, encode_batch([], uuid=uid))
            reply = self._read_frame()
            ok = False
            if is_batch_frame(reply):
                try:
                    items, ruid, err, _tid, _sp = decode_batch(reply)
                    ok = ruid == uid and err is None and not items
                # Capability NEGOTIATION: an undecodable echo means the
                # peer is pre-batch — the loud in-band verdict is
                # "capability absent", never an exception.
                except Exception:  # graftlint: disable=wire-loudness -- negotiation verdict lane
                    ok = False
            self._batch_ok = ok
            _flightrec.record(
                "rpc.batch_capability", transport="tcp", ok=ok,
                peer=f"{self.host}:{self.port}",
            )
        return self._batch_ok

    def evaluate_many(
        self,
        requests: Sequence[Sequence[np.ndarray]],
        *,
        window: int = 8,
        batch: object = "auto",
    ) -> List[List[np.ndarray]]:
        """Pipelined batch over the SAME lock-step connection.

        The frame protocol is strictly FIFO per connection (the C++
        node's loop is recv -> compute -> send, native/cpp_node.cpp),
        so up to ``window`` requests stay in flight and replies
        correlate by order + per-frame uuid — client encode, both
        network legs, and node compute overlap.  Oversized requests
        degrade to lock-step via the byte cap (one in flight, the
        proven-safe per-call mode).

        Same semantics as the gRPC lane's ``evaluate_many``:
        all-or-nothing TRANSPORT retry (reconnect, re-run the whole
        batch); a server error reply raises
        :class:`RemoteComputeError` without retry after draining the
        in-flight replies so the connection stays correlated.

        ``batch``: "auto" (default) packs the window into wire BATCH
        FRAMES — ``min(window, 32)`` requests per frame — when the
        peer answers the zero-item probe frame (:meth:`_probe_batch`);
        the TCP protocol has no GetLoad, so the probe IS the
        capability negotiation.  ``False`` forces per-call frames;
        ``True`` requires support and raises if the peer lacks it.
        """
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        # Identity checks, not equality: 0/1 would pass an `in` test
        # (0 == False) yet route down the WRONG branch below.
        if batch != "auto" and batch is not True and batch is not False:
            raise ValueError(
                f"batch must be 'auto', True or False, got {batch!r}"
            )
        with _spans.span(
            "rpc.evaluate_many",
            transport="tcp",
            n=len(requests),
            window=window,
        ):
            with _spans.span("encode"):
                trace_id = (
                    _spans.current_trace_id() if _spans.enabled() else None
                )
                # (buffer-vector, frame length, uuid) per request: the
                # scatter/gather form survives until sendmsg (or, on
                # the batch-frame path, until the frames are packed).
                budget = _deadline.wire_budget()
                encoded = []
                for args in requests:
                    uid = fast_uuid()
                    parts = encode_arrays_sg(
                        [np.asarray(a) for a in args],
                        uuid=uid,
                        trace_id=trace_id,
                        deadline_s=budget,
                        tenant=self.tenant,
                    )
                    encoded.append((parts, sg_nbytes(parts), uid))
            if not encoded:
                return []
            t0 = time.perf_counter()
            last_err: Optional[Exception] = None
            for attempt in range(self.retries + 1):
                if attempt:
                    _RETRIES.labels(transport="tcp").inc()
                    _flightrec.record(
                        "rpc.retry", transport="tcp", attempt=attempt,
                        batch=len(encoded),
                    )
                try:
                    use_batch = False
                    if batch is not False:
                        use_batch = self._probe_batch()
                        if batch is True and not use_batch:
                            raise RuntimeError(
                                f"node {self.host}:{self.port} does not "
                                "answer the batch-frame probe"
                            )
                    # Known wedge point: a pipelined window against a
                    # stalled peer can block in read — armed so a hang
                    # leaves an incident bundle (telemetry.watchdog).
                    with _watchdog.armed(
                        "tcp.batch_window", n=len(encoded), window=window
                    ):
                        if use_batch:
                            results = self._evaluate_many_batched_once(
                                encoded, window, trace_id
                            )
                        else:
                            results = self._evaluate_many_once(
                                encoded, window
                            )
                except (ConnectionError, OSError) as e:
                    last_err = e
                    _DROPS.labels(transport="tcp").inc()
                    _flightrec.record(
                        "rpc.drop", transport="tcp",
                        peer=f"{self.host}:{self.port}",
                    )
                    self.close()
                    continue
                _BATCH_S.labels(transport="tcp").observe(
                    time.perf_counter() - t0
                )
                return results
            raise ConnectionError(
                f"node {self.host}:{self.port} unreachable after "
                f"{self.retries + 1} attempts"
            ) from last_err

    def evaluate_many_partial(
        self,
        requests: Sequence[Sequence[np.ndarray]],
        *,
        window: int = 8,
        batch: object = "auto",
    ):
        """ONE pipelined pass with no reconnect-retry, surfacing
        partial progress: ``(results, transport_exc)`` with ``None``
        holes for requests whose reply never arrived — the failover
        primitive the replica pool (routing/) re-queues from, mirror
        of the gRPC client's ``evaluate_many_partial_async``.
        Deterministic server errors (:class:`RemoteComputeError`,
        corrupt frames, uuid desync) raise; only a dead/failed socket
        is returned as ``transport_exc``."""
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        if batch != "auto" and batch is not True and batch is not False:
            raise ValueError(
                f"batch must be 'auto', True or False, got {batch!r}"
            )
        with _spans.span(
            "rpc.evaluate_many",
            transport="tcp",
            n=len(requests),
            window=window,
            partial=True,
        ):
            with _spans.span("encode"):
                trace_id = (
                    _spans.current_trace_id() if _spans.enabled() else None
                )
                # (buffer-vector, frame length, uuid) per request: the
                # scatter/gather form survives until sendmsg (or, on
                # the batch-frame path, until the frames are packed).
                budget = _deadline.wire_budget()
                encoded = []
                for args in requests:
                    uid = fast_uuid()
                    parts = encode_arrays_sg(
                        [np.asarray(a) for a in args],
                        uuid=uid,
                        trace_id=trace_id,
                        deadline_s=budget,
                        tenant=self.tenant,
                    )
                    encoded.append((parts, sg_nbytes(parts), uid))
            if not encoded:
                return [], None
            out: List[Optional[List[np.ndarray]]] = [None] * len(encoded)
            t0 = time.perf_counter()
            try:
                use_batch = False
                if batch is not False:
                    use_batch = self._probe_batch()
                    if batch is True and not use_batch:
                        raise RuntimeError(
                            f"node {self.host}:{self.port} does not "
                            "answer the batch-frame probe"
                        )
                with _watchdog.armed(
                    "tcp.batch_window", n=len(encoded), window=window
                ):
                    if use_batch:
                        self._evaluate_many_batched_once(
                            encoded, window, trace_id, out=out
                        )
                    else:
                        self._evaluate_many_once(encoded, window, out=out)
            except (ConnectionError, OSError) as e:
                _DROPS.labels(transport="tcp").inc()
                _flightrec.record(
                    "rpc.drop", transport="tcp",
                    peer=f"{self.host}:{self.port}",
                )
                self.close()
                return out, e
            _BATCH_S.labels(transport="tcp").observe(
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
        """Reduce-scatter evaluation: ``[head_sum, flat_tail_sum]``.

        The window rides REDUCE batch frames (outer partition block):
        the node sums each frame's item replies — head (reply array 0)
        summed whole, tails flat-concatenated — and returns the sum as
        ``slices`` partition-indexed slices, reassembled here with the
        loud :class:`~..routing.partition.Reassembler` rules; partial
        sums from multiple frames are summed locally.  Wire bytes per
        reply drop from ``n_requests × tail_size`` to
        ``n_frames × tail_size`` — the gradient-sharding bandwidth story.

        ``slices > 1`` splits each frame's reply into that many
        partition-indexed items (gradients larger than one reply frame
        stream home in pieces); ``total``, when given, is validated
        against the node's actual flat tail size (a driver/node shape
        disagreement fails in-band instead of mis-assembling).

        Deterministic server errors raise
        :class:`RemoteComputeError`/:class:`WireError` after a drain;
        transport trouble retries like :meth:`evaluate_many`."""
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
            transport="tcp",
            n=len(requests),
            slices=slices,
        ):
            t0 = time.perf_counter()
            last_err: Optional[Exception] = None
            for attempt in range(self.retries + 1):
                if attempt:
                    _RETRIES.labels(transport="tcp").inc()
                    _flightrec.record(
                        "rpc.retry", transport="tcp", attempt=attempt,
                        batch=len(requests),
                    )
                    _deadline.check_remaining("tcp reduce retry")
                try:
                    with _watchdog.armed(
                        "tcp.reduce_window",
                        n=len(requests),
                        window=window,
                    ):
                        result = self._evaluate_reduced_once(
                            requests, window, slices, total
                        )
                except (ConnectionError, OSError) as e:
                    last_err = e
                    _DROPS.labels(transport="tcp").inc()
                    _flightrec.record(
                        "rpc.drop", transport="tcp", peer=self._peer
                    )
                    self.close()
                    continue
                _BATCH_S.labels(transport="tcp").observe(
                    time.perf_counter() - t0
                )
                return result
            raise ConnectionError(
                f"node {self.host}:{self.port} unreachable after "
                f"{self.retries + 1} attempts"
            ) from last_err

    def _evaluate_reduced_once(self, requests, window, slices, total):
        sock = self._connect()
        trace_id = _spans.current_trace_id() if _spans.enabled() else None
        chunk = max(1, min(window, self._BATCH_CHUNK))
        req_part = (0, slices, 0, 0, 0 if total is None else int(total))
        head: Optional[np.ndarray] = None
        flat: Optional[np.ndarray] = None
        # Lock-step per frame on purpose: reduce replies are tiny (one
        # tail regardless of window width), so pipelining frames buys
        # little and the one-in-flight mode keeps the drain trivial.
        # Each frame encodes AT SEND TIME so it stamps the budget as
        # it stands after the earlier frames' wall time (the deadline
        # restamp posture; the shm twin does the same).
        for start in range(0, len(requests), chunk):
            part_reqs = requests[start : start + chunk]
            outer_uuid = fast_uuid()
            frame = encode_batch(
                [
                    encode_arrays(
                        [np.asarray(a) for a in args], uuid=fast_uuid()
                    )
                    for args in part_reqs
                ],
                uuid=outer_uuid,
                trace_id=trace_id,
                deadline_s=_deadline.wire_budget(),
                partition=req_part,
            )
            _FRAME_REQS.labels(transport="tcp").observe(len(part_reqs))
            if _fi.active_plan is not None:  # chaos seam
                _fi.send_frame_through(
                    "tcp.send", sock.sendall, frame, peer=self._peer
                )
            else:
                _send_frame(sock, frame)
            reply = self._read_frame()
            if _fi.active_plan is not None:  # chaos seam
                reply = _fi.filter_bytes("tcp.recv", reply, self._peer)
            f_head, f_flat = self._consume_reduce_reply(
                reply, outer_uuid, slices, total
            )
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
        return [head, flat]

    def _consume_reduce_reply(self, reply, outer_uuid, slices, total):
        """One reduce reply frame -> (head_sum, flat_vector); loud on
        every anomaly (the Reassembler rules), closing the connection
        so the NEXT call reconnects cleanly."""
        try:
            items, ruid, outer_err, _tid, node_spans, rpart, _ver = (
                decode_batch_part(reply)
            )
            if node_spans:
                _reunion.ingest(node_spans)
        except Exception:
            _DROPS.labels(transport="tcp").inc()
            self.close()
            raise
        if outer_err is not None:
            if _deadline.is_deadline_error(outer_err):
                raise _deadline.DeadlineExceeded(outer_err)
            raise RemoteComputeError(outer_err)
        try:
            if ruid != outer_uuid:
                raise WireError(
                    "reduce reply does not correlate with its frame"
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
                    f"reduce reply geometry ({count}, {r_total}) does "
                    f"not match the request ({slices}, {total})"
                )
            if len(items) != slices:
                raise _partition.PartitionError(
                    f"reduce reply carries {len(items)} slices, "
                    f"requested {slices}"
                )
            head: Optional[np.ndarray] = None
            reassembler: Optional[_partition.Reassembler] = None
            for item in items:
                arrays, _uid, err, _t, _sp, ipart, _iv = (
                    decode_arrays_part(item)
                )
                if err is not None:
                    raise RemoteComputeError(err)
                if ipart is None:
                    raise _partition.PartitionError(
                        "reduce reply item carries no partition block"
                    )
                p = _partition.GradPartition(*ipart).validate()
                # Cross-check the ITEM's block against the OUTER block
                # (itself validated against the request) BEFORE the
                # geometry sizes anything: a corrupt item total would
                # otherwise size the reassembly buffer — an
                # attacker/chaos-chosen allocation instead of the
                # contracted loud refusal.
                if p.count != count or p.total != r_total:
                    raise _partition.PartitionError(
                        f"reduce item geometry ({p.count}, {p.total}) "
                        f"does not match the window ({count}, {r_total})"
                    )
                if p.index == 0:
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
                        p.total,
                        p.count,
                        np.asarray(slice_arr).dtype
                        if np.asarray(slice_arr).size
                        else np.dtype(np.float64),
                    )
                reassembler.add(p, np.asarray(slice_arr), iuid=_uid.hex())
            assert reassembler is not None
            if head is None:
                raise _partition.PartitionError(
                    "reduce reply carried no head item (index 0)"
                )
            return head, reassembler.result()
        except RemoteComputeError:
            raise
        except (WireError, RuntimeError):
            # Mis-assembled / desynchronized reply: close so the NEXT
            # call reconnects cleanly; the error surfaces loudly.
            _DROPS.labels(transport="tcp").inc()
            self.close()
            raise

    def _evaluate_many_once(self, encoded, window, out=None):
        # ``out`` (optional, len(encoded) of None) is filled in place
        # as replies validate — the partial-progress channel
        # evaluate_many_partial / the replica pool's failover build on.
        # ``encoded`` entries are (buffer-vector, nbytes, uuid).
        sock = self._connect()
        n = len(encoded)
        max_inflight = self._inflight_cap(encoded[0][1])
        results: List[Optional[List[np.ndarray]]] = (
            out if out is not None else [None] * n
        )
        write_idx = read_idx = 0
        inflight_bytes = 0
        while read_idx < n:
            # Coalesce every writable frame into ONE sendmsg vector: on
            # localhost the per-call cost is syscall-dominated, so a
            # window of small frames pays one gather syscall — and the
            # array payloads ride as views, never joined in userspace.
            burst = []
            while write_idx < n and (
                write_idx == read_idx
                or (
                    write_idx - read_idx < window
                    and inflight_bytes + encoded[write_idx][1]
                    <= max_inflight
                )
            ):
                parts, nbytes, _uid = encoded[write_idx]
                burst.append((parts, nbytes))
                inflight_bytes += nbytes
                write_idx += 1
            if burst:
                if _fi.active_plan is not None:  # chaos seam: per frame
                    for parts, _nb in burst:
                        _fi.send_frame_through(
                            "tcp.send", sock.sendall, b"".join(parts),
                            peer=self._peer,
                        )
                else:
                    vec = []
                    for parts, nbytes in burst:
                        vec.append(_U32.pack(nbytes))
                        vec.extend(parts)
                    _sendmsg_all(sock, vec)
            _WINDOW_DEPTH.labels(transport="tcp").observe(
                write_idx - read_idx
            )
            reply = self._read_frame()
            if _fi.active_plan is not None:  # chaos seam
                reply = _fi.filter_bytes("tcp.recv", reply, self._peer)
            _parts, request_len, uid = encoded[read_idx]
            inflight_bytes -= request_len
            try:
                outputs, reply_uid, error, _tid, node_spans = (
                    decode_arrays_all(reply)
                )
                if node_spans:
                    _reunion.ingest(node_spans)
            except Exception:
                # Corrupt payload with replies still in flight: the
                # connection cannot be trusted to stay correlated —
                # close so the NEXT call reconnects cleanly, and let
                # the WireError surface loudly.
                _DROPS.labels(transport="tcp").inc()
                self.close()
                raise
            if error is not None:
                # Drain so the connection stays correlated for the
                # NEXT call, then surface the deterministic error.  If
                # the drain itself fails, the leftover in-flight
                # replies would poison later calls with stale frames —
                # close instead of leaving a desynchronized socket.
                try:
                    for _ in range(write_idx - read_idx - 1):
                        self._read_frame()
                except (ConnectionError, OSError):
                    _DROPS.labels(transport="tcp").inc()
                    self.close()
                if _deadline.is_deadline_error(error):
                    raise _deadline.DeadlineExceeded(error)
                raise RemoteComputeError(error)
            if reply_uid != uid:
                _DROPS.labels(transport="tcp").inc()
                self.close()
                raise RuntimeError(
                    "uuid mismatch: reply does not match request"
                )
            results[read_idx] = outputs
            read_idx += 1
        return results

    _BATCH_CHUNK = 32  # requests per batch frame (server-side max_batch)

    def _evaluate_many_batched_once(self, encoded, window, trace_id,
                                    out=None):
        """One pipelined pass using wire batch frames: the window is
        packed ``min(window, 32)`` requests per frame — one syscall,
        one node decode loop, one (possibly vmapped) dispatch per
        frame.  Per-item uuids still correlate; the first item error
        drains the in-flight frames and raises RemoteComputeError
        without retry (same semantics as the unbatched pass).
        ``out`` is the in-place partial-progress channel (frame-
        granular), as in ``_evaluate_many_once``."""
        sock = self._connect()
        n = len(encoded)
        chunk = max(1, min(window, self._BATCH_CHUNK))
        frames = []  # (frame_bytes, outer_uuid, start, part)
        for start in range(0, n, chunk):
            part = encoded[start : start + chunk]
            outer_uuid = fast_uuid()
            # Batch frames nest COMPLETE item frames, so the
            # scatter/gather vectors are joined here — one flattening
            # per item, same count as the pre-sendmsg wire.
            # The server peeks the OUTER frame only (serve_npwire
            # _payload), so admission and the ambient budget ride the
            # batch frame's deadline — same contract as the gRPC
            # lane's _encode_batch_frame and the shm doorbell.
            frame = encode_batch(
                [
                    req[0] if len(req) == 1 and isinstance(req[0], bytes)
                    else b"".join(req)
                    for req, _nb, _u in part
                ],
                uuid=outer_uuid,
                trace_id=trace_id,
                deadline_s=_deadline.wire_budget(),
            )
            _FRAME_REQS.labels(transport="tcp").observe(len(part))
            frames.append((frame, outer_uuid, start, part))
        results: List[Optional[List[np.ndarray]]] = (
            out if out is not None else [None] * n
        )
        nf = len(frames)
        max_inflight = self._inflight_cap(len(frames[0][0]))
        write_idx = read_idx = 0
        inflight_bytes = 0
        while read_idx < nf:
            burst = []
            while write_idx < nf and (
                write_idx == read_idx
                or inflight_bytes + len(frames[write_idx][0])
                <= max_inflight
            ):
                payload = frames[write_idx][0]
                burst.append(payload)
                inflight_bytes += len(payload)
                write_idx += 1
            if burst:
                if _fi.active_plan is not None:  # chaos seam: per frame
                    for payload in burst:
                        _fi.send_frame_through(
                            "tcp.send", sock.sendall, payload,
                            peer=self._peer,
                        )
                else:
                    # One gather syscall, no userspace concat copy.
                    vec = []
                    for p in burst:
                        vec.append(_U32.pack(len(p)))
                        vec.append(p)
                    _sendmsg_all(sock, vec)
            _WINDOW_DEPTH.labels(transport="tcp").observe(
                write_idx - read_idx
            )
            reply = self._read_frame()
            if _fi.active_plan is not None:  # chaos seam
                reply = _fi.filter_bytes("tcp.recv", reply, self._peer)
            frame, outer_uuid, start, part = frames[read_idx]
            inflight_bytes -= len(frame)
            try:
                items, ruid, outer_err, _tid, node_spans = decode_batch(
                    reply
                )
                if node_spans:
                    _reunion.ingest(node_spans)
            except Exception:
                # Corrupt reply with frames still in flight: close so
                # the NEXT call reconnects cleanly; the WireError
                # surfaces loudly.
                _DROPS.labels(transport="tcp").inc()
                self.close()
                raise
            # Outer error FIRST: outer-level failures carry a zeroed
            # uuid (serve_tcp_once / cpp_node batch_error_reply), so a
            # uuid-first check would misreport them as correlation
            # failures.
            first_error = outer_err
            if first_error is None and (
                ruid != outer_uuid or len(items) != len(part)
            ):
                _DROPS.labels(transport="tcp").inc()
                self.close()
                raise RuntimeError(
                    "batch reply does not correlate with its frame"
                )
            if first_error is None:
                for j, (item, (_req, _nb, uid)) in enumerate(
                    zip(items, part)
                ):
                    try:
                        outputs, reply_uid, error, _t, item_spans = (
                            decode_arrays_all(item)
                        )
                    except Exception:
                        # Corrupt nested item with frames still in
                        # flight: same posture as a corrupt reply —
                        # close so the NEXT call reconnects cleanly.
                        _DROPS.labels(transport="tcp").inc()
                        self.close()
                        raise
                    if item_spans:
                        _reunion.ingest(item_spans)
                    if error is not None:
                        first_error = error
                        break
                    if reply_uid != uid:
                        _DROPS.labels(transport="tcp").inc()
                        self.close()
                        raise RuntimeError(
                            "uuid mismatch: batch item does not match "
                            "its request"
                        )
                    results[start + j] = outputs
            if first_error is not None:
                # Drain in-flight frames so the connection stays
                # correlated for the NEXT call, then surface the
                # deterministic error (no retry).
                try:
                    for _ in range(write_idx - read_idx - 1):
                        self._read_frame()
                except (ConnectionError, OSError):
                    _DROPS.labels(transport="tcp").inc()
                    self.close()
                if _deadline.is_deadline_error(first_error):
                    raise _deadline.DeadlineExceeded(first_error)
                raise RemoteComputeError(first_error)
            read_idx += 1
        return results


def _serve_batch_payload(
    compute_fn: Callable[..., Sequence[np.ndarray]],
    payload: bytes,
    *,
    transport: str = "tcp",
    request_views: bool = False,
) -> bytes:
    """One npwire batch frame in -> one batch frame out, per-item
    error isolation — the TCP server twin of the gRPC service's
    ``_run_batch_npwire`` (a zero-item frame is the capability probe
    and echoes an empty batch reply).  A same-signature window runs
    through the compute's ``.batch`` variant when present (one vmapped
    call), with scalar fallback on failure."""
    t_arrive = time.perf_counter()
    try:
        items, outer_uuid, _err, trace_id, _sp = decode_batch(payload)
    except Exception as e:
        _node_metrics.ERRORS.labels(kind="decode").inc()
        return encode_batch(
            [], uuid=b"\0" * 16, error=f"decode error: {e}"
        )
    t_decoded = time.perf_counter()
    # Zero-item frames are the pool's capability/health probe: they
    # must not feed the latency histograms the fleet plane merges, or
    # 1/s probe cadence dilutes every quantile toward the probe floor.
    is_probe = not items
    if not is_probe:
        _node_metrics.DECODE_S.observe(t_decoded - t_arrive)
    batch_fn = getattr(compute_fn, "batch", None)
    with _spans.trace_context(trace_id), _spans.span(
        "node.evaluate_batch", wire="npwire", transport=transport,
        n_items=len(items),
    ) as root:
        root.set_attr("decode_s", t_decoded - t_arrive)
        if _fi.active_plan is not None:  # chaos seam: compute path
            try:
                _fi.compute_filter()
            except _fi.FaultPlanError:
                raise  # a plan-authoring bug stays LOUD, never in-band
            except Exception as e:
                # In-band, frame-level: the injected compute failure
                # covers the whole window, exactly like a real one
                # raised before per-item dispatch.
                return encode_batch(
                    [], uuid=outer_uuid, error=str(e)
                )
        replies: List[Optional[bytes]] = [None] * len(items)
        decoded = []  # (slot, arrays, uuid)
        t_i0 = time.perf_counter()
        for i, item in enumerate(items):
            try:
                arrays, uid, _, _ = decode_arrays_ex(
                    item, copy=not request_views
                )
                decoded.append((i, arrays, uid))
            except Exception as e:
                _node_metrics.ERRORS.labels(kind="decode").inc()
                replies[i] = encode_arrays(
                    [], uuid=b"\0" * 16, error=f"decode error: {e}"
                )
        # Per-item decode is decode, not queue wait — book it in the
        # decode family so a decode-bound batch node shows up in the
        # fleet view as decode-bound, not queue-bound.
        item_decode_s = time.perf_counter() - t_i0
        if not is_probe:
            _node_metrics.DECODE_S.observe(item_decode_s)
        # Single source for dispatch semantics (vmapped-first, result
        # count validation, scalar fallback, per-item isolation):
        # batching.execute_window_sync — the sync twin of the gRPC
        # service's MicroBatcher path.
        t_c0 = time.perf_counter()
        if not is_probe:
            _node_metrics.QUEUE_S.observe(
                max(0.0, t_c0 - t_decoded - item_decode_s)
            )
        outcomes = _execute_window_sync(
            compute_fn, batch_fn, [arrs for _, arrs, _ in decoded]
        )
        if not is_probe:
            _node_metrics.COMPUTE_S.observe(time.perf_counter() - t_c0)
        t_e0 = time.perf_counter()
        for (i, _arrs, uid), res in zip(decoded, outcomes):
            if isinstance(res, Exception):
                _node_metrics.ERRORS.labels(kind="compute").inc()
                _flightrec.record(
                    "server.error", stage="compute", wire="npwire",
                    transport=transport, error=str(res)[:200],
                )
                replies[i] = encode_arrays([], uuid=uid, error=str(res))
            else:
                replies[i] = encode_arrays(
                    [np.asarray(o) for o in res], uuid=uid
                )
        reply = encode_batch(replies, uuid=outer_uuid)
        if not is_probe:
            _node_metrics.ENCODE_S.observe(time.perf_counter() - t_e0)
    if trace_id is not None and root.span is not None:
        reply = append_spans(reply, [root.span.to_dict()])
    return reply


def _serve_plain_payload(
    compute_fn: Callable[..., Sequence[np.ndarray]],
    payload: bytes,
    *,
    transport: str = "tcp",
    request_views: bool = False,
) -> bytes:
    """One plain npwire frame in -> one reply frame out: decode,
    compute, encode, with in-band error replies and the reunion spans
    piggyback.  Shared by the TCP accept loop and the shm doorbell's
    npwire fallback lane (probes from a mixed pool).

    ``request_views=True`` decodes request arrays as READ-ONLY
    frombuffer views into the frame — one payload copy saved per
    request, at the cost of breaking compute_fns that mutate their
    inputs in place; the historical owned-copy semantics stay the
    default.

    A request PARTITION block (npwire flag bit 64) asks for the
    head/tail SLICED reply (routing/partition.py's rule: array 0
    whole, arrays 1.. flat-concatenated and sliced to the requested
    element range, the block echoed on the reply).  Geometry or shape
    disagreement is answered in-band, loudly — never a mis-sliced
    gradient."""
    t_arrive = time.perf_counter()
    try:
        arrays, uid, _err, trace_id, _sp, part, step_version = (
            decode_arrays_part(payload, copy=not request_views)
        )
    except Exception as e:
        # A corrupt request fails ITS reply in-band and the connection
        # keeps serving — a hostile or chaos-mangled frame must not
        # tear down the node (mirror of cpp_node's serve_plain).
        _node_metrics.ERRORS.labels(kind="decode").inc()
        _flightrec.record(
            "server.error", stage="decode",
            wire="npwire", transport=transport,
            error=str(e)[:200],
        )
        return encode_arrays(
            [], uuid=b"\0" * 16, error=f"decode error: {e}"
        )
    t_decoded = time.perf_counter()
    _node_metrics.DECODE_S.observe(t_decoded - t_arrive)
    # Node-side spans adopt the driver's wire trace id,
    # same contract as the gRPC server (server.py).
    with _spans.trace_context(trace_id), _spans.span(
        "node.evaluate", wire="npwire", transport=transport
    ) as root:
        root.set_attr("decode_s", t_decoded - t_arrive)
        try:
            if _fi.active_plan is not None:  # chaos seam
                _fi.compute_filter()
            reply_version: Optional[int] = None
            with _spans.span("compute") as c_span:
                t_c0 = time.perf_counter()
                queue_wait = max(0.0, t_c0 - t_decoded)
                _node_metrics.QUEUE_S.observe(queue_wait)
                c_span.set_attr("queue_wait_s", queue_wait)
                if step_version is not None:
                    # Versioned sharded-optimizer lane: the
                    # handler owns slicing/versioning — outputs come
                    # back shard-shaped, stamped with the NEW version.
                    # A version stamp on a compute with no handler is a
                    # dispatch error, answered loudly in-band.
                    handler = getattr(
                        compute_fn, "versioned_update", None
                    )
                    if handler is None:
                        raise WireError(
                            "versioned request (flag bit 128) but this"
                            " node's compute has no versioned_update"
                            " handler"
                        )
                    outputs, reply_version = handler(
                        arrays, part, step_version
                    )
                    outputs = [np.asarray(o) for o in outputs]
                else:
                    outputs = [
                        np.asarray(o) for o in compute_fn(*arrays)
                    ]
                _node_metrics.COMPUTE_S.observe(
                    time.perf_counter() - t_c0
                )
            if part is not None and step_version is None:
                # Sliced reply (the scatter half of gradient sharding): loud on
                # geometry/shape disagreement — the PartitionError is a
                # WireError and rides the in-band error arm below.
                outputs = _partition.slice_reply(
                    outputs, _partition.GradPartition(*part)
                )
            with _spans.span("encode"):
                t_e0 = time.perf_counter()
                reply = encode_arrays(
                    outputs, uuid=uid, partition=part,
                    version=reply_version,
                )
                _node_metrics.ENCODE_S.observe(
                    time.perf_counter() - t_e0
                )
        except _fi.FaultPlanError:
            raise  # plan-authoring bug: LOUD, never in-band
        except Exception as e:  # error -> error payload
            _node_metrics.ERRORS.labels(kind="compute").inc()
            _flightrec.record(
                "server.error", stage="compute",
                wire="npwire", transport=transport,
                error=str(e)[:200],
            )
            reply = encode_arrays([], uuid=uid, error=str(e))
    # Reunion piggyback: traced requests get this node's span tree on
    # the reply tail (untraced frames stay byte-identical).
    if trace_id is not None and root.span is not None:
        reply = append_spans(reply, [root.span.to_dict()])
    return reply


def _serve_reduce_payload(
    compute_fn: Callable[..., Sequence[np.ndarray]],
    payload: bytes,
    *,
    transport: str = "tcp",
    request_views: bool = False,
) -> bytes:
    """One REDUCE window (batch frame + outer partition block) -> one
    batch reply of ``count`` partition-indexed slices.

    The reduce half of gradient sharding: the node sums its window's item
    replies elementwise (head summed whole, tails flat-concatenated —
    :func:`..routing.partition.reduce_replies`) and answers the sum as
    ``count`` partition-indexed items: item 0 is ``[head_sum,
    slice_0]``, items 1.. are ``[slice_i]``, each stamped with its
    partition block, the outer reply echoing the (server-completed)
    request block.  A compute_fn carrying a ``.reduce`` attribute —
    the mid-tier AGGREGATOR contract
    (:func:`..routing.partition`-based tree lowering of ``fed_sum``) —
    is handed the whole window and returns the already-summed
    ``[head, *tails]``, so a tree node forwards ONE reduced child
    window instead of computing items itself.

    Failure is all-or-nothing and in-band: any item decode or compute
    error fails the WHOLE window loudly (an outer error reply) —
    summing around a failed item would be the silent partial sum the
    loud-reassembly contract forbids."""
    t_arrive = time.perf_counter()
    try:
        items, outer_uuid, _err, trace_id, _sp, part, _ver = (
            decode_batch_part(payload)
        )
        assert part is not None  # dispatched on peek_partition
        req_part = _partition.GradPartition(*part)
    except WireError as e:
        _node_metrics.ERRORS.labels(kind="decode").inc()
        return encode_batch(
            [], uuid=b"\0" * 16, error=f"decode error: {e}"
        )
    t_decoded = time.perf_counter()
    _node_metrics.DECODE_S.observe(t_decoded - t_arrive)
    with _spans.trace_context(trace_id), _spans.span(
        "node.evaluate_reduce", wire="npwire", transport=transport,
        n_items=len(items), count=req_part.count,
    ) as root:
        root.set_attr("decode_s", t_decoded - t_arrive)
        if _fi.active_plan is not None:  # chaos seam: compute path
            try:
                _fi.compute_filter()
            except _fi.FaultPlanError:
                raise  # a plan-authoring bug stays LOUD, never in-band
            except Exception as e:
                return encode_batch([], uuid=outer_uuid, error=str(e))
        try:
            if not items:
                raise _partition.PartitionError(
                    "cannot reduce an empty window"
                )
            decoded = []
            for item in items:
                arrays, _uid, _e, _t = decode_arrays_ex(
                    item, copy=not request_views
                )
                decoded.append(list(arrays))
            reduce_fn = getattr(compute_fn, "reduce", None)
            t_c0 = time.perf_counter()
            _node_metrics.QUEUE_S.observe(max(0.0, t_c0 - t_decoded))
            if reduce_fn is not None:
                summed = [np.asarray(o) for o in reduce_fn(decoded)]
            else:
                outcomes = _execute_window_sync(
                    compute_fn, getattr(compute_fn, "batch", None),
                    decoded,
                )
                for res in outcomes:
                    if isinstance(res, Exception):
                        # All-or-nothing: a failed item fails the
                        # whole reduction (no silent partial sum).
                        raise res
                summed = _partition.reduce_replies(outcomes)
            _node_metrics.COMPUTE_S.observe(time.perf_counter() - t_c0)
            t_e0 = time.perf_counter()
            _layout, total, _dtype = _partition.tail_layout(summed)
            if req_part.total and req_part.total != total:
                raise _partition.PartitionError(
                    f"partition total {req_part.total} != window tail "
                    f"size {total} (driver/node shape disagreement)"
                )
            plan = _partition.plan_partitions(total, req_part.count)
            flat = _partition.concat_tail(summed)
            replies = []
            for p in plan:
                arrs = [flat[p.offset : p.offset + p.length]]
                if p.index == 0:
                    arrs.insert(0, np.asarray(summed[0]))
                replies.append(
                    encode_arrays(arrs, uuid=outer_uuid, partition=p)
                )
                _partition.PARTITION_SHARDS.labels(outcome="ok").inc()
            if _fi.active_plan is not None:  # chaos seam: shard lane
                # block_off: item frames carry flags=PARTITION only,
                # so the partition block sits right after the fixed
                # 26-byte npwire header.
                replies = _fi.shard_filter(
                    "partition.reply", replies, block_off=26
                )
            reply = encode_batch(
                replies,
                uuid=outer_uuid,
                partition=_partition.GradPartition(
                    0, req_part.count, 0, total, total
                ),
            )
            _node_metrics.ENCODE_S.observe(time.perf_counter() - t_e0)
        except _fi.FaultPlanError:
            raise  # plan-authoring bug: LOUD, never in-band
        except Exception as e:
            if isinstance(e, _partition.PartitionError):
                _partition.PARTITION_SHARDS.labels(
                    outcome="error"
                ).inc()
            _node_metrics.ERRORS.labels(kind="compute").inc()
            _flightrec.record(
                "server.error", stage="reduce", wire="npwire",
                transport=transport, error=str(e)[:200],
            )
            reply = encode_batch([], uuid=outer_uuid, error=str(e))
    if trace_id is not None and root.span is not None:
        reply = append_spans(reply, [root.span.to_dict()])
    return reply


def serve_npwire_payload(
    compute_fn: Callable[..., Sequence[np.ndarray]],
    payload: bytes,
    *,
    transport: str = "tcp",
    request_views: bool = False,
) -> bytes:
    """One npwire frame (plain OR batch) in -> one reply frame out —
    the whole node-side npwire contract as a function, so any framed
    byte channel (TCP accept loop, shm doorbell) serves identically.
    ``request_views`` opts the request decode into zero-copy read-only
    views (see :func:`_serve_plain_payload`).

    Deadline admission (flag bit 16, :mod:`.deadline`): an expired
    budget is answered with the in-band deadline classification BEFORE
    any decode or compute cost is paid; a live one is re-bound as the
    handler's ambient deadline so the compute inherits it.

    Instrumented with the same ``pftpu_server_*`` families as the gRPC
    service (:mod:`._node_metrics`) so TCP and shm template nodes
    aggregate into the fleet view like gRPC nodes (``method`` is
    ``evaluate`` for plain frames, ``evaluate_batch`` for batch
    frames; a zero-item batch frame is the pool's capability/health
    probe and counts as ``probe`` — keeping probe cadence OUT of the
    SLO engine's goodput objective, the gRPC lane's GetLoad posture,
    so an idle-but-probed fleet never pages on a goodput floor)."""
    batch = is_batch_frame(payload)
    reduce_window = False
    if batch:
        # n_items sits at the fixed header offset (<4sBB16sI then
        # <I count) — the same cheap peek posture as peek_deadline.
        try:
            (n_items,) = struct.unpack_from("<I", payload, 22)
        except struct.error:
            n_items = None  # truncated: the full decoder rejects it
        try:
            # An outer partition block marks a REDUCE window (the
            # partial-reduction lane, routing/partition.py).
            reduce_window = peek_partition(payload) is not None
        except WireError:
            reduce_window = False  # the full decoder rejects it below
        method = (
            "probe"
            if n_items == 0
            else ("evaluate_reduce" if reduce_window else "evaluate_batch")
        )
    else:
        method = "evaluate"
    _node_metrics.REQUESTS.labels(method=method).inc()
    _node_metrics.INFLIGHT.inc()
    try:
        try:
            budget = peek_deadline(payload)
        except WireError:
            budget = None  # the full decoder rejects it loudly below
        err = _deadline.shed_expired_admission(
            budget, transport=transport
        )
        if err is not None:
            uid = frame_uuid(payload)
            if batch:
                return encode_batch([], uuid=uid, error=err)
            return encode_arrays([], uuid=uid, error=err)
        with _deadline.budget_scope(budget):
            if batch:
                if reduce_window:
                    return _serve_reduce_payload(
                        compute_fn, payload, transport=transport,
                        request_views=request_views,
                    )
                return _serve_batch_payload(
                    compute_fn, payload, transport=transport,
                    request_views=request_views,
                )
            return _serve_plain_payload(
                compute_fn, payload, transport=transport,
                request_views=request_views,
            )
    finally:
        _node_metrics.INFLIGHT.dec()


def _serve_tcp_connection(
    conn: socket.socket,
    compute_fn: Callable[..., Sequence[np.ndarray]],
    request_views: bool = False,
) -> None:
    """One connection's lock-step frame loop (shared by the sequential
    and ``concurrent=True`` accept modes of :func:`serve_tcp_once`)."""
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
                        "tcp.server.recv", payload
                    )
                except (ConnectionError, OSError):
                    break
            try:
                _serve_send(
                    conn,
                    serve_npwire_payload(
                        compute_fn, payload,
                        request_views=request_views,
                    ),
                )
            except (ConnectionError, OSError):
                break


def serve_tcp_once(
    compute_fn: Callable[..., Sequence[np.ndarray]],
    host: str = "127.0.0.1",
    port: int = 0,
    *,
    ready_callback: Optional[Callable[[int], None]] = None,
    max_connections: Optional[int] = None,
    concurrent: bool = False,
    request_views: bool = False,
) -> None:
    """Blocking pure-Python server for the same protocol.

    The in-language peer of ``native/cpp_node.cpp`` — used to test the
    client without a compiler, and as a template for third-language
    nodes.  Serves connections sequentially by default;
    ``concurrent=True`` serves each accepted connection on its own
    daemon thread (the cpp_node accept model) so a held client
    connection cannot starve health probes — what a replica pool
    (routing/) needs from a pure-Python TCP node.  Each connection
    processes lock-step frames until the peer disconnects; corrupt
    frames are answered with in-band error replies, never a server
    crash.  Batch frames (npwire flag bit 8) are served with per-item
    error isolation; a compute_fn carrying a ``.batch`` attribute
    (``device_compute_fn(..., batched=True)``) executes same-signature
    windows as one vmapped call.  ``port=0`` binds an ephemeral port
    reported through ``ready_callback``.  ``max_connections`` bounds
    the accept loop (None = forever; in concurrent mode it bounds
    accepts, not completions).  ``request_views=True`` hands
    compute_fn READ-ONLY zero-copy views of request arrays instead of
    owned copies — one payload copy saved per request; leave it off
    for compute_fns that mutate their inputs in place.
    """
    import threading

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
                    target=_serve_tcp_connection,
                    args=(conn, compute_fn, request_views),
                    daemon=True,
                ).start()
            else:
                _serve_tcp_connection(conn, compute_fn, request_views)

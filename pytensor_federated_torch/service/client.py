"""Host-federation gRPC client: load balancing, connection cache, failover.

Port of the JAX package's ``service/client.py``, itself a re-design of
the reference's client core (reference: service.py:161-423).  The
behavioral contracts:

- **GetLoad polling**: all candidate servers queried concurrently with a
  timeout; unresponsive servers map to ``None``
  (reference: get_loads_async, service.py:161-211).
- **Balanced connect**: shuffle + small de-sync sleep, then pick the
  server with the fewest active clients
  (reference: ClientPrivates.connect_balanced, service.py:240-263) via
  :func:`..utils.argmin_none_or_func`.  Ports stay ``int`` s — the
  reference's numpy-shuffle turned them into strings; here the shuffle
  uses ``random.sample`` on the tuple list.
- **Connection cache**: gRPC objects are not picklable, so they live in
  a module-global dict keyed ``(id(client), pid, thread_id)`` and are
  re-created lazily after the client is pickled into worker processes
  (reference: _privates, service.py:214-275).
- **uuid correlation** on every evaluation
  (reference: service.py:321-322).
- **Failover**: on a dead connection the cached channel is dropped and
  the retry loop rebalances onto a surviving server
  (reference: service.py:407-416); all servers dead raises
  ``TimeoutError`` (reference: service.py:257-260).

``grpc`` is imported at the first gRPC use, not with this module
(:mod:`._grpc`); a missing ``grpcio`` raises ``ImportError`` there.
"""

from __future__ import annotations

import asyncio
import contextlib
import dataclasses
import functools
import json
import logging
import os
import random
import threading
import time
import uuid as uuid_mod
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..faultinject import runtime as _fi
from ..telemetry import flightrec as _flightrec
from ..telemetry import reunion as _reunion
from ..telemetry import spans as _spans
from ..telemetry import watchdog as _watchdog
from ..utils import argmin_none_or_func, get_event_loop
from . import _rpc_metrics
from . import deadline as _deadline
from . import npproto_codec
from ._grpc import grpc
from .npproto_codec import decode_get_load_result
from .npwire import (
    WireError,
    decode_arrays_all,
    decode_batch,
    encode_arrays,
    encode_batch,
    fast_uuid,
)
from .server import EVALUATE, EVALUATE_STREAM, GET_LOAD

_log = logging.getLogger(__name__)

HostPort = Tuple[str, int]
_identity = lambda b: b  # noqa: E731

# Driver-side RPC instrumentation, shared with the TCP lane
# (transport="grpc" here, "tcp" in .tcp) so dashboards aggregate
# across lanes.
_CALL_S = _rpc_metrics.CALL_S
_RETRIES = _rpc_metrics.RETRIES
_DROPS = _rpc_metrics.DROPS
_BATCH_S = _rpc_metrics.BATCH_S
_WINDOW_DEPTH = _rpc_metrics.WINDOW_DEPTH
_FRAME_REQS = _rpc_metrics.BATCH_FRAME_REQS


# gRPC status codes that mark a DETERMINISTIC server-side failure: the
# npproto path has no in-band error field, so a compute error surfaces
# as a stream abort — re-running it retries+1 times would re-execute
# the whole batch into the same exception.  Transport trouble
# (UNAVAILABLE, ...) stays retryable.  DEADLINE_EXCEEDED is in the
# NO-RETRY set: a spent deadline is spent on every replica at once, so
# a retry can only add load for a caller that already gave up — the
# retry-storm amplification the deadline machinery exists to remove
# (it is also the status the server aborts with for an npproto request
# whose wire budget expired).  Built at first use: the status codes are
# grpc's.
_NO_RETRY_NAMES = (
    "UNKNOWN",  # server handler raised
    "INVALID_ARGUMENT",
    "OUT_OF_RANGE",
    "FAILED_PRECONDITION",
    "UNIMPLEMENTED",
    "DEADLINE_EXCEEDED",
)


@functools.lru_cache(maxsize=1)
def _no_retry_status() -> frozenset:
    return frozenset(getattr(grpc.StatusCode, n) for n in _NO_RETRY_NAMES)


def _is_retryable(exc: BaseException) -> bool:
    """Whether the retry-and-rebalance loop should re-attempt after
    ``exc`` — AioRpcError is classified by status code; raw socket
    trouble (ConnectionError/OSError) is always transport."""
    if isinstance(exc, grpc.aio.AioRpcError):
        return exc.code() not in _no_retry_status()
    return True


async def _stream_write(stream, payload: bytes) -> None:
    """``stream.write`` with dead-stream translation: writing to an RPC
    the server already aborted raises ``asyncio.InvalidStateError``
    ("RPC already finished"), which is TRANSPORT trouble — without the
    translation it would escape the retry/failover classification and
    surface as an unclassified crash (found by tools/chaos_run.py:
    a server aborting mid-window left the next write unclassified)."""
    try:
        await stream.write(payload)
    except asyncio.InvalidStateError as e:
        raise ConnectionError(f"stream already finished: {e}") from e


async def _stream_read(stream):
    """``stream.read`` with the same dead-stream translation, bounded
    by the ambient deadline when one is set: a server that accepted
    the write but never replies must fail the call inside the caller's
    budget, not block until the watchdog fires.  The timeout cancels
    the read, desynchronizing the lock-step stream — the TimeoutError
    (an OSError since 3.10) lands in the callers' transport-error
    handlers, which drop the cached connection."""
    remaining = _deadline.remaining_s()
    try:
        if remaining is None:
            return await stream.read()
        if remaining <= 0:
            _deadline.DEADLINE_EXPIRED.labels(stage="client").inc()
            # The request was already written (lock-step): raising
            # without reading leaves the cached stream one reply
            # ahead, failing the NEXT healthy call with a uuid
            # mismatch.  DeadlineExceeded is a RuntimeError, so the
            # callers' transport handlers never drop the connection —
            # cancel the RPC here so the next use raises
            # InvalidStateError -> ConnectionError and reconnects.
            with contextlib.suppress(Exception):
                stream.cancel()
            raise _deadline.DeadlineExceeded(
                _deadline.deadline_error("budget spent awaiting reply")
            )
        return await asyncio.wait_for(stream.read(), timeout=remaining)
    except asyncio.CancelledError:
        # grpc.aio raises CancelledError from read() on an RPC that
        # was itself cancelled (e.g. by a previous timed-out read
        # tearing the call down) — that is a DEAD STREAM, transport
        # trouble, not our task being cancelled.  A genuine task
        # cancellation leaves the RPC alive and must propagate.
        done = getattr(stream, "done", None)
        if done is not None and done():
            raise ConnectionError("stream cancelled mid-read") from None
        raise
    except asyncio.TimeoutError:
        # Translate to the transport classification (asyncio's
        # TimeoutError is not an OSError on 3.10): the callers drop
        # the now-desynchronized connection and fail over; the next
        # attempt's own deadline check then raises DeadlineExceeded.
        _deadline.DEADLINE_EXPIRED.labels(stage="client").inc()
        raise ConnectionError(
            "reply deadline elapsed on the lock-step stream"
        ) from None
    except asyncio.InvalidStateError as e:
        raise ConnectionError(f"stream already finished: {e}") from e


async def get_load_async(
    host: str, port: int, *, timeout: float = 5.0
) -> Optional[dict]:
    """Query one server's load; ``None`` if unreachable/slow/garbled
    (reference: get_load_async, service.py:161-186).

    The reply format is AUTO-DETECTED: this package's nodes answer
    JSON (always starts with ``{``); an unmodified reference node —
    or a node started with ``getload_wire="npproto"`` — answers the
    reference's protobuf ``GetLoadResult`` (service.proto:24-31),
    which can never start with ``{`` (0x7B = field 15 with illegal
    wire type 3).  Either way the same dict comes back, so ANY client
    can balance over ANY pool.
    """
    try:
        async with grpc.aio.insecure_channel(f"{host}:{port}") as channel:
            method = channel.unary_unary(
                GET_LOAD, request_serializer=_identity, response_deserializer=_identity
            )
            reply = await asyncio.wait_for(method(b""), timeout=timeout)
            if reply[:1] == b"{":
                return json.loads(reply.decode("utf-8"))
            # The decoder accepts b"" (the legitimate all-defaults
            # encoding an idle proto-wire server sends) and schema-
            # evolved replies, but raises WireError on garbage that
            # proto3 leniency would otherwise decode to the all-zero —
            # i.e. maximally attractive — load (unknown-fields-only
            # buffers).
            try:
                return decode_get_load_result(reply)
            # A garbled load reply is a failed PROBE, not a failed call:
            # None feeds the balancer's "replica unknown" path, which is
            # the loud in-band verdict for this lane.
            except WireError:  # graftlint: disable=wire-loudness -- probe verdict lane
                return None
    except (  # graftlint: disable=wire-loudness -- probe verdict lane (None = failed probe)
        asyncio.TimeoutError,
        grpc.aio.AioRpcError,
        OSError,
        ConnectionError,
        ValueError,  # garbled JSON / undecodable bytes
    ):
        return None


async def get_loads_async(
    hosts_and_ports: Sequence[HostPort], *, timeout: float = 5.0
) -> List[Optional[dict]]:
    """Concurrent load query over the pool (reference: service.py:189-211)."""
    return list(
        await asyncio.gather(
            *(get_load_async(h, p, timeout=timeout) for h, p in hosts_and_ports)
        )
    )


async def get_node_traces_async(
    host: str, port: int, *, timeout: float = 5.0
) -> List[dict]:
    """PULL a node's recent completed span trees over the enriched
    GetLoad lane (request payload ``b"traces"``; server.py get_load)
    and ingest them into the trace-reunion store.  Returns the trees.

    The forensics complement to the reply piggyback: spans whose own
    reply never arrived (the call that wedged or died) are still in
    the node's ring — if the node survives, this fetches them.
    npwire-JSON nodes only; an npproto-wire or unreachable node yields
    ``[]`` (the fixed reference GetLoad schema has no room for traces).
    """
    try:
        async with grpc.aio.insecure_channel(f"{host}:{port}") as channel:
            method = channel.unary_unary(
                GET_LOAD,
                request_serializer=_identity,
                response_deserializer=_identity,
            )
            reply = await asyncio.wait_for(method(b"traces"), timeout=timeout)
            if reply[:1] != b"{":
                return []
            traces = json.loads(reply.decode("utf-8")).get("traces") or []
    except (
        asyncio.TimeoutError,
        grpc.aio.AioRpcError,
        OSError,
        ConnectionError,
        ValueError,
    ):
        return []
    if isinstance(traces, list):
        _reunion.ingest(traces)
        return traces
    return []


def get_node_traces(
    host: str, port: int, *, timeout: float = 5.0
) -> List[dict]:
    """Sync wrapper over :func:`get_node_traces_async`."""
    loop = get_event_loop()
    return loop.run_until_complete(
        get_node_traces_async(host, port, timeout=timeout)
    )


async def get_node_telemetry_async(
    host: str, port: int, *, timeout: float = 5.0
) -> Optional[dict]:
    """PULL a node's full telemetry snapshot over the enriched GetLoad
    lane (request payload ``b"telemetry"``, declared in
    :data:`.wire_registry.GETLOAD_PAYLOADS`; server.py ``get_load``).
    Returns the whole load dict — whose ``"telemetry"`` key carries the
    node's metric families, recent span trees, flight-record tail, and
    wall-clock ``ts`` — or ``None`` if the node is unreachable, slow,
    garbled, or answers without the key (an npproto-wire or
    pre-telemetry node).  The fleet collector
    (:mod:`...telemetry.collector`) is the consumer; unlike
    :func:`get_node_traces_async` nothing is ingested here — the
    collector owns merge/staleness semantics.
    """
    try:
        async with grpc.aio.insecure_channel(f"{host}:{port}") as channel:
            method = channel.unary_unary(
                GET_LOAD,
                request_serializer=_identity,
                response_deserializer=_identity,
            )
            reply = await asyncio.wait_for(
                method(b"telemetry"), timeout=timeout
            )
            if reply[:1] != b"{":
                return None
            load = json.loads(reply.decode("utf-8"))
    except (  # graftlint: disable=wire-loudness -- probe verdict lane (None = failed scrape)
        asyncio.TimeoutError,
        grpc.aio.AioRpcError,
        OSError,
        ConnectionError,
        ValueError,
    ):
        return None
    if not isinstance(load, dict) or not isinstance(
        load.get("telemetry"), dict
    ):
        return None
    return load


def get_node_telemetry(
    host: str, port: int, *, timeout: float = 5.0
) -> Optional[dict]:
    """Sync wrapper over :func:`get_node_telemetry_async`."""
    loop = get_event_loop()
    return loop.run_until_complete(
        get_node_telemetry_async(host, port, timeout=timeout)
    )


@dataclasses.dataclass
class ClientPrivates:
    """Non-picklable per-(client,process,thread,loop) connection state
    (reference: ClientPrivates, service.py:214-263).  ``loop`` records
    the aio loop the channel is bound to, so a cache hit can verify the
    entry really belongs to the currently running loop (id(loop) in the
    cache key can collide after a dead loop's address is recycled)."""

    host: str
    port: int
    channel: grpc.aio.Channel
    stream: Optional[grpc.aio.StreamStreamCall] = None
    loop: Optional[asyncio.AbstractEventLoop] = None
    # Per-connection batch capability: None = not yet probed; {} = the
    # server does not advertise wire batch frames; a dict with
    # "max_batch" = it does (GetLoad "batch" field, server.py).
    batch_caps: Optional[dict] = None

    @staticmethod
    async def connect(host: str, port: int, *, use_stream: bool) -> "ClientPrivates":
        channel = grpc.aio.insecure_channel(f"{host}:{port}")
        privates = ClientPrivates(
            host=host,
            port=port,
            channel=channel,
            loop=asyncio.get_running_loop(),
        )
        if use_stream:
            method = channel.stream_stream(
                EVALUATE_STREAM,
                request_serializer=_identity,
                response_deserializer=_identity,
            )
            privates.stream = method()
        _log.info("connected to %s:%d (stream=%s)", host, port, use_stream)
        return privates

    @staticmethod
    async def connect_balanced(
        hosts_and_ports: Sequence[HostPort],
        *,
        use_stream: bool,
        timeout: float = 5.0,
        desync: Tuple[float, float] = (0.0, 0.05),
    ) -> "ClientPrivates":
        """Pick the least-loaded healthy server
        (reference: connect_balanced, service.py:240-263)."""
        candidates = random.sample(list(hosts_and_ports), k=len(hosts_and_ports))
        # De-sync concurrent clients so they don't all pick the same
        # server (the reference sleeps U[0.2, 2] s; that dominates
        # connect latency, so the window here is 50 ms).
        await asyncio.sleep(random.uniform(*desync))
        loads = await get_loads_async(candidates, timeout=timeout)
        best = argmin_none_or_func(loads, lambda l: l["n_clients"])
        if best is None:
            raise TimeoutError(
                f"none of {len(candidates)} servers responded to GetLoad"
            )
        host, port = candidates[best]
        return await ClientPrivates.connect(host, port, use_stream=use_stream)

    async def close(self) -> None:
        if self.stream is not None:
            try:
                self.stream.cancel()
            except Exception:
                pass
            self.stream = None
        await self.channel.close()


# Module-global cache so client objects survive pickling into worker
# processes and reconnect lazily per process/thread/loop
# (reference: _privates + thread_pid_id, service.py:266-275).
# Keyed by a per-instance token rather than id(obj): CPython recycles
# object addresses, so an id-keyed cache could hand a new client a dead
# client's connection.  The token survives pickling, so a client copied
# into a worker process keys the same logical identity there.
# The key ALSO includes the driving event loop: a grpc.aio channel is
# bound to the loop it was created on, and one thread can legally run
# several loops over its lifetime (sync wrapper's cached loop, then
# asyncio.run(...)) — reusing a channel across loops errors or hangs,
# so each (client, process, thread, loop) owns its own connection.
_privates: Dict[Tuple[str, int, int, int], ClientPrivates] = {}


def thread_pid_id(obj) -> Tuple[str, int, int]:
    token = getattr(obj, "_cache_token", None) or str(id(obj))
    return (token, os.getpid(), threading.get_ident())


def _conn_key(obj) -> Tuple[str, int, int, int]:
    """Full cache key; must be computed inside the driving loop."""
    loop_id = id(asyncio.get_running_loop())
    return (*thread_pid_id(obj), loop_id)


def _cancel_stream(privates: Optional[ClientPrivates]) -> None:
    """Best-effort teardown usable from any context: stream.cancel() is
    loop-safe-ish; channel close must run on its own (possibly dead)
    loop, so the channel is left to GC."""
    if privates is not None and privates.stream is not None:
        try:
            privates.stream.cancel()
        except Exception:
            pass


def _purge_dead_loop_entries() -> None:
    """Evict entries whose loop has closed — each asyncio.run() leaves
    its connections behind, and unbounded entries both leak channels
    and set up id(loop) collisions.  Snapshot keys first (list() is
    C-atomic) so concurrent threads mutating the dict can't break the
    sweep."""
    for cid in list(_privates):
        privates = _privates.get(cid)
        if (
            privates is not None
            and privates.loop is not None
            and privates.loop.is_closed()
        ):
            _privates.pop(cid, None)
            _cancel_stream(privates)


class ArraysToArraysServiceClient:
    """Sync+async evaluation client with balancing and failover
    (reference: ArraysToArraysServiceClient, service.py:326-423)."""

    def __init__(
        self,
        host: Optional[str] = None,
        port: Optional[int] = None,
        *,
        hosts_and_ports: Optional[Sequence[HostPort]] = None,
        use_stream: bool = True,
        retries: int = 2,
        codec: str = "npwire",
    ):
        """``codec``: "npwire" (this package's native framing, default)
        or "npproto" — the REFERENCE's protobuf wire
        (protobufs/service.proto:6-19), letting this client talk to an
        unmodified reference node pool.  Method paths are identical in
        both stacks (``/ArraysToArraysService/...``), so only Evaluate
        payload bytes differ; GetLoad balancing auto-detects the reply
        format and needs no codec choice.
        """
        if codec not in ("npwire", "npproto"):
            raise ValueError(
                f"codec must be 'npwire' or 'npproto', got {codec!r}"
            )
        if hosts_and_ports is None:
            if host is None or port is None:
                raise ValueError("pass host+port or hosts_and_ports")
            hosts_and_ports = [(host, int(port))]
        elif host is not None or port is not None:
            raise ValueError("pass either host+port or hosts_and_ports, not both")
        self.hosts_and_ports: List[HostPort] = [
            (h, int(p)) for h, p in hosts_and_ports
        ]
        self.use_stream = use_stream
        self.retries = retries
        self.codec = codec
        self._cache_token = uuid_mod.uuid4().hex

    # -- connection management -------------------------------------------

    async def _get_privates(self) -> ClientPrivates:
        _purge_dead_loop_entries()
        cid = _conn_key(self)
        privates = _privates.get(cid)
        if privates is not None and privates.loop is not asyncio.get_running_loop():
            # id(loop) collision: a recycled address matched a dead
            # loop's entry.  Never drive that channel from this loop.
            _privates.pop(cid, None)
            _cancel_stream(privates)
            privates = None
        if privates is None:
            privates = await ClientPrivates.connect_balanced(
                self.hosts_and_ports, use_stream=self.use_stream
            )
            _privates[cid] = privates
        return privates

    async def _batch_caps(self, privates: ClientPrivates) -> dict:
        """Read (once per connection) whether the peer advertises wire
        batch frames via its GetLoad ``batch`` field.  A reference
        node answers protobuf GetLoad (no such field) and an
        unreachable/garbled reply degrades to {} — either way the
        client never coalesces toward a peer that did not opt in, which
        is the negotiation contract batch frames depend on."""
        if privates.batch_caps is None:
            caps: dict = {}
            try:
                method = privates.channel.unary_unary(
                    GET_LOAD,
                    request_serializer=_identity,
                    response_deserializer=_identity,
                )
                reply = await asyncio.wait_for(method(b""), timeout=5.0)
                if reply[:1] == b"{":
                    b = json.loads(reply.decode("utf-8")).get("batch")
                    if isinstance(b, dict) and int(b.get("max_batch", 0)) > 1:
                        caps = {"max_batch": int(b["max_batch"])}
            except (
                asyncio.TimeoutError,
                grpc.aio.AioRpcError,
                OSError,
                ConnectionError,
                ValueError,
                TypeError,
            ):
                caps = {}
            privates.batch_caps = caps
        return privates.batch_caps

    async def _drop_privates(self) -> None:
        cid = _conn_key(self)
        privates = _privates.pop(cid, None)
        if privates is not None:
            _DROPS.labels(transport="grpc").inc()
            _flightrec.record(
                "rpc.drop", transport="grpc",
                peer=f"{privates.host}:{privates.port}",
            )
            _log.warning(
                "dropping connection to %s:%d", privates.host, privates.port
            )
            await privates.close()

    def __del__(self):
        # Best-effort stream teardown (reference: service.py:355-365).
        # No loop is running here, so sweep every loop's entry for this
        # (client, process, thread) identity.  Snapshot keys first:
        # other threads may be inserting concurrently, and iterating
        # the live dict from __del__ could raise mid-sweep.
        prefix = thread_pid_id(self)
        for cid in list(_privates):
            if cid[:3] == prefix:
                _cancel_stream(_privates.pop(cid, None))

    # -- evaluation -------------------------------------------------------

    async def _evaluate_once(self, request: bytes) -> bytes:
        privates = await self._get_privates()
        peer = f"{privates.host}:{privates.port}"
        if _fi.active_plan is not None:  # chaos seam (faultinject)
            request = await _fi.filter_bytes_async("grpc.send", request, peer)
        if privates.stream is not None:
            # Lock-step bidi hot loop (reference: _streamed_evaluate,
            # service.py:150-158).
            await _stream_write(privates.stream, request)
            reply = await _stream_read(privates.stream)
            if reply is grpc.aio.EOF:
                raise ConnectionError("stream closed by server")
            if _fi.active_plan is not None:  # chaos seam
                reply = await _fi.filter_bytes_async("grpc.recv", reply, peer)
            return reply
        method = privates.channel.unary_unary(
            EVALUATE, request_serializer=_identity, response_deserializer=_identity
        )
        # The ambient deadline bounds the RPC itself too, via OUR
        # timer rather than grpc's ``timeout=``: grpc.aio's client-side
        # deadline can race into a local cancellation that surfaces as
        # a bare CancelledError instead of DEADLINE_EXCEEDED (observed
        # under the overload chaos lane), while wait_for converts the
        # same cancellation into a deterministic TimeoutError here.
        remaining = _deadline.remaining_s()
        if remaining is None:
            reply = await method(request)
        else:
            try:
                reply = await asyncio.wait_for(
                    method(request), timeout=max(remaining, 1e-3)
                )
            except asyncio.TimeoutError:
                _deadline.DEADLINE_EXPIRED.labels(stage="client").inc()
                raise _deadline.DeadlineExceeded(
                    _deadline.deadline_error("budget spent awaiting reply")
                ) from None
        if _fi.active_plan is not None:  # chaos seam
            reply = await _fi.filter_bytes_async("grpc.recv", reply, peer)
        return reply

    def _encode_request(self, arrays):
        """(request_bytes, uuid, decode) for one call under the active
        codec; ``decode`` returns ``(outputs, uuid, error)``.

        The ACTIVE telemetry trace id (if any) is embedded in the
        request — npwire flag block or npproto field 15 — so the node's
        span tree correlates with the driver's.  npproto field 15 is
        genuinely ignorable by peers that predate it (proto3 skips
        unknown fields; property-tested against the official runtime) —
        use that codec toward reference nodes.  The npwire flag block
        is only understood by this package's own nodes (which ship in
        lockstep with this client); a PRE-telemetry npwire node would
        reject a flagged frame, so toward one either disable telemetry
        or upgrade the node.  With telemetry disabled the request is
        byte-identical to the uninstrumented wire either way.

        Both decoders also harvest the reply's piggybacked node-side
        span trees (npwire flag 4 / npproto field 16) into the trace-
        reunion store (:mod:`..telemetry.reunion`) — how the driver
        gets the other half of a correlated trace."""
        arrays = [np.asarray(a) for a in arrays]
        trace_id = _spans.current_trace_id() if _spans.enabled() else None
        # Deadline propagation: the remaining budget rides the request
        # (npwire flag 16 / npproto field 18); None — the default —
        # keeps the frame byte-identical to the deadline-free wire.
        deadline_s = _deadline.wire_budget()
        if self.codec == "npproto":
            uuid = str(uuid_mod.uuid4())
            request = npproto_codec.encode_arrays_msg(
                arrays, uuid=uuid, trace_id=trace_id,
                deadline_s=deadline_s,
            )

            def decode(reply):
                outputs, ruuid, _tid, spans = (
                    npproto_codec.decode_arrays_msg_all(reply)
                )
                if spans:
                    _reunion.ingest(spans)
                return outputs, ruuid, None

        else:
            uuid = fast_uuid()
            request = encode_arrays(
                arrays, uuid=uuid, trace_id=trace_id,
                deadline_s=deadline_s,
            )

            def decode(reply):
                outputs, ruuid, error, _tid, spans = decode_arrays_all(reply)
                if spans:
                    _reunion.ingest(spans)
                return outputs, ruuid, error

        return request, uuid, decode

    async def _validate_reply(self, reply, uuid, decode):
        """Single-sourced reply validation: returns ``(outputs,
        error_msg)``.  The error check runs FIRST (error replies carry a
        zero uuid); a uuid mismatch — a desynchronized lock-step stream
        (e.g. a previous call cancelled between write and read) stays
        off-by-one forever — drops the connection so the next call
        reconnects cleanly, then raises."""
        # Off-loop when chaos is active: the decoder holds sync
        # byte-lane seams whose delay kinds sleep.
        outputs, reply_uuid, error = await _fi.call_shimmed_async(
            decode, reply
        )
        if error is None and reply_uuid != uuid:
            await self._drop_privates()
            raise RuntimeError(
                "uuid mismatch: response does not correlate with request"
            )
        return outputs, error

    async def evaluate_async(self, *arrays: np.ndarray) -> List[np.ndarray]:
        """Evaluate with retry-and-rebalance failover
        (reference: evaluate_async, service.py:376-423).

        Deterministic server failures do not burn retries: in-band
        error replies (npwire) and non-retryable gRPC status codes
        (npproto compute errors abort the RPC as UNKNOWN) raise
        immediately; only transport trouble rebalances."""
        with _spans.span(
            "rpc.evaluate", transport="grpc", codec=self.codec
        ) as root:
            # The span (entered above) binds the trace id the encode
            # step stamps into the request.
            with _spans.span("encode"):
                # Fail fast on a spent budget BEFORE paying encode or
                # transport: the pool's failover loop re-enters here,
                # so this is also what stops failover once the
                # caller's deadline is gone.
                _deadline.check_remaining("grpc evaluate")
                request, uuid, decode = await _fi.call_shimmed_async(
                    self._encode_request, arrays
                )
            mode = "stream" if self.use_stream else "unary"
            last_exc: Optional[BaseException] = None
            for attempt in range(self.retries + 1):
                if attempt:
                    _RETRIES.labels(transport="grpc").inc()
                    _flightrec.record(
                        "rpc.retry", transport="grpc", attempt=attempt
                    )
                    # A spent budget stops the rebalance loop: the
                    # retry would arrive at a replica only to be shed
                    # at its admission check.
                    _deadline.check_remaining("grpc retry")
                    # Restamp the REMAINING budget: re-sending the
                    # attempt-0 request would advertise the budget as
                    # it stood before the failed attempts burned wall
                    # time, so the replica would admit work whose
                    # caller is closer to giving up than the wire
                    # claims.  (A fresh uuid per attempt is fine: each
                    # attempt is its own RPC, validated against its
                    # own decode closure.)
                    if _deadline.current_deadline() is not None:
                        request, uuid, decode = await _fi.call_shimmed_async(
                            self._encode_request, arrays
                        )
                t0 = time.perf_counter()
                try:
                    with _spans.span("call"):
                        reply = await self._evaluate_once(request)
                except (grpc.aio.AioRpcError, ConnectionError, OSError) as e:
                    last_exc = e
                    await self._drop_privates()
                    if not _is_retryable(e):
                        root.set_attr("error", "server")
                        raise
                    continue
                with _spans.span("decode"):
                    outputs, error = await self._validate_reply(
                        reply, uuid, decode
                    )
                _CALL_S.labels(transport="grpc", mode=mode).observe(
                    time.perf_counter() - t0
                )
                if error is not None:
                    root.set_attr("error", "server")
                    _flightrec.record(
                        "rpc.error", transport="grpc", error=error[:200]
                    )
                    if _deadline.is_deadline_error(error):
                        raise _deadline.DeadlineExceeded(error)
                    raise RuntimeError(f"server error: {error}")
                return outputs
            root.set_attr("error", "transport")
            raise (
                last_exc
                if last_exc is not None
                else ConnectionError("evaluation failed")
            )

    def evaluate(self, *arrays: np.ndarray) -> List[np.ndarray]:
        """Sync wrapper (reference: evaluate, service.py:371-374)."""
        loop = get_event_loop()
        return loop.run_until_complete(self.evaluate_async(*arrays))

    # -- pipelined batch evaluation --------------------------------------

    async def _evaluate_many_once(
        self, encoded, window: int, out: Optional[list] = None
    ) -> List[List[np.ndarray]]:
        """One pipelined pass over the current connection.

        Stream mode: keep up to ``window`` requests in flight on the
        lock-step stream and read replies in order — the server
        guarantees FIFO (one reply per request, in order,
        server.py:evaluate_stream), so client serialize, both network
        legs, and server decode/compute overlap instead of paying the
        full round-trip per call.  Unary mode: ``window``-sized
        ``asyncio.gather`` chunks over HTTP/2 multiplexing.

        A SERVER-SIDE error reply must not poison the stream for later
        calls: the remaining in-flight replies are drained (count-only)
        before the error raises, so the lock-step correlation survives.

        ``out`` (optional, len(encoded) of ``None``) is filled IN
        PLACE as replies validate, so a caller supplying it observes
        the partial results of a pass that died mid-window — the
        replica-pool failover lane (routing/) re-queues exactly the
        still-``None`` tail.
        """
        privates = await self._get_privates()
        peer = f"{privates.host}:{privates.port}"
        n = len(encoded)
        results: List[Optional[List[np.ndarray]]] = (
            out if out is not None else [None] * n
        )
        if privates.stream is None:
            method = privates.channel.unary_unary(
                EVALUATE,
                request_serializer=_identity,
                response_deserializer=_identity,
            )
            for start in range(0, n, window):
                chunk = encoded[start : start + window]
                reqs = [req for req, _u, _d in chunk]
                if _fi.active_plan is not None:  # chaos seam
                    reqs = [
                        await _fi.filter_bytes_async("grpc.send", r, peer)
                        for r in reqs
                    ]
                # return_exceptions: every sibling RPC settles before we
                # raise, so a failing chunk never leaves orphan tasks
                # whose channel _drop_privates then closes under them
                # ("Task exception was never retrieved" spam).
                replies = await asyncio.gather(
                    *(method(req) for req in reqs),
                    return_exceptions=True,
                )
                for reply in replies:
                    if isinstance(reply, BaseException):
                        raise reply
                for k, (reply, (_req, uuid, decode)) in enumerate(
                    zip(replies, chunk)
                ):
                    outputs, error = await self._validate_reply(
                        reply, uuid, decode
                    )
                    if error is not None:
                        if _deadline.is_deadline_error(error):
                            raise _deadline.DeadlineExceeded(error)
                        raise RuntimeError(f"server error: {error}")
                    results[start + k] = outputs
            return results  # type: ignore[return-value]

        stream = privates.stream
        # Flow-control guard: a client that keeps WRITING while never
        # reading can deadlock against HTTP/2 stream windows when the
        # in-flight bytes exceed the transport's credit (client stuck
        # in write -> never reads -> server's replies never drain ->
        # server never reads the next request).  Capping in-flight
        # REQUEST bytes well under the 64 KiB minimum initial stream
        # window keeps every write completable, so the loop always
        # reaches read(); a single oversized request still proceeds
        # alone (the write_idx == read_idx disjunct) in plain lock-step,
        # which is the proven-safe per-call mode.
        max_inflight_bytes = 32 * 1024
        write_idx = read_idx = 0
        inflight_bytes = 0
        try:
            while read_idx < n:
                while write_idx < n and (
                    write_idx == read_idx
                    or (
                        write_idx - read_idx < window
                        and inflight_bytes + len(encoded[write_idx][0])
                        <= max_inflight_bytes
                    )
                ):
                    payload = encoded[write_idx][0]
                    if _fi.active_plan is not None:  # chaos seam
                        payload = await _fi.filter_bytes_async(
                            "grpc.send", payload, peer
                        )
                    await _stream_write(stream, payload)
                    inflight_bytes += len(encoded[write_idx][0])
                    write_idx += 1
                _WINDOW_DEPTH.labels(transport="grpc").observe(
                    write_idx - read_idx
                )
                reply = await _stream_read(stream)
                if reply is grpc.aio.EOF:
                    raise ConnectionError("stream closed by server")
                if _fi.active_plan is not None:  # chaos seam
                    reply = await _fi.filter_bytes_async("grpc.recv", reply, peer)
                _req, uuid, decode = encoded[read_idx]
                inflight_bytes -= len(_req)
                try:
                    outputs, error = await self._validate_reply(
                        reply, uuid, decode
                    )
                except (grpc.aio.AioRpcError, ConnectionError, OSError):
                    raise  # transport trouble: the outer except drops
                except RuntimeError:
                    raise  # uuid mismatch: _validate_reply already dropped
                except BaseException:
                    # Corrupt reply (e.g. WireError) with replies still
                    # in flight: the lock-step correlation cannot be
                    # trusted any more — drop the cached connection so
                    # the NEXT call reconnects cleanly, mirroring the
                    # TCP lane (tcp.py _evaluate_many_once), then let
                    # the decode error surface loudly.
                    await self._drop_privates()
                    raise
                if error is not None:
                    # Drain in-flight replies so the stream stays
                    # correlated for the NEXT call, then surface the
                    # deterministic server error (no retry — same
                    # policy as evaluate_async).
                    for _ in range(write_idx - read_idx - 1):
                        drained = await _stream_read(stream)
                        if drained is grpc.aio.EOF:
                            break
                    if _deadline.is_deadline_error(error):
                        raise _deadline.DeadlineExceeded(error)
                    raise RuntimeError(f"server error: {error}")
                results[read_idx] = outputs
                read_idx += 1
        except (grpc.aio.AioRpcError, ConnectionError, OSError):
            await self._drop_privates()
            raise
        return results  # type: ignore[return-value]

    def _decode_batch_item(self, item: bytes):
        """Decode one reply item out of a wire batch frame under the
        active codec -> (outputs, uuid, error); piggybacked node spans
        are harvested like any reply's."""
        if self.codec == "npproto":
            outputs, ruuid, error, _tid, spans = (
                npproto_codec.decode_arrays_msg_full(item)
            )
        else:
            outputs, ruuid, error, _tid, spans = decode_arrays_all(item)
        if spans:
            _reunion.ingest(spans)
        return outputs, ruuid, error

    def _encode_batch_frame(self, part, trace_id):
        """One outer batch frame for a window slice of encoded
        requests -> (frame_bytes, outer_uuid)."""
        deadline_s = _deadline.wire_budget()
        if self.codec == "npproto":
            outer_uuid = str(uuid_mod.uuid4())
            frame = npproto_codec.encode_batch_msg(
                [req for req, _u, _d in part],
                uuid=outer_uuid,
                trace_id=trace_id,
                deadline_s=deadline_s,
            )
        else:
            outer_uuid = fast_uuid()
            frame = encode_batch(
                [req for req, _u, _d in part],
                uuid=outer_uuid,
                trace_id=trace_id,
                deadline_s=deadline_s,
            )
        return frame, outer_uuid

    def _decode_batch_frame(self, reply: bytes):
        """Outer batch reply -> (items, outer_uuid, outer_error);
        outer spans (the node's whole-window tree) are harvested."""
        if self.codec == "npproto":
            items, ruuid, _tid, spans = npproto_codec.decode_batch_msg(
                reply
            )
            error = None
        else:
            items, ruuid, error, _tid, spans = decode_batch(reply)
        if spans:
            _reunion.ingest(spans)
        return items, ruuid, error

    async def _evaluate_many_batched_once(
        self, encoded, window: int, max_batch: int,
        out: Optional[list] = None,
    ) -> List[List[np.ndarray]]:
        """One pipelined pass using WIRE BATCH FRAMES: the window is
        packed ``min(window, max_batch)`` requests per frame, so K
        requests pay one transport message, one server decode loop and
        one (vmapped) dispatch per frame instead of per call.  Frames
        pipeline on the stream under the same in-flight byte cap as
        the unbatched path; per-item uuids still correlate inside each
        frame and the outer uuid correlates the frame itself.  Error
        semantics match the unbatched pass: the first item error
        drains the in-flight frames and raises without retry.
        ``out`` is the same in-place partial-results channel as
        :meth:`_evaluate_many_once` (frame-granular here: a frame's
        items land together when its reply validates)."""
        privates = await self._get_privates()
        peer = f"{privates.host}:{privates.port}"
        n = len(encoded)
        chunk = max(1, min(window, max_batch))
        trace_id = _spans.current_trace_id() if _spans.enabled() else None
        frames = []  # (frame_bytes, outer_uuid, start, part)
        for start in range(0, n, chunk):
            part = encoded[start : start + chunk]
            frame, outer_uuid = await _fi.call_shimmed_async(
                self._encode_batch_frame, part, trace_id
            )
            _FRAME_REQS.labels(transport="grpc").observe(len(part))
            frames.append((frame, outer_uuid, start, part))
        results: List[Optional[List[np.ndarray]]] = (
            out if out is not None else [None] * n
        )

        async def consume(reply, frame_idx, *, inflight_after: int):
            """Validate one outer reply; fills results or raises.
            ``inflight_after`` = frames still undrained after this one
            (for the error-drain path)."""
            _frame, outer_uuid, start, part = frames[frame_idx]
            try:
                items, ruuid, outer_error = await _fi.call_shimmed_async(
                    self._decode_batch_frame, reply
                )
            except (grpc.aio.AioRpcError, ConnectionError, OSError):
                raise
            except BaseException:
                # Corrupt reply mid-pipeline: correlation is gone —
                # drop so the NEXT call reconnects cleanly (same
                # posture as the unbatched pass).
                await self._drop_privates()
                raise
            # Outer error FIRST: an outer-level batch failure is
            # encoded with a zeroed uuid (server.py / cpp_node), so
            # checking correlation first would mask the real error as
            # a phantom uuid mismatch.
            if outer_error is not None:
                await self._drain_frames(inflight_after)
                if _deadline.is_deadline_error(outer_error):
                    raise _deadline.DeadlineExceeded(outer_error)
                raise RuntimeError(f"server error: {outer_error}")
            if ruuid != outer_uuid:
                await self._drop_privates()
                raise RuntimeError(
                    "uuid mismatch: batch reply does not correlate "
                    "with its frame"
                )
            if len(items) != len(part):
                await self._drop_privates()
                raise RuntimeError(
                    f"batch reply carries {len(items)} items for a "
                    f"{len(part)}-request frame"
                )
            for j, (item, (_req, uuid, _dec)) in enumerate(
                zip(items, part)
            ):
                try:
                    outputs, ruuid_j, error_j = await _fi.call_shimmed_async(
                        self._decode_batch_item, item
                    )
                except (grpc.aio.AioRpcError, ConnectionError, OSError):
                    raise
                except BaseException:
                    # Corrupt nested item with frames still in flight:
                    # the stream's undrained replies would poison the
                    # NEXT call — drop, like the unbatched pass does
                    # for a corrupt reply.
                    await self._drop_privates()
                    raise
                if error_j is not None:
                    await self._drain_frames(inflight_after)
                    if _deadline.is_deadline_error(error_j):
                        raise _deadline.DeadlineExceeded(error_j)
                    raise RuntimeError(f"server error: {error_j}")
                if ruuid_j != uuid:
                    await self._drop_privates()
                    raise RuntimeError(
                        "uuid mismatch: batch item does not correlate "
                        "with its request"
                    )
                results[start + j] = outputs

        if privates.stream is None:
            method = privates.channel.unary_unary(
                EVALUATE,
                request_serializer=_identity,
                response_deserializer=_identity,
            )
            # Bounded like the unbatched unary pass: ~window REQUESTS
            # in flight, i.e. window//chunk frames per gather — a huge
            # request list must not explode into thousands of
            # simultaneous RPCs just because frames are big.
            frames_per_gather = max(1, window // chunk)
            for start_f in range(0, len(frames), frames_per_gather):
                part_f = frames[start_f : start_f + frames_per_gather]
                payloads = [frame for frame, _u, _s, _p in part_f]
                if _fi.active_plan is not None:  # chaos seam
                    payloads = [
                        await _fi.filter_bytes_async("grpc.send", p, peer)
                        for p in payloads
                    ]
                replies = await asyncio.gather(
                    *(method(frame) for frame in payloads),
                    return_exceptions=True,
                )
                for reply in replies:
                    if isinstance(reply, BaseException):
                        raise reply
                for k, reply in enumerate(replies):
                    await consume(reply, start_f + k, inflight_after=0)
            return results  # type: ignore[return-value]

        stream = privates.stream
        # Same flow-control geometry as the unbatched pass: cap
        # in-flight frame bytes under the HTTP/2 stream window, with
        # the lone-frame disjunct for oversized frames.
        max_inflight_bytes = 32 * 1024
        nf = len(frames)
        write_idx = read_idx = 0
        inflight_bytes = 0
        try:
            while read_idx < nf:
                while write_idx < nf and (
                    write_idx == read_idx
                    or inflight_bytes + len(frames[write_idx][0])
                    <= max_inflight_bytes
                ):
                    payload = frames[write_idx][0]
                    if _fi.active_plan is not None:  # chaos seam
                        payload = await _fi.filter_bytes_async(
                            "grpc.send", payload, peer
                        )
                    await _stream_write(stream, payload)
                    inflight_bytes += len(frames[write_idx][0])
                    write_idx += 1
                _WINDOW_DEPTH.labels(transport="grpc").observe(
                    write_idx - read_idx
                )
                reply = await _stream_read(stream)
                if reply is grpc.aio.EOF:
                    raise ConnectionError("stream closed by server")
                if _fi.active_plan is not None:  # chaos seam
                    reply = await _fi.filter_bytes_async("grpc.recv", reply, peer)
                inflight_bytes -= len(frames[read_idx][0])
                await consume(
                    reply,
                    read_idx,
                    inflight_after=write_idx - read_idx - 1,
                )
                read_idx += 1
        except (grpc.aio.AioRpcError, ConnectionError, OSError):
            await self._drop_privates()
            raise
        return results  # type: ignore[return-value]

    async def _drain_frames(self, n_frames: int) -> None:
        """Count-only drain of in-flight stream replies so the
        lock-step correlation survives a deterministic server error
        (mirror of the unbatched drain)."""
        if n_frames <= 0:
            return
        privates = await self._get_privates()
        if privates.stream is None:
            return
        for _ in range(n_frames):
            drained = await _stream_read(privates.stream)
            if drained is grpc.aio.EOF:
                break

    async def evaluate_many_async(
        self,
        requests: Sequence[Sequence[np.ndarray]],
        *,
        window: int = 8,
        batch: object = "auto",
    ) -> List[List[np.ndarray]]:
        """Pipelined evaluation of MANY argument tuples on one node.

        The reference's stream protocol is strictly one-in-flight
        (lock-step write/read per call, reference: service.py:150-158),
        which prices every call at a full round-trip.  The wire itself
        is FIFO, so this client keeps ``window`` requests in flight and
        overlaps the pipeline stages — a throughput mode the
        reference's design cannot express (the JAX package measured
        1.7-3x the per-call rate on the localhost lane).

        ``batch``: "auto" (default) additionally packs the window into
        WIRE BATCH FRAMES — ``min(window, server max_batch)`` requests
        per transport message — when the connected server advertises
        the capability in its GetLoad reply, so the whole window pays
        one encode/decode and one syscall each way and the server can
        execute it as one vmapped call (on a node over the kernel: one
        kernel launch).  ``False`` forces the plain pipelined
        pass (per-call frames); ``True`` requires batch support and
        raises if the server does not advertise it.  Reference-wire
        peers never advertise, so "auto" degrades to the plain pass —
        a reference runtime never sees a batch frame.

        All-or-nothing TRANSPORT failover: on connection failure the
        whole batch retries on a freshly balanced connection
        (per-result partial retry would reorder effects on a stateful
        node).  Server-side compute errors raise without retry, like
        :meth:`evaluate_async`, and leave the connection usable: as
        in-band error replies with ``codec="npwire"``, and as
        non-retryable gRPC status aborts with ``codec="npproto"`` (the
        reference schema has no error field, so the server re-raises
        into the RPC layer — classified by status code here so a
        deterministic compute error is NOT re-executed retries+1
        times; npproto stream aborts do tear down that connection).
        In batched mode both codecs carry per-item in-band errors
        (npwire item error block / npproto field 14), same no-retry
        raise.
        """
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        # Identity checks, not equality: 0/1 would pass an `in` test
        # (0 == False) yet route down the WRONG branch below, so they
        # are rejected outright.
        if batch != "auto" and batch is not True and batch is not False:
            raise ValueError(
                f"batch must be 'auto', True or False, got {batch!r}"
            )
        with _spans.span(
            "rpc.evaluate_many",
            transport="grpc",
            n=len(requests),
            window=window,
        ) as root:
            with _spans.span("encode"):
                encoded = await _fi.call_shimmed_async(
                    lambda: [
                        self._encode_request(args) for args in requests
                    ]
                )
            if not encoded:
                return []
            t0 = time.perf_counter()
            last_exc: Optional[BaseException] = None
            for attempt in range(self.retries + 1):
                if attempt:
                    _RETRIES.labels(transport="grpc").inc()
                    _flightrec.record(
                        "rpc.retry", transport="grpc", attempt=attempt,
                        batch=len(encoded),
                    )
                try:
                    # Capability is per CONNECTION (a retry may land on
                    # a different pool member): read it after connect,
                    # before deciding how to pack the window.
                    max_batch = 0
                    if batch is not False:
                        privates = await self._get_privates()
                        caps = await self._batch_caps(privates)
                        max_batch = int(caps.get("max_batch", 0))
                        if batch is True and max_batch < 2:
                            raise RuntimeError(
                                f"server {privates.host}:{privates.port} "
                                "does not advertise wire batch frames "
                                "(GetLoad carries no usable 'batch' field)"
                            )
                    # Known wedge point: an HTTP/2 batch
                    # window can deadlock against flow control — armed
                    # so a hang leaves an incident bundle, not a blank.
                    with _watchdog.armed(
                        "grpc.batch_window",
                        n=len(encoded), window=window,
                    ):
                        if max_batch >= 2:
                            root.set_attr("batched", True)
                            results = await self._evaluate_many_batched_once(
                                encoded, window, max_batch
                            )
                        else:
                            results = await self._evaluate_many_once(
                                encoded, window
                            )
                except (grpc.aio.AioRpcError, ConnectionError, OSError) as e:
                    last_exc = e
                    await self._drop_privates()
                    if not _is_retryable(e):
                        raise
                    continue
                _BATCH_S.labels(transport="grpc").observe(
                    time.perf_counter() - t0
                )
                return results
            raise (
                last_exc
                if last_exc is not None
                else ConnectionError("batch evaluation failed")
            )

    def evaluate_many(
        self,
        requests: Sequence[Sequence[np.ndarray]],
        *,
        window: int = 8,
        batch: object = "auto",
    ) -> List[List[np.ndarray]]:
        """Sync wrapper over :meth:`evaluate_many_async`."""
        loop = get_event_loop()
        return loop.run_until_complete(
            self.evaluate_many_async(requests, window=window, batch=batch)
        )

    async def evaluate_many_partial_async(
        self,
        requests: Sequence[Sequence[np.ndarray]],
        *,
        window: int = 8,
        batch: object = "auto",
    ) -> Tuple[List[Optional[List[np.ndarray]]], Optional[BaseException]]:
        """ONE pipelined pass with no internal retry, surfacing partial
        progress: returns ``(results, transport_exc)`` where
        ``results`` holds each request's outputs in order with ``None``
        for every request whose reply never arrived, and
        ``transport_exc`` is the connection failure that ended the
        pass (``None`` on a complete pass).

        This is the failover primitive the replica pool
        (:mod:`pytensor_federated_torch.routing`) builds on: the caller
        re-queues exactly the ``None`` tail onto another replica
        instead of re-running the whole batch (the all-or-nothing
        contract :meth:`evaluate_many_async` keeps for single-node
        callers).  Batch-frame packing, the in-flight byte cap, and
        the capability negotiation all behave exactly as in
        :meth:`evaluate_many_async`; deterministic server errors
        (in-band error replies, non-retryable status codes, corrupt
        frames) RAISE instead of being returned — the same inputs
        would fail identically on any replica, so failover must not
        swallow them.
        """
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        if batch != "auto" and batch is not True and batch is not False:
            raise ValueError(
                f"batch must be 'auto', True or False, got {batch!r}"
            )
        with _spans.span(
            "rpc.evaluate_many",
            transport="grpc",
            n=len(requests),
            window=window,
            partial=True,
        ):
            with _spans.span("encode"):
                encoded = await _fi.call_shimmed_async(
                    lambda: [
                        self._encode_request(args) for args in requests
                    ]
                )
            if not encoded:
                return [], None
            out: List[Optional[List[np.ndarray]]] = [None] * len(encoded)
            t0 = time.perf_counter()
            try:
                max_batch = 0
                if batch is not False:
                    privates = await self._get_privates()
                    caps = await self._batch_caps(privates)
                    max_batch = int(caps.get("max_batch", 0))
                    if batch is True and max_batch < 2:
                        raise RuntimeError(
                            f"server {privates.host}:{privates.port} "
                            "does not advertise wire batch frames "
                            "(GetLoad carries no usable 'batch' field)"
                        )
                with _watchdog.armed(
                    "grpc.batch_window", n=len(encoded), window=window
                ):
                    if max_batch >= 2:
                        await self._evaluate_many_batched_once(
                            encoded, window, max_batch, out=out
                        )
                    else:
                        await self._evaluate_many_once(
                            encoded, window, out=out
                        )
            except (grpc.aio.AioRpcError, ConnectionError, OSError) as e:
                # Drop the connection (idempotent when the *_once pass
                # already did) and classify like the retry loop does —
                # only transport trouble is failover-worthy.
                await self._drop_privates()
                if not _is_retryable(e):
                    raise
                return out, e
            _BATCH_S.labels(transport="grpc").observe(
                time.perf_counter() - t0
            )
            return out, None

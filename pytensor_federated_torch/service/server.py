"""A node's compute on its device, and the gRPC service that serves it.

Port of the JAX package's ``service/server.py``:

- :func:`device_compute_fn` adapts a torch function on a device (a GPU,
  where the node's private data live) to the numpy compute contract
  that every transport serves (:func:`.tcp.serve_tcp_once`,
  :func:`.shm.serve_shm`, :func:`.ring.serve_ring`, and the service
  below).
- :class:`ArraysToArraysService` is the reference's generic "arrays in
  -> arrays out" core over gRPC (grpc.aio with raw-bytes methods): unary
  ``Evaluate``, the lock-step bidi ``EvaluateStream`` and the ``GetLoad``
  control-plane query, on either wire (npwire or the reference's
  protobuf, detected per request).  Compute runs in a thread executor,
  or coalesced by the :class:`.batching.MicroBatcher` when the compute
  has a vectorized ``.batch`` variant, so a window of requests on a
  CUDA node is one chain-batched kernel launch.  Admission control,
  deadline shedding and graceful drain as in the JAX package.
- :func:`serve` / :func:`run_node` start a node.

``grpc`` is imported at the first gRPC use, not with this module
(:mod:`._grpc`): :func:`device_compute_fn` works on a host without
``grpcio``.
"""

from __future__ import annotations

import asyncio
import json
import logging
import math
import time
from typing import Any, Callable, List, Optional, Sequence

import numpy as np
import torch

from ..faultinject import runtime as _fi
from ..signatures import ComputeFn
from ..telemetry import flightrec as _flightrec
from ..telemetry import spans as _spans
from ..utils import resolve_device
from . import deadline as _deadline
from . import npproto_codec
from ._grpc import grpc
from .batching import MicroBatcher, batched_compute_fn
from .npwire import (
    MAGIC,
    WireError,
    append_spans,
    decode_arrays_ex,
    decode_batch,
    encode_arrays,
    encode_batch,
    frame_uuid,
    is_batch_frame,
    peek_deadline,
    peek_partition,
)

_log = logging.getLogger(__name__)

# Node-side RPC instrumentation.
# Declared at import time in the shared ``_node_metrics`` module — the
# TCP/shm template nodes record into the SAME families, so every lane
# aggregates in the fleet view; every mutator is a no-op while
# telemetry is disabled, so an uninstrumented deployment pays one
# branch per call.
from ._node_metrics import (
    ADMISSION_SHED as _ADMISSION_SHED,
    COMPUTE_S as _COMPUTE_S,
    DECODE_S as _DECODE_S,
    ENCODE_S as _ENCODE_S,
    ERRORS as _ERRORS,
    INFLIGHT as _INFLIGHT,
    QUEUE_S as _QUEUE_S,
    REQUESTS as _REQUESTS,
)

SERVICE_NAME = "ArraysToArraysService"
EVALUATE = f"/{SERVICE_NAME}/Evaluate"
EVALUATE_STREAM = f"/{SERVICE_NAME}/EvaluateStream"
GET_LOAD = f"/{SERVICE_NAME}/GetLoad"

_identity = lambda b: b  # noqa: E731  (raw-bytes (de)serializer)


async def _fi_reply_filter(reply: bytes, context, *, unary: bool = False) -> tuple:
    """``grpc.server.reply`` chaos seam -> ``(reply_bytes, n_copies)``.

    Async on purpose: delay/stall are awaited so a chaos-slowed reply
    behaves like a genuinely slow node (GetLoad and sibling streams
    keep serving).  ``drop``/``disconnect`` abort the RPC with
    UNAVAILABLE — the transient classification, so a pooled client
    fails over instead of burning a no-retry error.  ``duplicate_reply``
    returns ``n_copies=2`` for the stream lane to yield twice; on the
    unary lane (one reply per RPC by construction) it is a plan-
    authoring bug and raises, rather than booking a fire that injected
    nothing."""
    rule = _fi.decide("grpc.server.reply")
    if rule is None:
        return reply, 1
    kind = rule.kind
    if kind in ("delay", "stall"):
        await asyncio.sleep(rule.delay_s if kind == "delay" else rule.stall_s)
        return reply, 1
    if kind in ("drop", "disconnect"):
        if context is not None:
            await context.abort(
                grpc.StatusCode.UNAVAILABLE,
                f"faultinject[{kind}]: reply withheld",
            )
        raise ConnectionError(f"faultinject[{kind}] at grpc.server.reply")
    if kind == "duplicate_reply":
        if unary:
            raise _fi.FaultPlanError(
                "duplicate_reply cannot be expressed on the unary lane"
            )
        return reply, 2
    # truncate_frame / corrupt_bytes / kill_process share the byte-lane
    # semantics (an inapplicable kind raises FaultPlanError, loudly);
    # transform_bytes is the sleep-free half, safe on the loop.
    return _fi.transform_bytes(rule, reply, "grpc.server.reply"), 1


def _to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if not a.flags.writeable:  # a zero-copy request view
        a = a.copy()
    return torch.from_numpy(a).to(device)


def device_compute_fn(
    fn: ComputeFn,
    *,
    device: Any = None,
    batched: bool = False,
    max_batch: int = 32,
) -> Callable:
    """Adapt a torch function into the host compute contract.

    Inputs arrive as numpy and are moved to ``device`` (``None``:
    ``cuda``, raising when there is none — a node never carries on
    quietly on the CPU; pass ``device="cpu"`` to mean the CPU); ``fn``
    runs there and its outputs return as numpy.

    ``batched=True`` additionally attaches a ``.batch`` attribute — a
    ``torch.func.vmap``-vectorized variant on the same device
    (:func:`.batching.batched_compute_fn`) — which executes a window of
    same-signature requests as ONE call instead of K.  ``max_batch``
    bounds the padded-bucket ladder.
    """
    dev = resolve_device(device)

    def compute(*arrays: np.ndarray) -> List[np.ndarray]:
        out = fn(*(_to_device(a, dev) for a in arrays))
        return [
            o.detach().cpu().numpy() if torch.is_tensor(o) else np.asarray(o)
            for o in out
        ]

    compute.device = dev
    if batched:
        compute.batch = batched_compute_fn(fn, device=dev, max_batch=max_batch)
    return compute


class ArraysToArraysService:
    """The gRPC service implementation (reference: service.py:75-115).

    ``compute_fn`` takes/returns NumPy arrays.  Three methods, same
    contract as the reference schema (reference: service.proto:6-19):
    unary ``Evaluate``, lock-step bidi ``EvaluateStream``, and the
    ``GetLoad`` control-plane query.
    """

    def __init__(
        self,
        compute_fn: Callable[..., Sequence[np.ndarray]],
        *,
        getload_wire: str = "npwire",
        inline_compute: bool = False,
        ship_spans: bool = True,
        max_batch: int = 32,
        max_wait_us: float = 200.0,
        batch_fn: Optional[Callable] = None,
        max_queue: Optional[int] = None,
        max_inflight_bytes: Optional[int] = None,
    ):
        """``getload_wire``: "npwire" (JSON reply, this package's
        native clients) or "npproto" (reference ``GetLoadResult``
        protobuf, for serving unmodified reference clients).  Evaluate
        and the stream need no such switch — their request payload
        identifies the wire and the reply mirrors it — but GetLoad's
        request is EMPTY in both schemas, so the reply format is a
        node-level choice.

        ``inline_compute``: run ``compute_fn`` directly on the event
        loop instead of in a thread executor.  The executor exists so
        a SLOW compute cannot stall GetLoad and other streams (the
        reference pays the same structure via its event loop +
        ``run_in_executor``-free design, but it is single-stream); for
        a sub-millisecond compute the two thread handoffs cost more
        than the compute (the JAX package measured ~1.4x sync-client
        and up to ~2x async-client round-trip throughput on the
        localhost lane) — so nodes serving fast evaluations should
        pass True.  A compute that blocks for
        long stretches must keep the default.

        ``ship_spans``: piggyback this node's completed span tree on
        each reply whose request carried a trace id (npwire flag 4 /
        npproto field 16), so the driver reunites both halves of the
        trace (:mod:`..telemetry.reunion`).  Costs a few hundred bytes
        of JSON per traced reply; False keeps replies span-free (the
        driver can still pull via GetLoad ``b"traces"``).

        ``max_batch``/``max_wait_us``: the micro-batching engine
        (:mod:`.batching`).  Requests that arrive while a device call
        is in flight — concurrent RPCs, concurrent streams, or the K
        items of one wire batch frame — coalesce and execute together
        as one ``torch.func.vmap``-batched call (on a node over the
        kernel: one kernel launch) when the compute exposes a
        vectorized variant (``batch_fn`` here, or the ``.batch``
        attribute ``device_compute_fn(..., batched=True)`` attaches).
        A lone request on an idle node dispatches immediately (zero
        added latency); ``max_wait_us`` is only ever paid while the
        queue is non-empty.  The coalescing queue serializes dispatch
        (that is what creates the batches), so it only ENGAGES where
        that trade wins: a vectorized compute, or an inline (sub-ms)
        one.  A slow executor-mode compute WITHOUT a vectorized
        variant keeps the classic per-request executor concurrency —
        wire batch frames are still served (decoded once, executed
        concurrently, replied as one frame) and the capability is
        still advertised, since the frame itself is a transport win
        regardless.  ``max_batch=1`` disables batch frames and the
        engine entirely.

        ``max_queue``/``max_inflight_bytes``: ADMISSION CONTROL — the
        overload-protection half of the node.  ``max_queue``
        bounds the node's backlog (the larger of in-flight RPCs and
        the micro-batcher's coalescing queue — a queued request is
        also an in-flight RPC, counted once); ``max_inflight_bytes``
        bounds the request bytes being served at once.  A full node
        first sheds queued work whose deadline is already spent
        (oldest-past-deadline first — those callers stopped waiting,
        so computing them is pure load), then refuses the NEW request
        with a retryable UNAVAILABLE so pinned clients rebalance and
        pools fail over, composing with the graceful-drain rejection
        below.  ``None`` (the default) keeps the historical unbounded
        queues."""
        if getload_wire not in ("npwire", "npproto"):
            raise ValueError(
                f"getload_wire must be 'npwire' or 'npproto', "
                f"got {getload_wire!r}"
            )
        self.getload_wire = getload_wire
        self.inline_compute = bool(inline_compute)
        self.ship_spans = bool(ship_spans)
        self.compute_fn = compute_fn
        self.max_batch = int(max_batch)
        batch_fn = batch_fn or getattr(compute_fn, "batch", None)
        self._batcher: Optional[MicroBatcher] = None
        if max_batch > 1 and (batch_fn is not None or inline_compute):
            self._batcher = MicroBatcher(
                compute_fn,
                batch_fn,
                max_batch=max_batch,
                max_wait_us=max_wait_us,
                inline=inline_compute,
            )
        self._n_clients = 0
        # Graceful-drain state: while draining, NEW work is rejected
        # with a retryable UNAVAILABLE (the pool fails over cleanly)
        # and :meth:`drain` waits for in-flight work to settle.
        self._draining = False
        self._inflight_rpcs = 0
        # Admission-control state (constructor docstring).
        self.max_queue = None if max_queue is None else int(max_queue)
        self.max_inflight_bytes = (
            None if max_inflight_bytes is None else int(max_inflight_bytes)
        )
        self._inflight_bytes = 0
        # Start psutil's interval-based CPU accounting early so the
        # first real query is meaningful (reference: service.py:84-85).
        try:
            import psutil

            psutil.cpu_percent()
        except Exception:
            pass

    # -- compute plumbing -------------------------------------------------

    async def _run_compute(self, request: bytes) -> bytes:
        """Deadline admission, then dispatch (:meth:`_run_compute_inner`).

        The request's remaining-budget field (npwire flag 16 / npproto
        field 18, :mod:`.deadline`) is peeked BEFORE any decode cost:
        an expired budget is answered with the in-band deadline
        classification (npwire) or raised as
        :class:`~.deadline.DeadlineExceeded` (npproto — the caller
        aborts the RPC as DEADLINE_EXCEEDED, the status the reference
        schema's error-field-free wire must use); a live one is bound
        as the handler's ambient deadline so the micro-batcher queue
        and the compute handoff inherit it."""
        is_npwire = request[:4] == MAGIC
        try:
            budget = (
                peek_deadline(request)
                if is_npwire
                else npproto_codec.peek_deadline_msg(request)
            )
        except WireError:
            budget = None  # the codec path below rejects it loudly
        err = _deadline.shed_expired_admission(budget, transport="grpc")
        if err is not None:
            if not is_npwire:
                raise _deadline.DeadlineExceeded(err)
            uid = frame_uuid(request)
            # call_shimmed_async: the encoders hold sync chaos
            # seams whose delay kinds sleep (never on the event loop).
            if is_batch_frame(request):
                return await _fi.call_shimmed_async(
                    encode_batch, [], uuid=uid, error=err
                )
            return await _fi.call_shimmed_async(
                encode_arrays, [], uuid=uid, error=err
            )
        with _deadline.budget_scope(budget):
            return await self._run_compute_inner(request)

    async def _run_compute_inner(self, request: bytes) -> bytes:
        """decode -> compute (in executor) -> encode, echoing the uuid.

        Errors are encoded into the reply instead of tearing down the
        stream (reference: _run_compute_func, service.py:45-72).

        WIRE AUTO-DETECTION: a request starting with the npwire magic
        is npwire (this package's native client); anything else is
        decoded as the reference's protobuf ``InputArrays``
        (npproto_codec — an npwire frame can never parse as proto:
        ``N`` = tag with illegal wire type 6, and a proto payload can
        never carry the magic).  The reply uses the SAME format, so an
        unmodified reference client gets reference-wire replies.  The
        reference schema has NO error field — its server re-raises into
        the gRPC layer (reference: service.py:45-72) — so npproto
        decode/compute errors raise here too and surface to the peer as
        a gRPC error, exactly what a reference client expects.
        """
        t_arrive = time.perf_counter()
        is_npwire = request[:4] == MAGIC
        # Wire batch frames (npwire flag bit 8 / npproto field 17): one
        # message carrying a whole pipelined window; handled on their
        # own path so error isolation stays per item.
        if is_npwire and is_batch_frame(request):
            return await self._run_batch_npwire(request, t_arrive)
        if not is_npwire and npproto_codec.has_batch_items(request):
            return await self._run_batch_npproto(request, t_arrive)
        trace_id = None
        # Codec calls go through _fi.call_shimmed_async: the codecs
        # hold sync byte-lane chaos seams whose delay kinds sleep, so
        # with a fault plan active they run in the executor instead of
        # on the loop (a blocking sleep on the event loop).
        if is_npwire:
            try:
                inputs, uuid, _, trace_id = await _fi.call_shimmed_async(
                    decode_arrays_ex, request
                )
            except Exception as e:
                _ERRORS.labels(kind="decode").inc()
                _flightrec.record(
                    "server.error", stage="decode", wire="npwire",
                    error=str(e)[:200],
                )
                return await _fi.call_shimmed_async(
                    encode_arrays,
                    [], uuid=b"\0" * 16, error=f"decode error: {e}",
                )
        else:
            try:
                inputs, proto_uuid, trace_id = await _fi.call_shimmed_async(
                    npproto_codec.decode_arrays_msg_ex, request
                )
            except Exception as e:
                _ERRORS.labels(kind="decode").inc()
                _flightrec.record(
                    "server.error", stage="decode", wire="npproto",
                    error=str(e)[:200],
                )
                raise
        t_decoded = time.perf_counter()
        _DECODE_S.observe(t_decoded - t_arrive)
        # Adopt the DRIVER's trace id off the wire (None is a no-op):
        # the node-side span tree lands in this process's telemetry
        # under the same 16-byte id as the driver-side tree.  The reply
        # is BUILT inside the span (encode is a timed stage) and the
        # finished tree attached after the span closes — the tree's
        # duration only exists then (npwire.append_spans docstring).
        with _spans.trace_context(trace_id), _spans.span(
            "node.evaluate",
            wire="npwire" if is_npwire else "npproto",
            n_inputs=len(inputs),
        ) as root:
            root.set_attr("decode_s", t_decoded - t_arrive)
            err_reply = None
            try:
                with _spans.span("compute") as c_span:
                    if _fi.active_plan is not None:  # chaos seam
                        await _fi.compute_filter_async()
                    if self._batcher is not None:
                        # Micro-batching engine: this request coalesces
                        # with any concurrently in-flight siblings (the
                        # batcher records queue-wait/compute metrics).
                        outputs = await self._batcher.submit(inputs)
                        c_span.set_attr(
                            "queue_depth", self._batcher.queue_depth
                        )
                    elif self.inline_compute:
                        # Fast-compute path: the two thread handoffs of
                        # the executor dominate a sub-ms compute
                        # (see the constructor docstring).
                        t_c0 = time.perf_counter()
                        outputs = list(self.compute_fn(*inputs))
                        t_c1 = time.perf_counter()
                        queue_wait = max(0.0, t_c0 - t_decoded)
                        _QUEUE_S.observe(queue_wait)
                        _COMPUTE_S.observe(t_c1 - t_c0)
                        c_span.set_attr("queue_wait_s", queue_wait)
                    else:
                        loop = asyncio.get_running_loop()

                        def timed_compute():
                            t0 = time.perf_counter()
                            out = list(self.compute_fn(*inputs))
                            return out, t0, time.perf_counter()

                        outputs, t_c0, t_c1 = await loop.run_in_executor(
                            None, timed_compute
                        )
                        queue_wait = max(0.0, t_c0 - t_decoded)
                        _QUEUE_S.observe(queue_wait)
                        _COMPUTE_S.observe(t_c1 - t_c0)
                        c_span.set_attr("queue_wait_s", queue_wait)
                    outputs = [np.asarray(o) for o in outputs]
            except _deadline.DeadlineExceeded as e:
                # Shed, not failed: the batcher (or a nested client)
                # abandoned work whose budget was spent — answer with
                # the bare deadline classification (no "compute error"
                # wrap, no traceback noise); npproto aborts the RPC as
                # DEADLINE_EXCEEDED via the handler's catch.
                if not is_npwire:
                    raise
                err_reply = await _fi.call_shimmed_async(
                    encode_arrays, [], uuid=uuid, error=str(e)
                )
            except Exception as e:
                _log.exception("compute_fn failed")
                _ERRORS.labels(kind="compute").inc()
                _flightrec.record(
                    "server.error", stage="compute",
                    wire="npwire" if is_npwire else "npproto",
                    error=str(e)[:200],
                )
                if not is_npwire:
                    raise
                err_reply = await _fi.call_shimmed_async(
                    encode_arrays,
                    [], uuid=uuid, error=f"compute error: {e}",
                )
            if err_reply is not None:
                reply = err_reply
            else:
                with _spans.span("encode"):
                    t_e0 = time.perf_counter()
                    if is_npwire:
                        reply = await _fi.call_shimmed_async(
                            encode_arrays, outputs, uuid=uuid
                        )
                    else:
                        reply = await _fi.call_shimmed_async(
                            npproto_codec.encode_arrays_msg,
                            outputs, uuid=proto_uuid,
                        )
                    _ENCODE_S.observe(time.perf_counter() - t_e0)
        # Trace reunion piggyback: the request carried a trace id, so
        # the driver is correlating — ship the node's half home on this
        # very reply.  Untraced requests get the byte-identical
        # frame (the acceptance invariant).
        if (
            self.ship_spans
            and trace_id is not None
            and root.span is not None
        ):
            tree = root.span.to_dict()
            if is_npwire:
                reply = append_spans(reply, [tree])
            else:
                reply = npproto_codec.append_spans_msg(reply, [tree])
        return reply

    async def _compute_window(
        self, to_compute: Sequence[Sequence[np.ndarray]]
    ) -> list:
        """Execute a decoded wire-batch window; one outcome (output
        list or exception) per request — per-item error isolation,
        whether or not the batching engine is engaged.  Without the
        engine (slow executor compute, no vectorized variant) the
        window fans out over the executor's workers, preserving the
        concurrency the per-RPC path has."""
        if _fi.active_plan is not None:  # chaos seam: compute path
            try:
                await _fi.compute_filter_async()
            except _fi.FaultPlanError:
                raise  # a plan-authoring bug stays LOUD, never in-band
            except RuntimeError as e:
                # Injected compute failure covers the whole window,
                # per item and in-band — exactly like a real pre-
                # dispatch failure would.
                return [e for _ in to_compute]
        if self._batcher is not None:
            return await self._batcher.submit_many(to_compute)

        def one(inputs) -> object:
            try:
                return [np.asarray(o) for o in self.compute_fn(*inputs)]
            except Exception as e:
                return e

        if self.inline_compute:
            return [one(inputs) for inputs in to_compute]
        loop = asyncio.get_running_loop()
        return list(
            await asyncio.gather(
                *(
                    loop.run_in_executor(None, one, inputs)
                    for inputs in to_compute
                )
            )
        )

    async def _run_batch_npwire(
        self, request: bytes, t_arrive: float
    ) -> bytes:
        """One npwire batch frame in -> one batch frame out, item
        replies in item order, each with its own uuid and its own
        error channel (a poisoned item fails only its own reply)."""
        try:
            items, outer_uuid, _err, trace_id, _spans_in = (
                await _fi.call_shimmed_async(decode_batch, request)
            )
        except Exception as e:
            _ERRORS.labels(kind="decode").inc()
            _flightrec.record(
                "server.error", stage="decode", wire="npwire-batch",
                error=str(e)[:200],
            )
            return await _fi.call_shimmed_async(
                encode_batch,
                [], uuid=b"\0" * 16, error=f"decode error: {e}",
            )
        try:
            reduce_part = peek_partition(request)
        except WireError:
            reduce_part = None
        if reduce_part is not None:
            # A REDUCE window (outer partition block): the
            # gRPC lane does not serve reduce windows — answering
            # per-item replies to a caller that asked for a partial
            # sum would be a silent contract break, so the refusal is
            # loud and in-band (the tcp/shm lanes, and aggregator
            # trees over them, are the reduce transports; this repo's
            # pooled client reduces grpc replicas driver-side).
            return await _fi.call_shimmed_async(
                encode_batch,
                [],
                uuid=outer_uuid,
                error=(
                    "partition reduce windows are not served on the "
                    "grpc lane (use tcp/shm, or the pooled client's "
                    "driver-side reduction)"
                ),
            )
        _DECODE_S.observe(time.perf_counter() - t_arrive)
        with _spans.trace_context(trace_id), _spans.span(
            "node.evaluate_batch", wire="npwire", n_items=len(items)
        ) as root:
            replies: list = [None] * len(items)
            to_compute = []  # (slot, inputs, uuid)
            for i, item in enumerate(items):
                try:
                    inputs, uuid, _, _ = await _fi.call_shimmed_async(
                        decode_arrays_ex, item
                    )
                except Exception as e:
                    _ERRORS.labels(kind="decode").inc()
                    _flightrec.record(
                        "server.error", stage="decode", wire="npwire",
                        error=str(e)[:200],
                    )
                    replies[i] = await _fi.call_shimmed_async(
                        encode_arrays,
                        [], uuid=b"\0" * 16, error=f"decode error: {e}",
                    )
                    continue
                to_compute.append((i, inputs, uuid))
            outcomes = await self._compute_window(
                [inputs for _, inputs, _ in to_compute]
            )
            with _spans.span("encode"):
                t_e0 = time.perf_counter()
                for (i, _inputs, uuid), res in zip(to_compute, outcomes):
                    if isinstance(res, BaseException):
                        _ERRORS.labels(kind="compute").inc()
                        _flightrec.record(
                            "server.error", stage="compute", wire="npwire",
                            error=str(res)[:200],
                        )
                        replies[i] = await _fi.call_shimmed_async(
                            encode_arrays,
                            [], uuid=uuid, error=f"compute error: {res}",
                        )
                    else:
                        replies[i] = await _fi.call_shimmed_async(
                            encode_arrays, res, uuid=uuid
                        )
                reply = await _fi.call_shimmed_async(
                    encode_batch, replies, uuid=outer_uuid
                )
                _ENCODE_S.observe(time.perf_counter() - t_e0)
        if (
            self.ship_spans
            and trace_id is not None
            and root.span is not None
        ):
            reply = append_spans(reply, [root.span.to_dict()])
        return reply

    async def _run_batch_npproto(
        self, request: bytes, t_arrive: float
    ) -> bytes:
        """npproto batch message (field 17) in -> batch message out.
        Per-item failures use the field-14 error extension — the
        isolation channel the reference schema lacks; only this
        package's clients send batch messages (capability-gated), so
        no reference peer ever sees field 14/17."""
        # Outer decode errors raise -> gRPC abort, exactly like a
        # malformed plain npproto request (reference contract).
        items, outer_uuid, trace_id, _spans_in = (
            await _fi.call_shimmed_async(
                npproto_codec.decode_batch_msg, request
            )
        )
        _DECODE_S.observe(time.perf_counter() - t_arrive)
        with _spans.trace_context(trace_id), _spans.span(
            "node.evaluate_batch", wire="npproto", n_items=len(items)
        ) as root:
            replies: list = [None] * len(items)
            to_compute = []
            for i, item in enumerate(items):
                try:
                    inputs, uuid, _ = await _fi.call_shimmed_async(
                        npproto_codec.decode_arrays_msg_ex, item
                    )
                except Exception as e:
                    _ERRORS.labels(kind="decode").inc()
                    _flightrec.record(
                        "server.error", stage="decode", wire="npproto",
                        error=str(e)[:200],
                    )
                    replies[i] = await _fi.call_shimmed_async(
                        npproto_codec.encode_arrays_msg,
                        [], uuid="", error=f"decode error: {e}",
                    )
                    continue
                to_compute.append((i, inputs, uuid))
            outcomes = await self._compute_window(
                [inputs for _, inputs, _ in to_compute]
            )
            with _spans.span("encode"):
                t_e0 = time.perf_counter()
                for (i, _inputs, uuid), res in zip(to_compute, outcomes):
                    if isinstance(res, BaseException):
                        _ERRORS.labels(kind="compute").inc()
                        _flightrec.record(
                            "server.error", stage="compute",
                            wire="npproto", error=str(res)[:200],
                        )
                        replies[i] = await _fi.call_shimmed_async(
                            npproto_codec.encode_arrays_msg,
                            [], uuid=uuid, error=f"compute error: {res}",
                        )
                    else:
                        replies[i] = await _fi.call_shimmed_async(
                            npproto_codec.encode_arrays_msg, res, uuid=uuid
                        )
                reply = await _fi.call_shimmed_async(
                    npproto_codec.encode_batch_msg,
                    replies, uuid=outer_uuid,
                )
                _ENCODE_S.observe(time.perf_counter() - t_e0)
        if (
            self.ship_spans
            and trace_id is not None
            and root.span is not None
        ):
            reply = npproto_codec.append_spans_msg(
                reply, [root.span.to_dict()]
            )
        return reply

    # -- graceful drain ---------------------------------------------------

    async def _reject_if_draining(self, context) -> None:
        """While draining, NEW work is refused with a retryable status:
        UNAVAILABLE is outside the client's no-retry set (client.py
        ``_NO_RETRY_STATUS``), so pinned clients retry-and-rebalance and
        the replica pool books a transient failure and fails the work
        over — the clean half of a rolling restart."""
        if self._draining:
            _flightrec.record("server.drain_reject")
            if context is not None:
                await context.abort(
                    grpc.StatusCode.UNAVAILABLE, "node draining"
                )
            raise ConnectionError("node draining")

    async def drain(self, timeout_s: float = 30.0) -> bool:
        """Begin a graceful drain: reject new work (see
        :meth:`_reject_if_draining`), then wait for every in-flight RPC
        — including requests parked in the micro-batcher's coalescing
        queue — to finish.  Returns ``True`` when the node went idle
        within ``timeout_s`` (``False`` = timed out with work still in
        flight; the caller may stop the server anyway or keep waiting).
        Idempotent; :meth:`undrain` re-opens the node."""
        self._draining = True
        _flightrec.record("server.drain_begin", inflight=self._inflight_rpcs)
        loop = asyncio.get_running_loop()
        deadline = loop.time() + timeout_s

        def busy() -> bool:
            if self._inflight_rpcs > 0:
                return True
            b = self._batcher
            return b is not None and (
                b.queue_depth > 0 or b._worker is not None
            )

        while busy() and loop.time() < deadline:
            await asyncio.sleep(0.01)
        clean = not busy()
        _flightrec.record(
            "server.drained", clean=clean, inflight=self._inflight_rpcs
        )
        return clean

    def undrain(self) -> None:
        """Re-open a draining/drained node for new work."""
        self._draining = False

    @property
    def draining(self) -> bool:
        return self._draining

    # -- admission control ------------------------------------------------

    async def _reject_overloaded(self, context, reason: str) -> None:
        """Refuse one request at the door with a RETRYABLE status —
        UNAVAILABLE is outside the clients' no-retry set, so a pinned
        client rebalances and a pool books a transient failure and
        fails over, exactly like the drain rejection.  The refusal is
        the cheap outcome by design: under overload the work a node
        does NOT accept is what keeps the work it did accept inside
        its SLO."""
        _ADMISSION_SHED.labels(reason=reason).inc()
        _flightrec.record(
            "admission.shed", transport="grpc", reason=reason
        )
        if context is not None:
            await context.abort(
                grpc.StatusCode.UNAVAILABLE,
                f"node overloaded ({reason})",
            )
        raise ConnectionError(f"node overloaded ({reason})")

    async def _admit(self, request: bytes, context) -> None:
        """Bounded-queue admission (constructor docstring): drain
        check, then queue-depth and in-flight-byte caps, shedding
        already-expired batcher entries before refusing new work."""
        await self._reject_if_draining(context)
        if self.max_queue is not None:
            def depth() -> int:
                # A queued request is ALSO an in-flight RPC (its
                # handler awaits the batcher), so summing the two
                # would double-count every queued single and halve
                # the effective cap.  max() counts each waiting
                # request once and still sees a one-RPC batch window
                # whose items outnumber its RPC.
                b = self._batcher
                return max(
                    self._inflight_rpcs,
                    b.queue_depth if b is not None else 0,
                )

            shed = 0
            if depth() >= self.max_queue and self._batcher is not None:
                # Shed oldest-past-deadline first: dead queue entries
                # must not crowd out live callers.
                shed = self._batcher.shed_expired()
            # A shed entry's handler is still counted by
            # _inflight_rpcs until its loop tick delivers the failed
            # future through the RPC's finally block, so recheck
            # against the depth the shed actually freed: exact for
            # unary traffic (one queued entry == one RPC); batch
            # windows already show the drop synchronously through
            # queue_depth, which stays the floor of the max().
            b = self._batcher
            if max(
                self._inflight_rpcs - shed,
                b.queue_depth if b is not None else 0,
            ) >= self.max_queue:
                await self._reject_overloaded(context, "queue_full")
        if (
            self.max_inflight_bytes is not None
            and self._inflight_rpcs > 0
            and self._inflight_bytes + len(request)
            > self.max_inflight_bytes
        ):
            # The idle-node exemption (_inflight_rpcs > 0): one
            # request larger than the cap must degrade to serial
            # service, not be refused forever.
            await self._reject_overloaded(context, "inflight_bytes")

    # -- RPC methods ------------------------------------------------------

    async def evaluate(self, request: bytes, context) -> bytes:
        await self._admit(request, context)
        _REQUESTS.labels(method="evaluate").inc()
        _INFLIGHT.inc()
        self._inflight_rpcs += 1
        self._inflight_bytes += len(request)
        try:
            reply = await self._run_compute(request)
        except _deadline.DeadlineExceeded as e:
            # npproto lane (no in-band error field): the RPC aborts as
            # DEADLINE_EXCEEDED — non-retryable in the client table,
            # because the budget is spent everywhere at once.
            if context is not None:
                await context.abort(
                    grpc.StatusCode.DEADLINE_EXCEEDED, str(e)
                )
            raise
        finally:
            _INFLIGHT.dec()
            self._inflight_rpcs -= 1
            self._inflight_bytes -= len(request)
        if _fi.active_plan is not None:  # chaos seam: reply lane
            reply, _n = await _fi_reply_filter(reply, context, unary=True)
        return reply

    async def evaluate_stream(self, request_iterator, context):
        """Lock-step bidi stream: one reply per request, in order
        (reference: service.py:104-112)."""
        self._n_clients += 1
        _log.info("stream opened (n_clients=%d)", self._n_clients)
        try:
            async for request in request_iterator:
                # Per request, not per stream: a drain (or overload)
                # beginning mid-stream rejects the stream's NEXT
                # request (retryable), while requests already being
                # served run to completion.
                await self._admit(request, context)
                _REQUESTS.labels(method="evaluate_stream").inc()
                _INFLIGHT.inc()
                self._inflight_rpcs += 1
                self._inflight_bytes += len(request)
                try:
                    reply = await self._run_compute(request)
                except _deadline.DeadlineExceeded as e:
                    if context is not None:
                        await context.abort(
                            grpc.StatusCode.DEADLINE_EXCEEDED, str(e)
                        )
                    raise
                finally:
                    _INFLIGHT.dec()
                    self._inflight_rpcs -= 1
                    self._inflight_bytes -= len(request)
                if _fi.active_plan is not None:  # chaos seam: reply lane
                    reply, n_copies = await _fi_reply_filter(reply, context)
                    for _ in range(n_copies):
                        yield reply
                else:
                    yield reply
        finally:
            self._n_clients -= 1
            _log.info("stream closed (n_clients=%d)", self._n_clients)

    def determine_load(self) -> dict:
        """Load snapshot (reference: service.py:88-96 GetLoadResult).

        With telemetry enabled, an ``"rpc"`` sub-dict folds the node's
        live RPC picture into the reply — request counts, in-flight
        depth, and compute/queue latency quantiles from the server
        histograms — so a driver polling GetLoad sees WHY a node is
        slow, not just that it is busy.  The three reference fields
        stay top-level, so balancing (and the npproto reply, which has
        no room for more) is unaffected.

        With the micro-batching engine enabled, a ``"batch"`` sub-dict
        carries BOTH the capability advertisement clients key on
        before sending wire batch frames (``max_batch`` > 1 is the
        signal) AND the live batcher picture: queue depth, dispatch
        tallies, and — telemetry on — batch-size/coalesce-wait
        quantiles.  npwire-JSON lane only; the reference-format
        GetLoad reply is fixed at its three fields, which is exactly
        why a reference peer can never be lured into batch frames.
        """
        try:
            import psutil

            percent_cpu = psutil.cpu_percent()
            percent_ram = psutil.virtual_memory().percent
        except Exception:
            percent_cpu = percent_ram = -1.0
        load = {
            "n_clients": self._n_clients,
            "percent_cpu": percent_cpu,
            "percent_ram": percent_ram,
        }
        if _spans.enabled():

            def _q(hist, q):
                v = hist.approx_quantile(q)
                return None if math.isnan(v) or math.isinf(v) else v

            load["rpc"] = {
                "requests_total": sum(
                    v for _n, _l, v in _REQUESTS.samples()
                ),
                "inflight": _INFLIGHT.value,
                "compute_p50_s": _q(_COMPUTE_S, 0.5),
                "compute_p99_s": _q(_COMPUTE_S, 0.99),
                "queue_p99_s": _q(_QUEUE_S, 0.99),
            }
        if self.max_batch > 1:
            # Capability advertisement: batch frames are served (and a
            # transport win) even when the coalescing engine itself is
            # not engaged for this compute, so max_batch>1 is the
            # signal; live engine stats ride along when it is.
            load["batch"] = (
                self._batcher.stats()
                if self._batcher is not None
                else {"max_batch": self.max_batch}
            )
        return load

    async def get_load(self, request: bytes, context) -> bytes:
        """GetLoad; the npwire-JSON reply doubles as the telemetry
        PULL lanes: a request payload of ``b"traces"`` adds this
        node's recent completed span trees (``"traces"`` key) to the
        reply — the reunion path for spans whose own reply never made
        it back (:func:`.client.get_node_traces`) — and ``b"telemetry"``
        adds the FULL telemetry snapshot (``"telemetry"`` key: metric
        families, recent traces, the flight-record tail, and the
        node's wall-clock ``ts`` for Cristian-style clock alignment)
        — the fleet-collector scrape lane
        (:mod:`..telemetry.collector`).  Both schemas define an EMPTY
        GetLoad request, so any non-empty payload is an in-repo
        extension (the recognized payloads are declared in
        :data:`.wire_registry.GETLOAD_PAYLOADS`); unknown payloads are
        ignored (plain load reply).  The npproto reply schema is fixed
        — no room for traces or telemetry there.
        """
        _REQUESTS.labels(method="get_load").inc()
        if _fi.active_plan is not None:  # chaos seam: probe lane
            # The async twin: a delay rule must not block the event
            # loop.
            garbage = await _fi.getload_filter_async()
            if garbage is not None:
                return garbage
        load = self.determine_load()
        if self.getload_wire == "npproto":
            return npproto_codec.encode_get_load_result(
                load["n_clients"], load["percent_cpu"], load["percent_ram"]
            )
        if request == b"traces" and _spans.enabled():
            load["traces"] = _spans.recent_traces(16)
        if request == b"telemetry" and _spans.enabled():
            from ..telemetry import export as _export

            load["telemetry"] = {
                **_export.snapshot(),
                "flightrec": _flightrec.events(128),
            }
        # default=str: the traces lane carries free-form span attrs
        # (numpy scalars included) — degrade, never fail the query.
        return json.dumps(load, default=str).encode("utf-8")

    # -- wiring -----------------------------------------------------------

    def generic_handler(self) -> grpc.GenericRpcHandler:
        handlers = {
            "Evaluate": grpc.unary_unary_rpc_method_handler(
                self.evaluate,
                request_deserializer=_identity,
                response_serializer=_identity,
            ),
            "EvaluateStream": grpc.stream_stream_rpc_method_handler(
                self.evaluate_stream,
                request_deserializer=_identity,
                response_serializer=_identity,
            ),
            "GetLoad": grpc.unary_unary_rpc_method_handler(
                self.get_load,
                request_deserializer=_identity,
                response_serializer=_identity,
            ),
        }
        return grpc.method_handlers_generic_handler(SERVICE_NAME, handlers)


async def serve(
    compute_fn: Optional[Callable[..., Sequence[np.ndarray]]],
    bind: str = "127.0.0.1",
    port: int = 50000,
    *,
    getload_wire: str = "npwire",
    inline_compute: bool = False,
    ship_spans: bool = True,
    max_batch: int = 32,
    max_wait_us: float = 200.0,
    max_queue: Optional[int] = None,
    max_inflight_bytes: Optional[int] = None,
    service: Optional[ArraysToArraysService] = None,
    metrics_port: Optional[int] = None,
    metrics_host: str = "127.0.0.1",
) -> grpc.aio.Server:
    """Start a node server (reference: demo_node.py:76-79).  Returns the
    started ``grpc.aio.Server`` (its bound port as ``server.port``);
    await ``server.wait_for_termination()``.

    Pass EITHER ``compute_fn`` (+ optional ``getload_wire``) — the
    service is constructed here — or a pre-built ``service`` with
    ``compute_fn=None``; both at once would be two sources of truth for
    what the node computes.

    ``metrics_port`` (opt-in) starts a Prometheus-style exposition
    endpoint (:mod:`..telemetry.export`) alongside the node — ``0``
    binds an ephemeral port.  Loopback-bound by default: a node's RPC
    telemetry can leak workload shape, so scraping across hosts is an
    explicit ``metrics_host`` decision.  The running exporter hangs off
    the returned server as ``server.metrics_exporter`` (``.port``,
    ``.close()``); it stops with the daemon thread at process exit."""
    if service is None:
        if compute_fn is None:
            raise ValueError("pass compute_fn or a pre-built service")
        service = ArraysToArraysService(
            compute_fn,
            getload_wire=getload_wire,
            inline_compute=inline_compute,
            ship_spans=ship_spans,
            max_batch=max_batch,
            max_wait_us=max_wait_us,
            max_queue=max_queue,
            max_inflight_bytes=max_inflight_bytes,
        )
    elif compute_fn is not None:
        raise ValueError(
            "pass either compute_fn or a pre-built service, not both "
            "(the service already owns its compute_fn)"
        )
    server = grpc.aio.server()
    server.add_generic_rpc_handlers((service.generic_handler(),))
    # ``port=0`` binds an ephemeral port; the bound one hangs off the
    # returned server as ``server.port``.
    server.port = server.add_insecure_port(f"{bind}:{port}")
    server.metrics_exporter = None
    if metrics_port is not None:
        from ..telemetry.export import start_exporter

        # Before server.start(): if the exposition port is taken, this
        # raises while nothing is listening yet, instead of leaking a
        # started gRPC server the caller never received a handle to.
        server.metrics_exporter = start_exporter(metrics_host, metrics_port)
    await server.start()
    _log.info("node listening on %s:%d", bind, server.port)
    return server


def run_node(
    compute_fn: Callable[..., Sequence[np.ndarray]],
    bind: str = "127.0.0.1",
    port: int = 50000,
    *,
    getload_wire: str = "npwire",
    inline_compute: bool = False,
    max_batch: int = 32,
    max_wait_us: float = 200.0,
    metrics_port: Optional[int] = None,
    metrics_host: str = "127.0.0.1",
) -> None:
    """Blocking single-node entry point (reference: demo_node.py:83-95).

    ``getload_wire="npproto"`` serves reference-format GetLoad replies
    so UNMODIFIED reference clients can balance over this node
    (Evaluate/EvaluateStream auto-detect per request either way).
    ``inline_compute=True`` skips the per-call thread-executor handoff
    for sub-ms compute fns (see ArraysToArraysService).
    ``max_batch``/``max_wait_us`` tune the micro-batching engine — a
    ``compute_fn`` with a ``.batch`` attribute (see
    :func:`device_compute_fn` ``batched=True``) executes coalesced
    windows as one vmapped call (``max_batch=1`` disables).
    ``metrics_port`` opts into the telemetry exposition endpoint
    (see :func:`serve`)."""

    async def main():
        server = await serve(
            compute_fn, bind, port,
            getload_wire=getload_wire,
            inline_compute=inline_compute,
            max_batch=max_batch,
            max_wait_us=max_wait_us,
            metrics_port=metrics_port,
            metrics_host=metrics_host,
        )
        await server.wait_for_termination()

    asyncio.run(main())

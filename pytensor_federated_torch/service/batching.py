"""Server-side batching for the host-federation lane.

A window of same-signature requests (a wire batch frame, a pipelined
``evaluate_many``, or requests that queue while a call is in flight)
runs as ONE vectorized call instead of K: :func:`batched_compute_fn`
vectorizes a torch compute function with ``torch.func.vmap`` over a
leading batch axis, :func:`execute_window_sync` runs a window with
per-request error isolation — a batched execution that fails falls
back to scalar re-execution of its window, so one poisoned input fails
only its own reply (``server.batch_fallback`` in the flight record) —
and :class:`MicroBatcher` is the asyncio coalescing queue in front of
a node's compute.

Batcher policy (the "adaptive" in micro-batching):

- **Idle: zero added latency.**  A lone request dispatches immediately
  — the drain loop starts on the submit and pops a single-entry group.
- **Under load: coalesce.**  Requests arriving while a call is in
  flight stack in the queue; when the call finishes the whole stack
  (same signature, up to ``max_batch``) dispatches as one batched
  call.  ``max_wait_us`` adds an optional post-batch pause to let a
  partially-filled next window top up — only ever paid when the queue
  is non-empty.

Port of the JAX package's ``service/batching.py`` (``jax.vmap`` + a
jitted padded-bucket cache there); on a node whose compute runs the
linear-regression kernel, a vmapped window reaches the kernel's
chain-axis vmap rule, so a window of K requests is one kernel launch.
"""

from __future__ import annotations

import asyncio
import time
from collections import deque
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..faultinject import runtime as _fi
from ..telemetry import flightrec as _flightrec
from ..telemetry import metrics as _metrics
from ..telemetry import spans as _spans
from ..utils import resolve_device
from . import deadline as _deadline

__all__ = ["MicroBatcher", "batched_compute_fn", "execute_window_sync"]

# Batcher instrumentation: the same families, by name, as the JAX
# package's batcher, so both packages' nodes land on one dashboard.
_BATCH_SIZE = _metrics.histogram(
    "pftpu_server_batch_size",
    "Requests coalesced per dispatched micro-batch",
    ("kind",),
    buckets=_metrics.DEFAULT_COUNT_BUCKETS,
)
_BATCHES = _metrics.counter(
    "pftpu_server_batches_total",
    "Micro-batches dispatched, by execution kind",
    ("kind",),
)
_BATCH_WAIT_S = _metrics.histogram(
    "pftpu_server_batch_wait_seconds",
    "Coalesce wait: request enqueue to batch dispatch",
)
_QUEUE_S = _metrics.histogram(
    "pftpu_server_queue_wait_seconds",
    "Wait between RPC decode and compute start (thread-executor queue)",
)
_COMPUTE_S = _metrics.histogram(
    "pftpu_server_compute_seconds", "compute_fn latency"
)
# Shared with the admission path in server.py (same family by name):
# work the node refused or abandoned instead of computing.
_ADMISSION_SHED = _metrics.counter(
    "pftpu_admission_shed_total",
    "Requests shed by server-side admission control, by reason",
    ("reason",),
)


def _signature(inputs: Sequence[np.ndarray]) -> Tuple:
    """Static signature of one request — the coalescing key."""
    return tuple((a.shape, a.dtype.str) for a in inputs)


def _bucket(k: int, cap: int) -> int:
    """Next power-of-two >= k, clamped to ``cap`` — the padded-bucket
    ladder: a window of any size runs at one of ``log2(cap) + 1``
    batch shapes, so whatever caches per shape (the caching allocator,
    a captured graph) sees few of them."""
    b = 1
    while b < k:
        b <<= 1
    return min(b, max(cap, k))


def batched_compute_fn(
    fn: Callable[..., Sequence[torch.Tensor]],
    *,
    device: Any = None,
    max_batch: int = 32,
) -> Callable:
    """Vectorize a torch compute fn over a leading batch axis.

    Returns ``batch(requests) -> [outputs_per_request]`` where
    ``requests`` is a list of same-signature numpy argument tuples.  The
    stack is padded to the next power-of-two bucket (repeating the
    first row — a value the fn provably accepts, so padding cannot
    manufacture a domain error a real input didn't), moved to
    ``device`` (``None``: CUDA, raising when there is none) and
    evaluated as one ``torch.func.vmap`` call.
    """
    dev = resolve_device(device)
    vfn = torch.func.vmap(fn)

    def batch(
        requests: Sequence[Sequence[np.ndarray]],
    ) -> List[List[np.ndarray]]:
        k = len(requests)
        if k == 0:
            return []
        if k > max_batch:
            # Chunk to this fn's own cap: never a batch shape off the
            # ladder.
            out: List[List[np.ndarray]] = []
            for s in range(0, k, max_batch):
                out.extend(batch(requests[s : s + max_batch]))
            return out
        n_args = len(requests[0])
        stacked = [
            np.stack([np.asarray(req[i]) for req in requests])
            for i in range(n_args)
        ]
        b = _bucket(k, max_batch)
        if b > k:
            pad = b - k
            stacked = [
                np.concatenate([s, np.repeat(s[:1], pad, axis=0)])
                for s in stacked
            ]
        with torch.no_grad():
            outs = vfn(*(torch.from_numpy(s).to(dev) for s in stacked))
        outs = [o.detach().cpu().numpy() for o in outs]
        return [[np.asarray(o[j]) for o in outs] for j in range(k)]

    return batch


def execute_window_sync(
    compute_fn: Callable,
    batch_fn: Optional[Callable],
    requests: Sequence[Sequence[np.ndarray]],
) -> List[object]:
    """Synchronous window execution: one outcome (output list or
    exception) per request — per-item error isolation.  A >= 2
    same-signature window with a ``batch_fn`` runs vectorized, with
    scalar re-execution fallback on failure; everything else runs
    scalar-wise.  Used by the TCP server (:func:`..tcp.serve_tcp_once`).
    """
    k = len(requests)
    if k == 0:
        return []
    outcomes: Optional[List[object]] = None
    vmapped_ok = False
    use_batch = (
        batch_fn is not None
        and k > 1
        and len({_signature(r) for r in requests}) == 1
    )
    if use_batch:
        try:
            outs = batch_fn(list(requests))
            if _fi.active_plan is not None:  # chaos: vectorized seam
                outs = _fi.mangle_batch_result(
                    "server.compute_batch", outs
                )
            if len(outs) != k:
                raise RuntimeError(
                    f"batch_fn returned {len(outs)} results for "
                    f"{k} requests"
                )
            outcomes = [list(o) for o in outs]
            vmapped_ok = True
        except Exception as e:
            _BATCHES.labels(kind="fallback").inc()
            _flightrec.record(
                "server.batch_fallback", size=k,
                error=f"{type(e).__name__}: {e}"[:200],
            )
            outcomes = None
    if outcomes is None:
        outcomes = []
        for req in requests:
            try:
                outcomes.append(
                    [np.asarray(o) for o in compute_fn(*req)]
                )
            except Exception as e:
                outcomes.append(e)
    kind = "vmapped" if vmapped_ok else ("single" if k == 1 else "serial")
    _BATCH_SIZE.labels(kind=kind).observe(k)
    _BATCHES.labels(kind=kind).inc()
    if k > 1:
        _flightrec.record("server.batch", size=k, exec_kind=kind)
    return outcomes


class _Pending:
    __slots__ = ("inputs", "sig", "future", "t_enqueue", "deadline")

    def __init__(self, inputs, sig, future, t_enqueue, deadline=None):
        self.inputs = inputs
        self.sig = sig
        self.future = future
        self.t_enqueue = t_enqueue
        # Absolute monotonic deadline captured at enqueue from the
        # ambient contextvar (None = unbounded): the shed key.
        self.deadline = deadline


class MicroBatcher:
    """Asyncio coalescing queue in front of a node's ``compute_fn``.

    ``compute_fn(*arrays) -> [arrays]`` is the scalar path;
    ``batch_fn(requests) -> [outputs_per_request]`` (e.g. from
    :func:`batched_compute_fn`, or the ``.batch`` attribute
    :func:`..server.device_compute_fn` attaches with ``batched=True``)
    is the vectorized path used whenever >= 2 same-signature requests
    coalesce.  Without a ``batch_fn`` the group runs scalar-wise —
    inline on the loop (one trip for the whole group, amortizing the
    handoffs that dominate sub-ms computes), or fanned out over the
    executor's workers so slow GIL-releasing computes keep the
    concurrency the pre-batching server had.

    ``inline=True`` executes on the event loop (the
    ``inline_compute`` contract of the service: sub-ms computes only);
    the default runs each group in the thread executor so a slow batch
    cannot stall GetLoad.
    """

    def __init__(
        self,
        compute_fn: Callable,
        batch_fn: Optional[Callable] = None,
        *,
        max_batch: int = 32,
        max_wait_us: float = 200.0,
        inline: bool = False,
    ):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.compute_fn = compute_fn
        self.batch_fn = batch_fn
        self.max_batch = int(max_batch)
        self.max_wait_us = float(max_wait_us)
        self.inline = bool(inline)
        self._pending: deque[_Pending] = deque()
        self._worker: Optional[asyncio.Task] = None
        # Plain always-on tallies (telemetry histograms are no-ops when
        # spans are disabled; GetLoad still wants the basic picture).
        self.n_dispatched = 0
        self.n_batches = 0
        self.n_fallbacks = 0
        self.n_shed = 0
        self.max_seen = 0

    # -- submission -------------------------------------------------------

    async def submit(self, inputs: Sequence[np.ndarray]) -> List[np.ndarray]:
        """Enqueue one request; returns its outputs (or raises ITS
        error).  A lone request on an idle batcher dispatches
        immediately — no timer, no added latency."""
        return await self._enqueue(inputs)

    async def submit_many(
        self, inputs_list: Sequence[Sequence[np.ndarray]]
    ) -> List[object]:
        """Enqueue a whole window at once (the server side of a wire
        batch frame) and gather per-request outcomes: each slot is the
        request's output list OR its exception (never raises for a
        single poisoned item — the per-item error isolation contract).
        """
        futures = [
            self._enqueue(inputs, start=False) for inputs in inputs_list
        ]
        # Enqueue-all-then-start: the window must be visible to the
        # drain loop as ONE stack, not trickle in one dispatch each.
        tasks = [asyncio.ensure_future(f) for f in futures]
        self._start()
        return await asyncio.gather(*tasks, return_exceptions=True)

    def _enqueue(self, inputs, *, start: bool = True):
        loop = asyncio.get_running_loop()
        fut = loop.create_future()
        arrays = [np.asarray(a) for a in inputs]
        self._pending.append(
            _Pending(
                arrays,
                _signature(arrays),
                fut,
                time.perf_counter(),
                _deadline.current_deadline(),
            )
        )
        self.max_seen = max(self.max_seen, len(self._pending))
        if start:
            self._start()
        return fut

    def _start(self) -> None:
        if self._worker is None and self._pending:
            self._worker = asyncio.ensure_future(self._drain())

    @property
    def queue_depth(self) -> int:
        return len(self._pending)

    def _shed_one(self, p: _Pending, where: str) -> None:
        """Fail one expired entry with the deadline classification —
        its reply races nothing downstream (never vmap'd in)."""
        self.n_shed += 1
        _ADMISSION_SHED.labels(reason="expired").inc()
        _deadline.DEADLINE_EXPIRED.labels(stage="queue").inc()
        _flightrec.record("admission.shed", reason="expired", where=where)
        if not p.future.done():
            p.future.set_exception(
                _deadline.DeadlineExceeded(
                    _deadline.deadline_error(f"shed in {where}")
                )
            )

    def shed_expired(self) -> int:
        """Drop every queued entry whose deadline is already spent
        (their callers stopped waiting: computing them is pure load)
        and fail their futures with the deadline classification.
        Returns how many were shed.  The admission path calls this
        BEFORE refusing new work — shedding the oldest-past-deadline
        first is how a full queue makes room for live requests."""
        if not self._pending:
            return 0
        now = time.monotonic()
        live: deque = deque()
        shed = 0
        for p in self._pending:
            if p.deadline is not None and now >= p.deadline:
                self._shed_one(p, "micro-batcher queue")
                shed += 1
            else:
                live.append(p)
        self._pending = live
        return shed

    def stats(self) -> dict:
        """Live batcher picture for GetLoad (:meth:`..server
        .ArraysToArraysService.determine_load`): always-on counts plus
        batch-size quantiles when telemetry is enabled."""
        out = {
            "max_batch": self.max_batch,
            "max_wait_us": self.max_wait_us,
            "queue_depth": self.queue_depth,
            "dispatched_total": self.n_dispatched,
            "batches_total": self.n_batches,
            "fallbacks_total": self.n_fallbacks,
            "shed_total": self.n_shed,
            "max_queue_seen": self.max_seen,
        }
        if _spans.enabled():
            import math

            def _q(hist, q):
                v = hist.approx_quantile(q)
                return None if math.isnan(v) or math.isinf(v) else v

            vmapped = _BATCH_SIZE.labels(kind="vmapped")
            out["size_p50"] = _q(vmapped, 0.5)
            out["size_p99"] = _q(vmapped, 0.99)
            out["wait_p99_s"] = _q(_BATCH_WAIT_S, 0.99)
        return out

    # -- the drain loop ---------------------------------------------------

    def _pop_group(self) -> List[_Pending]:
        """Pop the head request plus every queued same-signature
        sibling (stable order), up to ``max_batch``.  Mixed signatures
        stay queued and form their own group next iteration."""
        if not self._pending:
            return []
        head_sig = self._pending[0].sig
        group: List[_Pending] = []
        rest: List[_Pending] = []
        for p in self._pending:
            if p.sig == head_sig and len(group) < self.max_batch:
                group.append(p)
            else:
                rest.append(p)
        self._pending = deque(rest)
        return group

    async def _drain(self) -> None:
        try:
            under_load = False
            while self._pending:
                if (
                    under_load
                    and self.max_wait_us > 0
                    and len(self._pending) < self.max_batch
                ):
                    # Saturated lane: a short top-up pause fills the
                    # next window.  Never reached by a lone idle
                    # request (under_load is False on the first pass).
                    await asyncio.sleep(self.max_wait_us / 1e6)
                group = self._pop_group()
                await self._execute(group)
                under_load = True
        finally:
            self._worker = None
            if self._pending:
                # A submit raced the loop's exit check; reschedule so
                # nothing is stranded.
                self._start()

    async def _execute(self, group: List[_Pending]) -> None:
        # Shed expired entries AT DISPATCH: their callers are gone, so
        # stacking them into the vmapped call would spend device time
        # on replies nobody reads — the queue must never launder dead
        # work into compute.
        now = time.monotonic()
        live: List[_Pending] = []
        for p in group:
            if p.deadline is not None and now >= p.deadline:
                self._shed_one(p, "micro-batcher dispatch")
            else:
                live.append(p)
        group = live
        k = len(group)
        if k == 0:
            return
        t_dispatch = time.perf_counter()
        for p in group:
            _BATCH_WAIT_S.observe(t_dispatch - p.t_enqueue)
            _QUEUE_S.observe(t_dispatch - p.t_enqueue)
        self.n_dispatched += k
        self.n_batches += 1
        use_batch = k > 1 and self.batch_fn is not None

        def scalar_one(p: _Pending) -> object:
            try:
                return list(self.compute_fn(*p.inputs))
            except Exception as e:
                return e

        def batch_job() -> Optional[List[object]]:
            """One trip through the vectorized path; None on failure —
            the caller then re-runs the window scalar-wise, so one
            poisoned input fails only ITS reply."""
            t0 = time.perf_counter()
            try:
                outs = self.batch_fn([p.inputs for p in group])
                if _fi.active_plan is not None:  # chaos: vectorized seam
                    outs = _fi.mangle_batch_result(
                        "server.compute_batch", outs
                    )
                if len(outs) != k:
                    raise RuntimeError(
                        f"batch_fn returned {len(outs)} results "
                        f"for {k} requests"
                    )
                _COMPUTE_S.observe(time.perf_counter() - t0)
                return [list(o) for o in outs]
            except Exception as e:
                self.n_fallbacks += 1
                _BATCHES.labels(kind="fallback").inc()
                _flightrec.record(
                    "server.batch_fallback", size=k,
                    error=f"{type(e).__name__}: {e}"[:200],
                )
                return None

        try:
            loop = asyncio.get_running_loop()
            results: Optional[List[object]] = None
            vmapped_ok = False
            if use_batch:
                # call_shimmed_async: the inline fast path runs
                # batch_job on the loop ONLY while no fault plan is
                # active — batch_job holds the sync vectorized chaos
                # seam (mangle_batch_result), whose delay kinds sleep
                # (a blocking sleep on the event loop).
                results = await _fi.call_shimmed_async(
                    batch_job, inline=self.inline
                )
                vmapped_ok = results is not None
            if results is None:
                # Scalar path: no batch_fn, a lone request, or the
                # vectorized call failed.  Inline runs on the loop;
                # executor mode fans the group out CONCURRENTLY, so a
                # slow GIL-releasing compute keeps the multi-worker
                # overlap the pre-batching executor server had.
                t0 = time.perf_counter()
                if self.inline:
                    results = [scalar_one(p) for p in group]
                else:
                    results = list(
                        await asyncio.gather(
                            *(
                                loop.run_in_executor(None, scalar_one, p)
                                for p in group
                            )
                        )
                    )
                _COMPUTE_S.observe(time.perf_counter() - t0)
            # Recorded AFTER execution with the kind that actually
            # ran: a window whose vmapped call failed and re-ran
            # scalar-wise must not inflate the vmapped histograms an
            # operator reads off GetLoad.
            kind = (
                "vmapped"
                if vmapped_ok
                else ("single" if k == 1 else "serial")
            )
            _BATCH_SIZE.labels(kind=kind).observe(k)
            _BATCHES.labels(kind=kind).inc()
            if k > 1:
                _flightrec.record("server.batch", size=k, exec_kind=kind)
        except BaseException as e:
            # Engine failure (not a compute failure — those are caught
            # per request): fail the whole group loudly rather than
            # strand its futures.  BaseException matters: a cancelled
            # drain task (server shutdown) or a KeyboardInterrupt
            # escaping an inline compute would otherwise leave every
            # awaiting RPC handler blocked forever — the silent-wedge
            # class the watchdog exists for.
            err = (
                e
                if isinstance(e, Exception)
                else RuntimeError(f"batch execution aborted: {e!r}")
            )
            for p in group:
                if not p.future.done():
                    p.future.set_exception(err)
            if not isinstance(e, Exception):
                raise  # cancellation/KeyboardInterrupt still propagate
            return
        for p, res in zip(group, results):
            if p.future.done():  # cancelled caller; nothing to deliver
                continue
            if isinstance(res, Exception):
                p.future.set_exception(res)
            else:
                p.future.set_result(
                    [np.asarray(o) for o in res]  # type: ignore[union-attr]
                )

"""Server-side batching for the host-federation lane.

A window of same-signature requests (a wire batch frame, or a pipelined
``evaluate_many``) runs as ONE vectorized call instead of K:
:func:`batched_compute_fn` vectorizes a torch compute function with
``torch.func.vmap`` over a leading batch axis, and
:func:`execute_window_sync` runs a window with per-request error
isolation — a batched execution that fails falls back to scalar
re-execution of its window, so one poisoned input fails only its own
reply (``server.batch_fallback`` in the flight record).

Port of the JAX package's ``service/batching.py`` (``jax.vmap`` + a
jitted padded-bucket cache there).  The asyncio ``MicroBatcher`` of the
gRPC server is not ported yet.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..faultinject import runtime as _fi
from ..telemetry import flightrec as _flightrec
from ..telemetry import metrics as _metrics
from ..utils import resolve_device

__all__ = ["batched_compute_fn", "execute_window_sync"]

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

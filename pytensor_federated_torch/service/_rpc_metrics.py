"""Driver-side RPC metric families, shared by both transport lanes.

One declaration site for the instruments the gRPC lane (client.py,
``transport="grpc"``) and the TCP lane (tcp.py, ``transport="tcp"``)
both record into — the registry would dedupe identical re-declarations,
but a single source means the help text and bucket ladders cannot
drift between lanes (metric catalog: docs/observability.md).
"""

from __future__ import annotations

from ..telemetry import metrics as _metrics

CALL_S = _metrics.histogram(
    "pftpu_client_call_seconds",
    "One RPC attempt, driver-observed (write -> validated reply)",
    ("transport", "mode"),
)
RETRIES = _metrics.counter(
    "pftpu_client_retries_total",
    "Failed attempts that triggered the retry/rebalance loop",
    ("transport",),
)
DROPS = _metrics.counter(
    "pftpu_client_connection_drops_total",
    "Cached connections dropped (failover, desync, decode failure)",
    ("transport",),
)
BATCH_S = _metrics.histogram(
    "pftpu_client_batch_seconds",
    "evaluate_many wall time per batch",
    ("transport",),
)
WINDOW_DEPTH = _metrics.histogram(
    "pftpu_client_window_depth",
    "In-flight pipeline depth observed at each evaluate_many reply",
    ("transport",),
    buckets=_metrics.DEFAULT_COUNT_BUCKETS,
)
BATCH_FRAME_REQS = _metrics.histogram(
    "pftpu_client_batch_frame_requests",
    "Requests coalesced into each wire batch frame sent by evaluate_many",
    ("transport",),
    buckets=_metrics.DEFAULT_COUNT_BUCKETS,
)

__all__ = [
    "CALL_S",
    "RETRIES",
    "DROPS",
    "BATCH_S",
    "WINDOW_DEPTH",
    "BATCH_FRAME_REQS",
]

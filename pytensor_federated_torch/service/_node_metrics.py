"""Node-side RPC metric families, shared by every serving lane.

One declaration site for the ``pftpu_server_*`` instruments the gRPC
service (server.py), the TCP template node (tcp.py ``serve_tcp_once``)
and — through the shared ``serve_npwire_payload`` path — the shm
doorbell node all record into.  The registry would dedupe identical
re-declarations, but a single source means the help text and bucket
ladders cannot drift between lanes, and every lane's histograms merge
bucket-wise in the fleet view (:mod:`..telemetry.collector`).  Metric
catalog: docs/observability.md.
"""

from __future__ import annotations

from ..telemetry import metrics as _metrics

REQUESTS = _metrics.counter(
    "pftpu_server_requests_total",
    "RPCs served by the node, by method",
    ("method",),
)
ERRORS = _metrics.counter(
    "pftpu_server_errors_total",
    "Node-side failures, by kind (decode or compute)",
    ("kind",),
)
INFLIGHT = _metrics.gauge(
    "pftpu_server_inflight_requests",
    "Evaluate RPCs currently being served",
)
DECODE_S = _metrics.histogram(
    "pftpu_server_decode_seconds", "Request wire-decode latency"
)
QUEUE_S = _metrics.histogram(
    "pftpu_server_queue_wait_seconds",
    "Wait between RPC decode and compute start (thread-executor queue)",
)
COMPUTE_S = _metrics.histogram(
    "pftpu_server_compute_seconds", "compute_fn latency"
)
ENCODE_S = _metrics.histogram(
    "pftpu_server_encode_seconds", "Reply wire-encode latency"
)
ADMISSION_SHED = _metrics.counter(
    "pftpu_admission_shed_total",
    "Requests shed by server-side admission control, by reason",
    ("reason",),
)

__all__ = [
    "REQUESTS",
    "ERRORS",
    "INFLIGHT",
    "DECODE_S",
    "QUEUE_S",
    "COMPUTE_S",
    "ENCODE_S",
    "ADMISSION_SHED",
]

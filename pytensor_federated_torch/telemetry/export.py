"""Exposition lane: HTTP /metrics endpoint, snapshot API, JSONL dump.

Three ways out of the process, cheapest first:

- :func:`snapshot` — one dict with every metric family plus the recent
  span trees; what a driver polls in-process.
- :func:`dump_jsonl` — append that snapshot as one JSON line to a file;
  what a live-TPU capture session logs between configs
  (tools/metrics_dump.py wraps it as a CLI).
- :class:`MetricsExporter` — an opt-in ``ThreadingHTTPServer`` on a
  daemon thread serving ``GET /metrics`` (classic Prometheus text
  format 0.0.4), ``GET /snapshot`` and ``GET /traces`` (JSON).  Opt-in
  and loopback-bound by default: a federated node's telemetry can leak
  workload shape, so exposing it beyond the host is an explicit
  deployment decision (same posture as
  :class:`~..parallel.multihost.HeartbeatServer`).

The exporter is plain ``http.server`` — no new dependencies — and
serves reads only; nothing here can mutate the registry.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from . import flightrec as _flightrec
from . import metrics as _metrics
from . import spans as _spans

__all__ = ["MetricsExporter", "start_exporter", "snapshot", "dump_jsonl"]

_log = logging.getLogger(__name__)

#: Content type of the classic text exposition format.
PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def snapshot(*, traces: int = 16) -> dict:
    """Full telemetry state: metric families + the last ``traces``
    completed span trees + whether recording is on.  ``ts`` is this
    process's wall clock at snapshot build — the anchor a remote
    scraper (:mod:`.collector`) uses for Cristian-style clock-offset
    estimation."""
    return {
        "ts": time.time(),
        "enabled": _spans.enabled(),
        "metrics": _metrics.snapshot(),
        "traces": _spans.recent_traces(traces),
    }


def dump_jsonl(path: str, *, traces: int = 16) -> dict:
    """Append one timestamped snapshot line to ``path``; returns the
    record.  Append-mode so a polling loop (one line per capture
    window) builds a time series the same way
    tools/suite_cpu_*.jsonl does."""
    rec = {"ts": time.time(), **snapshot(traces=traces)}
    with open(path, "a", encoding="utf-8") as fh:
        fh.write(json.dumps(rec) + "\n")
    return rec


class _Handler(BaseHTTPRequestHandler):
    # Populated per-server via the factory in MetricsExporter.
    registry: Optional[_metrics.Registry] = None

    def do_GET(self):  # noqa: N802 (http.server API)
        path = self.path.split("?", 1)[0]
        if path in ("/metrics", "/"):
            body = _metrics.render_prometheus(self.registry).encode("utf-8")
            ctype = PROMETHEUS_CONTENT_TYPE
        elif path == "/snapshot":
            # The flight-record tail rides along so HTTP-lane replicas
            # (TCP/shm template nodes) contribute events to the fleet
            # timeline exactly like the GetLoad b"telemetry" lane —
            # same composition as server.py's get_load reply.
            # default=str: span/flightrec attrs are free-form (numpy
            # scalars included) — degrade to strings rather than fail
            # the scrape, the same posture as server.py's get_load
            # reply and the watchdog's bundle writer.
            body = json.dumps(
                {**snapshot(), "flightrec": _flightrec.events(128)},
                default=str,
            ).encode("utf-8")
            ctype = "application/json"
        elif path == "/traces":
            body = json.dumps(
                _spans.recent_traces(), default=str
            ).encode("utf-8")
            ctype = "application/json"
        else:
            self.send_error(404, "try /metrics, /snapshot or /traces")
            return
        self.send_response(200)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, fmt, *args):  # scrapes must not spam stderr
        _log.debug("exporter: " + fmt, *args)


class MetricsExporter:
    """Serve the registry over HTTP from a daemon thread.

    ``port=0`` binds an ephemeral port (read it back via ``.port``).
    Loopback by default; pass ``host="0.0.0.0"`` only when the scrape
    path genuinely crosses hosts.
    """

    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 0,
        *,
        registry: Optional[_metrics.Registry] = None,
    ):
        handler = type(
            "_BoundHandler",
            (_Handler,),
            {"registry": registry or _metrics.REGISTRY},
        )
        self._httpd = ThreadingHTTPServer((host, port), handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name="pftpu-metrics-exporter",
            daemon=True,
        )
        self._thread.start()
        _log.info("telemetry exporter on %s:%d", host, self.port)

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def address(self) -> tuple:
        return self._httpd.server_address[:2]

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=2.0)

    def __enter__(self) -> "MetricsExporter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def start_exporter(
    host: str = "127.0.0.1",
    port: int = 0,
    *,
    registry: Optional[_metrics.Registry] = None,
) -> MetricsExporter:
    """Start an HTTP exposition endpoint; returns the running exporter
    (``.port`` for the bound port, ``.close()`` to stop)."""
    return MetricsExporter(host, port, registry=registry)

"""Telemetry: spans, metrics, flight recorder, watchdog, trace reunion.

The JAX package's ``telemetry`` modules, copied: the same metric names
(``pftpu_*``), environment variables, flight-record event kinds and
span names, so torch and JAX nodes read as one fleet on a dashboard.
A process that imports both packages holds two separate registries.

- :mod:`.spans` — contextvar-propagated span trees with 16-byte trace
  ids that ride the wire.
- :mod:`.metrics` — counters, gauges and fixed-bucket histograms in a
  process-global registry, rendered as Prometheus text.
- :mod:`.export` — opt-in HTTP exposition endpoint + snapshot()/JSONL.
- :mod:`.flightrec` — bounded ring of structured events.
- :mod:`.watchdog` — armed-deadline hang watchdog writing incident
  bundles.
- :mod:`.reunion` — driver-side merge of the span trees nodes ship back
  on their replies.

- :mod:`.collector` — the fleet plane: harvest every replica's
  snapshot over HTTP ``/snapshot`` (the GetLoad lane is gRPC's, not
  ported yet), merge (counters summed, histograms bucket-wise, gauges
  per replica) with loud staleness marking, estimate per-replica clock
  offsets, and interleave all flight records into one timeline.
- :mod:`.critpath` — critical-path analysis over reunion-merged span
  trees: per-stage p50/p99 decomposition of end-to-end latency.
- :mod:`.slo` — declarative SLOs + a multi-window burn-rate engine
  over successive fleet snapshots.
"""

from . import collector, critpath, flightrec, reunion, slo, watchdog
from .collector import FleetCollector, FleetSnapshot
from .export import MetricsExporter, dump_jsonl, snapshot, start_exporter
from .slo import BurnRateEngine, Slo
from .watchdog import write_incident_bundle
from .metrics import (
    Counter,
    Gauge,
    Histogram,
    REGISTRY,
    Registry,
    counter,
    gauge,
    histogram,
    render_prometheus,
)
from .spans import (
    Span,
    clear_traces,
    current_span,
    current_trace_id,
    enabled,
    new_trace_id,
    recent_traces,
    set_enabled,
    span,
    trace_context,
)

__all__ = [
    "BurnRateEngine",
    "Counter",
    "FleetCollector",
    "FleetSnapshot",
    "Gauge",
    "Histogram",
    "MetricsExporter",
    "REGISTRY",
    "Registry",
    "Slo",
    "Span",
    "clear_traces",
    "collector",
    "counter",
    "critpath",
    "current_span",
    "current_trace_id",
    "dump_jsonl",
    "enabled",
    "flightrec",
    "gauge",
    "histogram",
    "new_trace_id",
    "recent_traces",
    "render_prometheus",
    "reunion",
    "set_enabled",
    "slo",
    "snapshot",
    "span",
    "start_exporter",
    "trace_context",
    "watchdog",
    "write_incident_bundle",
]

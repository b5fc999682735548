"""Fleet collector: cross-process telemetry harvest, merge, timeline.

The rest of telemetry makes one *process* observable; this module
makes the FLEET observable.  A :class:`FleetCollector` harvests full telemetry
snapshots from every replica over the existing lanes — the enriched
GetLoad request payload ``b"telemetry"`` on the npwire lane (declared
in :data:`..service.wire_registry.GETLOAD_PAYLOADS`, mirroring the
``b"traces"`` pull), or HTTP ``GET /snapshot`` against a
:class:`.export.MetricsExporter` for nodes without a GetLoad lane —
and merges them into one fleet view:

- **counters** are summed across replicas per label set,
- **histograms** merge bucket-wise (the shared fixed bucket ladder was
  designed for exactly this; mismatched ladders raise
  :class:`FleetMergeError` — loud, never a silently wrong quantile),
- **gauges** are kept per-replica under a ``replica`` label (summing
  instantaneous values across processes is meaningless).

A replica that dies mid-scrape is marked STALE — listed in
:attr:`FleetSnapshot.stale`, counted in
``pftpu_collector_replicas_stale``, flight-recorded as
``collector.replica_stale`` — and its numbers are EXCLUDED from the
merged view: a fleet aggregate is either complete or loudly partial,
never silently partial.

Clock alignment: every scrape estimates the replica's wall-clock
offset Cristian-style — the node stamps its clock into the snapshot
(``ts``, :func:`.export.snapshot`), the driver brackets the scrape
with its own clock, and the offset is taken against the RTT midpoint
(error bounded by ±RTT/2; on the loopback lanes this is tens of
microseconds, far below the millisecond-scale events being ordered).
:func:`FleetSnapshot.timeline` applies the offsets to every replica's
flight-record tail and interleaves them with the driver's own events
into ONE ordered incident timeline — embedded in incident bundles
(:func:`.watchdog.write_incident_bundle` pulls it from every live
collector via :func:`bundle_sections`) and rendered by
``tools/incident_report.py``.

The collector rides a replica pool when given one
(:class:`~..routing.pool.NodePool` — the live replica registry is
re-read every sweep, so replicas added/removed/failed-over mid-run
are followed), or a static target list otherwise.  ``start()`` runs
the sweep on a background daemon thread at ``interval_s``; each
snapshot is handed to the registered ``observers`` — the
:class:`.slo.BurnRateEngine` is the canonical one, making this the
signal bus a future autoscaler consumes.
"""

from __future__ import annotations

import json
import logging
import threading
import time
import urllib.request
import weakref
from collections import deque
from typing import (
    Any,
    Callable,
    Deque,
    Dict,
    Iterable,
    List,
    Mapping,
    Optional,
    Sequence,
    Tuple,
    Union,
)

from . import flightrec as _flightrec
from . import metrics as _metrics

__all__ = [
    "FleetCollector",
    "FleetSnapshot",
    "ReplicaScrape",
    "FleetMergeError",
    "merge_metric_snapshots",
    "merged_quantile",
    "fleet_timeline",
    "bundle_sections",
    "LOCAL_REPLICA",
]

_log = logging.getLogger(__name__)

#: The pseudo-replica address of the collector's own process (the
#: driver): its registry and flight record join the fleet view with a
#: clock offset of exactly zero.
LOCAL_REPLICA = "driver"

_SCRAPES = _metrics.counter(
    "pftpu_collector_scrapes_total",
    "Fleet-collector replica scrapes, by outcome",
    ("outcome",),
)
_SCRAPE_S = _metrics.histogram(
    "pftpu_collector_scrape_seconds",
    "Per-replica fleet-collector scrape round-trip latency",
)
_STALE = _metrics.gauge(
    "pftpu_collector_replicas_stale",
    "Replicas whose last fleet scrape failed (stale in the fleet view)",
)
_CLOCK_OFFSET = _metrics.gauge(
    "pftpu_collector_clock_offset_seconds",
    "Estimated replica wall-clock offset vs this driver (Cristian-style,"
    " RTT-midpoint)",
    ("replica",),
)


class FleetMergeError(RuntimeError):
    """Per-replica snapshots disagree in a way a merge must not paper
    over: same family name with different instrument types, or
    histograms with different bucket ladders."""


# -- merge ------------------------------------------------------------------


def _merge_histogram_children(
    children: Dict[Tuple[Tuple[str, str], ...], dict],
    labels: Dict[str, str],
    child: Mapping[str, Any],
    name: str,
    replica: str,
) -> None:
    key = tuple(sorted(labels.items()))
    buckets = dict(child.get("buckets") or {})
    agg = children.get(key)
    if agg is None:
        children[key] = {
            "labels": dict(labels),
            "count": int(child.get("count", 0)),
            "sum": float(child.get("sum", 0.0)),
            "buckets": {str(k): int(v) for k, v in buckets.items()},
        }
        return
    if set(agg["buckets"]) != set(str(k) for k in buckets):
        raise FleetMergeError(
            f"histogram {name!r}: replica {replica} uses bucket ladder "
            f"{sorted(buckets)} but the fleet ladder is "
            f"{sorted(agg['buckets'])} — refusing a bucket-wise merge "
            "of incompatible ladders"
        )
    agg["count"] += int(child.get("count", 0))
    agg["sum"] += float(child.get("sum", 0.0))
    for bound, n in buckets.items():
        agg["buckets"][str(bound)] += int(n)


def merge_metric_snapshots(
    per_replica: Mapping[str, Mapping[str, Any]],
) -> Dict[str, Any]:
    """Merge per-replica ``metrics.snapshot()`` maps into one fleet
    map, same shape as a single-registry snapshot.

    Merge semantics (module docstring): counters summed per label set,
    histograms merged bucket-wise (count/sum/bucket counts added;
    exemplars are per-process and dropped), gauges kept per replica
    under an added ``replica`` label.  A gauge that ALREADY carries a
    ``replica`` label (a scraped driver's pool gauges) keeps it and
    the scrape source goes under ``source`` instead — two processes'
    views of the same pool stay distinguishable.

    Raises :class:`FleetMergeError` on type or bucket-ladder conflicts
    — the merge is exact or it is refused; it never averages its way
    past a disagreement.  The merge is pure (inputs untouched), so the
    property test can compare it bit-for-bit against observing the
    union in one registry.
    """
    merged: Dict[str, Any] = {}
    # name -> (kind, help, children-accumulator)
    hist_children: Dict[str, Dict[Tuple[Tuple[str, str], ...], dict]] = {}
    counter_children: Dict[str, Dict[Tuple[Tuple[str, str], ...], dict]] = {}
    for replica in sorted(per_replica):
        snap = per_replica[replica]
        if not isinstance(snap, Mapping):
            raise FleetMergeError(
                f"replica {replica}: metrics snapshot is "
                f"{type(snap).__name__}, not a mapping"
            )
        for name, entry in snap.items():
            kind = entry.get("type", "untyped")
            known = merged.get(name)
            if known is None:
                merged[name] = {
                    "type": kind,
                    "help": entry.get("help", ""),
                    "children": [],
                }
            elif known["type"] != kind:
                raise FleetMergeError(
                    f"metric {name!r}: replica {replica} reports type "
                    f"{kind!r} but the fleet view already holds "
                    f"{known['type']!r}"
                )
            for child in entry.get("children", ()):
                labels = dict(child.get("labels") or {})
                if kind == "histogram":
                    _merge_histogram_children(
                        hist_children.setdefault(name, {}),
                        labels, child, name, replica,
                    )
                elif kind == "counter":
                    key = tuple(sorted(labels.items()))
                    acc = counter_children.setdefault(name, {})
                    agg = acc.get(key)
                    if agg is None:
                        acc[key] = {
                            "labels": labels,
                            "value": float(child.get("value", 0.0)),
                        }
                    else:
                        agg["value"] += float(child.get("value", 0.0))
                else:  # gauge (and anything untyped): per-replica
                    if "replica" in labels:
                        labels = {**labels, "source": replica}
                    else:
                        labels = {**labels, "replica": replica}
                    merged[name]["children"].append(
                        {"labels": labels, "value": child.get("value")}
                    )
    for name, acc in counter_children.items():
        merged[name]["children"].extend(
            acc[k] for k in sorted(acc)
        )
    for name, acc in hist_children.items():
        merged[name]["children"].extend(
            acc[k] for k in sorted(acc)
        )
    return merged


def merged_quantile(
    family: Optional[Mapping[str, Any]], q: float
) -> float:
    """Quantile estimate over ALL children of one merged histogram
    family (upper bucket bound containing the q-th observation — the
    same estimate :meth:`..telemetry.metrics.Histogram.approx_quantile`
    makes in-process).  ``nan`` for an absent/empty family."""
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"quantile must be in [0, 1], got {q}")
    buckets: Dict[float, int] = {}
    total = 0
    for child in (family or {}).get("children", ()):
        for bound, n in (child.get("buckets") or {}).items():
            b = float(bound)
            buckets[b] = buckets.get(b, 0) + int(n)
        total += int(child.get("count", 0))
    if total == 0:
        return float("nan")
    rank = q * total
    seen = 0
    for bound in sorted(buckets):
        seen += buckets[bound]
        if seen >= rank and buckets[bound]:
            return bound
    return float("inf")


# -- scrape results ---------------------------------------------------------


class ReplicaScrape:
    """One replica's scrape outcome (fresh or stale)."""

    __slots__ = (
        "address", "lane", "ok", "error", "ts", "rtt_s",
        "clock_offset_s", "metrics", "traces", "flightrec", "load",
    )

    def __init__(self, address: str, lane: str):
        self.address = address
        self.lane = lane
        self.ok = False
        self.error: Optional[str] = None
        self.ts: Optional[float] = None
        self.rtt_s: Optional[float] = None
        self.clock_offset_s: Optional[float] = None
        self.metrics: Optional[dict] = None
        self.traces: List[dict] = []
        self.flightrec: List[dict] = []
        self.load: Optional[dict] = None

    def to_dict(self) -> dict:
        return {
            "address": self.address,
            "lane": self.lane,
            "ok": self.ok,
            "error": self.error,
            "ts": self.ts,
            "rtt_s": self.rtt_s,
            "clock_offset_s": self.clock_offset_s,
            "metrics": self.metrics,
            "traces": self.traces,
            "flightrec": self.flightrec,
            "load": self.load,
        }


class FleetSnapshot:
    """One sweep's fleet view: per-replica scrapes + the merged
    registry + the loud-staleness record."""

    __slots__ = ("ts", "replicas", "merged", "stale", "unscraped")

    def __init__(
        self,
        ts: float,
        replicas: Dict[str, ReplicaScrape],
        merged: dict,
        stale: List[str],
        unscraped: List[str],
    ):
        self.ts = ts
        self.replicas = replicas
        self.merged = merged
        self.stale = stale
        self.unscraped = unscraped

    @property
    def complete(self) -> bool:
        """True when every registered replica answered this sweep."""
        return not self.stale and not self.unscraped

    def timeline(self, *, tail: Optional[int] = None) -> List[dict]:
        """The clock-aligned fleet timeline (:func:`fleet_timeline`)."""
        return fleet_timeline(self, tail=tail)

    def to_dict(self) -> dict:
        return {
            "ts": self.ts,
            "complete": self.complete,
            "stale": list(self.stale),
            "unscraped": list(self.unscraped),
            "merged": self.merged,
            "replicas": {
                a: r.to_dict() for a, r in self.replicas.items()
            },
        }


def fleet_timeline(
    snapshot: FleetSnapshot, *, tail: Optional[int] = None
) -> List[dict]:
    """Interleave every replica's flight-record tail into one ordered
    incident timeline.

    Each event gains ``replica`` (who recorded it) and ``ts_fleet``
    (its timestamp shifted onto the DRIVER's clock by the replica's
    estimated offset — alignment error is bounded by ±RTT/2 of the
    scrape that estimated it).  Events from the driver's own record
    (:data:`LOCAL_REPLICA`) carry offset zero by construction.
    ``tail`` keeps only the newest ``tail`` events after the merge.
    """
    out: List[dict] = []
    for addr, scrape in snapshot.replicas.items():
        offset = scrape.clock_offset_s or 0.0
        for ev in scrape.flightrec:
            ts = ev.get("ts")
            if not isinstance(ts, (int, float)):
                continue
            out.append(
                {**ev, "replica": addr, "ts_fleet": ts - offset}
            )
    out.sort(key=lambda e: e["ts_fleet"])
    if tail is not None:
        out = out[-tail:]
    return out


# -- the collector ----------------------------------------------------------

TargetSpec = Union[str, Tuple[str, int]]


def _as_addr(target: TargetSpec) -> Tuple[str, int]:
    if isinstance(target, str):
        host, _, port = target.rpartition(":")
        return host or "127.0.0.1", int(port)
    host, port = target
    return str(host), int(port)


def _scrape_http(host: str, port: int, timeout_s: float) -> dict:
    url = f"http://{host}:{port}/snapshot"
    with urllib.request.urlopen(url, timeout=timeout_s) as resp:
        body = resp.read()
    payload = json.loads(body)
    if not isinstance(payload, dict) or "metrics" not in payload:
        raise ValueError(f"{url} returned no metrics map")
    return payload


# Live started collectors, so incident bundles can embed the fleet
# picture without anyone threading a handle through the call stack.
_active: "weakref.WeakSet[FleetCollector]" = weakref.WeakSet()


class FleetCollector:
    """Harvest + merge the fleet's telemetry (module docstring).

    ``targets``: ``host:port`` strings or ``(host, port)`` pairs
    scraped over the GetLoad ``b"telemetry"`` lane.  ``http_targets``:
    the same shapes scraped over ``GET /snapshot`` (the fallback lane
    for nodes that expose a :class:`.export.MetricsExporter` instead
    of a gRPC GetLoad — TCP/shm template nodes), OR a mapping
    ``{serving_addr: exporter_target}`` — the exporter is scraped but
    the result is recorded under the replica's SERVING address, which
    is how a tcp/shm pool replica (whose exporter is necessarily a
    different socket) joins the fleet view under its own name instead
    of being listed unscraped.  ``pool``: a
    :class:`~..routing.pool.NodePool` whose live registry is re-read
    every sweep — grpc replicas ride the GetLoad lane; replicas of
    other transports are reported in :attr:`FleetSnapshot.unscraped`
    unless the mapping form of ``http_targets`` names them (the
    TCP/shm protocols have no telemetry reply lane).  The alias
    registry is LIVE: :meth:`add_http_target` /
    :meth:`remove_http_target` register and drop exporter mappings at
    runtime (the gateway autoscaler calls them as replicas spawn and
    drain), and with a ``pool`` attached each sweep garbage-collects
    aliases whose serving address has left the pool registry — a
    departed replica must never linger as a stale scrape target.  ``include_local`` folds this
    process's own registry and flight record in as the
    :data:`LOCAL_REPLICA` pseudo-replica (offset zero) so driver-side
    client/pool families and node families meet in one view.

    ``observers``: callables receiving each :class:`FleetSnapshot`
    (the SLO engine's ``observe``); an observer raising is logged and
    never stops the sweep.  ``start()``/``stop()`` run the sweep on a
    background daemon thread at ``interval_s`` (the pool-probe
    cadence posture); ``scrape_once()`` is the synchronous sweep.
    """

    def __init__(
        self,
        targets: Sequence[TargetSpec] = (),
        *,
        http_targets: Union[
            Sequence[TargetSpec], Mapping[str, TargetSpec]
        ] = (),
        pool: Optional[Any] = None,
        interval_s: float = 2.0,
        timeout_s: float = 2.0,
        include_local: bool = True,
        flightrec_tail: int = 128,
        history: int = 64,
        observers: Iterable[Callable[["FleetSnapshot"], Any]] = (),
    ):
        if targets:
            # The GetLoad lane is gRPC's: loud at construction, never a
            # collector whose every sweep marks these targets stale.
            from ..service._grpc_lane import grpc_lane_unavailable

            grpc_lane_unavailable("FleetCollector(targets=...)")
        self._targets = [_as_addr(t) for t in targets]
        if isinstance(http_targets, Mapping):
            self._http_targets: List[Tuple[str, int]] = []
            self._http_aliases = {
                str(addr): _as_addr(t)
                for addr, t in http_targets.items()
            }
        else:
            self._http_targets = [_as_addr(t) for t in http_targets]
            self._http_aliases = {}
        self.pool = pool
        self.interval_s = float(interval_s)
        self.timeout_s = float(timeout_s)
        self.include_local = bool(include_local)
        self.flightrec_tail = int(flightrec_tail)
        self.observers: List[Callable[["FleetSnapshot"], Any]] = list(
            observers
        )
        self.history: Deque[FleetSnapshot] = deque(maxlen=int(history))
        self._lock = threading.Lock()
        # Aliases registered at RUNTIME (add_http_target) follow pool
        # membership and are GC'd when their replica departs;
        # constructor-passed aliases are static configuration and are
        # never GC'd (they may name non-pool exporters).
        self._dynamic_aliases: set = set()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        # Addresses whose clock-offset gauge child this collector set
        # last sweep — so replicas that die or leave the pool get
        # their child REMOVED instead of exporting a stale offset
        # forever (and churn can't grow the label set without bound).
        self._offset_replicas: set = set()

    # -- target registry --------------------------------------------------

    def add_http_target(
        self, record_as: str, target: TargetSpec
    ) -> None:
        """Register (or re-point) an exporter alias at runtime: the
        exporter at ``target`` is scraped and recorded under the
        replica's serving address ``record_as`` — the hook the gateway
        autoscaler calls when it spawns a tcp/shm replica, so the
        fleet view follows scale-up without a collector restart."""
        with self._lock:
            self._http_aliases[str(record_as)] = _as_addr(target)
            self._dynamic_aliases.add(str(record_as))

    def remove_http_target(self, record_as: str) -> None:
        """Drop an exporter alias (idempotent) — scale-down's half of
        :meth:`add_http_target`: a drained replica stops being scraped
        on the next sweep instead of lingering as a stale target."""
        with self._lock:
            self._http_aliases.pop(str(record_as), None)
            self._dynamic_aliases.discard(str(record_as))

    def _sweep_targets(
        self,
    ) -> Tuple[List[Tuple[str, int, str, str]], List[str]]:
        """-> ([(host, port, lane, record_as)], [unscrapable pool
        addresses]).  ``record_as`` is the fleet-view address the
        scrape lands under — the scraped socket itself except for
        ``http_targets`` aliases, where a replica's exporter is
        scraped but recorded under its serving address."""
        seen: set = set()
        out: List[Tuple[str, int, str, str]] = []
        unscraped: List[str] = []
        for host, port in self._targets:
            if f"{host}:{port}" not in seen:
                seen.add(f"{host}:{port}")
                out.append((host, port, "grpc", f"{host}:{port}"))
        for host, port in self._http_targets:
            if f"{host}:{port}" not in seen:
                seen.add(f"{host}:{port}")
                out.append((host, port, "http", f"{host}:{port}"))
        with self._lock:
            aliases = dict(self._http_aliases)
            dynamic = set(self._dynamic_aliases)
        if self.pool is not None and dynamic:
            # Runtime-registered aliases (add_http_target) follow the
            # live pool registry: a DYNAMIC alias whose serving
            # address has left the pool is a departed autoscaled
            # replica — GC it so churn can neither scrape ghosts nor
            # grow the alias map without bound.  Static (constructor)
            # aliases are configuration and are never GC'd.  The
            # membership re-check and the pop happen under ONE lock
            # hold (with the registry re-read inside it), so a
            # replica re-spawned on the same address — whose
            # add_replica happens-before its add_http_target — can
            # never have its fresh registration collected: either the
            # re-read sees the replica, or the registration lands
            # after the pop and survives.
            live = {r.address for r in self.pool.replicas}
            for record_as in list(aliases):
                if record_as not in dynamic or record_as in live:
                    continue
                removed = False
                with self._lock:
                    if record_as in self._dynamic_aliases and (
                        record_as
                        not in {r.address for r in self.pool.replicas}
                    ):
                        self._http_aliases.pop(record_as, None)
                        self._dynamic_aliases.discard(record_as)
                        removed = True
                if removed:
                    del aliases[record_as]
                    _flightrec.record(
                        "collector.target_gc", replica=record_as
                    )
        for record_as, (host, port) in aliases.items():
            if record_as not in seen:
                seen.add(record_as)
                out.append((host, port, "http", record_as))
        if self.pool is not None:
            for replica in self.pool.replicas:
                if replica.address in seen:
                    continue
                seen.add(replica.address)
                if replica.transport == "grpc":
                    out.append(
                        (
                            replica.host, replica.port, "grpc",
                            replica.address,
                        )
                    )
                else:
                    # No telemetry reply lane on the tcp/shm wire: the
                    # replica is VISIBLY absent from the fleet view,
                    # not silently missing (map its exporter in
                    # http_targets={addr: (host, port)} to include it
                    # under this serving address).
                    unscraped.append(replica.address)
        return out, unscraped

    # -- scraping ---------------------------------------------------------

    def _ingest(
        self,
        scrape: ReplicaScrape,
        telemetry: dict,
        load: Optional[dict],
        t0_wall: float,
        t1_wall: float,
        rtt_s: float,
    ) -> None:
        scrape.rtt_s = rtt_s
        scrape.ok = True
        scrape.load = load
        scrape.metrics = telemetry.get("metrics") or {}
        traces = telemetry.get("traces")
        scrape.traces = traces if isinstance(traces, list) else []
        events = telemetry.get("flightrec")
        scrape.flightrec = events if isinstance(events, list) else []
        node_ts = telemetry.get("ts")
        if isinstance(node_ts, (int, float)):
            scrape.ts = float(node_ts)
            # Cristian: the node stamped its clock somewhere inside
            # [t0, t1] of our request; the midpoint is the minimum-
            # error estimate, off by at most ±RTT/2.
            scrape.clock_offset_s = scrape.ts - (t0_wall + t1_wall) / 2.0

    async def _scrape_one_async(
        self, host: str, port: int, lane: str, record_as: str
    ) -> ReplicaScrape:
        """One replica scrape (grpc GetLoad lane inline on the sweep
        loop; http lane handed to the executor so a slow exporter
        cannot serialize the sweep).  Never raises: a dead replica
        returns ``ok=False`` with the error string — the loud-stale
        verdict, not an exception tearing down the sweep."""
        import asyncio

        scrape = ReplicaScrape(record_as, lane)
        t0_wall = time.time()
        t0 = time.perf_counter()
        try:
            if lane == "http":
                loop = asyncio.get_running_loop()
                telemetry: Optional[dict] = await asyncio.wait_for(
                    loop.run_in_executor(
                        None, _scrape_http, host, port, self.timeout_s
                    ),
                    timeout=self.timeout_s + 1.0,
                )
                load = None
            else:
                from ..service._grpc_lane import grpc_lane_unavailable

                grpc_lane_unavailable(f"the GetLoad scrape of {record_as}")
            if telemetry is None:
                raise ConnectionError(
                    "no telemetry reply (unreachable, npproto-wire, or "
                    "pre-telemetry node)"
                )
        except Exception as e:
            scrape.error = f"{type(e).__name__}: {e}"
            return scrape
        self._ingest(
            scrape, telemetry, load,
            t0_wall, time.time(), time.perf_counter() - t0,
        )
        return scrape

    def _local_scrape(self) -> ReplicaScrape:
        from . import export as _export

        scrape = ReplicaScrape(LOCAL_REPLICA, "local")
        snap = _export.snapshot()
        scrape.ok = True
        scrape.ts = snap["ts"]
        scrape.rtt_s = 0.0
        scrape.clock_offset_s = 0.0
        scrape.metrics = snap["metrics"]
        scrape.traces = snap["traces"]
        scrape.flightrec = _flightrec.events(self.flightrec_tail)
        return scrape

    def scrape_once(self) -> FleetSnapshot:
        """One concurrent sweep over the live target registry; returns
        the fleet snapshot (also appended to :attr:`history` and
        handed to every observer).  Dead replicas are marked stale —
        loudly — and excluded from the merged view; the sweep itself
        is bounded by ``timeout_s`` per replica and never hangs on a
        dying peer."""
        targets, unscraped = self._sweep_targets()
        t0 = time.perf_counter()
        replicas: Dict[str, ReplicaScrape] = {}
        if targets:
            import asyncio

            from ..utils import get_event_loop

            async def sweep() -> List[ReplicaScrape]:
                return list(
                    await asyncio.gather(
                        *(
                            self._scrape_one_async(
                                host, port, lane, record_as
                            )
                            for host, port, lane, record_as in targets
                        )
                    )
                )

            # One cached loop per calling thread (the repo's grpc.aio
            # convention — channels are loop-bound, and a fresh loop
            # per sweep thrashes the shared poller; same posture as
            # NodePool.probe_once).
            for scrape in get_event_loop().run_until_complete(sweep()):
                replicas[scrape.address] = scrape
        if self.include_local:
            replicas[LOCAL_REPLICA] = self._local_scrape()
        stale = sorted(
            a for a, s in replicas.items() if not s.ok
        )
        for addr in stale:
            _SCRAPES.labels(outcome="error").inc()
            _flightrec.record(
                "collector.replica_stale",
                replica=addr,
                error=replicas[addr].error,
            )
        offset_addrs: set = set()
        for addr, scrape in replicas.items():
            if not scrape.ok:
                continue
            if scrape.lane != "local":
                _SCRAPES.labels(outcome="ok").inc()
                if scrape.rtt_s is not None:
                    _SCRAPE_S.observe(scrape.rtt_s)
            if scrape.clock_offset_s is not None:
                _CLOCK_OFFSET.labels(replica=addr).set(
                    scrape.clock_offset_s
                )
                offset_addrs.add(addr)
        for addr in self._offset_replicas - offset_addrs:
            _CLOCK_OFFSET.remove(replica=addr)
        self._offset_replicas = offset_addrs
        _STALE.set(len(stale))
        merged = merge_metric_snapshots(
            {a: s.metrics for a, s in replicas.items() if s.ok}
        )
        snapshot = FleetSnapshot(
            ts=time.time(),
            replicas=replicas,
            merged=merged,
            stale=stale,
            unscraped=sorted(unscraped),
        )
        _flightrec.record(
            "collector.scrape",
            n_ok=len(replicas) - len(stale),
            n_stale=len(stale),
            n_unscraped=len(unscraped),
            wall_s=round(time.perf_counter() - t0, 6),
        )
        with self._lock:
            self.history.append(snapshot)
        for observer in self.observers:
            try:
                observer(snapshot)
            except Exception:
                _log.exception("fleet-snapshot observer failed")
        return snapshot

    def latest(self) -> Optional[FleetSnapshot]:
        """The newest snapshot, or ``None`` before the first sweep."""
        with self._lock:
            return self.history[-1] if self.history else None

    # -- background sweep -------------------------------------------------

    def start(self) -> "FleetCollector":
        """Start the background sweep loop (idempotent); returns self."""
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return self
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop,
                name="pftpu-fleet-collector",
                daemon=True,
            )
            self._thread.start()
        _active.add(self)
        return self

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.scrape_once()
            except Exception:  # one bad sweep must never kill the loop
                _log.exception("fleet scrape sweep failed")
            self._stop.wait(self.interval_s)

    def stop(self) -> None:
        self._stop.set()
        thread = self._thread
        if thread is not None:
            thread.join(timeout=self.timeout_s + 5.0)
            self._thread = None
        _active.discard(self)

    def __enter__(self) -> "FleetCollector":
        return self.start()

    def __exit__(self, *exc: Any) -> None:
        self.stop()


def bundle_sections(*, timeline_tail: int = 256) -> Optional[list]:
    """The fleet picture for an incident bundle: a LIST with one entry
    per live collector — the latest snapshot's staleness record plus
    the clock-aligned timeline tail.  ``None`` when no collector is
    running (ordinary single-process bundles stay clean) — mirror of
    the fault_plan section's contract in
    :func:`.watchdog.write_incident_bundle`.  Always a list, even for
    a lone collector, so bundle consumers never shape-switch."""
    sections = []
    for collector in list(_active):
        snapshot = collector.latest()
        if snapshot is None:
            continue
        sections.append(
            {
                "ts": snapshot.ts,
                "complete": snapshot.complete,
                "stale": snapshot.stale,
                "unscraped": snapshot.unscraped,
                "replicas": {
                    a: {
                        "ok": s.ok,
                        "error": s.error,
                        "rtt_s": s.rtt_s,
                        "clock_offset_s": s.clock_offset_s,
                    }
                    for a, s in snapshot.replicas.items()
                },
                "timeline": snapshot.timeline(tail=timeline_tail),
            }
        )
    return sections or None

"""Declarative SLOs + a multi-window burn-rate engine over fleet
snapshots.

An :class:`Slo` declares what the fleet owes its callers — a goodput
floor, a p99 latency line, a shed-fraction budget — and a
:class:`BurnRateEngine` turns successive
:class:`~.collector.FleetSnapshot` sweeps into the classic
multi-window **burn rate**: how fast the fleet is consuming its error
budget, per look-back window.  Burn 1.0 = consuming budget exactly as
fast as the SLO allows; > 1 = on course to blow it (page); the short
window catches a cliff in seconds while the long window rides out
blips — the standard SRE alerting shape, computed here from the SAME
merged registries the rest of the fleet plane uses.

Objective semantics (per window, from counter/histogram DELTAS):

- ``p99_s``: budget = 1% of calls may exceed the line (that is what
  p99 *means*); burn = (fraction of the window's observations above
  the line) / 0.01, read bucket-wise from the latency histogram — so
  the line should sit on a bucket boundary of the shared ladder
  (:data:`~.metrics.DEFAULT_LATENCY_BUCKETS`) or it is rounded DOWN to
  one (conservative: the straddling bucket's calls all count against
  the budget).
- ``shed_frac_max``: burn = (shed fraction of the window) / budget.
- ``goodput_min``: a floor, not a ratio of bad events — burn =
  floor / observed goodput (capped; an idle fleet with zero traffic
  reports no goodput burn rather than a false page).

Window burn = max over declared objectives; engine burn = max over
windows.  Deltas are computed PER REPLICA between the two snapshots
bounding each window and only for replicas fresh in both — a replica
dying mid-window (or a counter reset on restart) can therefore never
produce a negative delta or a torn aggregate; it simply stops
contributing, while the collector's staleness marking keeps its death
loud.

Every ``observe()`` updates ``pftpu_slo_burn_rate`` (gauge, per
window) and flight-records ``slo.burn`` whenever any window burns
above 1 — the signal bus a future autoscaler consumes.
"""

from __future__ import annotations

import bisect
import dataclasses
import threading
from collections import deque
from typing import Any, Deque, Dict, Mapping, Optional, Sequence, Tuple

from . import flightrec as _flightrec
from . import metrics as _metrics

__all__ = ["Slo", "BurnRateEngine"]

_BURN = _metrics.gauge(
    "pftpu_slo_burn_rate",
    "SLO error-budget burn rate (max over objectives), per window",
    ("window",),
)

#: Burn values are capped here: a zero-goodput window against a floor
#: objective is "infinitely" bad, but an actual inf poisons JSON
#: artifacts and chart axes alike.
_BURN_CAP = 1000.0

_EVALUATE_METHODS = (
    "evaluate",
    "evaluate_stream",
    "evaluate_batch",
    "evaluate_reduce",
)


@dataclasses.dataclass(frozen=True)
class Slo:
    """One service-level objective set (module docstring).

    ``latency_metric`` defaults to the driver-observed per-attempt
    histogram (``pftpu_client_call_seconds`` — end-to-end, the number
    callers feel; the collector's ``include_local`` pseudo-replica is
    what brings it into the fleet view).  ``requests_metric`` /
    ``sheds_metric`` / ``errors_metric`` default to the node-side
    families every serving lane shares, so goodput and shed fractions
    aggregate across the whole fleet regardless of transport."""

    name: str = "default"
    goodput_min: Optional[float] = None
    p99_s: Optional[float] = None
    shed_frac_max: Optional[float] = None
    latency_metric: str = "pftpu_client_call_seconds"
    requests_metric: str = "pftpu_server_requests_total"
    sheds_metric: str = "pftpu_admission_shed_total"
    errors_metric: str = "pftpu_server_errors_total"
    #: The partition lane's shard-granular counters —
    #: ``{outcome=ok|error}`` items served into reduce windows and
    #: reassemblies.  They refine the error clamp below: shard errors
    #: are request-granular evidence, so a replica that answered few
    #: (or zero) FRAMES but refused shards must not fold to zero
    #: errors and read healthy.
    partition_metric: str = "pftpu_partition_shards_total"

    def __post_init__(self) -> None:
        if (
            self.goodput_min is None
            and self.p99_s is None
            and self.shed_frac_max is None
        ):
            raise ValueError(
                "an Slo needs at least one objective (goodput_min, "
                "p99_s, or shed_frac_max)"
            )


# One replica's extracted sample: counters + a flattened histogram.
_Hist = Tuple[int, Dict[float, int]]  # (count, {bound: n})


def _counter_total(
    metrics_map: Mapping[str, Any],
    name: str,
    label: Optional[str] = None,
    allowed: Optional[Sequence[str]] = None,
) -> float:
    fam = metrics_map.get(name) or {}
    total = 0.0
    for child in fam.get("children", ()):
        if label is not None and allowed is not None:
            if (child.get("labels") or {}).get(label) not in allowed:
                continue
        v = child.get("value")
        if isinstance(v, (int, float)):
            total += v
    return total


def _hist_flat(metrics_map: Mapping[str, Any], name: str) -> _Hist:
    fam = metrics_map.get(name) or {}
    count = 0
    buckets: Dict[float, int] = {}
    for child in fam.get("children", ()):
        count += int(child.get("count", 0))
        for bound, n in (child.get("buckets") or {}).items():
            b = float(bound)
            buckets[b] = buckets.get(b, 0) + int(n)
    return count, buckets


def _hist_delta(new: _Hist, old: _Hist) -> _Hist:
    count = new[0] - old[0]
    if count < 0:  # reset: the restarted process's whole history counts
        return new
    buckets = {
        b: max(0, n - old[1].get(b, 0)) for b, n in new[1].items()
    }
    return count, buckets


def _frac_over(hist: _Hist, threshold_s: float) -> Optional[float]:
    """Fraction of the histogram's observations above ``threshold_s``,
    bucket-wise.  A threshold sitting exactly on a bucket bound counts
    that bucket as good; a threshold INSIDE a bucket counts the whole
    straddling bucket against the budget (conservative — borderline
    calls can only hurt, never help).  Observations beyond the last
    bound are the count minus the bucket sum."""
    count, buckets = hist
    if count <= 0:
        return None
    bounds = sorted(buckets)
    idx = bisect.bisect_left(bounds, threshold_s)
    if idx < len(bounds) and bounds[idx] == threshold_s:
        idx += 1
    good = sum(buckets[b] for b in bounds[:idx])
    return max(0, count - good) / count


class BurnRateEngine:
    """Fold successive fleet snapshots into per-window burn rates
    (module docstring).  Thread-safe; wire it to a collector as an
    observer — ``FleetCollector(..., observers=[engine.observe])`` —
    or call :meth:`observe` by hand between sweeps."""

    def __init__(
        self,
        slo: Slo,
        *,
        windows_s: Sequence[float] = (60.0, 300.0),
        max_samples: int = 512,
    ):
        if not windows_s:
            raise ValueError("need at least one look-back window")
        self.slo = slo
        self.windows_s = tuple(sorted(float(w) for w in windows_s))
        self._samples: Deque[dict] = deque(maxlen=int(max_samples))
        self._lock = threading.Lock()
        self._last_report: Optional[dict] = None

    # -- sampling ---------------------------------------------------------

    def _extract(self, snapshot: Any) -> dict:
        """Per-FRESH-replica counter/histogram values of one sweep."""
        per_replica: Dict[str, dict] = {}
        for addr, scrape in snapshot.replicas.items():
            if not scrape.ok or scrape.metrics is None:
                continue
            m = scrape.metrics
            per_replica[addr] = {
                "requests": _counter_total(
                    m, self.slo.requests_metric,
                    "method", _EVALUATE_METHODS,
                ),
                "errors": _counter_total(m, self.slo.errors_metric),
                "sheds": _counter_total(m, self.slo.sheds_metric),
                "shards": _counter_total(m, self.slo.partition_metric),
                "shard_errors": _counter_total(
                    m, self.slo.partition_metric, "outcome", ("error",)
                ),
                "latency": _hist_flat(m, self.slo.latency_metric),
            }
        return {"ts": snapshot.ts, "replicas": per_replica}

    def observe(self, snapshot: Any) -> dict:
        """Ingest one :class:`~.collector.FleetSnapshot`; returns the
        current burn report (also kept as :meth:`report`)."""
        sample = self._extract(snapshot)
        with self._lock:
            self._samples.append(sample)
            report = self._compute(sample)
            self._last_report = report
        burn = report["burn_rate"]
        for window, rec in report["windows"].items():
            wburn = rec.get("burn_rate")
            _BURN.labels(window=window).set(
                wburn if wburn is not None else 0.0
            )
        if burn is not None and burn > 1.0:
            _flightrec.record(
                "slo.burn",
                slo=self.slo.name,
                burn_rate=round(burn, 3),
                windows={
                    w: round(rec["burn_rate"], 3)
                    for w, rec in report["windows"].items()
                    if rec.get("burn_rate") is not None
                },
            )
        return report

    def report(self) -> Optional[dict]:
        """The most recent burn report, or ``None`` before the first
        :meth:`observe`."""
        with self._lock:
            return self._last_report

    # -- burn math --------------------------------------------------------

    def _window_delta(
        self, newest: dict, window_s: float
    ) -> Optional[dict]:
        """Aggregate per-replica deltas between the newest sample and
        the oldest one inside the window; ``None`` until two samples
        span it."""
        horizon = newest["ts"] - window_s
        oldest = None
        for sample in self._samples:
            if sample is newest:
                continue
            if sample["ts"] >= horizon:
                oldest = sample
                break
        if oldest is None or newest["ts"] <= oldest["ts"]:
            return None
        elapsed = newest["ts"] - oldest["ts"]
        requests = errors = sheds = 0.0
        shards = shard_errors = 0.0
        latency: _Hist = (0, {})

        def cdelta(new_v: float, old_v: float) -> float:
            # Counter-reset rule (same as the histogram path): a value
            # below its baseline means the process restarted, and its
            # whole new history is the window's increase.
            d = new_v - old_v
            return new_v if d < 0 else d

        for addr, new in newest["replicas"].items():
            old = oldest["replicas"].get(addr)
            if old is None:
                continue  # appeared mid-window: no baseline yet
            req_d = cdelta(new["requests"], old["requests"])
            requests += req_d
            # Partition lane: shard items are
            # request-granular — clamp per-shard ERROR deltas at
            # per-shard REQUEST deltas, mirroring the frame-level
            # underflow clamp below at shard granularity (a shard
            # cannot fail more than once for goodput purposes).
            shard_d = cdelta(
                new.get("shards", 0.0), old.get("shards", 0.0)
            )
            shard_err_d = min(
                cdelta(
                    new.get("shard_errors", 0.0),
                    old.get("shard_errors", 0.0),
                ),
                shard_d,
            )
            shards += shard_d
            shard_errors += shard_err_d
            # Errors count per ITEM on the batch lanes while requests
            # count frames — clamp per replica (a frame cannot fail
            # more than once for goodput purposes) so a corrupt batch
            # window can never underflow the fleet's goodput into a
            # false all-bad page.  The ceiling includes the SHARD
            # error delta: a replica that answered zero (or few)
            # counted frames while refusing partition shards used to
            # fold its errors to zero and read HEALTHY — shard errors
            # are request-granular evidence and keep it in the
            # goodput's bad column.
            errors += min(
                cdelta(new["errors"], old["errors"]),
                req_d + shard_err_d,
            )
            sheds += cdelta(new["sheds"], old["sheds"])
            d = _hist_delta(new["latency"], old["latency"])
            merged_buckets = dict(latency[1])
            for b, n in d[1].items():
                merged_buckets[b] = merged_buckets.get(b, 0) + n
            latency = (latency[0] + d[0], merged_buckets)
        return {
            "elapsed_s": elapsed,
            "requests": requests,
            "errors": errors,
            "sheds": sheds,
            "shards": shards,
            "shard_errors": shard_errors,
            "latency": latency,
        }

    def _compute(self, newest: dict) -> dict:
        windows: Dict[str, dict] = {}
        overall: Optional[float] = None
        for window_s in self.windows_s:
            key = f"{window_s:g}s"
            delta = self._window_delta(newest, window_s)
            if delta is None:
                windows[key] = {"burn_rate": None}
                continue
            objectives: Dict[str, float] = {}
            goodput = (
                max(
                    0.0,
                    delta["requests"] - delta["errors"] - delta["sheds"],
                )
                / delta["elapsed_s"]
            )
            if (
                self.slo.goodput_min is not None
                and delta["requests"] > 0
            ):
                objectives["goodput"] = min(
                    _BURN_CAP, self.slo.goodput_min / max(goodput, 1e-9)
                )
            if self.slo.p99_s is not None:
                frac_bad = _frac_over(delta["latency"], self.slo.p99_s)
                if frac_bad is not None:
                    objectives["p99"] = min(
                        _BURN_CAP, frac_bad / 0.01
                    )
            if (
                self.slo.shed_frac_max is not None
                and delta["requests"] > 0
            ):
                frac_shed = delta["sheds"] / max(delta["requests"], 1.0)
                objectives["shed"] = min(
                    _BURN_CAP, frac_shed / self.slo.shed_frac_max
                )
            burn = max(objectives.values()) if objectives else None
            windows[key] = {
                "burn_rate": burn,
                "objectives": objectives,
                "goodput_rps": goodput,
                "requests": delta["requests"],
                "sheds": delta["sheds"],
                "errors": delta["errors"],
                "shards": delta.get("shards", 0.0),
                "shard_errors": delta.get("shard_errors", 0.0),
                "elapsed_s": delta["elapsed_s"],
            }
            if burn is not None:
                overall = burn if overall is None else max(overall, burn)
        return {
            "ts": newest["ts"],
            "slo": self.slo.name,
            "burn_rate": overall,
            "violating": bool(overall is not None and overall > 1.0),
            "windows": windows,
        }

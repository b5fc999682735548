"""Process-global metrics: counters, gauges, fixed-bucket histograms.

The quantitative half of the telemetry subsystem (spans are the
structural half, :mod:`.spans`).  Deliberately dependency-free — no
prometheus_client, no OpenTelemetry SDK: the container cannot grow new
dependencies, and the subset needed here (three instrument kinds, one
registry, one text renderer) is small enough to own outright, the same
way :mod:`..service.npproto_codec` owns its proto3 subset.

Concurrency model: every instrument family holds one ``threading.Lock``
guarding child creation AND value updates.  Python-level locks cost
~100 ns uncontended — invisible next to the millisecond-scale RPC and
compute paths being measured — and make multi-field updates
(histogram count+sum+bucket) atomic across threads; asyncio callers
are single-threaded per loop and inherit the same safety.  When
telemetry is disabled (:func:`~.spans.set_enabled`), every mutator
returns before touching the lock, so the disabled cost is one global
load + one branch (the bench gate in bench.py measures it).

Naming follows Prometheus conventions: ``pftpu_`` prefix, base-unit
``_seconds``/``_bytes`` suffixes, counters ending ``_total``.  The
text renderer emits classic exposition format 0.0.4 (``# HELP``,
``# TYPE``, cumulative ``_bucket{le=...}`` histograms) — scrapeable by
an unmodified Prometheus and validated by the golden-file test.
"""

from __future__ import annotations

import bisect
import math
import threading
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

from . import spans as _spans

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "Registry",
    "REGISTRY",
    "counter",
    "gauge",
    "histogram",
    "render_prometheus",
    "snapshot",
    "DEFAULT_LATENCY_BUCKETS",
]

# Fixed latency buckets (seconds): 100 us .. 10 s in a 1-2.5-5 ladder.
# Fixed (not adaptive) so node and driver histograms aggregate across
# processes by simple bucket-wise summation — the property Prometheus
# histograms are built around.
DEFAULT_LATENCY_BUCKETS: Tuple[float, ...] = (
    1e-4, 2.5e-4, 5e-4,
    1e-3, 2.5e-3, 5e-3,
    1e-2, 2.5e-2, 5e-2,
    1e-1, 2.5e-1, 5e-1,
    1.0, 2.5, 5.0, 10.0,
)

# Small-integer buckets (counts: fanout widths, pipeline window depths).
DEFAULT_COUNT_BUCKETS: Tuple[float, ...] = (
    1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0,
)


def _validate_name(name: str) -> None:
    # Prometheus metric/label names: [a-zA-Z_:][a-zA-Z0-9_:]*
    if not name or not all(c.isalnum() or c in "_:" for c in name) or (
        name[0].isdigit()
    ):
        raise ValueError(f"invalid metric/label name {name!r}")


def _escape_label_value(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _format_value(v: float) -> str:
    """Exposition-format number: integers render bare (no trailing .0),
    +Inf/-Inf/NaN in their spec spellings."""
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if math.isnan(v):
        return "NaN"
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(v)


class _Family:
    """Shared machinery: a named instrument with 0+ label dimensions;
    children are materialized per label-value tuple on first use."""

    kind = "untyped"

    def __init__(
        self,
        name: str,
        help: str,
        labelnames: Sequence[str] = (),
    ):
        _validate_name(name)
        for ln in labelnames:
            _validate_name(ln)
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._children: Dict[Tuple[str, ...], object] = {}
        if not self.labelnames:
            # Pre-materialize the single unlabeled child so the
            # no-label fast path never takes the creation branch.
            self._children[()] = self._make_child()

    def _make_child(self):
        raise NotImplementedError

    def labels(self, **kv: str):
        if set(kv) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: expected labels {self.labelnames}, "
                f"got {tuple(sorted(kv))}"
            )
        key = tuple(str(kv[ln]) for ln in self.labelnames)
        child = self._children.get(key)
        if child is None:
            with self._lock:
                child = self._children.setdefault(key, self._make_child())
        return child

    def _default_child(self):
        return self._children[()]

    def remove(self, **kv: str) -> None:
        """Drop one label-set's child (no-op when absent).  For gauges
        whose label values name transient identities — replicas, peers
        — so a long-running process with churn does not grow the label
        set without bound or keep exporting values for hosts that no
        longer exist."""
        if not self.labelnames:
            raise ValueError(
                f"{self.name}: remove() is for labeled families — the "
                "unlabeled default child is permanent"
            )
        if set(kv) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: expected labels {self.labelnames}, "
                f"got {tuple(sorted(kv))}"
            )
        key = tuple(str(kv[ln]) for ln in self.labelnames)
        with self._lock:
            self._children.pop(key, None)

    def samples(self) -> List[Tuple[str, Dict[str, str], float]]:
        """``(suffixed_name, labels, value)`` rows for rendering."""
        out = []
        with self._lock:
            items = list(self._children.items())
        for key, child in items:
            labels = dict(zip(self.labelnames, key))
            out.extend(child._samples(self.name, labels))  # type: ignore
        return out

    def _reset(self) -> None:
        with self._lock:
            for child in self._children.values():
                child._reset_values()  # type: ignore[attr-defined]


class _CounterChild:
    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if not _spans.enabled():
            return
        if amount < 0:
            raise ValueError("counters can only increase")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        return self._value

    def _samples(self, name, labels):
        return [(name, labels, self._value)]

    def _reset_values(self):
        self._value = 0.0


class Counter(_Family):
    """Monotonic counter family; name should end ``_total``."""

    kind = "counter"

    def _make_child(self):
        return _CounterChild()

    # Unlabeled convenience mutators forward to the single child.
    def inc(self, amount: float = 1.0) -> None:
        self._default_child().inc(amount)

    @property
    def value(self) -> float:
        return self._default_child().value


class _GaugeChild:
    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, value: float) -> None:
        if not _spans.enabled():
            return
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        if not _spans.enabled():
            return
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)

    @property
    def value(self) -> float:
        return self._value

    def _samples(self, name, labels):
        return [(name, labels, self._value)]

    def _reset_values(self):
        self._value = 0.0


class Gauge(_Family):
    """Set/inc/dec instantaneous value (in-flight RPCs, widths)."""

    kind = "gauge"

    def _make_child(self):
        return _GaugeChild()

    def set(self, value: float) -> None:
        self._default_child().set(value)

    def inc(self, amount: float = 1.0) -> None:
        self._default_child().inc(amount)

    def dec(self, amount: float = 1.0) -> None:
        self._default_child().dec(amount)

    @property
    def value(self) -> float:
        return self._default_child().value


class _HistogramChild:
    __slots__ = ("_lock", "_bounds", "_buckets", "_sum", "_count",
                 "_exemplar")

    def __init__(self, bounds: Tuple[float, ...]):
        self._lock = threading.Lock()
        self._bounds = bounds
        self._buckets = [0] * (len(bounds) + 1)  # +1 = the +Inf bucket
        self._sum = 0.0
        self._count = 0
        # Last (value, trace_id_hex) observed under an active trace —
        # the exemplar that lets a human jump from "p99 spiked" to one
        # concrete correlated span tree (exposed via snapshot(), not
        # the classic text format, which predates exemplars).
        self._exemplar: Optional[Tuple[float, str]] = None

    def observe(self, value: float) -> None:
        if not _spans.enabled():
            return
        idx = bisect.bisect_left(self._bounds, value)
        tid = _spans.current_trace_id()
        with self._lock:
            self._buckets[idx] += 1
            self._sum += value
            self._count += 1
            if tid is not None:
                self._exemplar = (value, tid.hex())

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def approx_quantile(self, q: float) -> float:
        """Quantile estimate from the cumulative buckets (upper bound
        of the bucket containing the q-th observation) — the same
        estimate ``histogram_quantile`` makes server-side, computed
        here so GetLoad can fold a latency summary into its reply
        without shipping raw buckets."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        with self._lock:
            total = self._count
            if total == 0:
                return float("nan")
            rank = q * total
            seen = 0
            for i, n in enumerate(self._buckets):
                seen += n
                if seen >= rank and n:
                    return (
                        self._bounds[i]
                        if i < len(self._bounds)
                        else float("inf")
                    )
        return float("inf")

    def _samples(self, name, labels):
        with self._lock:
            buckets = list(self._buckets)
            s, c = self._sum, self._count
        out = []
        cum = 0
        for bound, n in zip(self._bounds, buckets):
            cum += n
            out.append(
                (name + "_bucket", {**labels, "le": _format_value(bound)},
                 float(cum))
            )
        out.append((name + "_bucket", {**labels, "le": "+Inf"}, float(c)))
        out.append((name + "_sum", labels, s))
        out.append((name + "_count", labels, float(c)))
        return out

    def _reset_values(self):
        with self._lock:
            self._buckets = [0] * (len(self._bounds) + 1)
            self._sum = 0.0
            self._count = 0
            self._exemplar = None


class Histogram(_Family):
    """Fixed-bucket cumulative histogram (Prometheus semantics)."""

    kind = "histogram"

    def __init__(
        self,
        name: str,
        help: str,
        labelnames: Sequence[str] = (),
        *,
        buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS,
    ):
        bounds = tuple(float(b) for b in buckets)
        if list(bounds) != sorted(set(bounds)):
            raise ValueError(f"buckets must be sorted unique, got {buckets}")
        if bounds and math.isinf(bounds[-1]):
            bounds = bounds[:-1]  # +Inf is implicit
        self._bounds = bounds
        super().__init__(name, help, labelnames)

    def _make_child(self):
        return _HistogramChild(self._bounds)

    def observe(self, value: float) -> None:
        self._default_child().observe(value)

    @property
    def count(self) -> int:
        return self._default_child().count

    @property
    def sum(self) -> float:
        return self._default_child().sum

    def approx_quantile(self, q: float) -> float:
        return self._default_child().approx_quantile(q)


class Registry:
    """Name -> instrument family map; the process-global one is
    :data:`REGISTRY`.  Get-or-create semantics so every instrumented
    module can declare its instruments at import time in any order;
    re-declaring with a DIFFERENT type/labelset/buckets raises (two
    call sites disagreeing about a metric is a bug, not a merge)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._families: Dict[str, _Family] = {}

    def _get_or_create(self, cls, name, help, labelnames, **kwargs):
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = cls(name, help, labelnames, **kwargs)
                self._families[name] = fam
                return fam
        if type(fam) is not cls or fam.labelnames != tuple(labelnames):
            raise ValueError(
                f"metric {name!r} already registered as "
                f"{type(fam).__name__}{fam.labelnames}, cannot re-register "
                f"as {cls.__name__}{tuple(labelnames)}"
            )
        if (
            isinstance(fam, Histogram)
            and "buckets" in kwargs
            and fam._bounds != tuple(float(b) for b in kwargs["buckets"])
        ):
            raise ValueError(
                f"histogram {name!r} already registered with buckets "
                f"{fam._bounds}"
            )
        return fam

    def counter(self, name, help, labelnames=()) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(self, name, help, labelnames=()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(
        self, name, help, labelnames=(), *, buckets=DEFAULT_LATENCY_BUCKETS
    ) -> Histogram:
        return self._get_or_create(
            Histogram, name, help, labelnames, buckets=buckets
        )

    def families(self) -> List[_Family]:
        with self._lock:
            return sorted(self._families.values(), key=lambda f: f.name)

    def get(self, name: str) -> Optional[_Family]:
        with self._lock:
            return self._families.get(name)

    def reset(self) -> None:
        """Zero every instrument's VALUES, keeping registrations — the
        test-isolation hook.  Instruments are module-level singletons in
        the instrumented code, so dropping registrations would orphan
        the references those modules already hold."""
        for fam in self.families():
            fam._reset()


#: The process-global registry every instrumented module records into.
REGISTRY = Registry()


def counter(name: str, help: str, labelnames: Sequence[str] = ()) -> Counter:
    """Get-or-create a counter in the global registry."""
    return REGISTRY.counter(name, help, labelnames)


def gauge(name: str, help: str, labelnames: Sequence[str] = ()) -> Gauge:
    """Get-or-create a gauge in the global registry."""
    return REGISTRY.gauge(name, help, labelnames)


def histogram(
    name: str,
    help: str,
    labelnames: Sequence[str] = (),
    *,
    buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS,
) -> Histogram:
    """Get-or-create a fixed-bucket histogram in the global registry."""
    return REGISTRY.histogram(name, help, labelnames, buckets=buckets)


def render_prometheus(registry: Optional[Registry] = None) -> str:
    """Classic Prometheus exposition text (format 0.0.4).

    Deterministic: families alphabetical, children in insertion order,
    labels in declaration order — so a fixed sequence of observations
    renders byte-identically (the golden-file test depends on it).
    """
    registry = registry or REGISTRY
    lines: List[str] = []
    for fam in registry.families():
        lines.append(f"# HELP {fam.name} {fam.help}")
        lines.append(f"# TYPE {fam.name} {fam.kind}")
        for name, labels, value in fam.samples():
            if labels:
                body = ",".join(
                    f'{k}="{_escape_label_value(str(v))}"'
                    for k, v in labels.items()
                )
                lines.append(f"{name}{{{body}}} {_format_value(value)}")
            else:
                lines.append(f"{name} {_format_value(value)}")
    return "\n".join(lines) + "\n" if lines else ""


def snapshot(registry: Optional[Registry] = None) -> dict:
    """JSON-friendly dump of every family: values, histogram buckets,
    and exemplars (trace-id-bearing observations classic text format
    cannot carry)."""
    registry = registry or REGISTRY
    out: dict = {}
    for fam in registry.families():
        entry: dict = {"type": fam.kind, "help": fam.help}
        children = []
        with fam._lock:
            items = list(fam._children.items())
        for key, child in items:
            labels = dict(zip(fam.labelnames, key))
            if isinstance(child, _HistogramChild):
                with child._lock:
                    rec = {
                        "labels": labels,
                        "count": child._count,
                        "sum": child._sum,
                        "buckets": dict(
                            zip(
                                (_format_value(b) for b in child._bounds),
                                child._buckets,
                            )
                        ),
                    }
                    if child._exemplar is not None:
                        rec["exemplar"] = {
                            "value": child._exemplar[0],
                            "trace_id": child._exemplar[1],
                        }
            else:
                rec = {"labels": labels, "value": child.value}  # type: ignore
            children.append(rec)
        entry["children"] = children
        out[fam.name] = entry
    return out

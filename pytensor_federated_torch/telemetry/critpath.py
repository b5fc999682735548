"""Critical-path analysis over reunion-merged span trees.

The spans subsystem records WHERE time went per call; this module
turns a population of reunion-merged traces
(:func:`.reunion.merge_all`) into the answer an operator actually
needs: *which stage owns the latency*.  "p99 is 9 ms" becomes "6 ms
of it is queue wait on replica :50052".

Per trace, the end-to-end driver wall (the driver root span:
``rpc.evaluate`` / ``pool.evaluate`` / the ``evaluate_many`` twins) is
attributed to named stages:

==================  ========================================================
stage               source
==================  ========================================================
``driver_encode``   driver-side ``encode`` spans
``driver_decode``   driver-side ``decode`` spans
``driver_overhead`` driver root minus its direct children (retry loops,
                    pool pick/hedge bookkeeping between attempts)
``wire``            driver ``call``/``pool.attempt``/``pool.window`` span
                    minus the matched node tree's total — bytes in flight
                    plus transport stack both ways
``node_decode``     node ``decode_s`` attr (decode happens before the node
                    span opens; every lane stamps it as an attribute)
``node_queue``      node ``compute`` span's ``queue_wait_s`` attr
                    (thread-executor / micro-batcher coalescing queue)
``node_compute``    node ``compute`` span minus its queue wait
``node_encode``     node ``encode`` spans
==================  ========================================================

plus ``unattributed`` (whatever the spans did not cover — the report's
``coverage_frac`` is the attributed fraction, the honesty metric the
suite's fleet config gates at ≥ 90%).  When the node half of a trace
never arrived (reply lost, node dead before the GetLoad pull), the
whole call interval inside ``call`` stays in ``wire`` — visible, not
invented.

The report aggregates per-stage p50/p99/total, counts the DOMINANT
stage per trace, splits the decomposition per replica (the
``replica`` attr the pool stamps on its attempt spans), and runs a
fanout straggler diagnosis over ``fanout`` spans (width, straggler
gap, the member index that lost the race).  Pure functions over
dicts; no clock-sync assumption beyond per-process monotonic
durations (only DURATIONS are compared, never cross-process
timestamps — the fleet timeline in :mod:`.collector` owns wall-clock
alignment).

"""

from __future__ import annotations

import math
from typing import Any, Dict, Iterable, List, Mapping, Optional, Sequence

from . import reunion as _reunion

__all__ = [
    "STAGES",
    "analyze",
    "analyze_recent",
    "decompose_trace",
    "format_report",
]

#: Stage names, in pipeline order (the report renders them this way).
STAGES = (
    "driver_encode",
    "wire",
    "node_decode",
    "node_queue",
    "node_compute",
    "node_encode",
    "driver_decode",
    "driver_overhead",
)

_DRIVER_ROOTS = {
    "rpc.evaluate",
    "rpc.evaluate_many",
    "pool.evaluate",
    "pool.evaluate_many",
}
_CALL_SPANS = {"call", "pool.attempt", "pool.window"}
_NODE_ROOTS = {"node.evaluate", "node.evaluate_batch"}


def _walk(tree: Mapping[str, Any]) -> Iterable[Mapping[str, Any]]:
    yield tree
    for child in tree.get("children", ()):
        yield from _walk(child)


def _dur(span: Optional[Mapping[str, Any]]) -> float:
    if span is None:
        return 0.0
    d = span.get("duration_s")
    return float(d) if isinstance(d, (int, float)) else 0.0


def _attr(span: Mapping[str, Any], key: str) -> Optional[float]:
    v = (span.get("attrs") or {}).get(key)
    return float(v) if isinstance(v, (int, float)) else None


def _find_driver_root(
    trees: Sequence[Mapping[str, Any]],
) -> Optional[Mapping[str, Any]]:
    for tree in trees:
        if tree.get("name") in _DRIVER_ROOTS:
            return tree
    return None


def _node_total(tree: Mapping[str, Any]) -> float:
    """One node tree's whole served interval: span duration plus the
    pre-span decode the lanes stamp as ``decode_s``."""
    return _dur(tree) + (_attr(tree, "decode_s") or 0.0)


def decompose_trace(merged: Mapping[str, Any]) -> Optional[dict]:
    """Attribute ONE reunion-merged trace's driver wall to stages.

    ``merged`` is the :func:`.reunion.merged` shape (``driver`` +
    ``remote`` tree lists).  Returns ``None`` when the trace has no
    recognizable driver root (a node-only trace — e.g. pulled from a
    node whose driver ring already evicted its half).  The result maps
    every :data:`STAGES` name to seconds, plus ``wall_s``,
    ``unattributed_s``, ``coverage_frac``, ``dominant`` and
    ``replicas`` (per-replica attempt walls, from the pool's span
    attrs).
    """
    driver_root = _find_driver_root(merged.get("driver") or [])
    if driver_root is None:
        return None
    remote = [
        t
        for t in (merged.get("remote") or [])
        if t.get("name") in _NODE_ROOTS
    ]
    stages: Dict[str, float] = {s: 0.0 for s in STAGES}
    wall = _dur(driver_root)

    # Driver side: encode/decode anywhere under the root; the direct-
    # child gap is pool/retry bookkeeping.
    direct = driver_root.get("children", ())
    stages["driver_overhead"] = max(
        0.0, wall - sum(_dur(c) for c in direct)
    )
    # The wire interval is the INNERMOST call-ish span of each chain:
    # a pool.attempt wraps rpc.evaluate whose own `call` child is the
    # actual socket interval — counting the wrapper too would fold the
    # driver-side encode/decode it contains into "wire" twice.
    call_spans = _call_spans_of(driver_root)
    innermost = [
        span
        for span in call_spans
        if not any(
            d.get("name") in _CALL_SPANS for d in _descendants(span)
        )
    ]
    call_wall = sum(_dur(span) for span in innermost)
    replicas: Dict[str, float] = {}
    for span in call_spans:
        replica = (span.get("attrs") or {}).get("replica")
        if isinstance(replica, str):
            replicas[replica] = replicas.get(replica, 0.0) + _dur(span)
    for span in _walk(driver_root):
        name = span.get("name")
        if name == "encode":
            stages["driver_encode"] += _dur(span)
        elif name == "decode":
            stages["driver_decode"] += _dur(span)

    # Node side: every remote tree for this trace (retries/hedges can
    # contribute several) — their intervals all sit inside call_wall.
    node_total = 0.0
    for tree in remote:
        node_total += _node_total(tree)
        stages["node_decode"] += _attr(tree, "decode_s") or 0.0
        for span in _walk(tree):
            name = span.get("name")
            if name == "compute":
                queue = _attr(span, "queue_wait_s") or 0.0
                stages["node_queue"] += queue
                stages["node_compute"] += max(0.0, _dur(span) - queue)
            elif name == "encode":
                stages["node_encode"] += _dur(span)
    stages["wire"] = max(0.0, call_wall - node_total)
    # Node span time not in decode/queue/compute/encode (asarray
    # copies, span bookkeeping) stays unattributed — honesty over
    # completeness.
    attributed = sum(stages.values())
    unattributed = max(0.0, wall - attributed)
    dominant = max(stages, key=lambda s: stages[s]) if wall > 0 else None
    return {
        **stages,
        "wall_s": wall,
        "unattributed_s": unattributed,
        "coverage_frac": (
            min(1.0, attributed / wall) if wall > 0 else 0.0
        ),
        "dominant": dominant,
        "replicas": replicas,
        "trace_id": merged.get("trace_id"),
    }


def _call_spans_of(root: Mapping[str, Any]) -> List[Mapping[str, Any]]:
    return [s for s in _walk(root) if s.get("name") in _CALL_SPANS]


def _descendants(span: Mapping[str, Any]) -> List[Mapping[str, Any]]:
    out: List[Mapping[str, Any]] = []
    for child in span.get("children", ()):
        out.extend(_walk(child))
    return out


def _quantile(values: List[float], q: float) -> float:
    if not values:
        return float("nan")
    values = sorted(values)
    idx = max(0, min(len(values) - 1, int(math.ceil(q * len(values))) - 1))
    return values[idx]


def _fanout_diagnosis(
    driver_trees: Sequence[Mapping[str, Any]],
) -> Optional[dict]:
    """Straggler picture over every ``fanout`` span in the driver
    trees: gap quantiles and which member index loses most often."""
    gaps: List[float] = []
    widths: List[float] = []
    slowest: Dict[str, int] = {}
    for tree in driver_trees:
        for span in _walk(tree):
            if span.get("name") != "fanout":
                continue
            gap = _attr(span, "straggler_gap_s")
            if gap is not None:
                gaps.append(gap)
            width = _attr(span, "width")
            if width is not None:
                widths.append(width)
            members = [
                c
                for c in span.get("children", ())
                if c.get("name") == "fanout.member"
            ]
            if members:
                worst = max(members, key=_dur)
                idx = (worst.get("attrs") or {}).get("idx")
                slowest[str(idx)] = slowest.get(str(idx), 0) + 1
    if not gaps and not slowest:
        return None
    return {
        "n_fanouts": max(len(gaps), sum(slowest.values())),
        "straggler_gap_p50_s": _quantile(gaps, 0.5),
        "straggler_gap_p99_s": _quantile(gaps, 0.99),
        "mean_width": (
            sum(widths) / len(widths) if widths else float("nan")
        ),
        "slowest_member_counts": slowest,
    }


def analyze(
    merged_traces: Sequence[Mapping[str, Any]],
) -> dict:
    """Aggregate the per-trace decomposition over a trace population.

    Returns the critical-path report: per-stage ``p50_s``/``p99_s``/
    ``total_s``/``frac`` (fraction of total attributed wall),
    ``dominant_stage`` counts, overall ``coverage_frac`` (attributed
    wall / driver wall — the ≥ 0.9 acceptance line), per-replica
    attempt walls, and the fanout straggler diagnosis.  Traces without
    a driver root are counted in ``n_skipped`` rather than silently
    dropped.
    """
    per_stage: Dict[str, List[float]] = {s: [] for s in STAGES}
    per_stage["unattributed"] = []
    dominant: Dict[str, int] = {}
    replicas: Dict[str, float] = {}
    wall_total = attributed_total = 0.0
    walls: List[float] = []
    n_skipped = 0
    driver_trees: List[Mapping[str, Any]] = []
    for merged in merged_traces:
        driver_trees.extend(merged.get("driver") or [])
        rec = decompose_trace(merged)
        if rec is None:
            n_skipped += 1
            continue
        walls.append(rec["wall_s"])
        wall_total += rec["wall_s"]
        attributed_total += rec["wall_s"] - rec["unattributed_s"]
        for stage in STAGES:
            per_stage[stage].append(rec[stage])
        per_stage["unattributed"].append(rec["unattributed_s"])
        if rec["dominant"] is not None:
            dominant[rec["dominant"]] = (
                dominant.get(rec["dominant"], 0) + 1
            )
        for addr, wall in rec["replicas"].items():
            replicas[addr] = replicas.get(addr, 0.0) + wall
    stages_report = {}
    for stage, values in per_stage.items():
        total = sum(values)
        stages_report[stage] = {
            "p50_s": _quantile(values, 0.5),
            "p99_s": _quantile(values, 0.99),
            "total_s": total,
            "frac": total / wall_total if wall_total > 0 else 0.0,
        }
    return {
        "n_traces": len(walls),
        "n_skipped": n_skipped,
        "wall_total_s": wall_total,
        "wall_p50_s": _quantile(walls, 0.5),
        "wall_p99_s": _quantile(walls, 0.99),
        "coverage_frac": (
            attributed_total / wall_total if wall_total > 0 else 0.0
        ),
        "stages": stages_report,
        "dominant_stage": dominant,
        "replica_wall_s": {
            a: replicas[a] for a in sorted(replicas)
        },
        "fanout": _fanout_diagnosis(driver_trees),
    }


def analyze_recent() -> dict:
    """The report over everything currently in the reunion store +
    the driver's completed-root ring (:func:`.reunion.merge_all`)."""
    return analyze(_reunion.merge_all())


def _fmt_s(v: float) -> str:
    if isinstance(v, float) and math.isnan(v):
        return "-"
    if v >= 1.0:
        return f"{v:.3f} s"
    return f"{v * 1e3:.3f} ms"


def format_report(report: Mapping[str, Any]) -> str:
    """Render one :func:`analyze` report as an aligned text table —
    what ``tools/metrics_dump.py --fleet`` and the tutorial print."""
    rows = [("stage", "p50", "p99", "total", "share", "dominant#")]
    dominant = report.get("dominant_stage") or {}
    for stage in (*STAGES, "unattributed"):
        rec = (report.get("stages") or {}).get(stage)
        if rec is None:
            continue
        rows.append(
            (
                stage,
                _fmt_s(rec["p50_s"]),
                _fmt_s(rec["p99_s"]),
                _fmt_s(rec["total_s"]),
                f"{100.0 * rec['frac']:.1f}%",
                str(dominant.get(stage, "")),
            )
        )
    widths = [
        max(len(r[i]) for r in rows) for i in range(len(rows[0]))
    ]
    out = [
        "  ".join(c.ljust(w) for c, w in zip(row, widths)).rstrip()
        for row in rows
    ]
    out.append(
        f"traces: {report.get('n_traces', 0)} "
        f"(skipped {report.get('n_skipped', 0)}), wall p50 "
        f"{_fmt_s(report.get('wall_p50_s', float('nan')))} / p99 "
        f"{_fmt_s(report.get('wall_p99_s', float('nan')))}, coverage "
        f"{100.0 * report.get('coverage_frac', 0.0):.1f}%"
    )
    replica_wall = report.get("replica_wall_s") or {}
    if replica_wall:
        out.append(
            "attempt wall by replica: "
            + ", ".join(
                f"{a}={_fmt_s(w)}" for a, w in replica_wall.items()
            )
        )
    fanout = report.get("fanout")
    if fanout:
        out.append(
            f"fanouts: {fanout['n_fanouts']}, straggler gap p50 "
            f"{_fmt_s(fanout['straggler_gap_p50_s'])} / p99 "
            f"{_fmt_s(fanout['straggler_gap_p99_s'])}"
        )
    return "\n".join(out) + "\n"

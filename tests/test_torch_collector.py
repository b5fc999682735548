"""The port's fleet plane (collector merge, critical path, SLO burn) and
the watchdog bundle's ``fleet`` section against the JAX package's.

Every pure function gets the same snapshots and span trees in both
packages and must return equal outputs (or raise the same error with
the same text).  Then a ``FleetCollector`` of the port scrapes two
in-process HTTP exporters, and an incident bundle written while it
runs carries its ``fleet`` section.
"""

import json
import math
import random

import numpy as np
import pytest

from pytensor_federated_tpu.telemetry import collector as jcollector
from pytensor_federated_tpu.telemetry import critpath as jcritpath
from pytensor_federated_tpu.telemetry import flightrec as jflightrec
from pytensor_federated_tpu.telemetry import metrics as jmetrics
from pytensor_federated_tpu.telemetry import slo as jslo
from pytensor_federated_torch.routing import NodePool
from pytensor_federated_torch.telemetry import collector as tcollector
from pytensor_federated_torch.telemetry import critpath as tcritpath
from pytensor_federated_torch.telemetry import export as texport
from pytensor_federated_torch.telemetry import flightrec as tflightrec
from pytensor_federated_torch.telemetry import metrics as tmetrics
from pytensor_federated_torch.telemetry import slo as tslo
from pytensor_federated_torch.telemetry import spans as tspans
from pytensor_federated_torch.telemetry import watchdog as twatchdog

PKG = {"torch": (tcollector, tcritpath, tslo, tmetrics, tflightrec),
       "jax": (jcollector, jcritpath, jslo, jmetrics, jflightrec)}


def _outcome(fn, *a, **kw):
    try:
        return ("ok", fn(*a, **kw))
    except Exception as e:
        return (type(e).__name__, str(e))


def _alike(name, build):
    """``build(collector, critpath, slo, metrics, flightrec)`` in both
    packages; equal outcomes (NaN compares equal to NaN)."""
    got, want = (_outcome(build, *PKG[p]) for p in ("torch", "jax"))
    assert json.dumps(got, sort_keys=True, default=str) == json.dumps(want, sort_keys=True,
                                                                      default=str), name
    return got


# --- metric snapshots ----------------------------------------------------------


def _registry_snapshot(metrics, seed, *, ladder=None, gauge_replica=False, conflict=False):
    rng = random.Random(seed)
    r = metrics.Registry()
    c = r.counter("pftpu_server_requests_total", "x", ("method",))
    c.labels(method="evaluate").inc(rng.randint(1, 50))
    c.labels(method="get_load").inc(rng.randint(0, 5))
    kw = {} if ladder is None else {"buckets": ladder}
    h = r.histogram("pftpu_client_call_seconds", "x", ("transport", "mode"), **kw)
    for _ in range(rng.randint(1, 40)):
        h.labels(transport="tcp", mode="unary").observe(rng.choice([0.0004, 0.002, 0.03, 0.3]))
    if conflict:
        r.gauge("pftpu_server_errors_total", "x").set(1)
    else:
        r.counter("pftpu_server_errors_total", "x", ("kind",)).labels(kind="compute").inc(seed)
    g = r.gauge("pftpu_pool_replica_up", "x", ("replica",) if gauge_replica else ())
    (g.labels(replica=f"10.0.0.{seed}:1") if gauge_replica else g).set(seed % 2)
    return metrics.snapshot(r)


MERGE_CASES = {
    "three-replicas": lambda m: {f"n{i}": _registry_snapshot(m, i) for i in range(3)},
    "gauge-replica-label": lambda m: {"driver": _registry_snapshot(m, 4, gauge_replica=True),
                                      "n1": _registry_snapshot(m, 5, gauge_replica=True)},
    "ladder-mismatch": lambda m: {"n1": _registry_snapshot(m, 1),
                                  "n2": _registry_snapshot(m, 2, ladder=(0.1, 1.0))},
    "type-conflict": lambda m: {"n1": _registry_snapshot(m, 1),
                                "n2": _registry_snapshot(m, 2, conflict=True)},
    "empty": lambda m: {},
}


@pytest.mark.parametrize("case", sorted(MERGE_CASES))
def test_merge_metric_snapshots_alike(case):
    snaps = MERGE_CASES[case](jmetrics)  # one input, the JAX package's registry
    out = _alike(case, lambda col, *_: col.merge_metric_snapshots(snaps))
    assert (out[0] == "ok") == (case in ("three-replicas", "gauge-replica-label", "empty"))
    if case == "ladder-mismatch":
        assert out[0] == "FleetMergeError" and "bucket ladder" in out[1]


def test_snapshots_of_either_registry_merge_alike():
    """A torch node's registry snapshot and a JAX node's have one shape."""
    snaps = {"t": _registry_snapshot(tmetrics, 3), "j": _registry_snapshot(jmetrics, 3)}
    assert snaps["t"] == snaps["j"]
    _alike("mixed", lambda col, *_: col.merge_metric_snapshots(snaps))


@pytest.mark.parametrize("q", [0.0, 0.5, 0.9, 0.99, 0.999, 1.0])
def test_merged_quantile_alike(q):
    snaps = {f"n{i}": _registry_snapshot(jmetrics, i) for i in range(4)}
    merged = jcollector.merge_metric_snapshots(snaps)
    fam = merged["pftpu_client_call_seconds"]
    got = _alike("q", lambda col, *_: [col.merged_quantile(fam, q), col.merged_quantile(None, q)])
    assert math.isnan(got[1][1])


class _Scrape:
    def __init__(self, offset, events):
        self.clock_offset_s, self.flightrec = offset, events


class _Snapshot:
    def __init__(self, replicas):
        self.replicas = replicas


@pytest.mark.parametrize("tail", [None, 5, 50])
def test_fleet_timeline_alike(tail):
    rng = random.Random(2)
    replicas = {
        a: _Scrape(off, [{"kind": f"ev{i}", "ts": 1000.0 + rng.random(), "seq": i}
                         for i in range(8)] + [{"kind": "no-ts"}])
        for a, off in (("driver", 0.0), ("n1", 0.25), ("n2", -0.1), ("n3", None))
    }
    out = _alike("timeline", lambda col, *_: col.fleet_timeline(_Snapshot(replicas), tail=tail))
    assert len(out[1]) == (32 if tail is None else min(tail, 32))


# --- critical path -----------------------------------------------------------


def _span(name, dur, children=(), **attrs):
    d = {"name": name, "duration_s": dur, "trace_id": "aa" * 16}
    if attrs:
        d["attrs"] = attrs
    if children:
        d["children"] = list(children)
    return d


def _trace(seed):
    rng = random.Random(seed)
    q, c = rng.uniform(0, 0.01), rng.uniform(0.001, 0.01)
    node = _span("node.evaluate", c + q + 0.0011,
                 [_span("compute", c + q, queue_wait_s=q), _span("encode", 0.001)],
                 decode_s=0.0004)
    call = c + q + 0.003
    rpc = _span("rpc.evaluate", call + 0.002,
                [_span("encode", 0.001), _span("call", call), _span("decode", 0.001)])
    kind = seed % 4
    if kind == 1:  # through a pool
        rpc = _span("pool.evaluate", call + 0.003,
                    [_span("pool.attempt", call + 0.0025, [rpc], replica=f"127.0.0.1:{seed}")])
    elif kind == 2:  # a fan-out with a straggler
        members = [_span("fanout.member", d, idx=i) for i, d in enumerate((0.001, 0.002, call))]
        rpc = _span("rpc.evaluate", call + 0.002,
                    [_span("call", call), _span("fanout", call, members, width=3,
                                                straggler_gap_s=call - 0.002)])
    elif kind == 3:  # no node tree came home
        return {"trace_id": f"{seed:02x}", "driver": [rpc], "remote": []}
    return {"trace_id": f"{seed:02x}", "driver": [rpc], "remote": [node]}


@pytest.mark.parametrize("seed", range(8))
def test_decompose_trace_alike(seed):
    _alike("decompose", lambda _c, crit, *_: crit.decompose_trace(_trace(seed)))


def test_node_only_trace_is_skipped_alike():
    merged = {"trace_id": "cc", "driver": [], "remote": [_span("node.evaluate", 0.005)]}
    assert _alike("skip", lambda _c, crit, *_: crit.decompose_trace(merged)) == ("ok", None)


@pytest.mark.parametrize("n", [1, 5, 40])
def test_analyze_and_format_alike(n):
    traces = [_trace(s) for s in range(n)]
    out = _alike("analyze", lambda _c, crit, *_: crit.analyze(traces))
    assert out[1]["n_traces"] + out[1]["n_skipped"] == n
    assert tcritpath.format_report(out[1]) == jcritpath.format_report(out[1])


# --- SLO burn rate -----------------------------------------------------------


class _FakeScrape:
    def __init__(self, m):
        self.ok, self.metrics = True, m


class _FakeSnapshot:
    def __init__(self, ts, per_replica):
        self.ts = ts
        self.replicas = {a: _FakeScrape(m) for a, m in per_replica.items()}


def _node_snapshot(requests, bad, total, sheds=0):
    r = jmetrics.Registry()
    r.counter("pftpu_server_requests_total", "x", ("method",)).labels(method="evaluate").inc(requests)
    if sheds:
        r.counter("pftpu_admission_shed_total", "x", ("reason",)).labels(reason="expired").inc(sheds)
    child = r.histogram("pftpu_client_call_seconds", "x", ("transport", "mode")).labels(
        transport="tcp", mode="unary")
    for _ in range(bad):
        child.observe(0.3)
    for _ in range(total - bad):
        child.observe(0.002)
    return jmetrics.snapshot(r)


SLO_RUNS = {
    "spike-heal": (dict(p99_s=0.05, goodput_min=1.0),
                   [(100.0, {"n": (10, 0, 10)}), (105.0, {"n": (30, 10, 30)}),
                    (114.0, {"n": (90, 10, 90)})]),
    "sheds": (dict(shed_frac_max=0.05),
              [(0.0, {"n": (10, 0, 10)}), (5.0, {"n": (30, 0, 30, 10)})]),
    "replica-death": (dict(goodput_min=1.0),
                      [(0.0, {"a": (100, 0, 100), "b": (100, 0, 100)}), (5.0, {"a": (110, 0, 110)})]),
    "counter-reset": (dict(goodput_min=1.0), [(0.0, {"a": (100, 0, 100)}), (5.0, {"a": (4, 0, 4)})]),
    "single-sample": (dict(goodput_min=1.0), [(0.0, {"a": (1, 0, 1)})]),
}


@pytest.mark.parametrize("run", sorted(SLO_RUNS))
def test_burn_rate_engine_alike(run):
    kw, seq = SLO_RUNS[run]
    snaps = [_FakeSnapshot(ts, {a: _node_snapshot(*v) for a, v in per.items()}) for ts, per in seq]

    def build(_col, _crit, slo, _m, fr):
        fr.clear()
        engine = slo.BurnRateEngine(slo.Slo(**kw), windows_s=(10.0, 60.0))
        reports = [engine.observe(s) for s in snaps]
        return reports, engine.report(), [e["kind"] for e in fr.events() if e["kind"] == "slo.burn"]

    _alike(run, build)


@pytest.mark.parametrize("kw", [{}, {"p99_s": 0.05}, {"shed_frac_max": 0.1}],
                         ids=["none", "p99", "shed"])
def test_slo_objectives_alike(kw):
    out = _alike("slo", lambda _c, _k, slo, *_: slo.Slo(**kw))
    assert (out[0] == "ValueError") == (not kw)


def test_frac_over_alike():
    hist = (10, {0.1: 0, 0.25: 10, 0.5: 0})
    for line in (0.05, 0.2, 0.25, 0.4, 1.0):
        assert tslo._frac_over(hist, line) == jslo._frac_over(hist, line)


# --- the collector over live exporters, and the bundle -----------------------


@pytest.fixture
def exporters():
    exps = [texport.start_exporter() for _ in range(2)]
    yield exps
    for e in exps:
        e.close()


def test_fleet_collector_over_http_exporters(exporters, tmp_path):
    """Two exporters of this process's registry, scraped over HTTP under
    two serving addresses: the merged request count is the sum of the
    two nodes' own counts, and a bundle written while the collector runs
    carries its ``fleet`` section."""
    requests = tmetrics.counter("pftpu_server_requests_total", "Requests served", ("method",))
    requests.labels(method="evaluate").inc(7)
    own = sum(c["value"] for c in texport.snapshot()["metrics"]["pftpu_server_requests_total"]
              ["children"])
    tflightrec.record("test.marker", n=1)
    targets = {"node-a:1": ("127.0.0.1", exporters[0].port),
               "node-b:2": ("127.0.0.1", exporters[1].port)}
    pool = NodePool(transport="tcp")
    pool.add_replica("127.0.0.1", 9, transport="shm")  # no exporter mapped: unscraped
    with tcollector.FleetCollector(http_targets=targets, pool=pool, interval_s=60.0,
                                   include_local=True) as col:
        snap = col.scrape_once()
        assert not snap.stale and snap.unscraped == ["127.0.0.1:9"]
        assert not snap.complete  # loudly partial: one replica has no exporter
        assert set(snap.replicas) == {"node-a:1", "node-b:2", tcollector.LOCAL_REPLICA}
        merged = tcollector.merge_metric_snapshots(
            {a: s.metrics for a, s in snap.replicas.items() if a != tcollector.LOCAL_REPLICA})
        total = sum(c["value"] for c in merged["pftpu_server_requests_total"]["children"])
        assert total == 2 * own
        timeline = snap.timeline()
        assert {e["replica"] for e in timeline if e["kind"] == "test.marker"} == set(snap.replicas)
        assert [e["ts_fleet"] for e in timeline] == sorted(e["ts_fleet"] for e in timeline)
        path = twatchdog.write_incident_bundle("fleet-test", dir=str(tmp_path))
        with open(path) as fh:
            bundle = json.load(fh)
        assert isinstance(bundle["fleet"], list) and bundle["fleet"]
        assert set(bundle["fleet"][0]["replicas"]) == set(snap.replicas)
    pool.close()
    # No live collector: single-process bundles stay clean.
    path = twatchdog.write_incident_bundle("no-fleet", dir=str(tmp_path))
    with open(path) as fh:
        assert "fleet" not in json.load(fh)


def test_dead_exporter_is_stale_not_hung(exporters):
    port = exporters[1].port
    exporters[1].close()
    col = tcollector.FleetCollector(http_targets=[("127.0.0.1", port)], timeout_s=1.0,
                                    include_local=False)
    snap = col.scrape_once()
    assert snap.stale == [f"127.0.0.1:{port}"] and not snap.complete
    assert snap.merged == {}


def test_critpath_of_a_live_traced_call():
    """Spans recorded by the port's own tracer decompose as the JAX
    package decomposes the same merged trees."""
    prev = tspans.set_enabled(True)
    try:
        tspans.clear_traces()
        with tspans.span("rpc.evaluate"):
            with tspans.span("encode"):
                pass
            with tspans.span("call"):
                np.ones(1000).sum()
            with tspans.span("decode"):
                pass
        driver = [t for t in tspans.recent_traces() if t["name"] == "rpc.evaluate"]
    finally:
        tspans.set_enabled(prev)
    merged = [{"trace_id": d["trace_id"], "driver": [d], "remote": []} for d in driver]
    assert len(merged) == 1
    _alike("live", lambda _c, crit, *_: crit.analyze(merged))

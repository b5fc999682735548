"""The port's copied telemetry, fault-injection, deadline and partition
modules behave as the JAX package's do, on the same inputs.

One case each of ``tests/test_telemetry.py``, ``test_faultinject.py``,
``test_deadline.py``, ``test_partition.py`` and ``test_watchdog.py``,
run through both packages side by side.
"""

import json
import os

import numpy as np
import pytest

from pytensor_federated_tpu.faultinject import plan as jplan
from pytensor_federated_tpu.routing import partition as jpart
from pytensor_federated_tpu.service import deadline as jdl
from pytensor_federated_tpu.service import npwire as jw
from pytensor_federated_tpu.telemetry import metrics as jmetrics
from pytensor_federated_torch.faultinject import plan as tplan
from pytensor_federated_torch.routing import partition as tpart
from pytensor_federated_torch.service import deadline as tdl
from pytensor_federated_torch.service import npwire as tw
from pytensor_federated_torch.telemetry import flightrec, metrics as tmetrics, spans, watchdog


def _drive(m):
    """One fixed sequence of metric operations on a fresh registry."""
    reg = m.Registry()
    c = reg.counter("pftpu_unit_requests_total", "Requests", ("method",))
    c.labels(method="evaluate").inc()
    c.labels(method="evaluate").inc(2.5)
    c.labels(method="probe").inc()
    g = reg.gauge("pftpu_unit_inflight", "In flight")
    g.inc(3)
    g.dec()
    h = reg.histogram("pftpu_unit_seconds", "Latency", ("lane",))
    for v in (0.0004, 0.003, 0.02, 0.02, 1.7, 40.0):
        h.labels(lane='tcp "x"').observe(v)
    return m.render_prometheus(reg), reg


def test_same_metric_operations_render_the_same_prometheus_text():
    jtext, _ = _drive(jmetrics)
    ttext, treg = _drive(tmetrics)
    assert ttext == jtext
    assert "pftpu_unit_seconds_bucket" in ttext
    # The port's registry is its own: nothing leaked into the global one.
    assert tmetrics.REGISTRY.get("pftpu_unit_requests_total") is None
    assert treg.get("pftpu_unit_requests_total") is not None


PLAN = {
    "seed": 11,
    "plan_id": "cross-check",
    "rules": [
        {"kind": "delay", "point": "tcp.*", "prob": 0.3, "delay_s": 0.01},
        {"kind": "drop", "point": "tcp.send", "every": 3},
        {"kind": "corrupt_bytes", "point": "npwire.*", "nth": 4},
        {"kind": "compute_error", "point": "server.compute", "peer": "9001", "prob": 0.5},
    ],
}


def test_fault_plans_from_the_same_json_decide_the_same():
    text = json.dumps(PLAN)
    jp, tp = jplan.FaultPlan.from_json(text), tplan.FaultPlan.from_json(text)
    assert tp.to_json() == jp.to_json()
    sites = [("tcp.send", None), ("tcp.recv", "127.0.0.1:9001"), ("npwire.encode", None),
             ("server.compute", "127.0.0.1:9001"), ("server.compute", "127.0.0.1:9002")]
    jd, td = [], []
    for i in range(200):
        point, peer = sites[i % len(sites)]
        for p, out in ((jp, jd), (tp, td)):
            rule = p.decide(point, peer)
            out.append(None if rule is None else (rule.index, rule.kind))
    assert td == jd
    assert any(d is not None for d in td) and any(d is None for d in td)
    assert tp.snapshot()["rules"] == jp.snapshot()["rules"]


@pytest.mark.parametrize("budget", [None, 0.5, 30.0])
def test_deadline_scope_and_peek_deadline_agree(budget):
    arrays = [np.ones(3, np.float32)]
    with jdl.deadline_scope(budget), tdl.deadline_scope(budget):
        jb, tb = jdl.wire_budget(), tdl.wire_budget()
        jf = jw.encode_arrays(arrays, uuid=b"u" * 16, deadline_s=jb)
        tf = tw.encode_arrays(arrays, uuid=b"u" * 16, deadline_s=tb)
    if budget is None:
        assert jb is None and tb is None and tf == jf
        assert tw.peek_deadline(tf) is None and jw.peek_deadline(tf) is None
    else:
        assert 0 < tb <= budget and 0 < jb <= budget
        for frame in (jf, tf):
            assert tw.peek_deadline(frame) == jw.peek_deadline(frame)
    err = tdl.deadline_error("tcp admission")
    assert err == jdl.deadline_error("tcp admission")
    assert tdl.is_deadline_error(err) and jdl.is_deadline_error(err)
    with tdl.deadline_scope(1e-9):
        with pytest.raises(tdl.DeadlineExceeded):
            tdl.check_remaining("unit")


def test_partition_plans_and_reassembly_agree():
    for total, count in [(10, 4), (0, 1), (7, 7), (1000, 3)]:
        assert [tuple(p) for p in tpart.plan_partitions(total, count)] == [
            tuple(p) for p in jpart.plan_partitions(total, count)
        ]
    replies = [[np.float32(1.0), np.arange(4, dtype=np.float32), np.ones((2, 2), np.float32)]] * 3
    for got, want in zip(tpart.reduce_replies(replies), jpart.reduce_replies(replies)):
        np.testing.assert_array_equal(got, want)
    part = tpart.GradPartition(1, 3, 3, 3, 8)
    reply = [np.float32(2.0), np.arange(4, dtype=np.float32), np.ones((2, 2), np.float32)]
    for got, want in zip(tpart.slice_reply(reply, part), jpart.slice_reply(reply, jpart.GradPartition(*part))):
        np.testing.assert_array_equal(got, want)
    flat = np.arange(8, dtype=np.float32)
    ra = tpart.Reassembler(8, 3, np.float32)
    for p in tpart.plan_partitions(8, 3):
        ra.add(p, flat[p.offset:p.offset + p.length])
    np.testing.assert_array_equal(ra.result(), flat)
    with pytest.raises(tpart.PartitionError) as te:
        tpart.Reassembler(8, 3).result()
    with pytest.raises(jpart.PartitionError) as je:
        jpart.Reassembler(8, 3).result()
    assert str(te.value) == str(je.value)


def test_watchdog_bundle_has_its_sections_and_no_fleet(tmp_path):
    with spans.span("bundle.op"):
        flightrec.record("unit.pre_incident", hint=1)
        path = watchdog.write_incident_bundle("unit-test", attrs={"k": "v"}, dir=str(tmp_path))
    with open(path) as fh:
        bundle = json.load(fh)
    assert bundle["reason"] == "unit-test" and bundle["pid"] == os.getpid()
    assert {"threads", "flightrec", "telemetry", "trace_reunion"} <= set(bundle)
    assert "fleet" not in bundle
    assert {"unit.pre_incident", "span.open"} <= {e["kind"] for e in bundle["flightrec"]}
    assert "metrics" in bundle["telemetry"]

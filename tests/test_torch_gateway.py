"""The port's gateway tier against the JAX package's.

- The fairness primitives (``TokenBucket``, ``WeightedFairQueue``,
  ``TenantFairness``), driven with one injected clock and one seeded
  operation sequence in both packages, take the same admit decisions
  and pop the same sequence; the no-starvation bound holds under
  hypothesis-generated backlogs; the denial strings are equal.
- The ``Autoscaler`` takes the same decisions over one scripted signal
  sequence (a fake collector, a scripted clock).
- End to end: a torch ``GatewayThread`` and a JAX one, each over its
  own package's pool of the same two nodes (one torch node on the CPU,
  one JAX node), answer the same request frames with the same reply
  bytes: plain and pipelined requests, quota denials, expired deadlines
  shed at the gateway, failover around a dead replica, a hog tenant
  against a mouse, and a real scale-up that serves traffic.

The nodes compute exactly in float32 (small integers), so the torch and
the JAX node give the same bits and a reply does not depend on which
replica served it.  Every server bounds its accepts, every socket read
has a timeout, every gateway and pool is stopped.
"""

import random
import socket
import struct
import threading
import time

import numpy as np
import pytest

from pytensor_federated_tpu import gateway as jgw
from pytensor_federated_tpu.gateway import autoscale as jautoscale
from pytensor_federated_tpu.gateway import server as jgwserver
from pytensor_federated_tpu.routing import NodePool as JNodePool
from pytensor_federated_tpu.routing.pool import _tcp_probe as jtcp_probe
from pytensor_federated_tpu.service import npwire as jw
from pytensor_federated_tpu.service import tcp as jtcp
from pytensor_federated_tpu.service.server import device_compute_fn as jax_device_compute_fn
from pytensor_federated_torch import gateway as tgw
from pytensor_federated_torch.gateway import autoscale as tautoscale
from pytensor_federated_torch.gateway import server as tgwserver
from pytensor_federated_torch.routing import NodePool
from pytensor_federated_torch.routing.pool import _tcp_probe
from pytensor_federated_torch.service import tcp as ttcp
from pytensor_federated_torch.service.server import device_compute_fn as torch_device_compute_fn
from pytensor_federated_torch.telemetry import metrics as tmetrics
from pytensor_federated_torch.telemetry import spans as tspans

TIMEOUT_S = 30.0
GW = {"torch": tgw, "jax": jgw}
POOL = {"torch": NodePool, "jax": JNodePool}
AUTOSCALE = {"torch": tautoscale, "jax": jautoscale}


# --- nodes -------------------------------------------------------------------


def _fn(a, x):
    r = x - a
    return [-(r * r).sum(), -2.0 * r]


def _slowed(compute, delay_s):
    def fn(*arrays):
        time.sleep(delay_s)
        return compute(*arrays)

    def batch(requests):
        time.sleep(delay_s)
        return compute.batch(requests)

    fn.batch = batch
    return fn


def _start_node(pkg, delay_s=0.0):
    """A TCP node of ``pkg`` on a daemon thread; returns its port."""
    if pkg == "torch":
        compute, serve = torch_device_compute_fn(_fn, device="cpu", batched=True), ttcp.serve_tcp_once
    else:
        compute, serve = jax_device_compute_fn(_fn, batched=True), jtcp.serve_tcp_once
    if delay_s:
        compute = _slowed(compute, delay_s)
    ports, ready = [], threading.Event()
    threading.Thread(target=serve, args=(compute,), daemon=True,
                     kwargs={"ready_callback": lambda p: (ports.append(p), ready.set()),
                             "max_connections": 200, "concurrent": True}).start()
    assert ready.wait(TIMEOUT_S)
    return ports[0]


@pytest.fixture(scope="module")
def node_ports():
    """One torch node and one JAX node: the mixed pool's replicas."""
    return [_start_node("torch"), _start_node("jax")]


def _dead_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _recv_exact(sock, n):
    out = b""
    while len(out) < n:
        b = sock.recv(n - len(out))
        if not b:
            raise ConnectionError("peer closed")
        out += b
    return out


def _exchange(port, frames, gap_s=0.0):
    """Send ``frames`` pipelined on one connection; the replies, in order."""
    with socket.create_connection(("127.0.0.1", port), timeout=TIMEOUT_S) as s:
        s.settimeout(TIMEOUT_S)
        for f in frames:
            s.sendall(struct.pack("<I", len(f)) + f)
            if gap_s:
                time.sleep(gap_s)
        replies = []
        for _ in frames:
            (n,) = struct.unpack("<I", _recv_exact(s, 4))
            replies.append(_recv_exact(s, n))
    return replies


def _request(i):
    return [np.float32(i % 5), np.arange(6, dtype=np.float32) + np.float32(i)]


def _frame(i, **kw):
    return jw.encode_arrays(_request(i), uuid=i.to_bytes(16, "little"), **kw)


def _want(i):
    r = _request(i)[1] - _request(i)[0]
    return [np.float32(-(r * r).sum()), (-2.0 * r).astype(np.float32)]


def _decoded(reply):
    arrays, uuid, error, _tid, _sp = jw.decode_arrays_all(reply)
    return arrays, uuid, error


def _both_gateways(node_replicas, pool_kw=None, **gw_kw):
    """``{pkg: (GatewayThread, pool)}`` over the same replicas."""
    out = {}
    for pkg in ("torch", "jax"):
        pool = POOL[pkg](node_replicas, transport="tcp", **(pool_kw or {}))
        kw = dict(gw_kw)
        if "fairness" in kw:
            kw["fairness"] = GW[pkg].TenantFairness(**kw["fairness"])
        gw = GW[pkg].GatewayThread(pool, **kw)
        gw.start()
        out[pkg] = (gw, pool)
    return out


def _stop(gws):
    for gw, pool in gws.values():
        gw.stop()
        pool.close()


# --- fairness primitives ---------------------------------------------------------


class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


@pytest.mark.parametrize("rate,burst", [(10.0, 3.0), (1.0, 1.0), (250.0, 40.0)])
def test_token_bucket_spends_alike(rate, burst):
    rng = np.random.default_rng(int(rate))
    steps = [(float(rng.exponential(0.5 / rate)), float(rng.choice([1.0, 1.0, 2.0, 0.5])))
             for _ in range(300)]
    traces = []
    for mod in (tgw, jgw):
        clock = _Clock()
        b = mod.TokenBucket(rate_per_s=rate, burst=burst, clock=clock)
        trace = []
        for dt, cost in steps:
            clock.t += dt
            trace.append((b.try_spend(cost), round(b.tokens(), 9)))
        clock.t += 1e6
        trace.append(b.tokens())
        traces.append(trace)
    assert traces[0] == traces[1]
    assert any(not ok for ok, _ in traces[0][:-1]) and any(ok for ok, _ in traces[0][:-1])


def test_token_bucket_refuses_bad_settings_alike():
    errs = []
    for mod in (tgw, jgw):
        with pytest.raises(ValueError) as e:
            mod.TokenBucket(rate_per_s=0.0)
        errs.append(str(e.value))
    assert errs[0] == errs[1]


def _drive_queue(mod, seed, n_ops=600):
    rng = random.Random(seed)
    tenants = [f"t{i}" for i in range(rng.randint(2, 6))]
    weights = {t: rng.choice([0.0, 0.25, 0.5, 1.0, 3.0]) for t in tenants}
    q = mod.WeightedFairQueue(weights=weights, quantum=rng.choice([0.5, 1.0]))
    trace, k = [], 0
    for _ in range(n_ops):
        op = rng.random()
        if op < 0.55:
            t = rng.choice(tenants)
            q.push(t, (t, k))
            k += 1
            trace.append(("push", t))
        elif op < 0.62:
            t = rng.choice(tenants)
            q.push_front(t, (t, -k))
            k += 1
            trace.append(("front", t))
        else:
            trace.append(("pop", q.pop()))
        trace.append((q.depth(), q.active_tenants()))
    while (p := q.pop()) is not None:
        trace.append(("drain", p))
    trace.append(sorted(q._states))
    return trace


@pytest.mark.parametrize("seed", range(8))
def test_weighted_fair_queue_pops_alike(seed):
    assert _drive_queue(tgw, seed) == _drive_queue(jgw, seed)


def test_weighted_fair_queue_push_front_and_floor():
    for mod in (tgw, jgw):
        q = mod.WeightedFairQueue(weights={"z": 0.0})
        assert q.weight_of("z") == mod.WeightedFairQueue.MIN_WEIGHT
        q.push("a", 1)
        q.push("a", 2)
        assert q.pop() == ("a", 1)
        q.push_front("a", 1)  # deferred, not dispatched
        assert [q.pop()[1] for _ in range(2)] == [1, 2]
        q.push("z", 3)
        assert q.pop() == ("z", 3) and q.pop() is None and q._states == {}


def test_no_starvation_bound_hypothesis():
    """Any backlogged tenant is served within the DRR bound, in both
    packages, under hypothesis-generated backlogs and weights, and the
    two pop the same sequence."""
    hypothesis = pytest.importorskip("hypothesis")
    st = hypothesis.strategies

    @hypothesis.settings(max_examples=40, deadline=None)
    @hypothesis.given(
        backlogs=st.dictionaries(st.sampled_from("abcde"), st.integers(1, 30), min_size=2),
        weights=st.dictionaries(st.sampled_from("abcde"), st.floats(0.1, 4.0, allow_nan=False)),
    )
    def prop(backlogs, weights):
        sequences = []
        for mod in (tgw, jgw):
            q = mod.WeightedFairQueue(weights=weights)
            tenants = sorted(backlogs)

            def gap_bound(t):
                passes = int(np.ceil(1.0 / (q.weight_of(t) * q.quantum)))
                per_pass = sum(1 + int(np.ceil(q.weight_of(o) * q.quantum))
                               for o in tenants if o != t)
                return passes * max(per_pass, 1) + per_pass + 1

            for t in tenants:
                for i in range(backlogs[t]):
                    q.push(t, (t, i))
            last, k, seq = {t: 0 for t in tenants}, 0, []
            while (popped := q.pop()) is not None:
                for t in tenants:
                    if q.depth(t):
                        assert k - last[t] <= gap_bound(t)
                last[popped[0]] = k
                seq.append(popped)
                k += 1
            sequences.append(seq)
        assert sequences[0] == sequences[1]

    prop()


def _drive_fairness(mod, kw, script, clock):
    f = mod.TenantFairness(**kw)
    for b in list(f._buckets.values()):
        b._clock = clock
    out = []
    for op, tenant, dt in script:
        clock.t += dt
        if op == "admit":
            # Buckets are made on first use; give each the scripted clock.
            verdict = f.admit(tenant)
            for b in f._buckets.values():
                if b._clock is not clock:
                    b._clock, b._last = clock, clock.t
            out.append(verdict)
        elif op == "push":
            f.queue.push(tenant, tenant)
        else:
            out.append(f.queue.pop())
        out.append((sorted(f._buckets), f.queue.depth()))
    return out


FAIRNESS_CASES = {
    "quota": ({"quota_rate_per_s": 2.0, "quota_burst": 3.0},
              [("admit", "acme", 0.0)] * 5 + [("admit", "acme", 0.6), ("admit", "beta", 0.0)]
              + [("admit", "acme", 0.1)] * 3),
    "backlog": ({"max_backlog_per_tenant": 2},
                [("admit", "t", 0.0), ("push", "t", 0.0), ("push", "t", 0.0), ("admit", "t", 0.0),
                 ("pop", None, 0.0), ("admit", "t", 0.0)]),
    "cardinality": ({"quota_rate_per_s": 0.001, "quota_burst": 5.0, "max_tenants": 2},
                    [("admit", "a", 0.0), ("admit", "b", 0.0), ("admit", "c", 0.0),
                     ("admit", "a", 0.0), ("admit", "d", 0.0)]),
    "cardinality-no-quota": ({"max_tenants": 3},
                             [("admit", "a", 0.0), ("push", "a", 0.0), ("admit", "b", 0.0),
                              ("push", "b", 0.0), ("admit", "c", 0.0), ("push", "c", 0.0),
                              ("admit", "d", 0.0), ("pop", None, 0.0), ("pop", None, 0.0),
                              ("pop", None, 0.0), ("admit", "d", 0.0)]),
    "idle-reclaim": ({"quota_rate_per_s": 10.0, "quota_burst": 2.0, "max_tenants": 2},
                     [("admit", "a", 0.0), ("admit", "b", 0.0), ("admit", "c", 0.0),
                      ("admit", "c", 5.0), ("admit", "b", 0.0)]),
}


@pytest.mark.parametrize("case", sorted(FAIRNESS_CASES))
def test_tenant_fairness_admits_alike(case):
    kw, script = FAIRNESS_CASES[case]
    got = _drive_fairness(tgw, kw, script, _Clock())
    want = _drive_fairness(jgw, kw, script, _Clock())
    assert got == want
    assert any(v is not None and isinstance(v, str) for v in got)


def test_overload_errors_are_equal():
    for tenant, detail in [("acme", "quota exhausted"), ("*", "gateway reply ceiling exceeded"),
                           ("", "x")]:
        assert tgw.overload_error(tenant, detail) == jgw.overload_error(tenant, detail)
    assert tgw.OVERLOAD_ERROR_PREFIX == jgw.OVERLOAD_ERROR_PREFIX
    for e in (None, "x", tgw.overload_error("a", "b"), "wrapped: " + jgw.overload_error("a", "b")):
        assert tgw.is_overload_error(e) == jgw.is_overload_error(e)
    assert sorted(tgw.__all__) == sorted(jgw.__all__)


# --- the autoscaler -----------------------------------------------------------------


class _FakeCollector:
    def __init__(self):
        self.added = []
        self.removed = []

    def add_http_target(self, record_as, target):
        self.added.append((record_as, target))

    def remove_http_target(self, record_as):
        self.removed.append(record_as)


#: (queue_depth, shed, denied, clock advance) per step.
AUTOSCALE_SCRIPT = (
    [(50.0, 0, 0, 1.0)] * 4 + [(0.0, 0, 0, 6.0)] * 3 + [(5.0, 0, 0, 1.0), (8.0, 0, 0, 1.0)] * 3
    + [(0.0, 10, 5, 1.0), (0.0, 40, 20, 1.0), (0.0, 90, 30, 1.0), (0.0, 90, 30, 7.0)]
    + [(60.0, 90, 30, 6.0)] * 5 + [(0.0, 90, 30, 11.0)] * 6
)


def _drive_autoscaler(pkg, monkeypatch):
    monkeypatch.setattr(AUTOSCALE[pkg], "_tcp_probe", lambda *a, **k: True)
    pool = POOL[pkg]([("127.0.0.1", 1)], transport="tcp")
    collector, spawned, stopped = _FakeCollector(), [], []
    clock = _Clock()
    sig = {}

    def spawn():
        port = 40000 + len(spawned)
        spawned.append(port)
        return ("127.0.0.1", port, port)

    scaler = GW[pkg].Autoscaler(
        pool, lambda: dict(sig), spawn, stopped.append, min_replicas=1, max_replicas=3,
        scale_up_queue_depth=10.0, scale_down_queue_depth=1.0, scale_up_shed_rate=20.0,
        consecutive=2, cooldown_up_s=5.0, cooldown_down_s=5.0, drain_grace_s=0.0,
        collector=collector, exporter_of=lambda h, p: (h, p + 1), clock=clock)
    trace = []
    try:
        for depth, shed, denied, dt in AUTOSCALE_SCRIPT:
            clock.t += dt
            sig.update(queue_depth=depth, shed=float(shed), denied=float(denied))
            trace.append((scaler.step(), len(pool)))
        scaler.stop(drain_owned=True)
        trace.append((len(pool), spawned, stopped, collector.added, collector.removed))
    finally:
        pool.close()
    return trace


def test_autoscaler_decides_alike(monkeypatch):
    got = _drive_autoscaler("torch", monkeypatch)
    want = _drive_autoscaler("jax", monkeypatch)
    assert got == want
    decisions = [d for d, _ in got[:-1]]
    assert "up" in decisions and "down" in decisions


def test_autoscaler_refuses_a_missing_dead_band():
    errs = []
    for pkg in ("torch", "jax"):
        pool = POOL[pkg](transport="tcp")
        try:
            with pytest.raises(ValueError) as e:
                GW[pkg].Autoscaler(pool, dict, lambda: None, lambda h: None,
                                   scale_up_queue_depth=2.0, scale_down_queue_depth=2.0)
            errs.append(str(e.value))
        finally:
            pool.close()
    assert errs[0] == errs[1]


# --- the accept tier, end to end ---------------------------------------------------


def test_plain_and_pipelined_requests_get_the_same_bytes(node_ports):
    replicas = [("127.0.0.1", p) for p in node_ports]
    gws = _both_gateways(replicas)
    try:
        frames = [_frame(i, tenant=f"t{i % 3}") for i in range(24)]
        replies = {pkg: _exchange(gw.port, frames) for pkg, (gw, _) in gws.items()}
        assert replies["torch"] == replies["jax"]
        for i, reply in enumerate(replies["torch"]):
            arrays, uuid, error = _decoded(reply)
            assert error is None and uuid == i.to_bytes(16, "little")
            for got, want in zip(arrays, _want(i)):
                assert got.tobytes() == np.asarray(want).tobytes()
        # The pool's liveness probe (a zero-item batch frame) is answered
        # by the gateway itself, and a stock client works through it.
        for pkg, (gw, _) in gws.items():
            assert _tcp_probe("127.0.0.1", gw.port, timeout=5.0)
            assert jtcp_probe("127.0.0.1", gw.port, timeout=5.0)
            client = ttcp.TcpArraysClient("127.0.0.1", gw.port, tenant="t1", timeout_s=TIMEOUT_S)
            try:
                many = client.evaluate_many([_request(i) for i in range(40)], window=16)
                assert [m[0].tobytes() for m in many] == [_want(i)[0].tobytes() for i in range(40)]
            finally:
                client.close()
    finally:
        _stop(gws)


def test_quota_denials_and_expired_deadlines_get_the_same_bytes(node_ports):
    replicas = [("127.0.0.1", p) for p in node_ports]
    gws = _both_gateways(replicas, fairness={"quota_rate_per_s": 1.0, "quota_burst": 2.0})
    telemetry_was = tspans.enabled()
    tspans.set_enabled(True)  # the gateway's metric families count with telemetry on
    try:
        shed = tmetrics.REGISTRY.get("pftpu_gateway_shed_total")
        before = shed.labels(reason="expired_arrival").value
        frames = ([_frame(i, tenant="burster") for i in range(5)]
                  + [_frame(10 + i, deadline_s=0.0) for i in range(3)]
                  + [_frame(20, deadline_s=-1.0, tenant="other")])
        replies = {pkg: _exchange(gw.port, frames) for pkg, (gw, _) in gws.items()}
        assert replies["torch"] == replies["jax"]
        errors = [_decoded(r)[2] for r in replies["torch"]]
        assert errors[:2] == [None, None]
        for e in errors[2:5]:
            assert tgw.is_overload_error(e) and "[tenant burster]" in e and "quota" in e
        for e in errors[5:]:
            assert e == "deadline exceeded: budget spent before gateway admission"
        # The torch gateway counted its 4 expired frames (the JAX one
        # counts in its own registry).
        assert shed.labels(reason="expired_arrival").value - before == 4
        denials = tmetrics.REGISTRY.get("pftpu_gateway_denials_total")
        assert denials.labels(tenant="burster", reason="quota").value >= 3
        # A denied request is answered when retried once the bucket refills.
        time.sleep(1.1)
        again = {pkg: _exchange(gw.port, [frames[2]]) for pkg, (gw, _) in gws.items()}
        assert again["torch"] == again["jax"] and _decoded(again["torch"][0])[2] is None
    finally:
        tspans.set_enabled(telemetry_was)
        _stop(gws)


def test_failover_around_a_dead_replica(node_ports):
    """A pool seeded with a dead address: each window fails over to a
    live replica, and every request gets its exact reply."""
    replicas = [("127.0.0.1", _dead_port()), ("127.0.0.1", node_ports[0]),
                ("127.0.0.1", node_ports[1])]
    gws = _both_gateways(replicas, pool_kw={"policy": "round_robin"})
    try:
        frames = [_frame(i) for i in range(9)]
        replies = {pkg: [_exchange(gw.port, [f])[0] for f in frames]
                   for pkg, (gw, _) in gws.items()}
        assert replies["torch"] == replies["jax"]
        for i, reply in enumerate(replies["torch"]):
            arrays, _, error = _decoded(reply)
            assert error is None and arrays[0].tobytes() == _want(i)[0].tobytes()
        dead = f"127.0.0.1:{replicas[0][1]}"
        for pkg, (_, pool) in gws.items():
            assert any(r.address == dead and r.breaker.consecutive_failures > 0
                       for r in pool.replicas) or dead not in [r.address for r in pool.available_replicas()]
    finally:
        _stop(gws)


def test_no_upstream_is_a_loud_in_band_error():
    replicas = [("127.0.0.1", _dead_port())]
    gws = _both_gateways(replicas)
    try:
        replies = {pkg: _exchange(gw.port, [_frame(1)]) for pkg, (gw, _) in gws.items()}
        errors = {pkg: _decoded(r[0])[2] for pkg, r in replies.items()}
        assert errors["torch"] == errors["jax"] and tgw.is_overload_error(errors["torch"])
    finally:
        _stop(gws)


def test_hog_tenant_does_not_starve_the_mouse():
    """A hog floods 300 pipelined requests through each gateway; a mouse
    tenant's 15 sequential calls finish while the flood is in flight,
    each interactive, with the same replies from both gateways."""
    port = _start_node("torch", delay_s=0.002)
    mouse_replies = {}
    for pkg in ("torch", "jax"):
        pool = POOL[pkg]([("127.0.0.1", port)], transport="tcp")
        gw = GW[pkg].GatewayThread(pool, fairness=GW[pkg].TenantFairness(max_backlog_per_tenant=1000),
                                   frame_items=8)
        gw.start()
        try:
            hog_done, mouse_lat, replies = [], [], []

            def hog():
                c = ttcp.TcpArraysClient("127.0.0.1", gw.port, tenant="hog", timeout_s=TIMEOUT_S)
                c.evaluate_many([_request(i) for i in range(300)], window=64)
                hog_done.append(time.monotonic())
                c.close()

            def mouse():
                c = ttcp.TcpArraysClient("127.0.0.1", gw.port, tenant="mouse", timeout_s=TIMEOUT_S)
                for i in range(15):
                    t0 = time.monotonic()
                    replies.append(c.evaluate(*_request(i)))
                    mouse_lat.append(time.monotonic() - t0)
                c.close()

            ht, mt = threading.Thread(target=hog), threading.Thread(target=mouse)
            ht.start()
            time.sleep(0.1)  # the hog's backlog is in place
            mt.start()
            mt.join(60)
            mouse_finished = time.monotonic()
            assert not mt.is_alive(), "mouse starved"
            ht.join(120)
            assert not ht.is_alive() and hog_done
            assert mouse_finished <= hog_done[0] + 1.0
            assert max(mouse_lat) < 0.5, mouse_lat
            mouse_replies[pkg] = [[a.tobytes() for a in r] for r in replies]
        finally:
            gw.stop()
            pool.close()
    assert mouse_replies["torch"] == mouse_replies["jax"]


def test_denial_pause_scales_alike(node_ports):
    pools = {pkg: POOL[pkg]([("127.0.0.1", node_ports[0])], transport="tcp") for pkg in POOL}
    try:
        servers = {"torch": tgwserver.GatewayServer(pools["torch"], denial_pause_s=0.05),
                   "jax": jgwserver.GatewayServer(pools["jax"], denial_pause_s=0.05)}
        for k in (0, 1, 10, 10_000):
            assert servers["torch"]._denial_pause_for(k) == servers["jax"]._denial_pause_for(k)
        assert servers["torch"]._denial_pause_for(10_000) == tgwserver.GatewayServer.MAX_DENIAL_PAUSE_S
    finally:
        for p in pools.values():
            p.close()


def test_real_scale_up_serves_traffic(node_ports):
    """An autoscaler under queue pressure spawns a REAL node (one JAX,
    one torch), which joins the pool after its liveness probe, serves
    windows through the gateway, and is drained on stop."""
    decisions = {}
    for pkg, new_node in (("torch", "jax"), ("jax", "torch")):
        pool = POOL[pkg]([("127.0.0.1", node_ports[0])], transport="tcp", policy="round_robin")
        gw = GW[pkg].GatewayThread(pool)
        gw.start()
        spawned = []
        try:
            def spawn(new_node=new_node):
                port = _start_node(new_node)
                spawned.append(port)
                return ("127.0.0.1", port, port)

            scaler = GW[pkg].Autoscaler(pool, gw.server.signals, spawn, lambda handle: None,
                                        min_replicas=1, max_replicas=2, scale_up_queue_depth=0.0,
                                        scale_down_queue_depth=-1.0, consecutive=1,
                                        cooldown_up_s=0.0, drain_grace_s=0.0)
            decisions[pkg] = [scaler.step(), len(pool), scaler.step()]
            replies = [_exchange(gw.port, [_frame(i)])[0] for i in range(8)]
            for i, reply in enumerate(replies):
                arrays, _, error = _decoded(reply)
                assert error is None and arrays[0].tobytes() == _want(i)[0].tobytes()
            new = pool.replica_at("127.0.0.1", spawned[0])
            assert new is not None and new.ewma_latency_s is not None  # it answered a window
            scaler.stop(drain_owned=True)
            decisions[pkg].append(len(pool))
        finally:
            gw.stop()
            pool.close()
    assert decisions["torch"] == decisions["jax"] == ["up", 2, None, 1]


def test_gateway_names_match_the_jax_package():
    assert sorted(tgw.__all__) == sorted(jgw.__all__)
    assert tgwserver.WINDOW_BYTE_CAP == jgwserver.WINDOW_BYTE_CAP
    for name in ("pftpu_gateway_requests_total", "pftpu_gateway_denials_total",
                 "pftpu_gateway_shed_total", "pftpu_gateway_queue_depth",
                 "pftpu_gateway_connections", "pftpu_gateway_window_requests",
                 "pftpu_gateway_upstream_seconds", "pftpu_gateway_queue_wait_seconds",
                 "pftpu_gateway_autoscale_total", "pftpu_gateway_autoscaled_replicas"):
        assert tmetrics.REGISTRY.get(name) is not None, name

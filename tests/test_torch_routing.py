"""The port's routing (breaker, retry budget, policies, replica pool and
pooled client) against the JAX package's.

- The state machines, driven by one event sequence with the same
  seeded jitter and a scripted clock in both packages, must walk the
  same states and arm the same backoffs.
- A mixed pool (JAX and torch nodes over tcp, shm and ring) behind the
  port's ``PooledArraysClient`` returns exactly one correct reply per
  request while a torch node is SIGKILLed in the middle of a window.
- ``evaluate_reduced`` through a pool is equal across the packages.
- The gRPC lane, not carried by the port yet, raises its named error.

Nodes bind ephemeral ports; every wait is bounded and every pool is
closed.  The computes give integer-valued float64 replies, so replies
and sums are exact whatever the order of summation.
"""

import asyncio
import os
import random
import select
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from pytensor_federated_tpu.routing import breaker as jbreaker
from pytensor_federated_tpu.routing import budget as jbudget
from pytensor_federated_tpu.routing import policies as jpolicies
from pytensor_federated_tpu.routing import NodePool as JNodePool
from pytensor_federated_tpu.routing import PooledArraysClient as JPooledArraysClient
from pytensor_federated_tpu.service import ring as jring
from pytensor_federated_tpu.service import shm as jshm
from pytensor_federated_tpu.service import tcp as jtcp
from pytensor_federated_torch.routing import breaker as tbreaker
from pytensor_federated_torch.routing import budget as tbudget
from pytensor_federated_torch.routing import policies as tpolicies
from pytensor_federated_torch.routing import NodePool, PooledArraysClient
from pytensor_federated_torch.routing import pooled_client as tpooled
from pytensor_federated_torch.service import _grpc_lane
from pytensor_federated_torch.service import ring as tring
from pytensor_federated_torch.service import shm as tshm
from pytensor_federated_torch.service import tcp as ttcp
from pytensor_federated_torch.service.server import device_compute_fn
from pytensor_federated_torch.telemetry import FleetCollector
from pytensor_federated_torch.telemetry import flightrec as tflightrec

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT_S = 30.0


# --- the state machines ----------------------------------------------------


class _Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


BREAKER_SCRIPTS = {
    # trip, wait out the backoff, half-open probe fails, re-trip with a
    # doubled backoff, recover
    "trip-refail-recover": ["fail", "fail", "fail", "acquire", "adv 0.3", "acquire", "adv 0.4",
                            "acquire", "acquire", "fail", "adv 0.5", "acquire", "adv 0.7",
                            "acquire", "ok", "acquire", "fail"],
    # success resets the failure count below the threshold
    "reset-below-threshold": ["fail", "fail", "ok", "fail", "fail", "acquire", "fail", "acquire",
                              "adv 10", "acquire", "release", "acquire", "ok"],
    # the backoff ladder caps at max_backoff_s
    "ladder-cap": ["fail"] * 3 + ["adv 100", "acquire", "fail"] * 8 + ["adv 100", "acquire", "ok"],
}


def _drive_breaker(mod, script, seed):
    clock = _Clock()
    transitions = []
    br = mod.CircuitBreaker(failure_threshold=3, backoff_s=0.5, max_backoff_s=8.0,
                            jitter_frac=0.2, clock=clock, rng=random.Random(seed),
                            on_transition=lambda a, b: transitions.append((a, b)))
    trace = []
    for op in script:
        if op.startswith("adv"):
            clock.t += float(op.split()[1])
            res = None
        elif op == "fail":
            res = br.record_failure()
        elif op == "ok":
            res = br.record_success()
        elif op == "acquire":
            res = br.acquire()
        else:
            res = br.release()
        trace.append((op, res, br.state, br.available(), br.consecutive_failures, br.backoff_s,
                      br._open_until - 1000.0, len(transitions)))
    return trace, transitions


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("script", sorted(BREAKER_SCRIPTS))
def test_breaker_walks_the_same_states(script, seed):
    got = _drive_breaker(tbreaker, BREAKER_SCRIPTS[script], seed)
    want = _drive_breaker(jbreaker, BREAKER_SCRIPTS[script], seed)
    assert got == want
    assert {b for _, b in want[1]} >= {"open", "half_open"}


@pytest.mark.parametrize("kw", [{"failure_threshold": 0}, {"backoff_s": 0.0},
                                {"backoff_s": 2.0, "max_backoff_s": 1.0}],
                         ids=["threshold", "backoff", "ladder"])
def test_breaker_refuses_bad_settings_alike(kw):
    errs = []
    for mod in (tbreaker, jbreaker):
        with pytest.raises(ValueError) as e:
            mod.CircuitBreaker(**kw)
        errs.append(str(e.value))
    assert errs[0] == errs[1]


BUDGET_SCRIPT = [("spend", 1)] * 5 + [("adv", 0.1), ("spend", 1), ("spend", 2), ("adv", 0.25),
                                       ("refund", 1), ("spend", 3), ("adv", 10.0), ("spend", 1),
                                       ("tokens", None)] + [("spend", 1)] * 6


@pytest.mark.parametrize("rate,burst", [(4.0, 4.0), (2.0, 16.0), (0.5, 1.0)])
def test_retry_budget_spends_alike(monkeypatch, rate, burst):
    traces = []
    for mod in (tbudget, jbudget):
        clock = _Clock()
        monkeypatch.setattr(mod, "time", SimpleNamespace(monotonic=clock))
        b = mod.RetryBudget(rate_per_s=rate, burst=burst, name="test")
        trace = []
        for op, arg in BUDGET_SCRIPT:
            if op == "adv":
                clock.t += arg
                res = None
            elif op == "spend":
                res = b.try_spend(arg, what="retry")
            elif op == "refund":
                res = b.refund(arg)
            else:
                res = b.tokens()
            trace.append((op, res, round(b._tokens, 12), b.n_granted, b.n_denied))
        trace.append(b.snapshot())
        traces.append(trace)
    assert traces[0] == traces[1]


class _FakeReplica:
    def __init__(self, i, depth, ewma, inflight):
        self.address, self._depth, self.ewma_latency_s, self.inflight = f"r{i}", depth, ewma, inflight

    def queue_depth(self):
        return self._depth


def _fleet(seed):
    rng = np.random.default_rng(seed)
    return [_FakeReplica(i, None if rng.random() < 0.3 else int(rng.integers(0, 4)),
                         None if rng.random() < 0.3 else float(rng.integers(1, 5)),
                         int(rng.integers(0, 3))) for i in range(6)]


@pytest.mark.parametrize("seed", [0, 3, 11])
@pytest.mark.parametrize("name", ["round_robin", "ewma", "p2c"])
def test_policies_pick_alike(name, seed):
    fleet = _fleet(seed)
    picks = []
    for mod in (tpolicies, jpolicies):
        policy = (mod.PowerOfTwoChoicesPolicy(random.Random(seed)) if name == "p2c"
                  else mod.get_policy(name))
        assert policy.name == name
        picks.append([[r.address for r in policy.pick(fleet[: 2 + i % 5], k=1 + i % 3)]
                      for i in range(40)])
    assert picks[0] == picks[1]


def test_unknown_policy_refused_alike():
    errs = []
    for mod in (tpolicies, jpolicies):
        with pytest.raises(ValueError) as e:
            mod.get_policy("fastest")
        errs.append(str(e.value))
    assert errs[0] == errs[1]


# --- pools over live nodes ---------------------------------------------------


def _quad_np(x):
    x = np.asarray(x)
    return [np.asarray(-np.sum((x - 3.0) ** 2)), -2.0 * (x - 3.0)]


def _quad_torch(x):
    return [-torch.sum((x - 3.0) ** 2), -2.0 * (x - 3.0)]


def _expected(i):
    return -((i - 3.0) ** 2 + 4.0)


def _requests(n):
    return [(np.array([float(i), 5.0]),) for i in range(n)]


def _serve_thread(serve, compute, **kw):
    ports, ready = [], threading.Event()

    def on_ready(port):
        ports.append(port)
        ready.set()

    threading.Thread(target=serve, args=(compute,), daemon=True,
                     kwargs={"ready_callback": on_ready, "max_connections": 100, **kw}).start()
    assert ready.wait(TIMEOUT_S)
    return ports[0]


def _slow(fn, delay):
    def compute(*a):
        time.sleep(delay)
        return fn(*a)

    return compute


@pytest.fixture(scope="module")
def mixed_nodes():
    """One in-process node per (package, lane): (lane, port) pairs."""
    torch_compute = device_compute_fn(_quad_torch, device="cpu")
    return {
        ("torch", "tcp"): _serve_thread(ttcp.serve_tcp_once, torch_compute, concurrent=True),
        ("torch", "shm"): _serve_thread(tshm.serve_shm, torch_compute),
        ("torch", "ring"): _serve_thread(tring.serve_ring, torch_compute),
        ("jax", "tcp"): _serve_thread(jtcp.serve_tcp_once, _quad_np, concurrent=True),
        ("jax", "shm"): _serve_thread(jshm.serve_shm, _quad_np),
        ("jax", "ring"): _serve_thread(jring.serve_ring, _quad_np),
    }


NODE_SCRIPT = """
import sys, time
sys.path.insert(0, {root!r})
import torch
from pytensor_federated_torch.service import device_compute_fn, serve_shm

def quad(x):
    time.sleep({delay})
    return [-torch.sum((x - 3.0) ** 2), -2.0 * (x - 3.0)]

serve_shm(device_compute_fn(quad, device="cpu"), "127.0.0.1", 0,
          ready_callback=lambda port: print(port, flush=True))
"""


def _spawn_torch_shm_node(delay):
    """A torch shm node in a process of its own (it can be SIGKILLed);
    returns ``(process, port)`` once it listens."""
    proc = subprocess.Popen(
        [sys.executable, "-c", NODE_SCRIPT.format(root=str(ROOT), delay=delay)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""},
    )
    ready, _, _ = select.select([proc.stdout], [], [], 120)
    if not ready:
        proc.kill()
        raise TimeoutError("the torch shm node did not start")
    line = proc.stdout.readline()
    if not line.strip():
        proc.kill()
        raise RuntimeError(proc.stderr.read())
    return proc, int(line)


def test_mixed_pool_fails_over_when_a_node_dies_mid_window(mixed_nodes):
    proc, victim_port = _spawn_torch_shm_node(delay=0.005)
    pool = NodePool(transport="tcp", policy="round_robin", probe_interval_s=0.2,
                    breaker_kwargs=dict(failure_threshold=1, backoff_s=30.0, max_backoff_s=60.0))
    for (_pkg, lane), port in mixed_nodes.items():
        pool.add_replica("127.0.0.1", port, transport=lane)
    victim = pool.add_replica("127.0.0.1", victim_port, transport="shm")
    client = PooledArraysClient(pool)
    tflightrec.clear()
    try:
        assert pool.probe_once() == 7
        # Every replica serves before the kill.
        warm = client.evaluate_many(_requests(28), window=2)
        assert [float(o[0]) for o in warm] == [_expected(i) for i in range(28)]
        arenas = [victim.client._req_arena.path, victim.client._rep_arena.path]
        pool.start()  # the probe thread runs through the kill
        n = 280
        reqs = _requests(n)

        async def run_with_kill():
            asyncio.get_running_loop().call_later(0.1, proc.kill)  # SIGKILL mid-window
            return await asyncio.wait_for(client.evaluate_many_async(reqs, window=8), TIMEOUT_S)

        results = asyncio.run(run_with_kill())
        assert proc.wait(timeout=TIMEOUT_S) == -signal.SIGKILL
        # Exactly one reply per request, each its own.
        assert len(results) == n
        assert [float(np.asarray(o[0])) for o in results] == [_expected(i) for i in range(n)]
        for i, o in enumerate(results):
            np.testing.assert_array_equal(o[1], [-2.0 * (i - 3.0), -4.0])
        assert victim.breaker.state == "open"
        events = tflightrec.events()
        assert any(e["kind"] == "pool.failover" and e.get("replica") == victim.address
                   and e.get("requeued", 0) > 0 for e in events)
        assert any(e["kind"] == "pool.breaker_open" and e.get("replica") == victim.address
                   for e in events)
        # The node unlinked its arenas once attached: nothing is left.
        assert not any(os.path.exists(p) for p in arenas)
        # The survivors keep serving.
        assert float(client.evaluate(np.array([1.0, 5.0]))[0]) == _expected(1.0)
    finally:
        pool.close()
        if proc.poll() is None:
            proc.kill()
        proc.wait(timeout=TIMEOUT_S)
        proc.stdout.close()
        proc.stderr.close()


@pytest.mark.parametrize("lanes", [("tcp",), ("shm", "ring"), ("tcp", "shm", "ring")],
                         ids=["tcp", "shm+ring", "all"])
def test_evaluate_reduced_is_equal_across_packages(mixed_nodes, lanes):
    reqs = _requests(21)
    want_head = sum(_expected(i) for i in range(21))
    want_tail = np.sum([-2.0 * (r[0] - 3.0) for r in reqs], axis=0)
    got = []
    for pool_cls, client_cls in ((NodePool, PooledArraysClient), (JNodePool, JPooledArraysClient)):
        pool = pool_cls(transport="tcp")
        for (_pkg, lane), port in mixed_nodes.items():
            if lane in lanes:
                pool.add_replica("127.0.0.1", port, transport=lane)
        try:
            head, tail = client_cls(pool).evaluate_reduced(reqs, window=4, total=2)
            got.append((float(head), np.asarray(tail).tolist()))
        finally:
            pool.close()
    assert got[0] == got[1] == (want_head, want_tail.tolist())


def test_pool_of_both_packages_answers_alike(mixed_nodes):
    """The same requests through each package's pool over every node:
    the same replies, bit for bit."""
    reqs = _requests(24)
    replies = []
    for pool_cls, client_cls in ((NodePool, PooledArraysClient), (JNodePool, JPooledArraysClient)):
        pool = pool_cls(transport="tcp", policy="round_robin")
        for (_pkg, lane), port in mixed_nodes.items():
            pool.add_replica("127.0.0.1", port, transport=lane)
        try:
            c = client_cls(pool)
            assert pool.probe_once() == len(mixed_nodes)
            replies.append([[np.asarray(a).tobytes() for a in out]
                            for out in c.evaluate_many(reqs, window=3)]
                           + [[np.asarray(a).tobytes() for a in c.evaluate(*reqs[5])]])
        finally:
            pool.close()
    assert replies[0] == replies[1]


# --- the gRPC lane ------------------------------------------------------------


def test_grpc_lane_raises_its_named_error():
    pool = NodePool()  # the default transport is gRPC's
    assert pool.transport == "grpc" and len(pool) == 0
    with pytest.raises(_grpc_lane.GrpcLaneUnavailable, match="next slice of the port"):
        pool.add_replica("127.0.0.1", 1)
    with pytest.raises(_grpc_lane.GrpcLaneUnavailable, match="gRPC lane"):
        NodePool([("127.0.0.1", 1)])
    with pytest.raises(_grpc_lane.GrpcLaneUnavailable):
        NodePool(transport="tcp").add_replica("127.0.0.1", 1, transport="grpc")
    with pytest.raises(_grpc_lane.GrpcLaneUnavailable, match="FleetCollector"):
        FleetCollector(targets=["127.0.0.1:1"])
    with pytest.raises(_grpc_lane.GrpcLaneUnavailable):
        PooledArraysClient([("127.0.0.1", 1)])
    # The failure classifier never reaches for grpc.
    assert tpooled._grpc_classifier() == (None, None)
    assert issubclass(_grpc_lane.GrpcLaneUnavailable, NotImplementedError)


def test_grpc_lane_error_is_not_failed_over():
    """The named error is the caller's own fault to the pool: it is not
    transient, so no pool retries it over another lane."""
    pool = NodePool(transport="tcp")
    try:
        err = _grpc_lane.GrpcLaneUnavailable("x")
        assert not pool.is_transient(err)
        assert pool.is_transient(ConnectionError("x"))
    finally:
        pool.close()


def test_get_event_loop_alike():
    """Both packages' ``get_event_loop``: the running loop inside a
    coroutine, one loop per thread otherwise (created once, made anew
    after it is closed)."""
    from pytensor_federated_tpu.utils import get_event_loop as jget
    from pytensor_federated_torch.utils import get_event_loop as tget

    def shape(get):
        out = {}
        loop = get()
        out["stable"] = get() is loop

        async def inner():
            return get() is asyncio.get_running_loop()

        out["running"] = loop.run_until_complete(inner())
        seen = []
        t = threading.Thread(target=lambda: seen.append(get()))
        t.start()
        t.join(TIMEOUT_S)
        out["per_thread"] = seen[0] is not loop
        seen[0].close()
        loop.close()
        fresh = get()
        out["fresh_after_close"] = fresh is not loop and not fresh.is_closed()
        return out

    got, want = shape(tget), shape(jget)
    assert got == want and all(want.values()), (got, want)


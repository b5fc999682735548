"""One ``fed`` model under the port's three placements, against the JAX
package, on the same numpy inputs (``tests/test_fed_placements.py`` and
``tests/test_fed_pool_chaos.py`` of the JAX package, mirrored).

- ONE model definition runs and differentiates under ``MeshPlacement``
  (8 CPU slots), ``PoolPlacement`` (two in-process TCP replicas serving
  the port's ``make_node_compute`` of the same per-shard function) and
  ``MixedPlacement``; each is held against the dense JAX reference
  (``jax.value_and_grad`` of the plain sum) and against the JAX
  package's ``parallel/sharded.py:FederatedLogp`` on its 8-device CPU
  mesh, at the JAX tests' tolerances (rtol 1e-5 on values, 1e-4 on
  gradients).
- The port's pool lane over replicas serving the JAX package's
  ``fed.make_node_compute`` gives the values and gradients it gives over
  its own (the wire bytes are shared).
- The fusion pass coalesces two independent ``fed_map`` calls into one
  window (the flight record); ``reduce=True`` lowers to one reduced
  window and falls back where a per-shard program input is inexact; a
  pool-placed closure over driver state raises the JAX package's text;
  a replica SIGKILLed mid-window leaves exactly one correct reply per
  shard.
- Where the installed JAX can trace the JAX package's ``fed_map`` (it
  lacks ``jax.interpreters.partial_eval.convert_constvars_jaxpr`` from
  JAX 0.9.0 on), the port's programs are also held against the JAX
  package's ``fed.program`` under the same placements.
"""

import os
import select
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.interpreters import partial_eval as jax_pe

from pytensor_federated_tpu.parallel import make_mesh as jmake_mesh
from pytensor_federated_tpu.parallel.sharded import FederatedLogp as JFederatedLogp
from pytensor_federated_tpu.service import serve_tcp_once as jserve_tcp_once
from pytensor_federated_torch import fed
from pytensor_federated_torch.parallel import make_mesh
from pytensor_federated_torch.routing import NodePool, PooledArraysClient
from pytensor_federated_torch.service import TcpArraysClient, serve_tcp_once
from pytensor_federated_torch.telemetry import flightrec, spans

ROOT = Path(__file__).resolve().parents[1]
N = 8
RTOL = 1e-5  # float32: identical math, differing reduction orders
GTOL = 1e-4
CPU = torch.device("cpu")
TIMEOUT_S = 60.0
JAX_FED = hasattr(jax_pe, "convert_constvars_jaxpr")


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def telemetry():
    """Spans and the flight recorder on, as the evidence needs them;
    restored after."""
    was_spans, was_rec = spans.set_enabled(True), flightrec.set_enabled(True)
    flightrec.clear()
    yield
    spans.set_enabled(was_spans)
    flightrec.set_enabled(was_rec)


def _shard_logp(p, xs, ys):
    pred = p[0] + p[1] * xs
    if isinstance(xs, torch.Tensor):
        return -torch.sum((ys - pred) ** 2)
    return -jnp.sum((ys - pred) ** 2)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(N, 12)).astype(np.float32)
    y = (1.0 - 2.0 * x + 0.1 * rng.normal(size=(N, 12))).astype(np.float32)
    return x, y


@pytest.fixture(scope="module")
def params():
    return np.float32([0.4, -1.1])


def _serve_thread(serve, compute):
    box, ready = {}, threading.Event()
    threading.Thread(
        target=serve, args=(compute,), daemon=True,
        kwargs=dict(ready_callback=lambda p: (box.update(p=p), ready.set()), concurrent=True),
    ).start()
    assert ready.wait(TIMEOUT_S)
    return box["p"]


def _pool(ports, **kw):
    pool = NodePool([("127.0.0.1", p) for p in ports], transport="tcp",
                    breaker_kwargs=dict(failure_threshold=1, backoff_s=30.0), **kw)
    return pool, PooledArraysClient(pool)


@pytest.fixture(scope="module")
def pool_client():
    """Two TCP replicas serving the port's node-side twin of the
    per-shard logp, behind a routed pool client."""
    compute = fed.make_node_compute(_shard_logp, device="cpu")
    pool, client = _pool([_serve_thread(serve_tcp_once, compute) for _ in range(2)])
    yield client
    client.close()
    pool.close()


@pytest.fixture(scope="module")
def jax_pool_client():
    """Two TCP replicas of the JAX package serving its own
    ``make_node_compute`` of the same per-shard function."""
    from pytensor_federated_tpu.fed.placements import make_node_compute as jmake_node_compute

    compute = jmake_node_compute(_shard_logp)
    pool, client = _pool([_serve_thread(jserve_tcp_once, compute) for _ in range(2)])
    yield client
    client.close()
    pool.close()


def _model_for(x, y):
    x, y = torch.as_tensor(x), torch.as_tensor(y)

    def model(p):
        pb = fed.fed_broadcast(p, N)
        lps = fed.fed_map(lambda s: _shard_logp(s[0], s[1], s[2]), (pb, x, y))
        return fed.fed_sum(lps)

    return model


def _value_and_grad(run, p):
    p = torch.as_tensor(p).clone().requires_grad_(True)
    v = run(p)
    (g,) = torch.autograd.grad(v, p)
    return float(v), g.numpy()


def _jax_dense(x, y, p):
    ref = lambda q: sum(_shard_logp(q, jnp.asarray(x[i]), jnp.asarray(y[i])) for i in range(N))
    v, g = jax.value_and_grad(ref)(jnp.asarray(p))
    return float(v), np.asarray(g)


def _jax_mesh(x, y, p, devices8):
    ev = JFederatedLogp(lambda q, s: _shard_logp(q, s[0], s[1]),
                        (jnp.asarray(x), jnp.asarray(y)),
                        mesh=jmake_mesh({"shards": 8}, devices=devices8))
    v, g = ev.logp_and_grad(jnp.asarray(p))
    return float(v), np.asarray(g)


def _placements(pool_client):
    return {
        "mesh": fed.MeshPlacement(make_mesh({"shards": 8}, devices=[CPU] * 8)),
        "pool": fed.PoolPlacement(pool_client, window=8),
        "mixed": fed.MixedPlacement(
            fed.MeshPlacement(make_mesh({"shards": 4}, devices=[CPU] * 4)),
            fed.PoolPlacement(pool_client, window=8),
            pool_shards=4,
        ),
    }


class TestEquivalenceGate:
    @pytest.mark.parametrize("name", ["mesh", "pool", "mixed"])
    def test_one_model_three_placements(self, data, params, devices8, pool_client, name):
        x, y = data
        run = fed.program(_model_for(x, y), _placements(pool_client)[name])
        v, g = _value_and_grad(run, params)
        for ref in (_jax_dense(x, y, params), _jax_mesh(x, y, params, devices8)):
            np.testing.assert_allclose(v, ref[0], rtol=RTOL, err_msg=name)
            np.testing.assert_allclose(g, ref[1], rtol=GTOL, err_msg=name)

    def test_value_and_grad_through_pool(self, data, params, pool_client):
        x, y = data
        ev = fed.FederatedLogpGrad(lambda p, d: _shard_logp(p, d[0], d[1]), (x, y),
                                   placement=fed.PoolPlacement(pool_client, window=4),
                                   device="cpu")
        v, (g,) = ev.logp_and_grad(torch.as_tensor(params))
        ref = _jax_dense(x, y, params)
        np.testing.assert_allclose(float(v), ref[0], rtol=RTOL)
        np.testing.assert_allclose(g.numpy(), ref[1], rtol=GTOL)
        # The host surface: numpy in, (logp, [grads]) out; and torch_fn.
        lp, (g_host,) = ev(params)
        assert isinstance(lp, np.ndarray) and isinstance(g_host, np.ndarray)
        np.testing.assert_allclose(float(lp), ref[0], rtol=RTOL)
        np.testing.assert_allclose(g_host, ref[1], rtol=GTOL)
        lp2, grads2 = ev.torch_fn(torch.as_tensor(params))
        assert float(lp2) == float(lp) and np.array_equal(grads2[0].numpy(), g_host)

    def test_chain_batch_through_each_lane(self, data, params, pool_client):
        """A batch of chains under ``torch.func.vmap`` (the pool lane one
        window per chain, in turn) and one backward of their sum, against
        JAX's ``jax.vmap`` of the dense reference."""
        x, y = data
        batch = np.stack([params, params + 0.25, params - 0.5])
        ref = lambda q: sum(_shard_logp(q, jnp.asarray(x[i]), jnp.asarray(y[i]))
                            for i in range(N))
        jv = np.asarray(jax.vmap(ref)(jnp.asarray(batch)))
        jg = np.asarray(jax.vmap(jax.grad(ref))(jnp.asarray(batch)))
        for name, placement in _placements(pool_client).items():
            run = fed.program(_model_for(x, y), placement)
            b = torch.as_tensor(batch).requires_grad_(True)
            v = torch.func.vmap(run)(b)
            (g,) = torch.autograd.grad(v.sum(), b)
            np.testing.assert_allclose(v.detach().numpy(), jv, rtol=RTOL, err_msg=name)
            np.testing.assert_allclose(g.numpy(), jg, rtol=GTOL, err_msg=name)

    def test_replicas_of_either_package_give_the_same_answer(
        self, data, params, pool_client, jax_pool_client
    ):
        """The port's pool lane over replicas serving the JAX package's
        ``fed.make_node_compute`` gives what it gives over the port's own
        (float32 on both sides; the frames are the same bytes)."""
        x, y = data
        got = {}
        for name, client in (("torch", pool_client), ("jax", jax_pool_client)):
            for reduce in (False, True):
                run = fed.program(_model_for(x, y),
                                  fed.PoolPlacement(client, window=8, reduce=reduce))
                got[name, reduce] = _value_and_grad(run, params)
        ref = got["torch", False]
        for key, (v, g) in got.items():
            np.testing.assert_allclose(v, ref[0], rtol=RTOL, err_msg=str(key))
            np.testing.assert_allclose(g, ref[1], rtol=GTOL, err_msg=str(key))


def _fused_windows():
    return [e for e in flightrec.events() if e["kind"] == "fed.fused_window"]


class TestFusionEvidence:
    def test_two_maps_one_window(self, data, params, pool_client, telemetry):
        """Two independent fed_maps fuse into ONE pipelined window: the
        flight record shows one fed.fused_window carrying both calls'
        requests, and one fed.window span."""
        x, y = (torch.as_tensor(a) for a in data)
        x2 = x + 0.5

        def model(p):
            pb = fed.fed_broadcast(p, N)
            a = fed.fed_sum(fed.fed_map(lambda s: _shard_logp(*s), (pb, x, y)))
            b = fed.fed_sum(fed.fed_map(lambda s: _shard_logp(*s), (pb, x2, y)))
            return a + b

        run = fed.program(model, fed.PoolPlacement(pool_client, window=8))
        run(torch.as_tensor(params))  # records the graph
        flightrec.clear()
        v, g = _value_and_grad(run, params)
        fused = _fused_windows()
        assert len(fused) == 1, fused
        assert fused[0]["calls"] == 2 and fused[0]["requests"] == 2 * N
        window_spans = [e for e in flightrec.events()
                        if e["kind"] == "span.close" and e.get("name") == "fed.window"]
        assert len(window_spans) == 1
        jref = lambda q: sum(_shard_logp(q, jnp.asarray(xx[i]), jnp.asarray(data[1][i]))
                             for xx in (data[0], data[0] + 0.5) for i in range(N))
        jv, jg = jax.value_and_grad(jref)(jnp.asarray(params))
        np.testing.assert_allclose(v, float(jv), rtol=RTOL)
        np.testing.assert_allclose(g, np.asarray(jg), rtol=GTOL)

    def test_fuse_off_pays_two_windows(self, data, params, pool_client, telemetry):
        x, y = (torch.as_tensor(a) for a in data)

        def model(p):
            pb = fed.fed_broadcast(p, N)
            a = fed.fed_sum(fed.fed_map(lambda s: _shard_logp(*s), (pb, x, y)))
            b = fed.fed_sum(fed.fed_map(lambda s: _shard_logp(*s), (pb, x, y)))
            return a + b

        run = fed.program(model, fed.PoolPlacement(pool_client, window=8), fuse=False)
        run(torch.as_tensor(params))
        fused = _fused_windows()
        assert len(fused) == 2
        assert all(e["calls"] == 1 for e in fused)


class TestReducedWindows:
    def test_reduce_gives_one_reduced_window(self, data, params, pool_client, telemetry):
        x, y = data
        run = fed.program(_model_for(x, y),
                          fed.PoolPlacement(pool_client, window=8, reduce=True))
        v, g = _value_and_grad(run, params)
        kinds = [e["kind"] for e in flightrec.events() if e["kind"].startswith("fed.")]
        assert kinds == ["fed.reduce_window"]
        ref = _jax_dense(x, y, params)
        np.testing.assert_allclose(v, ref[0], rtol=RTOL)
        np.testing.assert_allclose(g, ref[1], rtol=GTOL)

    def test_inexact_program_input_falls_back(self, data, params, pool_client, telemetry):
        """A per-shard PROGRAM INPUT that is inexact needs its per-shard
        gradient, which a sum cannot carry: the pair falls back to the
        per-shard window, and both gradients stay right."""
        x, y = data
        yt = torch.as_tensor(y)

        def model(p, xx):
            pb = fed.fed_broadcast(p, N)
            return fed.fed_sum(fed.fed_map(lambda s: _shard_logp(*s), (pb, xx, yt)))

        run = fed.program(model, fed.PoolPlacement(pool_client, window=8, reduce=True))
        p = torch.as_tensor(params).requires_grad_(True)
        xx = torch.as_tensor(x).requires_grad_(True)
        v = run(p, xx)
        gp, gx = torch.autograd.grad(v, (p, xx))
        kinds = [e["kind"] for e in flightrec.events() if e["kind"].startswith("fed.")]
        assert kinds == ["fed.fused_window"]
        ref = lambda q, a: sum(_shard_logp(q, a[i], jnp.asarray(y[i])) for i in range(N))
        jv, (jgp, jgx) = jax.value_and_grad(ref, argnums=(0, 1))(jnp.asarray(params),
                                                                 jnp.asarray(x))
        np.testing.assert_allclose(float(v), float(jv), rtol=RTOL)
        np.testing.assert_allclose(gp.numpy(), np.asarray(jgp), rtol=GTOL)
        np.testing.assert_allclose(gx.numpy(), np.asarray(jgx), rtol=GTOL, atol=1e-5)


class TestPoolContractEnforcement:
    def test_varying_closure_const_raises(self, data, params, pool_client):
        """A pool-placed fed_map that CLOSES over driver state (instead of
        broadcasting it) fails loudly at lowering, with the JAX package's
        text: the node cannot know the value."""
        x, y = (torch.as_tensor(a) for a in data)

        def model(p):
            return fed.fed_sum(fed.fed_map(lambda s: _shard_logp(p, s[0], s[1]), (x, y)))

        run = fed.program(model, fed.PoolPlacement(pool_client, window=8))
        with pytest.raises(ValueError) as err:
            run(torch.as_tensor(params))
        assert str(err.value) == (
            "a pool-placed fed_map closes over 1 driver-varying value(s); "
            "pool placements ship only MAPPED operands, so route driver state "
            "through fed_broadcast (making it a mapped operand) instead of "
            "closure capture"
        )

    def test_baked_function_constants_are_fine(self, data, params):
        """Concrete constants inside the per-shard function are NOT driver
        state: the node's deployed copy of the same function carries
        them."""
        x, y = (torch.as_tensor(a) for a in data)

        def shard_fn(p, xs, ys):
            prior_scale = torch.tensor([0.25, 0.5])
            return _shard_logp(p, xs, ys) - torch.sum((p * prior_scale) ** 2)

        port = _serve_thread(serve_tcp_once, fed.make_node_compute(shard_fn, device="cpu"))
        client = TcpArraysClient("127.0.0.1", port)

        def model(p):
            pb = fed.fed_broadcast(p, N)
            return fed.fed_sum(fed.fed_map(lambda s: shard_fn(s[0], s[1], s[2]), (pb, x, y)))

        run = fed.program(model, fed.PoolPlacement(client, window=8))
        np.testing.assert_allclose(float(run(torch.as_tensor(params))),
                                   float(model(torch.as_tensor(params))), rtol=RTOL)
        client.close()

    def test_a_value_reaching_the_shard_function_unseen_raises(self, data, params):
        """A program-derived value that reaches a per-shard function
        other than through its closure would be baked into the graph:
        it raises at recording."""
        x, y = (torch.as_tensor(a) for a in data)

        def shard_fn(s):
            return _shard_logp(_HOLDER["p"], s[0], s[1])

        def model(p):
            _HOLDER["p"] = p
            return fed.fed_sum(fed.fed_map(shard_fn, (x, y)))

        run = fed.program(model, fed.MeshPlacement(make_mesh({"shards": 2}, devices=[CPU] * 2)))
        with pytest.raises(ValueError, match="other than through its closure"):
            run(torch.as_tensor(params))


#: A module global: a value stored here reaches a per-shard function
#: through no closure of its.
_HOLDER: dict = {}


NODE_SCRIPT = """
import sys, time
sys.path.insert(0, {root!r})
import torch
from pytensor_federated_torch import fed
from pytensor_federated_torch.service import serve_tcp_once

def shard_logp(p, x, y):
    return -torch.sum((y - p[0] - p[1] * x) ** 2)

base = fed.make_node_compute(shard_logp, device="cpu")

def compute(*arrays):
    time.sleep({delay})
    return base(*arrays)

serve_tcp_once(compute, "127.0.0.1", 0, concurrent=True,
               ready_callback=lambda port: print(port, flush=True))
"""


def test_midwindow_kill_exactly_one_correct_reply(telemetry):
    """A pool-placed fed_map rides a 2-replica pool and one replica (a
    process of its own) is SIGKILLed in the middle of the window: every
    shard's logp comes back once and correct."""
    proc = subprocess.Popen(
        [sys.executable, "-c", NODE_SCRIPT.format(root=str(ROOT), delay=0.02)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""},
    )
    pool = client = None
    try:
        ready, _, _ = select.select([proc.stdout], [], [], 120)
        assert ready, "the node did not start"
        victim_port = int(proc.stdout.readline())
        node = fed.make_node_compute(lambda p, x, y: -torch.sum((y - p[0] - p[1] * x) ** 2),
                                     device="cpu")

        def survivor_compute(*arrays):
            time.sleep(0.02)  # as slow as the victim: the pool splits each window
            return node(*arrays)

        pool, client = _pool([victim_port, _serve_thread(serve_tcp_once, survivor_compute)])
        n = 32
        rng = np.random.default_rng(17)
        x = torch.as_tensor(rng.normal(size=(n, 8)).astype(np.float32))
        y = torch.as_tensor(rng.normal(size=(n, 8)).astype(np.float32))
        p = torch.tensor([0.2, -0.6])

        def model(q):
            pb = fed.fed_broadcast(q, n)
            return fed.fed_map(lambda s: _shard_logp(s[0], s[1], s[2]), (pb, x, y))

        run = fed.program(model, fed.PoolPlacement(client, window=8))
        expected = np.asarray([_shard_logp(p, x[i], y[i]) for i in range(n)])
        np.testing.assert_allclose(run(p).numpy(), expected, rtol=RTOL)  # both warm
        victim = next(r for r in pool.replicas if r.port == victim_port)
        victim_pass = victim.client.evaluate_many_partial

        def pass_then_kill(*args, **kwargs):
            threading.Timer(0.05, proc.kill).start()
            return victim_pass(*args, **kwargs)

        victim.client.evaluate_many_partial = pass_then_kill
        flightrec.clear()
        lps = run(p).numpy()
        assert proc.wait(timeout=TIMEOUT_S) == -signal.SIGKILL
        assert lps.shape == (n,)
        np.testing.assert_allclose(lps, expected, rtol=RTOL)
        kinds = {e["kind"] for e in flightrec.events()}
        assert {"pool.failover", "fed.fused_window"} <= kinds, sorted(kinds)
    finally:
        if client is not None:
            client.close()
            pool.close()
        if proc.poll() is None:
            proc.kill()
        proc.wait(timeout=TIMEOUT_S)
        proc.stdout.close()
        proc.stderr.close()


@pytest.mark.skipif(not JAX_FED, reason=(
    "the installed JAX lacks jax.interpreters.partial_eval.convert_constvars_jaxpr "
    "(removed in JAX 0.9.0), which the JAX package's fed_map traces with"))
class TestAgainstTheJaxPrograms:
    """The port's programs against the JAX package's ``fed.program`` on
    the same model, as ``tests/test_fed_placements.py`` builds it."""

    def test_one_model_three_placements(self, data, params, devices8, pool_client):
        from pytensor_federated_tpu import fed as jfed

        x, y = data
        jx, jy = jnp.asarray(x), jnp.asarray(y)

        def jmodel(p):
            pb = jfed.fed_broadcast(p, N)
            return jfed.fed_sum(jfed.fed_map(lambda s: _shard_logp(s[0], s[1], s[2]),
                                             (pb, jx, jy)))

        jplacements = {
            "mesh": jfed.MeshPlacement(jmake_mesh({"shards": 8}, devices=devices8)),
            "pool": jfed.PoolPlacement(pool_client, window=8),
            "mixed": jfed.MixedPlacement(
                jfed.MeshPlacement(jmake_mesh({"shards": 4}, devices=devices8[:4])),
                jfed.PoolPlacement(pool_client, window=8), pool_shards=4),
        }
        for name, placement in _placements(pool_client).items():
            v, g = _value_and_grad(fed.program(_model_for(x, y), placement), params)
            jrun = jfed.program(jmodel, jplacements[name])
            jv, jg = jax.value_and_grad(jrun)(jnp.asarray(params))
            np.testing.assert_allclose(v, float(jv), rtol=RTOL, err_msg=name)
            np.testing.assert_allclose(g, np.asarray(jg), rtol=GTOL, err_msg=name)

    def test_plans_match(self, data, params):
        """Both packages fuse the same two independent maps into one
        window and leave a dependent pair alone."""
        from pytensor_federated_tpu import fed as jfed
        from pytensor_federated_torch.fed.lowering import _record

        x, y = data

        def model_of(lib, xs, ys, dependent):
            def model(p):
                pb = lib.fed_broadcast(p, N)
                a = lib.fed_map(lambda s: _shard_logp(*s), (pb, xs, ys))
                b = (lib.fed_map(lambda s: s[0] * 2.0, (a,)) if dependent
                     else lib.fed_map(lambda s: _shard_logp(*s), (pb, xs + 1, ys)))
                return lib.fed_sum(a) + lib.fed_sum(b)

            return model

        for dependent in (False, True):
            jplan = jfed.plan_windows(jax.make_jaxpr(
                model_of(jfed, jnp.asarray(x), jnp.asarray(y), dependent))(
                    jnp.asarray(params)).jaxpr)
            p = torch.as_tensor(params)
            rec, _ = _record(model_of(fed, torch.as_tensor(x), torch.as_tensor(y), dependent),
                             (p,), [p])
            tplan = fed.plan_windows(rec.graph)
            assert sorted(map(len, tplan.values())) == sorted(map(len, jplan.values()))

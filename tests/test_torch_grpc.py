"""The port's gRPC lane against the JAX package's, in both mixed
directions: a torch ``ArraysToArraysService`` driven by the JAX
package's client, a JAX service driven by the port's client (and each
package against itself).

- ``evaluate`` (stream and unary), ``evaluate_many`` (batched, plain and
  the partial form) give the same decoded bytes on both codecs (npwire
  and the reference's protobuf), and the two services answer the same
  request bytes with the same reply bytes.
- ``get_load``/``get_loads``, the logp adapters (``LogpServiceClient``,
  ``LogpGradServiceClient``) against the JAX package's values and
  gradients on the flagship (rtol 5e-5 on the value, 5e-4 on the
  gradient: tests/test_pallas.py's tolerances), deadline propagation,
  overload rejection and drain.
- The pool's default transport probes and fails over, the pooled
  client's classifier retries what the JAX one retries, and
  ``FleetCollector(targets=...)`` scrapes GetLoad.

Every node runs its compute on the CPU (``device="cpu"``); each service
runs on its own event-loop thread on an ephemeral port; every call is
bounded.  The wire computes are exact in float32 (small integers), so
the torch and JAX nodes give the same bits.
"""

import asyncio
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest

grpc = pytest.importorskip(
    "grpc", reason="grpcio is absent on the GPU host; the gRPC lane is held on the CPU"
)

import pytensor_federated_torch as pft  # noqa: E402
from pytensor_federated_tpu.models.linear import generate_node_data as jax_generate  # noqa: E402
from pytensor_federated_tpu.ops.pallas_kernels import linreg_logp_grad_fn as jax_kernel_fn  # noqa: E402
from pytensor_federated_tpu.routing import NodePool as JNodePool  # noqa: E402
from pytensor_federated_tpu.routing import PooledArraysClient as JPooledArraysClient  # noqa: E402
from pytensor_federated_tpu.routing import pooled_client as jpooled  # noqa: E402
from pytensor_federated_tpu.service import client as jclient  # noqa: E402
from pytensor_federated_tpu.service import clients as jclients  # noqa: E402
from pytensor_federated_tpu.service import deadline as jdl  # noqa: E402
from pytensor_federated_tpu.service import npproto_codec as jproto  # noqa: E402
from pytensor_federated_tpu.service import npwire as jw  # noqa: E402
from pytensor_federated_tpu.service import server as jserver  # noqa: E402
from pytensor_federated_tpu.wrappers import wrap_logp_grad_fn as jax_wrap  # noqa: E402
from pytensor_federated_torch.routing import NodePool, PooledArraysClient  # noqa: E402
from pytensor_federated_torch.routing import pooled_client as tpooled  # noqa: E402
from pytensor_federated_torch.service import client as tclient  # noqa: E402
from pytensor_federated_torch.service import clients as tclients  # noqa: E402
from pytensor_federated_torch.service import deadline as tdl  # noqa: E402
from pytensor_federated_torch.service import server as tserver  # noqa: E402
from pytensor_federated_torch.telemetry import FleetCollector  # noqa: E402
from pytensor_federated_torch.telemetry import spans as tspans  # noqa: E402

TIMEOUT_S = 30.0
KEYS = ("intercept", "slope", "log_sigma", "offsets")
SLOW_A = 99.0  # a request with this ``a`` takes SLOW_S at the node
SLOW_S = 0.4
BAD_A = -1000.0  # a request with this ``a`` is refused by the node
BAD_ERROR = "a must be above -100"
CLIENT = {"torch": tclient, "jax": jclient}
CLIENTS = {"torch": tclients, "jax": jclients}
DEADLINE = {"torch": tdl, "jax": jdl}
DIRECTIONS = [("torch", "jax"), ("jax", "torch"), ("torch", "torch"), ("jax", "jax")]
IDS = [f"{s}-node-{c}-client" for s, c in DIRECTIONS]


# --- nodes ----------------------------------------------------------------


class _Node:
    """A service on its own event-loop thread, on an ephemeral port."""

    def __init__(self, service, pkg):
        self.service = service
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever, daemon=True)
        self.thread.start()
        if pkg == "torch":  # the port's entry point
            self.server = self.run(tserver.serve(None, port=0, service=service))
            self.port = self.server.port
        else:  # the JAX package's serve() keeps its bound port to itself
            async def start():
                server = grpc.aio.server()
                server.add_generic_rpc_handlers((service.generic_handler(),))
                port = server.add_insecure_port("127.0.0.1:0")
                await server.start()
                return server, port

            self.server, self.port = self.run(start())

    def run(self, coro, timeout=TIMEOUT_S):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(timeout)

    def stop(self):
        self.run(self.server.stop(0))
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(TIMEOUT_S)


def _check(a, x):
    if float(a) >= SLOW_A:
        time.sleep(SLOW_S)
    if float(a) <= BAD_A:
        raise ValueError(BAD_ERROR)


def torch_fn(a, x):
    r = x - a
    return [-(r * r).sum(), -2.0 * r]


def jax_fn(a, x):
    r = x - a
    return [-(r * r).sum(), -2.0 * r]


def _guarded(compute):
    def fn(a, x):
        _check(a, x)
        return compute(a, x)

    def batch(requests):
        for a, x in requests:
            _check(a, x)  # a poisoned window falls back to per-item
        return compute.batch(requests)

    fn.batch = batch
    return fn


def _wire_compute(pkg):
    if pkg == "torch":
        return _guarded(tserver.device_compute_fn(torch_fn, device="cpu", batched=True))
    return _guarded(jserver.device_compute_fn(jax_fn, batched=True))


def _service(pkg, compute=None, **kw):
    mod = tserver if pkg == "torch" else jserver
    return mod.ArraysToArraysService(compute or _wire_compute(pkg), **kw)


@pytest.fixture(scope="module")
def nodes():
    started = {pkg: _Node(_service(pkg), pkg) for pkg in ("torch", "jax")}
    yield {pkg: n.port for pkg, n in started.items()}
    for n in started.values():
        n.stop()


def _request(i):
    return (np.float32(i % 5), np.arange(6, dtype=np.float32) + np.float32(i))


def _reference(a, x):
    r = x.astype(np.float64) - float(a)
    return [-(r * r).sum(), -2.0 * r]


def _bytes(outs):
    return [[np.asarray(o).dtype.str, np.asarray(o).shape, np.asarray(o).tobytes()] for o in outs]


def _client(pkg, port, **kw):
    return CLIENT[pkg].ArraysToArraysServiceClient("127.0.0.1", port, **kw)


# --- evaluate, evaluate_stream, evaluate_many --------------------------------


@pytest.mark.parametrize("use_stream", [True, False], ids=["stream", "unary"])
@pytest.mark.parametrize("codec", ["npwire", "npproto"])
def test_evaluate_gives_the_same_bytes_every_way(nodes, codec, use_stream):
    replies = {}
    for node, client in DIRECTIONS:
        c = _client(client, nodes[node], codec=codec, use_stream=use_stream)
        outs = [c.evaluate(*_request(i)) for i in range(4)]
        for i, out in enumerate(outs):
            for got, want in zip(out, _reference(*_request(i))):
                np.testing.assert_array_equal(np.asarray(got, np.float64), want)
        replies[(node, client)] = [_bytes(o) for o in outs]
    first = next(iter(replies.values()))
    assert all(r == first for r in replies.values())


@pytest.mark.parametrize("batch", ["auto", True, False], ids=["auto", "batched", "plain"])
@pytest.mark.parametrize("codec", ["npwire", "npproto"])
def test_evaluate_many_and_partial_give_the_same_bytes(nodes, codec, batch):
    reqs = [_request(i) for i in range(19)]
    replies = {}
    for node, client in DIRECTIONS:
        c = _client(client, nodes[node], codec=codec)
        many = c.evaluate_many(reqs, window=5, batch=batch)
        loop = asyncio.new_event_loop()
        try:
            partial, exc = loop.run_until_complete(
                c.evaluate_many_partial_async(reqs, window=7, batch=batch))
        finally:
            loop.close()
        assert exc is None and len(many) == len(partial) == len(reqs)
        replies[(node, client)] = [_bytes(o) for o in many]
        assert [_bytes(o) for o in partial] == replies[(node, client)]
        for out, req in zip(many, reqs):
            for got, want in zip(out, _reference(*req)):
                np.testing.assert_array_equal(np.asarray(got, np.float64), want)
    first = next(iter(replies.values()))
    assert all(r == first for r in replies.values())


def _raw_unary(port, payload):
    async def call():
        async with grpc.aio.insecure_channel(f"127.0.0.1:{port}") as channel:
            method = channel.unary_unary(tserver.EVALUATE, request_serializer=lambda b: b,
                                         response_deserializer=lambda b: b)
            return await asyncio.wait_for(method(payload), timeout=TIMEOUT_S)

    return asyncio.run(call())


def _raw_requests():
    """Request bytes with fixed uuids: plain, poisoned, expired, batch."""
    uid = b"u" * 16
    plain = jw.encode_arrays(list(_request(3)), uuid=uid)
    items = [jw.encode_arrays(list(_request(i)), uuid=bytes([65 + i]) * 16) for i in range(5)]
    items[2] = jw.encode_arrays([np.float32(BAD_A), np.zeros(6, np.float32)], uuid=b"p" * 16)
    proto_items = [jproto.encode_arrays_msg(list(_request(i)), uuid=f"item-{i}") for i in range(4)]
    return {
        "npwire": jw.encode_arrays(list(_request(3)), uuid=uid),
        "npwire-poisoned": jw.encode_arrays([np.float32(BAD_A), np.zeros(6, np.float32)], uuid=uid),
        "npwire-expired": jw.encode_arrays(list(_request(3)), uuid=uid, deadline_s=0.0),
        "npwire-batch": jw.encode_batch(items, uuid=b"o" * 16),
        "npwire-batch-expired": jw.encode_batch(items, uuid=b"o" * 16, deadline_s=-1.0),
        "npwire-garbled": plain[:-3],
        "npproto": jproto.encode_arrays_msg(list(_request(4)), uuid="one"),
        "npproto-batch": jproto.encode_batch_msg(proto_items, uuid="outer"),
    }


@pytest.mark.parametrize("kind", sorted(_raw_requests()))
def test_services_answer_the_same_bytes(nodes, kind):
    """The same request bytes to both services: the same reply bytes
    (the uuids are echoed, the computes exact, the errors in-band)."""
    payload = _raw_requests()[kind]
    replies = [_raw_unary(nodes[pkg], payload) for pkg in ("torch", "jax")]
    assert replies[0] == replies[1]
    if kind in ("npwire-poisoned", "npwire-expired", "npwire-garbled"):
        err = jw.decode_arrays_all(replies[0])[2]
        want = {"npwire-poisoned": BAD_ERROR, "npwire-expired": "deadline exceeded",
                "npwire-garbled": "decode error"}[kind]
        assert err is not None and want in err


# --- GetLoad ----------------------------------------------------------------


@pytest.mark.parametrize("node,client", DIRECTIONS, ids=IDS)
def test_get_load_and_get_loads(nodes, node, client):
    mod = CLIENT[client]
    load = asyncio.run(mod.get_load_async("127.0.0.1", nodes[node], timeout=5.0))
    assert set(load) >= {"n_clients", "percent_cpu", "percent_ram", "batch"}
    assert load["batch"]["max_batch"] == 32
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        dead = s.getsockname()[1]
    loads = asyncio.run(mod.get_loads_async(
        [("127.0.0.1", nodes[node]), ("127.0.0.1", dead)], timeout=2.0))
    assert loads[1] is None and loads[0]["batch"] == load["batch"]


def test_reference_format_get_load_reads_the_same():
    """A node answering the reference's GetLoadResult protobuf: both
    clients decode it to the same three fields (the CPU and RAM shares
    are live readings, so only the client count is compared)."""
    started = {pkg: _Node(_service(pkg, getload_wire="npproto"), pkg) for pkg in ("torch", "jax")}
    try:
        for pkg, n in started.items():
            got = [asyncio.run(CLIENT[c].get_load_async("127.0.0.1", n.port, timeout=5.0))
                   for c in ("torch", "jax")]
            # percent_cpu/percent_ram are live readings: compare the fields.
            assert set(got[0]) == set(got[1]) == {"n_clients", "percent_cpu", "percent_ram"}
            assert got[0]["n_clients"] == got[1]["n_clients"] == 0
    finally:
        for n in started.values():
            n.stop()


# --- the logp adapters on the flagship ----------------------------------------


@pytest.fixture(scope="module")
def flagship_nodes():
    """Two shards x 24 observations of the flagship data: a torch node
    (the kernel's plain version on the CPU) and a JAX node (the Pallas
    kernel in interpret mode), each serving logp+grad and logp."""
    data, _ = pft.generate_node_data(2, n_obs=24, seed=123, device="cpu")
    (x, y), mask = data.tree()
    arrs = [t.numpy() for t in (x, y, mask)]
    tkern = pft.linreg_logp_grad_fn(x, y, mask)
    jkern = jax_kernel_fn(*arrs, interpret=True)

    def torch_lg(*params):
        logp, g = tkern(dict(zip(KEYS, params)))
        return logp, tuple(g[k] for k in KEYS)

    def jax_lg(*params):
        logp, g = jkern(dict(zip(KEYS, params)))
        return logp, tuple(g[k] for k in KEYS)

    computes = {
        ("torch", "grad"): tserver.device_compute_fn(pft.wrap_logp_grad_fn(torch_lg), device="cpu"),
        ("jax", "grad"): jserver.device_compute_fn(jax_wrap(jax_lg)),
        ("torch", "logp"): tserver.device_compute_fn(lambda *p: [torch_lg(*p)[0]], device="cpu"),
        ("jax", "logp"): jserver.device_compute_fn(lambda *p: [jax_lg(*p)[0]]),
    }
    started = {k: _Node(_service(k[0], c), k[0]) for k, c in computes.items()}
    yield {k: n.port for k, n in started.items()}
    for n in started.values():
        n.stop()


def _flagship_params(seed):
    rng = np.random.default_rng(seed)
    return (np.float32(1.5 + 0.3 * rng.normal()), np.float32(2.0 + 0.3 * rng.normal()),
            np.float32(-0.7 + 0.1 * rng.normal()), rng.normal(scale=0.3, size=2).astype(np.float32))


@pytest.mark.parametrize("node,client", DIRECTIONS, ids=IDS)
def test_logp_grad_clients_give_the_jax_values(flagship_nodes, node, client):
    jdata, _ = jax_generate(2, n_obs=24, seed=123)
    (jx, jy), jmask = jdata.tree()
    jkern = jax_kernel_fn(jx, jy, jmask, interpret=True)
    grad_client = CLIENTS[client].LogpGradServiceClient("127.0.0.1", flagship_nodes[(node, "grad")])
    logp_client = CLIENTS[client].LogpServiceClient("127.0.0.1", flagship_nodes[(node, "logp")])
    reqs = [_flagship_params(s) for s in range(3)]
    many = grad_client.evaluate_many(reqs, window=3)
    logps = logp_client.evaluate_many(reqs, window=2)
    for req, (m_logp, m_grads), m_only in zip(reqs, many, logps):
        logp, grads = grad_client.evaluate(*req)
        want_logp, want_g = jkern({k: jnp.asarray(v) for k, v in zip(KEYS, req)})
        for got in (logp, m_logp, logp_client.evaluate(*req), m_only):
            np.testing.assert_allclose(np.asarray(got), np.asarray(want_logp), rtol=5e-5)
        for gs in (grads, m_grads):
            assert len(gs) == 4
            for g, k in zip(gs, KEYS):
                np.testing.assert_allclose(np.asarray(g), np.asarray(want_g[k]), rtol=5e-4,
                                           atol=5e-4)


# --- deadlines, overload, drain --------------------------------------------------


def _error_text(call):
    try:
        call()
    except Exception as e:  # noqa: BLE001 - the class and text are compared
        return type(e).__name__, str(e)
    return None


@pytest.mark.parametrize("node,client", DIRECTIONS, ids=IDS)
def test_deadline_propagation_gives_the_same_errors(nodes, node, client):
    c = _client(client, nodes[node])
    dl = DEADLINE[client]
    with dl.deadline_scope(30.0):
        out = c.evaluate(*_request(1))
    np.testing.assert_array_equal(np.asarray(out[0], np.float64), _reference(*_request(1))[0])
    spent = _error_text(lambda: _in_scope(dl, 1e-9, c))
    # The slow request outlives its budget: the client's bounded read
    # ends it inside the budget.
    t0 = time.perf_counter()
    slow = _error_text(lambda: _in_scope(dl, 0.1, c, a=SLOW_A))
    assert time.perf_counter() - t0 < SLOW_S
    assert spent == ("DeadlineExceeded", "deadline exceeded: budget spent before grpc evaluate")
    assert slow[0] in ("DeadlineExceeded", "ConnectionError") and "deadline" in slow[1]
    time.sleep(SLOW_S)  # let the node finish the abandoned slow request


def _in_scope(dl, budget, c, a=1.0):
    with dl.deadline_scope(budget):
        return c.evaluate(np.float32(a), np.zeros(6, np.float32))


def test_deadline_errors_are_equal_across_the_packages(nodes):
    got = {}
    for node, client in DIRECTIONS:
        c = _client(client, nodes[node], use_stream=False)
        got[(node, client)] = (_error_text(lambda: _in_scope(DEADLINE[client], 1e-9, c)),
                               _error_text(lambda: c.evaluate(np.float32(BAD_A),
                                                              np.zeros(6, np.float32))))
    first = next(iter(got.values()))
    assert all(v == first for v in got.values())
    assert first[1] == ("RuntimeError", f"server error: compute error: {BAD_ERROR}")


@pytest.mark.parametrize("pkg", ["torch", "jax"])
def test_overload_rejection_gives_the_same_error(pkg):
    """A node with ``max_queue=1`` serving a slow request refuses the
    next one with a retryable UNAVAILABLE naming the reason; the two
    packages' clients raise the same error."""
    node = _Node(_service(pkg, max_queue=1), pkg)
    try:
        got = []
        slow = threading.Thread(target=lambda: got.append(
            _client("torch", node.port, retries=0).evaluate(np.float32(SLOW_A), np.zeros(6, np.float32))))
        slow.start()
        time.sleep(SLOW_S / 4)
        errors = [_error_text(lambda: _client(c, node.port, retries=0, use_stream=False).evaluate(
            *_request(0))) for c in ("torch", "jax")]
        slow.join(TIMEOUT_S)
        assert len(got) == 1
        assert errors[0][0] == errors[1][0] == "AioRpcError"
        assert "node overloaded (queue_full)" in errors[0][1]
        assert "StatusCode.UNAVAILABLE" in errors[0][1] and "StatusCode.UNAVAILABLE" in errors[1][1]
    finally:
        node.stop()


@pytest.mark.parametrize("pkg", ["torch", "jax"])
def test_drain_rejects_new_work_and_finishes_inflight_work(pkg):
    node = _Node(_service(pkg), pkg)
    try:
        done = []
        inflight = threading.Thread(target=lambda: done.append(
            _client("torch", node.port, retries=0).evaluate(np.float32(SLOW_A),
                                                            np.ones(6, np.float32))))
        inflight.start()
        time.sleep(SLOW_S / 4)
        drained = asyncio.run_coroutine_threadsafe(node.service.drain(timeout_s=10.0), node.loop)
        time.sleep(0.05)
        assert node.service.draining
        refused = _error_text(lambda: _client("jax", node.port, retries=0,
                                              use_stream=False).evaluate(*_request(2)))
        assert drained.result(TIMEOUT_S) is True
        inflight.join(TIMEOUT_S)
        assert float(done[0][0]) == -6.0 * (1.0 - SLOW_A) ** 2
        assert refused[0] == "AioRpcError" and "node draining" in refused[1]
        node.service.undrain()
        out = _client("torch", node.port).evaluate(*_request(2))
        assert _bytes(out) == _bytes([np.asarray(v, np.float32) for v in _reference(*_request(2))])
    finally:
        node.stop()


# --- the pool, the classifier, the collector ---------------------------------------


def test_default_grpc_pool_probes_and_fails_over(nodes):
    """A ``NodePool()`` on its default transport (gRPC) over a dead port
    and the two live nodes, in each package: the probe finds two, and
    every pooled call is answered, the same bytes from both packages'
    pools."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        dead = s.getsockname()[1]
    replicas = [("127.0.0.1", dead), ("127.0.0.1", nodes["torch"]), ("127.0.0.1", nodes["jax"])]
    reqs = [_request(i) for i in range(12)]
    replies = []
    for pool_cls, client_cls in ((NodePool, PooledArraysClient), (JNodePool, JPooledArraysClient)):
        pool = pool_cls(replicas, policy="round_robin")
        try:
            assert pool.transport == "grpc"
            assert pool.probe_once() == 2
            c = client_cls(pool)
            outs = [c.evaluate(*r) for r in reqs] + c.evaluate_many(reqs, window=4)
            replies.append([_bytes(o) for o in outs])
            served = {r.address: r.ewma_latency_s is not None for r in pool.replicas}
            assert served[f"127.0.0.1:{nodes['torch']}"] and served[f"127.0.0.1:{nodes['jax']}"]
        finally:
            pool.close()
    assert replies[0] == replies[1]


@pytest.mark.parametrize("code", list(grpc.StatusCode), ids=lambda c: c.name)
def test_grpc_classifier_retries_what_the_jax_one_retries(code):
    err = grpc.aio.AioRpcError(code, grpc.aio.Metadata(), grpc.aio.Metadata(), details="x")
    assert tclient._is_retryable(err) == jclient._is_retryable(err)
    assert tpooled._is_transport_error(err) == jpooled._is_transport_error(err)
    pool, jpool = NodePool(transport="tcp"), JNodePool(transport="tcp")
    try:
        assert pool.is_transient(err) == jpool.is_transient(err)
    finally:
        pool.close()
        jpool.close()


def test_fleet_collector_scrapes_get_load(nodes):
    """``FleetCollector(targets=...)`` scrapes both nodes over GetLoad,
    telemetry on; the merged request count covers the calls made."""
    telemetry_was = tspans.enabled()
    tspans.set_enabled(True)
    try:
        targets = [f"127.0.0.1:{nodes[p]}" for p in ("torch", "jax")]
        collector = FleetCollector(targets=targets, include_local=False)
        before = collector.scrape_once()
        assert before.complete and set(before.replicas) == set(targets)
        for pkg in ("torch", "jax"):
            _client(pkg, nodes["torch"]).evaluate(*_request(7))
        after = collector.scrape_once()
        fam = after.replicas[targets[0]].metrics.get("pftpu_server_requests_total", {})
        assert sum(c["value"] for c in fam.get("children", [])) >= 2
    finally:
        tspans.set_enabled(telemetry_was)

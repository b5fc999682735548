"""The port's TCP lane against the JAX package's and the C++ node.

Every direction on the same request arrays: a torch node against the
JAX package's client, a JAX node against the port's client, torch
against torch, and the port's client against ``native/cpp_node``.  Each
node computes the C++ node's contract, ``[intercept, slope, sigma, x,
y] -> [logp, dlogp/dintercept, dlogp/dslope]`` — the torch node through
the port's ``device_compute_fn`` on the CPU, the JAX node through the
JAX package's — and refuses ``sigma <= 0`` with the C++ node's text.

Sockets bind ephemeral ports; servers run on daemon threads with a
bounded accept count; every blocking call has a timeout and every
client is closed.
"""

import math
import shutil
import socket
import struct
import subprocess
import threading
import time
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytensor_federated_tpu.routing.partition import GradPartition as JGradPartition
from pytensor_federated_tpu.service import batching as jbatching
from pytensor_federated_tpu.service import deadline as jdl
from pytensor_federated_tpu.service import npwire as jw
from pytensor_federated_tpu.service import tcp as jtcp
from pytensor_federated_tpu.service.server import device_compute_fn as jax_device_compute_fn
from pytensor_federated_torch.routing.partition import GradPartition as TGradPartition
from pytensor_federated_torch.service import batching as tbatching
from pytensor_federated_torch.service import deadline as tdl
from pytensor_federated_torch.service import npwire as tw
from pytensor_federated_torch.service import tcp as ttcp
from pytensor_federated_torch.service.server import device_compute_fn as torch_device_compute_fn

REPO = Path(__file__).resolve().parents[1]
NATIVE = REPO / "native"
TIMEOUT_S = 30.0
SIGMA_ERROR = "sigma must be positive"
SLOW_INTERCEPT = 99.0  # a request with this intercept takes SLOW_S at the node
SLOW_S = 0.4
LOG_2PI = math.log(2 * math.pi)

PKG = {
    "torch": {"tcp": ttcp, "wire": tw, "deadline": tdl, "part": TGradPartition, "batching": tbatching},
    "jax": {"tcp": jtcp, "wire": jw, "deadline": jdl, "part": JGradPartition, "batching": jbatching},
}


def torch_compute(a, b, s, x, y):
    r = y - (a + b * x)
    logp = torch.sum(-0.5 * (r / s) ** 2 - torch.log(s) - 0.5 * LOG_2PI)
    return [logp, torch.sum(r) / s**2, torch.sum(r * x) / s**2]


def jax_compute(a, b, s, x, y):
    r = y - (a + b * x)
    logp = jnp.sum(-0.5 * (r / s) ** 2 - jnp.log(s) - 0.5 * LOG_2PI)
    return [logp, jnp.sum(r) / s**2, jnp.sum(r * x) / s**2]


def guarded(compute):
    """The node contract's input checks, shared by both Python nodes."""

    def check(a, s):
        if float(a) >= SLOW_INTERCEPT:
            time.sleep(SLOW_S)
        if float(s) <= 0:
            raise ValueError(SIGMA_ERROR)

    def fn(a, b, s, x, y):
        check(a, s)
        return compute(a, b, s, x, y)

    def batch(requests):
        for r in requests:
            check(r[0], r[2])  # a poisoned window falls back to per-item
        return compute.batch(requests)

    fn.batch = batch
    return fn


def _serve(compute, serve_tcp_once):
    ports, ready = [], threading.Event()

    def on_ready(port):
        ports.append(port)
        ready.set()

    threading.Thread(
        target=serve_tcp_once, args=(compute,), daemon=True,
        kwargs={"ready_callback": on_ready, "max_connections": 500, "concurrent": True},
    ).start()
    assert ready.wait(TIMEOUT_S)
    return ports[0]


@pytest.fixture(scope="module")
def nodes():
    return {
        "torch": _serve(
            guarded(torch_device_compute_fn(torch_compute, device="cpu", batched=True)),
            ttcp.serve_tcp_once,
        ),
        "jax": _serve(guarded(jax_device_compute_fn(jax_compute, batched=True)), jtcp.serve_tcp_once),
    }


DIRECTIONS = [("torch", "jax"), ("jax", "torch"), ("torch", "torch")]
IDS = [f"{n}-node-{c}-client" for n, c in DIRECTIONS]


def _request(i=0, sigma=0.5, n=64):
    rng = np.random.default_rng(i)
    x = rng.normal(size=n).astype(np.float32)
    y = (1.5 + 2.0 * x + 0.5 * rng.normal(size=n)).astype(np.float32)
    return (np.float32(1.0 + 0.1 * i), np.float32(1.8), np.float32(sigma), x, y)


def _reference(a, b, s, x, y):
    a, b, s, x, y = (np.asarray(v, np.float64) for v in (a, b, s, x, y))
    r = y - (a + b * x)
    return [np.sum(-0.5 * (r / s) ** 2 - np.log(s) - 0.5 * LOG_2PI), r.sum() / s**2, (r * x).sum() / s**2]


def _check(out, req):
    assert len(out) == 3
    for got, want in zip(out, _reference(*req)):
        assert np.shape(got) == () and np.asarray(got).dtype == np.float32
        np.testing.assert_allclose(float(got), want, rtol=2e-5, atol=1e-4)


def _client(pkg, port, **kw):
    return PKG[pkg]["tcp"].TcpArraysClient("127.0.0.1", port, timeout_s=TIMEOUT_S, **kw)


def _raw_call(port, frame):
    """One length-prefixed frame to the node and its reply, by hand."""
    with socket.create_connection(("127.0.0.1", port), timeout=TIMEOUT_S) as s:
        s.sendall(struct.pack("<I", len(frame)) + frame)
        f = s.makefile("rb")
        (n,) = struct.unpack("<I", f.read(4))
        return f.read(n)


@pytest.mark.parametrize("node,client", DIRECTIONS, ids=IDS)
def test_evaluate_and_pipelined_windows(nodes, node, client):
    c = _client(client, nodes[node])
    try:
        reqs = [_request(i) for i in range(10)]
        single = [c.evaluate(*r) for r in reqs]
        for out, r in zip(single, reqs):
            _check(out, r)
        vmapped = PKG[node]["batching"]._BATCHES.labels(kind="vmapped")
        before = vmapped.value
        for batch in (False, True):  # per-call frames, then batch frames
            many = c.evaluate_many(reqs, window=4, batch=batch)
            for got, want in zip(many, single):
                for g, w in zip(got, want):
                    np.testing.assert_allclose(g, w, rtol=1e-6)
        assert c._batch_ok is True
        assert vmapped.value > before  # the node ran windows as one vmapped call
    finally:
        c.close()


@pytest.mark.parametrize("node,client", DIRECTIONS, ids=IDS)
def test_batch_frame_isolates_a_poisoned_item(nodes, node, client):
    wire = PKG[client]["wire"]
    reqs = [_request(0), _request(1, sigma=-1.0), _request(2)]
    items = [wire.encode_arrays(list(r), uuid=bytes([i]) * 16) for i, r in enumerate(reqs)]
    reply = _raw_call(nodes[node], wire.encode_batch(items, uuid=b"w" * 16))
    out_items, uid, err, _trace, _spans = wire.decode_batch(reply)
    assert uid == b"w" * 16 and err is None and len(out_items) == 3
    decoded = [wire.decode_arrays(it) for it in out_items]
    assert [d[1] for d in decoded] == [bytes([i]) * 16 for i in range(3)]
    _check(decoded[0][0], reqs[0])
    assert decoded[1][0] == [] and decoded[1][2] == SIGMA_ERROR
    _check(decoded[2][0], reqs[2])
    # Through the client, the window raises the item's error in-band and
    # the connection keeps serving.
    c = _client(client, nodes[node])
    try:
        with pytest.raises(PKG[client]["tcp"].RemoteComputeError, match=SIGMA_ERROR):
            c.evaluate_many(reqs, window=3, batch=True)
        _check(c.evaluate(*reqs[2]), reqs[2])
    finally:
        c.close()


@pytest.mark.parametrize("node,client", DIRECTIONS, ids=IDS)
def test_in_band_compute_error_has_the_same_text(nodes, node, client):
    c = _client(client, nodes[node])
    try:
        with pytest.raises(PKG[client]["tcp"].RemoteComputeError) as e:
            c.evaluate(*_request(0, sigma=0.0))
        assert str(e.value) == SIGMA_ERROR
        _check(c.evaluate(*_request(1)), _request(1))
    finally:
        c.close()


@pytest.mark.parametrize("node,client", DIRECTIONS, ids=IDS)
def test_expired_deadline(nodes, node, client):
    p = PKG[client]
    # Spent before the send: refused without a round trip.
    c = _client(client, nodes[node])
    try:
        with p["deadline"].deadline_scope(1e-9):
            with pytest.raises(p["deadline"].DeadlineExceeded):
                c.evaluate(*_request(0))
        # Spent at the node: the budget runs out while it computes.
        slow = (np.float32(SLOW_INTERCEPT),) + _request(0)[1:]
        t0 = time.perf_counter()
        with p["deadline"].deadline_scope(0.1):
            with pytest.raises(p["deadline"].DeadlineExceeded):
                c.evaluate(*slow)
        assert time.perf_counter() - t0 < SLOW_S
    finally:
        c.close()
    # Spent on arrival: the node answers the deadline classification
    # in-band without computing.
    reply = _raw_call(nodes[node], p["wire"].encode_arrays(list(_request(0)), deadline_s=0.0))
    _arrays, _uid, err = p["wire"].decode_arrays(reply)
    assert p["deadline"].is_deadline_error(err)
    assert err == "deadline exceeded: budget spent before admission"


@pytest.mark.parametrize("node,client", DIRECTIONS, ids=IDS)
def test_partitioned_and_reduced_replies(nodes, node, client):
    part = PKG[client]["part"]
    c = _client(client, nodes[node])
    try:
        reqs = [_request(i) for i in range(6)]
        full = c.evaluate(*reqs[0])
        head, sl = c.evaluate(*reqs[0], partition=part(1, 2, 1, 1, 2))
        np.testing.assert_allclose(head, full[0], rtol=1e-6)
        np.testing.assert_allclose(sl, [full[2]], rtol=1e-6)
        head_sum, tail_sum = c.evaluate_reduced(reqs, window=4, slices=2, total=2)
        outs = [c.evaluate(*r) for r in reqs]
        np.testing.assert_allclose(head_sum, sum(float(o[0]) for o in outs), rtol=1e-5)
        np.testing.assert_allclose(
            tail_sum, [sum(float(o[k]) for o in outs) for k in (1, 2)], rtol=1e-5
        )
        with pytest.raises(PKG[client]["tcp"].RemoteComputeError, match="partition total"):
            c.evaluate(*reqs[0], partition=part(0, 1, 0, 9, 9))
    finally:
        c.close()


# --- the port's client against the C++ node (skips as test_native_node.py does)

native = pytest.mark.skipif(
    shutil.which("g++") is None and not (NATIVE / "cpp_node").exists(),
    reason="no g++ and no prebuilt cpp_node",
)


@pytest.fixture(scope="module")
def cpp_node(tmp_path_factory):
    if shutil.which("g++"):  # a private build: never races another test's make
        binary = tmp_path_factory.mktemp("cpp_node") / "cpp_node"
        subprocess.run(
            ["g++", "-O2", "-std=c++17", "-pthread", "-o", str(binary), str(NATIVE / "cpp_node.cpp")],
            check=True, capture_output=True, timeout=300,
        )
    else:
        binary = NATIVE / "cpp_node"
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    proc = subprocess.Popen([str(binary), str(port)], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        line = proc.stdout.readline()  # readiness barrier
        assert "listening" in line, line
        yield port
    finally:
        proc.kill()
        proc.wait(timeout=TIMEOUT_S)


@native
def test_port_client_against_cpp_node(cpp_node):
    c = ttcp.TcpArraysClient("127.0.0.1", cpp_node, timeout_s=TIMEOUT_S)
    try:
        reqs = [tuple(np.float64(v) for v in r[:3]) + tuple(v.astype(np.float64) for v in r[3:])
                for r in (_request(i) for i in range(6))]
        single = [c.evaluate(*r) for r in reqs]
        for out, r in zip(single, reqs):
            for got, want in zip(out, _reference(*r)):
                np.testing.assert_allclose(float(got), want, rtol=1e-12)
        for batch in (False, True):
            for got, want in zip(c.evaluate_many(reqs, window=3, batch=batch), single):
                for g, w in zip(got, want):
                    assert g.tobytes() == w.tobytes()
        head, sl = c.evaluate(*reqs[0], partition=TGradPartition(0, 2, 0, 1, 2))
        assert float(head) == float(single[0][0]) and float(sl[0]) == float(single[0][1])
        bad = reqs[0][:2] + (np.float64(-1.0),) + reqs[0][3:]
        with pytest.raises(ttcp.RemoteComputeError) as e:
            c.evaluate(*bad)
        assert str(e.value) == SIGMA_ERROR
        with tdl.deadline_scope(1e-9), pytest.raises(tdl.DeadlineExceeded):
            c.evaluate(*reqs[0])
    finally:
        c.close()
    reply = _raw_call(cpp_node, tw.encode_arrays(list(reqs[0]), deadline_s=0.0))
    assert tw.decode_arrays(reply)[2] == "deadline exceeded: budget spent before admission"

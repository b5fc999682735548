"""The port's shared-memory and ring lanes against the JAX package's.

Both lanes, every direction, on the same request arrays: a torch node
against the JAX package's client, a JAX node against the port's
client, and torch against torch.  Each node computes the contract of
``tests/test_torch_tcp.py`` (``[intercept, slope, sigma, x, y] ->
[logp, dlogp/dintercept, dlogp/dslope]``, ``sigma <= 0`` refused with
the C++ node's text), the torch node through the port's
``device_compute_fn`` on the CPU — fed READ-ONLY views of the shared
pages, which it copies before ``torch.from_numpy``.

Nodes run on daemon threads and bind ephemeral ports; every read has a
timeout and every client is closed.
"""

import os
import platform
import threading
import time
import warnings

import numpy as np
import pytest

from test_torch_tcp import (
    SIGMA_ERROR,
    SLOW_INTERCEPT,
    SLOW_S,
    TIMEOUT_S,
    _check,
    _request,
    guarded,
    jax_compute,
    torch_compute,
)
from pytensor_federated_tpu.routing.partition import GradPartition as JGradPartition
from pytensor_federated_tpu.service import arena as jarena
from pytensor_federated_tpu.service import batching as jbatching
from pytensor_federated_tpu.service import deadline as jdl
from pytensor_federated_tpu.service import ring as jring
from pytensor_federated_tpu.service import shm as jshm
from pytensor_federated_tpu.service import tcp as jtcp
from pytensor_federated_tpu.service.server import device_compute_fn as jax_device_compute_fn
from pytensor_federated_torch.routing.partition import GradPartition as TGradPartition
from pytensor_federated_torch.service import arena as tarena
from pytensor_federated_torch.service import batching as tbatching
from pytensor_federated_torch.service import deadline as tdl
from pytensor_federated_torch.service import ring as tring
from pytensor_federated_torch.service import shm as tshm
from pytensor_federated_torch.service import tcp as ttcp
from pytensor_federated_torch.service.server import device_compute_fn as torch_device_compute_fn

PKG = {
    "torch": {"shm": tshm, "ring": tring, "tcp": ttcp, "deadline": tdl, "part": TGradPartition,
              "batching": tbatching},
    "jax": {"shm": jshm, "ring": jring, "tcp": jtcp, "deadline": jdl, "part": JGradPartition,
            "batching": jbatching},
}
LANES = {"shm": ("serve_shm", "ShmArraysClient"), "ring": ("serve_ring", "RingArraysClient")}
DIRECTIONS = [("torch", "jax"), ("jax", "torch"), ("torch", "torch")]
CASES = [(lane, n, c) for lane in LANES for n, c in DIRECTIONS]
IDS = [f"{lane}-{n}-node-{c}-client" for lane, n, c in CASES]


def _serve(pkg, lane, compute):
    ports, ready = [], threading.Event()

    def on_ready(port):
        ports.append(port)
        ready.set()

    serve = getattr(PKG[pkg][lane], LANES[lane][0])
    threading.Thread(target=serve, args=(compute,), daemon=True,
                     kwargs={"ready_callback": on_ready, "max_connections": 200}).start()
    assert ready.wait(TIMEOUT_S)
    return ports[0]


def _torch_node():
    return guarded(torch_device_compute_fn(torch_compute, device="cpu", batched=True))


def _jax_node():
    return guarded(jax_device_compute_fn(jax_compute, batched=True))


@pytest.fixture(scope="module")
def nodes():
    return {(pkg, lane): _serve(pkg, lane, _torch_node() if pkg == "torch" else _jax_node())
            for pkg in PKG for lane in LANES}


def _client(pkg, lane, port, **kw):
    cls = getattr(PKG[pkg][lane], LANES[lane][1])
    return cls("127.0.0.1", port, timeout_s=TIMEOUT_S, **kw)


@pytest.mark.parametrize("lane,node,client", CASES, ids=IDS)
def test_evaluate_and_pipelined_windows(nodes, lane, node, client):
    c = _client(client, lane, nodes[node, lane])
    try:
        reqs = [_request(i) for i in range(10)]
        with warnings.catch_warnings():
            # torch.from_numpy warns on a read-only array: the node must
            # copy the shared pages' views before handing them to torch.
            warnings.simplefilter("error")
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
        assert vmapped.value > before  # the node ran windows as one vmapped call
        if lane == "ring":
            assert c._com_ring is not None  # the rings were negotiated
    finally:
        c.close()


@pytest.mark.parametrize("lane,node,client", CASES, ids=IDS)
def test_window_isolates_a_poisoned_item(nodes, lane, node, client):
    fallback = PKG[node]["batching"]._BATCHES.labels(kind="fallback")
    before = fallback.value
    reqs = [_request(0), _request(1, sigma=-1.0), _request(2)]
    c = _client(client, lane, nodes[node, lane])
    try:
        with pytest.raises(PKG[client]["tcp"].RemoteComputeError, match=SIGMA_ERROR):
            c.evaluate_many(reqs, window=3, batch=True)
        # The window fell back to per-item execution at the node, and
        # the connection keeps serving.
        assert fallback.value == before + 1
        _check(c.evaluate(*reqs[2]), reqs[2])
        good = c.evaluate_many([reqs[0], reqs[2]], window=2, batch=True)
        _check(good[0], reqs[0])
        _check(good[1], reqs[2])
    finally:
        c.close()


@pytest.mark.parametrize("lane,node,client", CASES, ids=IDS)
def test_in_band_compute_error_has_the_same_text(nodes, lane, node, client):
    c = _client(client, lane, nodes[node, lane])
    try:
        with pytest.raises(PKG[client]["tcp"].RemoteComputeError) as e:
            c.evaluate(*_request(0, sigma=0.0))
        assert str(e.value) == SIGMA_ERROR
        _check(c.evaluate(*_request(1)), _request(1))
    finally:
        c.close()


@pytest.mark.parametrize("lane,node,client", CASES, ids=IDS)
def test_expired_deadline(nodes, lane, node, client):
    p = PKG[client]
    c = _client(client, lane, nodes[node, lane])
    try:
        # Spent before the send: refused without a round trip.
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
    # A fresh connection serves after the abandoned one.
    c = _client(client, lane, nodes[node, lane])
    try:
        _check(c.evaluate(*_request(3)), _request(3))
    finally:
        c.close()


@pytest.mark.parametrize("lane,node,client", CASES, ids=IDS)
def test_partitioned_and_reduced_replies(nodes, lane, node, client):
    part = PKG[client]["part"]
    c = _client(client, lane, nodes[node, lane])
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


@pytest.mark.parametrize("lane,node,client", CASES, ids=IDS)
def test_no_arena_file_is_left(nodes, lane, node, client):
    """The node unlinks both arena files once the client has mapped
    them (its first post-attach frame): nothing stays in the arena
    directory, even for a peer that is later killed."""
    c = _client(client, lane, nodes[node, lane])
    try:
        _check(c.evaluate(*_request(0)), _request(0))
        paths = [c._req_arena.path, c._rep_arena.path]
        assert all(os.path.basename(p).startswith("pftpu-arena-") for p in paths)
        assert os.path.dirname(paths[0]) == tarena.arena_dir() == jarena.arena_dir()
        assert not any(os.path.exists(p) for p in paths)
    finally:
        c.close()
    assert not any(os.path.exists(p) for p in paths)


@pytest.mark.parametrize("node,client", DIRECTIONS, ids=[f"{n}-node-{c}-client" for n, c in DIRECTIONS])
def test_ring_syscalls_per_evaluation(nodes, node, client):
    """The ring lane parks on the futex (never the polling fallback on
    Linux x86_64), and a lock-step evaluation costs about a park and a
    wake on each side, in each package's own counters (~1.1 per side
    measured here; the bound of 3 leaves room for a park that outlasts
    its 50 ms slice on a loaded machine)."""
    ring = {pkg: PKG[pkg]["ring"] for pkg in (node, client)}
    n = 40
    c = _client(client, "ring", nodes[node, "ring"])
    try:
        _check(c.evaluate(*_request(0)), _request(0))  # attach and negotiate
        assert c._com_ring is not None
        for r in ring.values():
            r.reset_syscall_counts()
        for i in range(n):
            _check(c.evaluate(*_request(i)), _request(i))
        counts = {pkg: r.syscall_counts() for pkg, r in ring.items()}
    finally:
        c.close()
    if platform.system() == "Linux" and platform.machine() == "x86_64":
        assert all(r.futex_available() for r in ring.values())
    for pkg, cnt in counts.items():
        if ring[pkg].futex_available():
            assert cnt["fallback_poll"] == 0, (pkg, cnt)
        total = cnt["futex_wait"] + cnt["futex_wake"] + cnt["fallback_poll"]
        sides = 2 if node == client else 1  # one process holds both ends
        assert total <= 3 * sides * n, (pkg, cnt)


@pytest.mark.parametrize("ring_kw", [{}, {"ring_slots": 8, "ring_record_bytes": 128}],
                         ids=["v1", "v2-ring"])
@pytest.mark.parametrize("writer,reader", [("torch", "jax"), ("jax", "torch")])
def test_arena_file_is_shared_across_packages(tmp_path, writer, reader, ring_kw):
    """An arena one package creates and writes, the other attaches and
    reads: the same header, slots and generations, the same loud error
    for a torn slot, and the same file bytes from both writers."""
    mods = {"torch": tarena, "jax": jarena}
    bufs = [np.arange(5, dtype=np.float32).tobytes(), b"", np.float64(2.5).tobytes(), b"xyz"]
    files = {}
    for w in ("torch", "jax"):
        a = mods[w].Arena.create(1 << 16, path=str(tmp_path / f"{w}.shm"), writer=True, **ring_kw)
        slots = [a.write_many(bufs) for _ in range(3)]
        a.free(slots[0][0])
        files[w] = (a, slots)
    assert (tmp_path / "torch.shm").read_bytes() == (tmp_path / "jax.shm").read_bytes()
    a, slots = files[writer]
    b = mods[reader].Arena.attach(a.path)
    try:
        assert (b.capacity, b.ring_slots, b.ring_record_bytes) == (
            a.capacity, a.ring_slots, a.ring_record_bytes)
        for slot, gen, deltas in slots[1:]:
            got = [b.read_bytes(slot, d, len(buf), gen) for d, buf in zip(deltas, bufs)]
            assert got == bufs
        slot, gen, deltas = slots[2]
        a.scribble_tail(slot)
        errs = []
        for arena in (b, a):
            with pytest.raises(Exception) as e:
                arena.read_bytes(slot, deltas[0], len(bufs[0]), gen)
            errs.append((type(e.value).__name__, str(e.value)))
        assert errs[0] == errs[1] and errs[0][0] == "WireError"
    finally:
        b.close()
        for arena, _ in files.values():
            arena.close(unlink=True)

"""The port's multi-process layer (``parallel/multihost.py``) against the
JAX package's, and a real two-process ``torch.distributed`` run.

- The mesh layout of ``make_multihost_mesh`` against the JAX package's
  on the same shapes (one process; and two processes, the JAX side over
  stand-in devices that carry a ``process_index``), and its errors.
- Each package's ``probe_peer`` against the other's ``HeartbeatServer``
  (the same ``alive:<index>:<pid>`` bytes), ``detect_dead_peers`` on a
  dead port, ``remesh_after_failure`` (shrink, the warning for slots of
  live peers, ``TimeoutError``), ``initialize_multihost()`` with no
  cluster returning 1 in a child process, and ``get_load``'s rank.
- Two gloo ranks x 4 CPU slots evaluate the flagship's sharded
  logp+grad through the kernel's wrapper (its plain version on the CPU):
  both ranks report the same bits, equal to one process driving all 8
  slots, and the gradient equals the unsharded one (rtol 1e-6, float32:
  not x2, not x1/2); a gradient through ``sharded_compute``'s gathered
  outputs equals the 8-slot mesh's too.  Rank 1 is then SIGKILLed in its work loop; rank 0
  detects the death through its heartbeat probes, remeshes to its own 4
  slots and reproduces the value (rtol 1e-6).  The ranks' code is this
  file's ``__main__``; every wait is bounded and every child is killed
  in ``finally``.
"""

import json
import logging
import os
import signal
import socket
import subprocess
import sys
import threading
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD, LOCAL_SLOTS = 2, 4
N_OBS = 64
POINT = {"intercept": 1.3, "slope": 1.9, "log_sigma": -0.6}


def _flagship(torch, pft):
    """The flagship data tree (8 shards, the kernel's per-shard form) and
    a point off the mode, float32 on the CPU."""
    data, _ = pft.generate_node_data(8, n_obs=N_OBS, seed=123, device="cpu")
    (x, y), mask = data.tree()
    tree = ((x, y), mask, torch.arange(8))
    p = {k: torch.tensor(v) for k, v in POINT.items()}
    p["offsets"] = torch.linspace(-0.2, 0.2, 8)
    return tree, p


def _evaluator(pft, tree, mesh):
    from pytensor_federated_torch.ops.linreg_kernel import linreg_shard_logp

    fed = pft.FederatedLogp(linreg_shard_logp, tree, mesh=mesh)
    return lambda p: pft.linreg_prior_logp(p) + fed.logp(p)


def _residual_stats(params, shard):
    """A per-shard output tree that is not a logp, for ``sharded_compute``."""
    (x, y), mask, sid = shard
    r = (y - (params["intercept"] + params["offsets"][sid]) - params["slope"] * x) * mask
    return {"ssr": (r * r).sum() * (-2.0 * params["log_sigma"]).exp(), "head": r[:2]}


def _compute_loss(pft, tree, mesh):
    """A scalar of ``sharded_compute``'s outputs, differentiated through
    the gather of the slots' outputs."""
    stats = pft.sharded_compute(_residual_stats, tree, mesh=mesh)

    def loss(p):
        out = stats(p)
        return out["ssr"].sum() + 0.5 * (out["head"] ** 2).sum()

    return loss


def _bits(t):
    return [float(v).hex() for v in t.detach().reshape(-1).tolist()]


def _rank_main(rank, coord_port, hb_base):
    """One rank of the two-process run (see the module docstring)."""
    sys.path.insert(0, REPO)
    import torch

    import pytensor_federated_torch as pft
    from pytensor_federated_torch.parallel import (
        HeartbeatServer,
        ZeroShardedLogpGrad,
        detect_dead_peers,
        initialize_multihost,
        make_multihost_mesh,
        probe_peer,
        remesh_after_failure,
    )
    from pytensor_federated_torch.ops.linreg_kernel import linreg_shard_logp
    from pytensor_federated_torch.utils import value_and_grad

    def say(tag, obj):
        print(f"{tag} {json.dumps(obj)}", flush=True)

    n = initialize_multihost(f"127.0.0.1:{coord_port}", num_processes=WORLD, process_id=rank,
                             backend="gloo", timeout_s=20.0)
    hb = HeartbeatServer(port=hb_base + rank, process_index=rank)
    tree, p = _flagship(torch, pft)
    mesh = make_multihost_mesh(devices=["cpu"] * LOCAL_SLOTS)
    v, g = value_and_grad(_evaluator(pft, tree, mesh), p)
    # One process driving all 8 slots, and no mesh: no collectives.
    one = pft.make_mesh({"shards": 8}, devices=["cpu"] * 8)
    v8, g8 = value_and_grad(_evaluator(pft, tree, one), p)
    v0, g0 = value_and_grad(_evaluator(pft, tree, None), p)
    z = ZeroShardedLogpGrad(linreg_shard_logp, tree, p, mesh=mesh)
    z8 = ZeroShardedLogpGrad(linreg_shard_logp, tree, p, mesh=one)
    sg, sg8 = z.logp_and_scattered_grad(p), z8.logp_and_scattered_grad(p)
    zg = z.gather_grad(sg)
    cv, cg = value_and_grad(_compute_loss(pft, tree, mesh), p)
    cv8, cg8 = value_and_grad(_compute_loss(pft, tree, one), p)
    zfinal, ztrace = z.sgd_steps(p, learning_rate=1e-4, num_steps=3)
    zfinal8, ztrace8 = z8.sgd_steps(p, learning_rate=1e-4, num_steps=3)
    keys = sorted(g)
    say("PHASE-A", {
        "rank": rank, "world": n, "mesh": dict(mesh.shape),
        "processes": mesh.processes.reshape(-1).tolist(),
        "process_index": pft.get_load(["cpu"])[0].process_index,
        "logp": float(v).hex(), "grad": {k: _bits(g[k]) for k in keys},
        "logp8": float(v8).hex(), "grad8": {k: _bits(g8[k]) for k in keys},
        "logp0": float(v0), "grad0": {k: g0[k].reshape(-1).tolist() for k in keys},
        "grad_f": {k: g[k].reshape(-1).tolist() for k in keys},
        "zero_local_slices": [i for i, s in enumerate(sg.grad_slices) if s is not None],
        "zero_bits_equal_one_process": (
            float(sg.logp).hex() == float(sg8.logp).hex()
            and all(torch.equal(sg.grad_slices[i], sg8.grad_slices[i])
                    for i in range(8) if sg.grad_slices[i] is not None)
            and all(torch.equal(ztrace, ztrace8) and torch.equal(zfinal[k], zfinal8[k])
                    for k in keys)),
        "zero_grad": {k: _bits(zg[k]) for k in keys},
        "compute": float(cv).hex(), "compute8": float(cv8).hex(),
        "compute_grad": {k: _bits(cg[k]) for k in keys},
        "compute_grad_f": {k: cg[k].reshape(-1).tolist() for k in keys},
        "compute_grad8": {k: cg8[k].reshape(-1).tolist() for k in keys},
    })
    if rank != 0:
        say("SERVING", {})
        local = _evaluator(pft, tree, one)
        while True:  # the work loop: only the SIGKILL ends it
            local(p)
            time.sleep(0.05)

    peer = {1: ("127.0.0.1", hb_base + 1)}
    deadline = time.monotonic() + 10.0
    while not probe_peer(peer[1], timeout=0.5, expect_process_index=1):
        if time.monotonic() > deadline:
            say("FAIL", {"why": "peer heartbeat never came up"})
            os._exit(2)
        time.sleep(0.05)
    say("PEER-ALIVE", {})
    t0, deadline = time.monotonic(), time.monotonic() + 10.0
    while detect_dead_peers(peer, timeout=0.5, retries=3, retry_wait=0.1) != [1]:
        if time.monotonic() > deadline:
            say("FAIL", {"why": "peer death never detected"})
            os._exit(2)
    say("PEER-DEAD", {"seconds": time.monotonic() - t0})
    survivors = remesh_after_failure(mesh, axis="shards", dead_process_ids=[1])
    v2 = _evaluator(pft, tree, survivors)(p)
    hb.stop()
    say("PHASE-B", {"mesh": dict(survivors.shape), "multiprocess": survivors.is_multiprocess,
                    "logp": float(v2)})
    sys.stdout.flush()
    os._exit(0)  # no process-group teardown with a dead peer


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]))


import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from pytensor_federated_tpu.parallel import multihost as jmultihost  # noqa: E402
import pytensor_federated_torch as pft  # noqa: E402
from pytensor_federated_torch.parallel import (  # noqa: E402
    HeartbeatServer,
    detect_dead_peers,
    make_mesh,
    make_multihost_mesh,
    probe_peer,
    remesh_after_failure,
)
from pytensor_federated_torch.telemetry import flightrec, spans  # noqa: E402

CPU = torch.device("cpu")


@pytest.fixture
def recording():
    """The flight recorder on (it records only with spans on), emptied."""
    prev, prev_fr = spans.set_enabled(True), flightrec.set_enabled(True)
    flightrec.clear()
    yield
    spans.set_enabled(prev)
    flightrec.set_enabled(prev_fr)
    flightrec.clear()


class _Dev:
    """A stand-in JAX device of another process, for the layout only."""

    def __init__(self, process_index, id):
        self.process_index, self.id, self.platform = process_index, id, "cpu"


@pytest.mark.parametrize("inner", [None, {"chains": 2}, {"chains": 4}])
def test_layout_matches_jax_one_process(devices8, inner):
    mesh = make_multihost_mesh(inner, devices=[CPU] * 8, num_processes=1)
    jmesh = jmultihost.make_multihost_mesh(inner, devices=devices8)
    assert dict(mesh.shape) == dict(jmesh.shape) and mesh.axis_names == jmesh.axis_names
    assert mesh.processes is None and not mesh.is_multiprocess


@pytest.mark.parametrize("inner", [None, {"chains": 2}])
def test_layout_matches_jax_two_processes(inner):
    """Host-major over two processes of 4 devices each: the same shape
    and each slot's process as the JAX layout of the same devices."""
    mesh = make_multihost_mesh(inner, devices=[CPU] * 4, num_processes=2)
    jdevs = [_Dev(p, p * 4 + i) for p in (1, 0) for i in range(4)]
    jmesh = jmultihost.make_multihost_mesh(inner, devices=jdevs)
    assert dict(mesh.shape) == dict(jmesh.shape) and mesh.axis_names == jmesh.axis_names
    want = np.vectorize(lambda d: d.process_index)(jmesh.devices)
    assert np.array_equal(mesh.processes, want) and mesh.is_multiprocess
    assert mesh.slot_processes("shards") == list(want.reshape(want.shape[0], -1)[:, 0])


def test_layout_errors_match_jax(devices8):
    cases = [({"chains": 3}, 1), ({"shards": 2}, 1), ({"chains": 4}, 3)]
    for inner, hosts in cases:
        with pytest.raises(ValueError) as got:
            make_multihost_mesh(inner, devices=[CPU] * (8 // hosts if hosts != 3 else 2),
                                num_processes=hosts)
        jdevs = (devices8 if hosts == 1
                 else [_Dev(p, p * 2 + i) for p in range(3) for i in range(2)])
        with pytest.raises(ValueError) as want:
            jmultihost.make_multihost_mesh(inner, devices=jdevs)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("server", ["torch", "jax"])
def test_probe_each_packages_server(server):
    """Each package's probe reads the other's heartbeat: alive, the
    identity check, and dead after stop."""
    cls = HeartbeatServer if server == "torch" else jmultihost.HeartbeatServer
    probe = jmultihost.probe_peer if server == "torch" else probe_peer
    hb = cls(process_index=3)
    try:
        addr = hb.address
        assert probe(addr, timeout=2.0) and probe(addr, timeout=2.0, expect_process_index=3)
        assert not probe(addr, timeout=2.0, expect_process_index=1)
        with socket.create_connection(addr, timeout=2.0) as s:
            banner = s.recv(64)
        assert banner == f"alive:3:{os.getpid()}".encode()
    finally:
        hb.stop()
    assert not probe(addr, timeout=0.5)


def test_detect_dead_peers_on_a_dead_port(recording):
    hb = HeartbeatServer(process_index=0)
    try:
        dead = detect_dead_peers({0: hb.address, 7: ("127.0.0.1", 1)}, timeout=0.3,
                                 retries=2, retry_wait=0.05)
        jdead = jmultihost.detect_dead_peers({0: hb.address, 7: ("127.0.0.1", 1)},
                                             timeout=0.3, retries=2, retry_wait=0.05)
    finally:
        hb.stop()
    assert dead == jdead == [7]
    events = [e for e in flightrec.events() if e["kind"] == "mesh.peer_dead"]
    assert [e["peer"] for e in events] == [7]


def test_remesh_after_failure(caplog, devices8, recording):
    mesh = make_mesh({"shards": 8}, devices=[CPU] * 8)
    assert dict(remesh_after_failure(mesh, devices=[CPU] * 5).shape) == {"shards": 5}
    grid = make_mesh({"chains": 2, "shards": 4}, devices=[CPU] * 8)
    new = remesh_after_failure(grid, axis="shards", devices=[CPU] * 6)
    jnew = jmultihost.remesh_after_failure(
        jmultihost.make_mesh({"chains": 2, "shards": 4}, devices=devices8), axis="shards",
        devices=devices8[:6])
    assert dict(new.shape) == dict(jnew.shape) and new.axis_names == jnew.axis_names
    assert dict(remesh_after_failure(mesh, dead_process_ids=[999]).shape) == {"shards": 8}
    with pytest.raises(TimeoutError, match="no healthy devices"):
        remesh_after_failure(mesh, devices=[])
    # A two-process mesh with no verdict: the peer's slots are dropped
    # with a warning (local view), and the rebuilt mesh is this process's.
    two = make_multihost_mesh(devices=[CPU] * 4, num_processes=2)
    with caplog.at_level(logging.WARNING, logger="pytensor_federated_torch"):
        local = remesh_after_failure(two)
    assert dict(local.shape) == {"shards": 4} and not local.is_multiprocess
    assert any("NOT declared dead" in r.getMessage() for r in caplog.records)
    caplog.clear()
    with caplog.at_level(logging.WARNING, logger="pytensor_federated_torch"):
        remesh_after_failure(two, dead_process_ids=[1])
    assert not any("NOT declared dead" in r.getMessage() for r in caplog.records)
    remesh = [e for e in flightrec.events() if e["kind"] == "mesh.remesh"]
    assert remesh[-1]["old_size"] == 8 and remesh[-1]["new_size"] == 4
    assert remesh[-1]["dead_process_ids"] == [1]
    assert {"kind", "axis", "old_size", "new_size", "dead_process_ids", "n_alive"} <= set(
        remesh[-1])


def test_initialize_without_a_cluster_returns_one():
    """In a fresh child process with no launcher environment: 1, no
    process group; an unavailable backend raises either way."""
    env = {k: v for k, v in os.environ.items() if k not in ("RANK", "WORLD_SIZE",
                                                             "MASTER_ADDR", "MASTER_PORT")}
    code = (
        "import sys, torch\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "from pytensor_federated_torch.parallel import initialize_multihost\n"
        "n = initialize_multihost()\n"
        "try:\n"
        "    initialize_multihost('127.0.0.1:1', num_processes=2, process_id=0,\n"
        "                         backend='no-such-backend')\n"
        "    raised = None\n"
        "except RuntimeError as e:\n"
        "    raised = str(e)\n"
        "print(n, torch.distributed.is_initialized(), raised)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                         timeout=60)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == (
        "1 False torch.distributed backend 'no-such-backend' is not available here")


def test_get_load_reports_the_rank():
    """Without a process group the rank is 0 (the two-process run checks
    rank 1's report)."""
    assert [x.process_index for x in pft.get_load([CPU, CPU])] == [0, 0]


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _free_port_pair():
    for _ in range(50):
        base = _free_port()
        try:
            with socket.socket() as s:
                s.bind(("127.0.0.1", base + 1))
            return base
        except OSError:
            continue
    raise RuntimeError("no consecutive free port pair found")


class _Lines:
    """A child's stdout, drained on a thread; waits are bounded."""

    def __init__(self, proc):
        self.lines, self._cond = [], threading.Condition()
        threading.Thread(target=self._drain, args=(proc,), daemon=True).start()

    def _drain(self, proc):
        for line in proc.stdout:
            with self._cond:
                self.lines.append(line.rstrip("\n"))
                self._cond.notify_all()

    def wait(self, tag, timeout):
        end = time.monotonic() + timeout
        with self._cond:
            while True:
                for line in self.lines:
                    if line.startswith(tag + " "):
                        return json.loads(line[len(tag) + 1:])
                if any(line.startswith("FAIL ") for line in self.lines):
                    raise AssertionError("\n".join(self.lines))
                left = end - time.monotonic()
                if left <= 0:
                    raise AssertionError(f"no {tag} within {timeout} s:\n" + "\n".join(self.lines))
                self._cond.wait(left)


def test_two_gloo_ranks_sum_detect_and_remesh():
    coord, hb_base = _free_port(), _free_port_pair()
    env = {k: v for k, v in os.environ.items() if k not in ("RANK", "WORLD_SIZE",
                                                             "MASTER_ADDR", "MASTER_PORT")}
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(r), str(coord),
                               str(hb_base)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]
    lines = [_Lines(p) for p in procs]
    try:
        a = [lines[r].wait("PHASE-A", 25) for r in range(WORLD)]
        assert [x["world"] for x in a] == [2, 2] and [x["process_index"] for x in a] == [0, 1]
        assert a[0]["mesh"] == {"shards": 8} and a[0]["processes"] == [0] * 4 + [1] * 4
        # Both ranks hold the same bits, equal to one process driving all
        # 8 slots (the slots' sums added in slot order either way).
        assert a[0]["logp"] == a[1]["logp"] == a[0]["logp8"]
        assert a[0]["grad"] == a[1]["grad"]
        assert a[0]["zero_grad"] == a[1]["zero_grad"]
        assert [x["zero_local_slices"] for x in a] == [[0, 1, 2, 3], [4, 5, 6, 7]]
        assert all(x["zero_bits_equal_one_process"] for x in a)
        # The gradient is the unsharded one: not x2 (a sum whose backward
        # sums again), not x1/2 (no sum over the processes).
        v0 = a[0]["logp0"]
        assert abs(float.fromhex(a[0]["logp"]) - v0) <= 1e-6 * abs(v0)
        for k, g0 in a[0]["grad0"].items():
            g0 = np.asarray(g0)
            np.testing.assert_allclose(a[0]["grad_f"][k], g0, rtol=1e-6,
                                       atol=1e-6 * float(np.abs(g0).max()))
        # sharded_compute: a gradient through the gathered outputs holds
        # every rank's slots (the 8-slot mesh's), not this rank's share.
        assert a[0]["compute"] == a[1]["compute"] == a[0]["compute8"]
        assert a[0]["compute_grad"] == a[1]["compute_grad"]
        for k, g8 in a[0]["compute_grad8"].items():
            g8 = np.asarray(g8)
            np.testing.assert_allclose(a[0]["compute_grad_f"][k], g8, rtol=1e-6,
                                       atol=1e-6 * float(np.abs(g8).max()))
        lines[1].wait("SERVING", 10)
        lines[0].wait("PEER-ALIVE", 10)
        procs[1].send_signal(signal.SIGKILL)
        procs[1].wait(timeout=10)
        assert procs[1].returncode == -signal.SIGKILL
        dead = lines[0].wait("PEER-DEAD", 15)
        assert dead["seconds"] < 5.0
        b = lines[0].wait("PHASE-B", 10)
        assert procs[0].wait(timeout=10) == 0
        assert b["mesh"] == {"shards": 4} and not b["multiprocess"]
        np.testing.assert_allclose(b["logp"], float.fromhex(a[0]["logp"]), rtol=1e-6)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)


def test_mesh_docstring_names_the_multiprocess_layer():
    """The mesh module no longer calls the multi-process layer unported:
    its docstring points at ``multihost``, whose slots carry ranks."""
    from pytensor_federated_torch.parallel import mesh

    assert "is not ported" not in mesh.__doc__
    assert ":mod:`.multihost`" in mesh.__doc__ and "processes" in mesh.__doc__

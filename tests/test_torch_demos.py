"""The port's demos against the JAX package's: a node's compute, demo
gRPC pools of either package answering the other's client, the remote
demo driver over mixed torch and JAX nodes, the pool's SIGTERM teardown,
and the local demo.

Every node runs with ``device="cpu"``; every pool manager is reaped in
a ``finally``, every wait is bounded (nodes up within 60 s, each client
call within 30 s, the nodes gone within 10 s of the SIGTERM).
Tolerance on a node's float32 value and gradient against the JAX
node's: rtol 1e-5.
"""

import asyncio
import functools
import multiprocessing as mp
import os
import socket
import time

import numpy as np
import pytest

from pytensor_federated_tpu.demos import demo_node as jdemo
from pytensor_federated_tpu.service import LogpGradServiceClient as JClient
from pytensor_federated_torch.demos import demo_model, demo_node
from pytensor_federated_torch.service import LogpGradServiceClient as TClient

POINTS = [(1.5, 2.0), (0.0, 0.0), (-1.0, 3.5)]
TOL = dict(rtol=1e-5, atol=1e-4)
CALL_TIMEOUT_S = 30.0


def _free_ports(n):
    # Every probe socket stays open until all ports are drawn.
    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def _children(pid):
    """Live child PIDs of ``pid`` from /proc (zombies excluded)."""
    out = []
    for entry in os.listdir("/proc"):
        if entry.isdigit():
            try:
                with open(f"/proc/{entry}/stat") as f:
                    fields = f.read().rsplit(")", 1)[1].split()
            except OSError:
                continue
            if int(fields[1]) == pid and fields[0] not in ("Z", "X"):
                out.append(int(entry))
    return out


def _call(client, *args):
    async def go():
        return await asyncio.wait_for(client.evaluate_async(*args), CALL_TIMEOUT_S)

    return asyncio.run(go())


@pytest.fixture(scope="module")
def pools():
    """Two torch demo nodes and one JAX demo node, each pool behind its
    own manager process (``run_node_pool``)."""
    from conftest import scrubbed_child_env, wait_nodes_up

    torch_ports, jax_ports = _free_ports(2), _free_ports(1)
    with scrubbed_child_env():
        ctx = mp.get_context("spawn")
        managers = {
            "torch": ctx.Process(target=functools.partial(demo_node.run_node_pool, device="cpu"),
                                 args=("127.0.0.1", torch_ports)),
            "jax": ctx.Process(target=jdemo.run_node_pool, args=("127.0.0.1", jax_ports)),
        }
        for p in managers.values():
            p.start()
    try:
        wait_nodes_up(torch_ports + jax_ports, timeout=60)
        yield {"torch": torch_ports, "jax": jax_ports, "managers": managers}
    finally:
        for p in managers.values():
            p.terminate()
        for p in managers.values():
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)


def test_node_compute_matches_the_jax_node():
    port = 50001
    t = demo_node.make_node_compute(port, device="cpu")
    j = jdemo.make_node_compute(port)
    for i0, s0 in POINTS:
        args = (np.float32(i0), np.float32(s0))
        got, want = t(*args), j(*args)
        assert [np.shape(g) for g in got] == [(), (), ()]
        np.testing.assert_allclose(np.array(got, np.float64), np.array(want, np.float64), **TOL)


def test_entry_points_need_cuda_unless_told_cpu():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        demo_node.make_node_compute(50000)
    with pytest.raises(SystemExit) as e:
        demo_node.main(["--ports"])  # missing value
    assert e.value.code != 0


def test_each_pool_answers_the_other_packages_client(pools):
    """A JAX client against a torch node and a torch client against a
    JAX node, both with the JAX node's values."""
    for kind, ports, client_cls in (("torch", pools["torch"], JClient),
                                    ("jax", pools["jax"], TClient)):
        for port in ports:
            ref = jdemo.make_node_compute(port)
            client = client_cls("127.0.0.1", port)
            for i0, s0 in POINTS:
                args = (np.float32(i0), np.float32(s0))
                logp, grads = _call(client, *args)
                want = ref(*args)
                np.testing.assert_allclose(
                    np.array([logp, *grads], np.float64), np.array(want, np.float64), **TOL,
                    err_msg=f"{kind} node on port {port}")


def test_run_remote_over_mixed_nodes_recovers_the_slope(pools):
    """tests/test_e2e_remote.py:50's gate (median slope 2 ± 0.15) over
    two torch nodes and one JAX node."""
    res = demo_model.run_remote("127.0.0.1", pools["torch"] + pools["jax"], draws=200)
    slope = res.samples["slope"].numpy()
    assert slope.shape == (1, 200)
    assert abs(np.median(slope) - 2.0) < 0.15


def test_sigterm_tears_the_torch_pool_down(pools):
    """The pool manager's SIGTERM handler terminates every node: their
    processes are gone within 10 s and the manager exits 128 + 15."""
    manager = pools["managers"]["torch"]
    nodes = _children(manager.pid)
    assert len(nodes) == 2, nodes
    manager.terminate()  # SIGTERM
    manager.join(timeout=10)
    assert manager.exitcode == 128 + 15
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline and _live(nodes):
        time.sleep(0.1)
    assert _live(nodes) == []


def _live(pids):
    live = []
    for pid in pids:
        try:
            with open(f"/proc/{pid}/stat") as f:
                if f.read().rsplit(")", 1)[1].split()[0] not in ("Z", "X"):
                    live.append(pid)
        except OSError:
            pass
    return live


def test_run_local_recovers_the_slope():
    """tests/test_demos.py:13's gate at 4 shards and 15 + 15 draws (2
    chains) on the CPU, through the kernel wrapper's plain version."""
    res = demo_model.run_local(n_shards=4, draws=15, device="cpu")
    slope = np.median(res.samples["slope"].numpy())
    assert abs(slope - 2.0) < 0.15

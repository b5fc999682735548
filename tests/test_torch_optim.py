"""The port's sharded optimizer (``optim/``) against the JAX package's.

- The node's versioned update over ``tests/test_optim.py``'s five seed
  geometries: bit for bit equal to the port's driver-centric Adam (Adam
  is elementwise, so slice-of-Adam is Adam-of-slice), and equal to
  ``optax.adam`` to float32 rounding (|diff| <= 1e-6 + 1e-5 |p|: the
  gradients and the bias-correction powers are computed by different
  libraries).
- The store and the stale protocol raise the JAX package's error
  classes with its strings.
- A JAX node and a torch node read each other's shard checkpoints
  (optax's state leaves: the int32 count, then mu, then nu).
- Over live nodes: a mixed pool whose JAX owner is SIGKILLed fails the
  shard over to a torch replica that restores it from the shared store
  with no double step; a lost reply recovers through the refresh lane;
  a gRPC replica is refused at bind.

Every node binds an ephemeral port and every wait is bounded.
"""

import os
import select
import signal
import subprocess
import sys
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pytensor_federated_tpu import optim as jopt
from pytensor_federated_tpu.routing import partition as jpartition
from pytensor_federated_tpu.service import npwire as jnpwire
from pytensor_federated_tpu.service import tcp as jtcp
from pytensor_federated_torch import optim as topt
from pytensor_federated_torch.optim._adam import adam
from pytensor_federated_torch.optim.sharded import SHARD_UPDATES
from pytensor_federated_torch.routing import NodePool
from pytensor_federated_torch.routing import partition as tpartition
from pytensor_federated_torch.service import npwire as tnpwire
from pytensor_federated_torch.service import shm as tshm
from pytensor_federated_torch.service import tcp as ttcp

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT_S = 30.0
LR = 0.05
# float32 rounding between the packages (see the module docstring).
ATOL, RTOL = 1e-6, 1e-5

# tests/test_optim.py's seed geometries: (total, count).
_SEED_GEOMETRIES = [(1, 1), (5, 5), (13, 3), (8, 2), (40, 6)]


def _quad_loss_jax(params, x):
    return jnp.sum((params - x) ** 2) + jnp.sum(jnp.sin(params))


def _quad_grad_jax(params, x):
    loss, g = jax.value_and_grad(_quad_loss_jax)(jnp.asarray(params), jnp.asarray(x))
    return np.asarray(loss), np.asarray(g)


def _quad_grad_torch(params, x):
    p = torch.as_tensor(np.asarray(params)).requires_grad_(True)
    loss = torch.sum((p - torch.as_tensor(np.asarray(x))) ** 2) + torch.sum(torch.sin(p))
    (g,) = torch.autograd.grad(loss, p)
    return loss.detach(), g


def _params_of(arrays):
    return np.asarray(arrays[0]).ravel()


def _torch_compute(store):
    return topt.make_update_compute(_quad_grad_torch, adam(LR), store, params_of=_params_of)


def _jax_compute(store):
    return jopt.make_update_compute(_quad_grad_jax, optax.adam(LR), store, params_of=_params_of)


def _driver_adam(total, xs):
    """The port's driver-centric Adam: the whole gradient, the whole
    update, ``params + update``; the trajectory after each step."""
    opt = adam(LR)
    params = np.zeros(total, np.float32)
    state = opt.init(torch.from_numpy(params))
    out = []
    for x in xs:
        _, g = _quad_grad_torch(params, x)
        upd, state = opt.update(g, state)
        params = params + upd.numpy()
        out.append(params)
    return out


def _optax_adam(total, xs):
    opt = optax.adam(LR)
    params = jnp.zeros(total, jnp.float32)
    state = opt.init(params)
    out = []
    for x in xs:
        _, g = jax.value_and_grad(_quad_loss_jax)(params, jnp.asarray(x))
        upd, state = opt.update(g, state)
        params = optax.apply_updates(params, upd)
        out.append(np.asarray(params))
    return out


def _close(a, b):
    np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)


# --- the node's versioned update -----------------------------------------------


@pytest.mark.parametrize("total,count", _SEED_GEOMETRIES)
def test_versioned_update_bit_identical_and_against_optax(tmp_path, total, count):
    compute = _torch_compute(topt.ShardStore(str(tmp_path)))
    plan = tpartition.plan_partitions(total, count)
    rng = np.random.default_rng(total * 31 + count)
    xs = [rng.normal(size=total).astype(np.float32) for _ in range(3)]
    params = np.zeros(total, np.float32)
    for step, (x, want, ref) in enumerate(zip(xs, _driver_adam(total, xs), _optax_adam(total, xs))):
        new = params.copy()
        for part in plan:
            outputs, rv = compute.versioned_update([params, x], tuple(part), step)
            assert rv == step + 1
            assert outputs[1].size == part.length and outputs[1].dtype == np.float32
            new[part.offset : part.offset + part.length] += outputs[1]
        params = new
        np.testing.assert_array_equal(params, want)
        _close(params, ref)


def test_adam_state_leaves_are_optax_order():
    p = np.linspace(-1.0, 1.0, 5).astype(np.float32)
    g = np.cos(p) + 0.5
    tstate = adam(LR).init(torch.from_numpy(p))
    jstate = optax.adam(LR).init(jnp.asarray(p))
    _, tstate = adam(LR).update(torch.from_numpy(g), tstate)
    _, jstate = optax.adam(LR).update(jnp.asarray(g), jstate)
    tleaves = adam(LR).leaves(tstate)
    jleaves = [np.asarray(leaf) for leaf in jax.tree_util.tree_leaves(jstate)]
    assert [(a.dtype, a.shape) for a in tleaves] == [(b.dtype, b.shape) for b in jleaves]
    assert int(tleaves[0]) == int(jleaves[0]) == 1
    for a, b in zip(tleaves[1:], jleaves[1:]):
        _close(a, b)


# --- the store and the stale protocol ---------------------------------------------


def _both(fn):
    """Run ``fn(optim, partition, npwire, root)`` against each package;
    return each outcome as ``(error class name, message)`` or a value."""
    out = []
    for pkg, part_mod, wire, sub in ((jopt, jpartition, jnpwire, "jax"),
                                    (topt, tpartition, tnpwire, "torch")):
        try:
            out.append(("ok", fn(pkg, part_mod, wire, sub)))
        except Exception as e:  # noqa: BLE001 - the classes are compared
            out.append((type(e).__name__, str(e)))
    return out


def _store_case(name, tmp_path):
    def run(pkg, part_mod, wire, sub):
        store = pkg.ShardStore(str(tmp_path / name / sub))
        if name == "round_trip":
            part = part_mod.plan_partitions(10, 3)[1]
            assert store.load(part) is None and store.version(part) is None
            params = np.arange(part.length, dtype=np.float32)
            store.save(part, 4, params, [np.int32(4), np.ones(part.length), np.zeros(part.length)])
            state = store.load(part)
            store.save(part, 5, params + 1, state.opt_leaves)
            again = store.load(part)
            store.drop(part)
            return (state.version, again.version, again.params.tolist(),
                    [a.dtype.str for a in again.opt_leaves], store.load(part),
                    os.path.basename(store._path(part)))
        if name == "geometry_collision":
            part = part_mod.plan_partitions(10, 2)[0]
            store.save(part, 1, np.zeros(part.length), [])
            store.save(part, 2, np.zeros(part.length + 1), [])
        if name == "geometry_mismatch":
            part = part_mod.plan_partitions(10, 2)[0]
            store.save(part, 1, np.zeros(part.length), [])
            other = part_mod.GradPartition(0, 2, 0, 5, 10)
            with np.load(store._path(part)) as z:
                payload = dict(z)
            payload["geometry"] = np.asarray([0, 2, 0, 5, 11], np.uint64)
            np.savez(store._path(part), **payload)
            store.load(other)
        if name == "corrupt":
            part = part_mod.plan_partitions(6, 2)[0]
            store.save(part, 1, np.zeros(part.length), [])
            with open(store._path(part), "wb") as f:
                f.write(b"not an npz")
            store.load(part)
        if name == "stale":
            part = part_mod.GradPartition(2, 4, 10, 5, 20)
            err = pkg.StaleShardError(part, 7, 6)
            assert isinstance(err, wire.WireError)
            return (pkg.stale_message(part, 7, 6), pkg.parse_stale_error(str(err)),
                    pkg.parse_stale_error("some other error"), err.holds, err.expected)
        return None

    return run


@pytest.mark.parametrize("name", ["round_trip", "geometry_collision", "geometry_mismatch",
                                  "corrupt", "stale"])
def test_store_and_stale_protocol_match_jax(tmp_path, name):
    jax_out, torch_out = _both(_store_case(name, tmp_path))
    assert torch_out == jax_out
    if name in ("geometry_collision", "geometry_mismatch"):
        assert torch_out[0] == "PartitionError"
    if name == "corrupt":
        assert torch_out[0] == "WireError" and "corrupt shard checkpoint" in torch_out[1]


def _protocol_case(tmp_path):
    """The handler's refusals (tests/test_optim.py's protocol test)."""

    def run(pkg, part_mod, wire, sub):
        store = pkg.ShardStore(str(tmp_path / sub))
        compute = (_jax_compute if pkg is jopt else _torch_compute)(store)
        (part,) = part_mod.plan_partitions(5, 1)
        x, zero = np.ones(5, np.float32), np.zeros(5, np.float32)
        out = []
        for call in (
            lambda: compute(np.zeros(3)),
            lambda: compute.versioned_update([np.zeros(3)], None, 0),
            lambda: compute.versioned_update([], tuple(part), 0),
            lambda: compute.versioned_update([zero, x], tuple(part), 0)[1],
            lambda: compute.versioned_update([zero, x], tuple(part), 0),
            lambda: compute.versioned_update([], tuple(part), 1)[1],
            lambda: compute.versioned_update([], tuple(part), 2),
            lambda: (store.drop(part), compute.versioned_update([zero, x], tuple(part), 1)),
        ):
            try:
                out.append(("ok", call()))
            except Exception as e:  # noqa: BLE001 - the classes are compared
                out.append((type(e).__name__, str(e)))
        return out

    return run


def test_handler_refusals_match_jax(tmp_path):
    (_, jax_out), (_, torch_out) = _both(_protocol_case(tmp_path))
    assert torch_out == jax_out
    kinds = [k for k, _ in torch_out]
    assert kinds == ["RuntimeError", "WireError", "WireError", "ok", "StaleShardError", "ok",
                     "StaleShardError", "StaleShardError"]


# --- checkpoints across packages ----------------------------------------------------


@pytest.mark.parametrize("first,second", [("jax", "torch"), ("torch", "jax")])
def test_checkpoints_restore_across_packages(tmp_path, first, second):
    """Three steps by one package's node, three more by the other's from
    the same store: the trajectory follows optax's to float32 rounding,
    and the store's Adam count equals its version."""
    makers = {"jax": (_jax_compute, jpartition), "torch": (_torch_compute, tpartition)}
    total, count = 13, 3
    rng = np.random.default_rng(11)
    xs = [rng.normal(size=total).astype(np.float32) for _ in range(6)]
    params = np.zeros(total, np.float32)
    for step, x in enumerate(xs):
        make, part_mod = makers[first if step < 3 else second]
        store = (jopt if part_mod is jpartition else topt).ShardStore(str(tmp_path))
        compute = make(store)
        new = params.copy()
        for part in part_mod.plan_partitions(total, count):
            outputs, rv = compute.versioned_update([params, x], tuple(part), step)
            assert rv == step + 1
            new[part.offset : part.offset + part.length] += outputs[1]
        params = new
    _close(params, _optax_adam(total, xs)[-1])
    store = topt.ShardStore(str(tmp_path))
    for part in tpartition.plan_partitions(total, count):
        state = store.load(part)
        assert state.version == 6 and int(state.opt_leaves[0]) == 6
        assert state.opt_leaves[0].dtype == np.int32


def test_checkpoint_of_another_optimizer_is_refused(tmp_path):
    store = topt.ShardStore(str(tmp_path))
    (part,) = tpartition.plan_partitions(4, 1)
    store.save(part, 1, np.zeros(4, np.float32), [np.zeros(4, np.float32)])
    with pytest.raises(tnpwire.WireError, match="optimizer-state leaves"):
        _torch_compute(store).versioned_update([np.zeros(4, np.float32)] * 2, tuple(part), 1)


# --- over live nodes ---------------------------------------------------------------


def _serve_thread(serve, compute, **kw):
    ports, ready = [], threading.Event()

    def on_ready(port):
        ports.append(port)
        ready.set()

    threading.Thread(target=serve, args=(compute,), daemon=True,
                     kwargs={"port": 0, "ready_callback": on_ready, **kw}).start()
    assert ready.wait(TIMEOUT_S)
    return ports[0]


JAX_OWNER = """
import sys
sys.path.insert(0, {root!r})
from pytensor_federated_tpu.utils import force_cpu_backend
force_cpu_backend()
import jax, jax.numpy as jnp, numpy as np, optax
from pytensor_federated_tpu.optim import ShardStore, make_update_compute
from pytensor_federated_tpu.service.tcp import serve_tcp_once

def grad(params, x):
    f = lambda p, x: jnp.sum((p - x) ** 2) + jnp.sum(jnp.sin(p))
    loss, g = jax.value_and_grad(f)(jnp.asarray(params), jnp.asarray(x))
    return np.asarray(loss), np.asarray(g)

compute = make_update_compute(grad, optax.adam({lr}), ShardStore({store!r}),
                              params_of=lambda a: np.asarray(a[0]).ravel())
serve_tcp_once(compute, "127.0.0.1", 0, concurrent=True,
               ready_callback=lambda port: print(port, flush=True))
"""


@pytest.fixture(scope="module")
def jax_owner(tmp_path_factory):
    """A JAX owner node in a process of its own (it is SIGKILLed), over
    a store directory that a torch replica shares; ``(proc, port,
    store_root)``."""
    root = str(tmp_path_factory.mktemp("shared_store"))
    proc = subprocess.Popen(
        [sys.executable, "-c", JAX_OWNER.format(root=str(ROOT), lr=LR, store=root)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "JAX_PLATFORMS": "cpu"},
    )
    try:
        ready, _, _ = select.select([proc.stdout], [], [], 120)
        line = proc.stdout.readline() if ready else ""
        if not line.strip():
            proc.kill()
            raise RuntimeError(f"the JAX owner did not start: {proc.stderr.read()}")
        yield proc, int(line), root
    finally:
        proc.kill()
        proc.wait(timeout=TIMEOUT_S)
        proc.stdout.close()
        proc.stderr.close()


def test_mixed_pool_failover_restores_on_a_torch_replica(jax_owner):
    """The JAX owner steps the shard twice and is SIGKILLed; the next
    step fails over to a torch shm replica over the same store, which
    restores the JAX checkpoint and steps once: no double step, and the
    trajectory follows optax's."""
    proc, jax_port, root = jax_owner
    total = 6
    xs = [np.full(total, v, np.float32) for v in (1.0, -0.5, 2.0)]
    pool = NodePool(transport="tcp", probe_interval_s=60.0,
                    breaker_kwargs={"failure_threshold": 1})
    try:
        jax_replica = pool.add_replica("127.0.0.1", jax_port, transport="tcp")
        opt = topt.ShardedOptimizer(total, pool=pool, count=1)
        params = np.zeros(total, np.float32)
        for x in xs[:2]:
            params, accepted = opt.apply(params, opt.step([params, x]))
            assert accepted == [0]
        assert opt._owners[0].address == jax_replica.address
        torch_port = _serve_thread(tshm.serve_shm, _torch_compute(topt.ShardStore(root)))
        pool.add_replica("127.0.0.1", torch_port, transport="shm")
        proc.send_signal(signal.SIGKILL)
        assert proc.wait(timeout=TIMEOUT_S) == -signal.SIGKILL
        before = SHARD_UPDATES.labels(outcome="applied").value
        (res,) = opt.step([params, xs[2]])
        assert res.status == "applied" and res.version == 3
        assert opt._owners[0].address != jax_replica.address
        assert SHARD_UPDATES.labels(outcome="applied").value == before + 1
        params, _ = opt.apply(params, [res])
        state = topt.ShardStore(root).load(opt.parts[0])
        assert opt.versions == [3] and state.version == 3 and int(state.opt_leaves[0]) == 3
        np.testing.assert_array_equal(params, state.params)
        _close(params, _optax_adam(total, xs)[-1])
    finally:
        pool.close()


def test_lost_reply_recovers_without_double_step(tmp_path):
    """tests/test_optim.py's lost-reply case over torch nodes (one tcp,
    one shm): the repeated stamp is refused, the refresh lane hands back
    the applied slice, and the driver adopts the node's version."""
    store = topt.ShardStore(str(tmp_path))
    clients = [
        ttcp.TcpArraysClient("127.0.0.1", _serve_thread(ttcp.serve_tcp_once, _torch_compute(store),
                                                        concurrent=True)),
        tshm.ShmArraysClient("127.0.0.1", _serve_thread(tshm.serve_shm, _torch_compute(store))),
    ]
    try:
        total = 8
        opt = topt.ShardedOptimizer(total, clients=clients)
        params = np.zeros(total, np.float32)
        x = np.ones(total, np.float32)
        params, _ = opt.apply(params, opt.step([params, x]))
        opt.versions[0] -= 1
        results = opt.step([params, x])
        assert [r.status for r in results] == ["recovered", "applied"]
        params2, accepted = opt.apply(params, results)
        assert accepted == [0, 1] and opt.versions == [1, 2]
        p0 = opt.parts[0]
        state = store.load(p0)
        assert state.version == 1 and int(state.opt_leaves[0]) == 1
        np.testing.assert_array_equal(params2[p0.offset : p0.offset + p0.length], state.params)
        assert opt.max_reply_elems == 4
        results = opt.step([params2, x])
        assert [r.status for r in results] == ["applied", "applied"] and opt.versions == [2, 3]
        # A fresh driver against shards at versions >= 2 is divergence.
        with pytest.raises(tnpwire.WireError, match="diverged"):
            topt.ShardedOptimizer(total, clients=clients).step([params2, x])
    finally:
        for c in clients:
            c.close()


def test_grpc_replica_refused_at_bind():
    """A gRPC replica has no versioned lane: refused with the JAX
    package's error, through ``clients=`` and through a pool."""

    class FakeGrpcClient:
        def evaluate(self, *a, **k):  # pragma: no cover - never called
            return []

    msgs = []
    for pkg in (jopt, topt):
        with pytest.raises(TypeError, match="versioned") as ei:
            pkg.ShardedOptimizer(4, clients=[FakeGrpcClient()]).step([np.zeros(4, np.float32)])
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]
    pool = NodePool(transport="grpc", probe_interval_s=60.0)
    try:
        replica = pool.add_replica("127.0.0.1", 1)
        with pytest.raises(TypeError, match=f"replica {replica.address} has no versioned"):
            topt.ShardedOptimizer(4, pool=pool, count=1).step([np.zeros(4, np.float32)])
    finally:
        pool.close()

"""The port's pure bridge cores (``bridge/core.py``), without pytensor,
against the JAX package's (``tests/test_bridge_core.py``, mirrored).

- The perform-layer contracts and the grad-dtype policy give the JAX
  package's arrays, dtypes and errors on the same inputs.
- ``plan_fusion`` gives the JAX package's plan on the same nodes, also on
  a graph of the fake pytensor's applies.
- ``member_torch_callable`` / ``fused_torch_callable`` flatten and order
  as ``member_jax_callable`` / ``fused_jax_callable`` do, on the same
  member functions written for each backend.
- Two ``fed.FederatedLogpGrad`` potentials over one pool of TCP replicas
  compose into ONE program whose two maps share one ``fed.fused_window``
  (``tests/test_fed_placements.py``'s bridge case), against the dense
  JAX reference at the JAX tests' float32 tolerances.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytensor_federated_tpu.bridge import core as jcore
from pytensor_federated_torch import fed
from pytensor_federated_torch.bridge import core
from pytensor_federated_torch.bridge.core import (
    coerce_logp,
    coerce_logp_grads,
    coerce_outputs,
    fused_torch_callable,
    grad_output_dtype,
    member_torch_callable,
    plan_fusion,
)
from pytensor_federated_torch.routing import NodePool, PooledArraysClient
from pytensor_federated_torch.service import serve_tcp_once
from pytensor_federated_torch.telemetry import flightrec, spans

TIMEOUT_S = 60.0


def _same(a, b):
    """Equal arrays of equal dtype, element for element."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


class TestPerformContracts:
    def test_coerce_outputs_casts(self):
        out = coerce_outputs([np.float64(1.5), [1, 2]], ["float32", "int64"])
        assert out[0].dtype == np.float32 and out[1].dtype == np.int64
        for got, want in zip(out, jcore.coerce_outputs([np.float64(1.5), [1, 2]],
                                                       ["float32", "int64"])):
            _same(got, want)

    def test_coerce_outputs_arity(self):
        for mod in (core, jcore):
            with pytest.raises(ValueError, match="returned 1 outputs, expected 2"):
                mod.coerce_outputs([np.zeros(2)], ["float32", "float32"])

    def test_coerce_logp_scalar_contract(self):
        assert coerce_logp(2.5, "float64").shape == ()
        _same(coerce_logp(2.5, "float64"), jcore.coerce_logp(2.5, "float64"))
        for mod in (core, jcore):
            with pytest.raises(ValueError, match="scalar"):
                mod.coerce_logp(np.zeros(3), "float64")

    def test_coerce_logp_grads(self):
        args = (1.0, [np.ones(2), 3.0], "float32", ["float32", "float64"])
        logp, grads = coerce_logp_grads(*args)
        assert logp.dtype == np.float32
        assert grads[1].dtype == np.float64
        jlogp, jgrads = jcore.coerce_logp_grads(*args)
        _same(logp, jlogp)
        for g, j in zip(grads, jgrads):
            _same(g, j)
        for mod in (core, jcore):
            with pytest.raises(ValueError, match="1 grads for 2"):
                mod.coerce_logp_grads(1.0, [np.ones(2)], "f", ["float32", "float32"])

    @pytest.mark.parametrize("dtype,floatx", [
        ("int64", "float32"), ("uint8", "float64"), ("bool", "float32"),
        ("float32", "float64"), ("float64", "float32"), ("int32", "float64"),
    ])
    def test_grad_dtype_policy(self, dtype, floatx):
        """Int/bool inputs upcast to floatX; floats keep their dtype —
        the JAX package's answer for every pair."""
        want = floatx if dtype.startswith(("int", "uint", "bool")) else dtype
        assert grad_output_dtype(dtype, floatx) == want
        assert jcore.grad_output_dtype(dtype, floatx) == want

    def test_int_grad_truncation_prevented_end_to_end(self):
        """A 0.7 gradient through an int-typed output would cast to 0;
        the policy and the coercion together keep it 0.7."""
        dt = grad_output_dtype("int64", "float32")
        _, grads = coerce_logp_grads(0.0, [0.7], "float32", [dt])
        assert float(grads[0]) == pytest.approx(0.7)
        _same(grads[0], jcore.coerce_logp_grads(0.0, [0.7], "float32", [dt])[1][0])


class _Node:
    """Minimal stand-in for a pytensor Apply in planning tests."""

    def __init__(self, op, inputs, outputs):
        self.op, self.inputs, self.outputs = op, inputs, outputs


def _accessors():
    return dict(op_of=lambda n: n.op, inputs_of=lambda n: n.inputs,
                outputs_of=lambda n: n.outputs)


class TestPlanFusion:
    def test_plan_shapes_and_order(self):
        a = _Node("opA", ["x", "y"], ["a0"])
        b = _Node("opB", ["z"], ["b0", "b1"])
        plan = plan_fusion([a, b], **_accessors())
        assert plan["members"] == ["opA", "opB"]
        assert plan["in_counts"] == [2, 1]
        assert plan["out_counts"] == [1, 2]
        assert plan["all_inputs"] == ["x", "y", "z"]
        assert plan["replacements"] == [("a0", 0), ("b0", 1), ("b1", 2)]
        assert plan == jcore.plan_fusion([a, b], **_accessors())

    def test_same_plan_on_a_fake_pytensor_graph(self):
        """On applies of the fake pytensor (its numpy-only graph classes,
        not installed as ``pytensor``), the two packages plan alike."""
        import pytensor_shim as pts

        class Two(pts.Op):
            def make_node(self, *inputs):
                return pts.Apply(self, list(inputs), [pts.TensorType("float64", ())()
                                                      for _ in range(2)])

        x, y, z = (pts.TensorType("float64", (3,))() for _ in range(3))
        nodes = [Two().make_node(x, y), Two().make_node(z), (x + z).owner]
        plan = plan_fusion(nodes, **_accessors())
        jplan = jcore.plan_fusion(nodes, **_accessors())
        assert plan.keys() == jplan.keys()
        for key in plan:
            assert len(plan[key]) == len(jplan[key])
            for a, b in zip(plan[key], jplan[key]):
                assert a == b if not isinstance(a, tuple) else (a[0] is b[0] and a[1] == b[1])
        assert [pos for _, pos in plan["replacements"]] == list(range(5))


class TestTorchDispatch:
    def test_member_logp_grad_flattens(self):
        fn = member_torch_callable("logp_grad", lambda x: (torch.sum(x), [2.0 * x]))
        out = fn(torch.arange(3.0))
        jout = jax.jit(jcore.member_jax_callable(
            "logp_grad", lambda x: (jnp.sum(x), [2.0 * x])))(jnp.arange(3.0))
        assert len(out) == len(jout) == 2
        np.testing.assert_allclose(out[1].numpy(), [0.0, 2.0, 4.0])
        np.testing.assert_array_equal(out[1].numpy(), np.asarray(jout[1]))

    def test_member_logp_passthrough(self):
        fn = member_torch_callable("logp", lambda x: -torch.sum(x**2))
        assert float(fn(torch.ones(2))) == -2.0

    def test_member_arrays_tuples(self):
        fn = member_torch_callable("arrays", lambda x: [x + 1, x - 1])
        out = fn(torch.zeros(2))
        assert isinstance(out, tuple) and len(out) == 2

    def test_missing_torch_fn_raises(self):
        with pytest.raises(NotImplementedError, match="torch_fn"):
            member_torch_callable("logp", None)

    def test_unknown_kind_raises(self):
        with pytest.raises(ValueError, match="unknown member kind"):
            member_torch_callable("weird", lambda x: x)

    def test_fused_inlines_in_order(self):
        """The same three members, written once for each backend, fused:
        the same four outputs in the same order."""
        m1 = member_torch_callable("logp_grad", lambda x: (torch.sum(x), [torch.ones_like(x)]))
        m2 = member_torch_callable("logp", lambda a, b: a * b)
        m3 = member_torch_callable("arrays", lambda x: [x * 10])
        fused = fused_torch_callable([m1, m2, m3], [1, 2, 1])
        out = fused(torch.arange(2.0), torch.tensor(3.0), torch.tensor(4.0), torch.tensor(5.0))
        assert len(out) == 4
        assert float(out[0]) == 1.0
        assert float(out[2]) == 12.0
        assert float(out[3]) == 50.0
        j1 = jcore.member_jax_callable("logp_grad", lambda x: (jnp.sum(x), [jnp.ones_like(x)]))
        j2 = jcore.member_jax_callable("logp", lambda a, b: a * b)
        j3 = jcore.member_jax_callable("arrays", lambda x: [x * 10])
        jout = jax.jit(jcore.fused_jax_callable([j1, j2, j3], [1, 2, 1]))(
            jnp.arange(2.0), jnp.float32(3.0), jnp.float32(4.0), jnp.float32(5.0))
        for t, j in zip(out, jout):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))

    def test_fused_arity_validated(self):
        fused = fused_torch_callable([lambda x: (x,)], [1])
        with pytest.raises(ValueError, match="members consume 1"):
            fused(1.0, 2.0)
        with pytest.raises(ValueError, match="in_counts"):
            fused_torch_callable([lambda x: (x,)], [1, 2])


# ---------------------------------------------------------------------------
# fed potentials: one program, one window
# ---------------------------------------------------------------------------

N = 8
RTOL, GTOL = 1e-5, 1e-4  # the JAX fed tests' float32 tolerances


def _shard_logp(p, xs, ys):
    pred = p[0] + p[1] * xs
    if isinstance(xs, torch.Tensor):
        return -torch.sum((ys - pred) ** 2)
    return -jnp.sum((ys - pred) ** 2)


def _jax_dense(x, y, p):
    ref = lambda q: sum(_shard_logp(q, jnp.asarray(x[i]), jnp.asarray(y[i])) for i in range(N))
    v, g = jax.value_and_grad(ref)(jnp.asarray(p))
    return float(v), np.asarray(g)


@pytest.fixture(scope="module")
def pool_client():
    """Two TCP replicas serving the port's node-side twin of the
    per-shard logp, behind a routed pool client."""
    compute = fed.make_node_compute(_shard_logp, device="cpu")
    ports = []
    for _ in range(2):
        box, ready = {}, threading.Event()
        threading.Thread(
            target=serve_tcp_once, args=(compute,), daemon=True,
            kwargs=dict(ready_callback=lambda p, box=box, ready=ready: (box.update(p=p),
                                                                        ready.set()),
                        concurrent=True),
        ).start()
        assert ready.wait(TIMEOUT_S)
        ports.append(box["p"])
    pool = NodePool([("127.0.0.1", p) for p in ports], transport="tcp",
                    breaker_kwargs=dict(failure_threshold=1, backoff_s=30.0))
    client = PooledArraysClient(pool)
    yield client
    client.close()
    pool.close()


@pytest.fixture
def telemetry():
    was_spans, was_rec = spans.set_enabled(True), flightrec.set_enabled(True)
    flightrec.clear()
    yield
    spans.set_enabled(was_spans)
    flightrec.set_enabled(was_rec)


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_fused_torch_callable_one_window(pool_client, telemetry):
    """Two potentials, each with its OWN PoolPlacement over the shared
    client (fusion keys on equivalence), compose into one program: one
    ``fed.fused_window`` carrying both maps, each member's value and
    gradient equal to the dense JAX reference."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(N, 12)).astype(np.float32)
    y = (1.0 - 2.0 * x + 0.1 * rng.normal(size=(N, 12))).astype(np.float32)
    params = np.float32([0.4, -1.1])
    per_shard = lambda p, d: _shard_logp(p, d[0], d[1])
    ev_a = fed.FederatedLogpGrad(per_shard, (x, y), device="cpu",
                                 placement=fed.PoolPlacement(pool_client, window=8))
    ev_b = fed.FederatedLogpGrad(per_shard, (x + 0.5, y), device="cpu",
                                 placement=fed.PoolPlacement(pool_client, window=8))
    m_a = member_torch_callable("logp_grad", ev_a.torch_fn, name="a")
    m_b = member_torch_callable("logp_grad", ev_b.torch_fn, name="b")
    assert getattr(m_a, "_fed_evaluator", None) is ev_a
    fused = fused_torch_callable([m_a, m_b], [1, 1])
    p = torch.as_tensor(params)
    fused(p, p)  # records the joint program
    flightrec.clear()
    lp_a, g_a, lp_b, g_b = fused(p, p)
    windows = [e for e in flightrec.events() if e["kind"] == "fed.fused_window"]
    assert len(windows) == 1 and windows[0]["calls"] == 2
    for lp, g, xs in ((lp_a, g_a, x), (lp_b, g_b, x + 0.5)):
        v, jg = _jax_dense(xs, y, params)
        np.testing.assert_allclose(float(lp.detach()), v, rtol=RTOL)
        np.testing.assert_allclose(g.numpy(), jg, rtol=GTOL)


def test_fused_fed_logp_keeps_its_graph_and_grads_are_first_order():
    """On a mesh of CPU slots: the fused program's logps stay
    differentiable w.r.t. the caller's inputs (a sampler's backward
    through them gives each member's gradient), the returned gradients
    carry no graph, and the same tensor passed to both members gets each
    member's own gradient."""
    from pytensor_federated_torch.parallel import make_mesh

    rng = np.random.default_rng(5)
    x = rng.normal(size=(N, 6)).astype(np.float32)
    y = rng.normal(size=(N, 6)).astype(np.float32)
    per_shard = lambda p, d: _shard_logp(p, d[0], d[1])
    mesh = make_mesh({"shards": 4}, devices=["cpu"] * 4)
    evs = [fed.FederatedLogpGrad(per_shard, (x + k, y), device="cpu",
                                 placement=fed.MeshPlacement(mesh)) for k in (0.0, 1.0)]
    fused = fused_torch_callable(
        [member_torch_callable("logp_grad", ev.torch_fn) for ev in evs], [1, 1])
    p = torch.tensor([0.2, 0.7], requires_grad=True)
    lp_a, g_a, lp_b, g_b = fused(p, p)
    assert not g_a.requires_grad and not g_b.requires_grad
    assert not torch.equal(g_a, g_b)
    (total,) = torch.autograd.grad(lp_a + lp_b, p)
    torch.testing.assert_close(total, g_a + g_b, rtol=1e-6, atol=0.0)
    for ev, lp, g in zip(evs, (lp_a, lp_b), (g_a, g_b)):
        v, (gv,) = ev.logp_and_grad(p.detach())
        torch.testing.assert_close(lp.detach(), v, rtol=RTOL, atol=0.0)
        torch.testing.assert_close(g, gv, rtol=GTOL, atol=0.0)


@pytest.mark.parametrize("lane", ["member", "fused"])
def test_linreg_potentials_under_chain_vmap(lane):
    """``torch_fn`` of ``FederatedLogpGrad(linreg_shard_logp, ...)`` over a
    4-slot mesh, and the fused program of two such members, under
    ``torch.func.vmap`` over 3 chains as a sampler batches them: the
    returned gradients are first order, one ``torch.autograd.grad`` of
    the chains' summed values gives the same gradients (the kernel's
    backward runs first order both times), and each chain equals its own
    call and the JAX kernel's ``value_and_grad`` in interpret mode."""
    import pytensor_federated_torch as pft
    from pytensor_federated_tpu.ops.pallas_kernels import linreg_logp_grad_fn as jax_kernel_fn
    from pytensor_federated_torch.ops.linreg_kernel import linreg_shard_logp
    from pytensor_federated_torch.parallel import make_mesh

    data, _ = pft.generate_node_data(N, n_obs=16, seed=123, device="cpu")
    (x, y), mask = data.tree()
    ys = (y, y + 0.5)
    mesh = make_mesh({"shards": 4}, devices=["cpu"] * 4)
    evs = [fed.FederatedLogpGrad(linreg_shard_logp, ((x, yk), mask, torch.arange(N)),
                                 device="cpu", placement=fed.MeshPlacement(mesh))
           for yk in ys]
    rng = np.random.default_rng(11)
    C = 3
    chains = {"intercept": rng.normal(size=C), "slope": rng.normal(size=C),
              "log_sigma": 0.1 * rng.normal(size=C), "offsets": rng.normal(size=(C, N))}
    leaves = {k: torch.tensor(v, dtype=torch.float32, requires_grad=True)
              for k, v in chains.items()}
    if lane == "member":
        batched = per_chain = lambda ps: [(lp, gs[0]) for lp, gs in [evs[0].torch_fn(ps)]]
    else:
        fused = fused_torch_callable(
            [member_torch_callable("logp_grad", ev.torch_fn) for ev in evs], [1, 1])
        batched = per_chain = lambda ps: list(zip(*[iter(fused(ps, ps))] * 2))
    members = torch.func.vmap(batched)(leaves)
    total = sum(lp.sum() for lp, _ in members)
    back = torch.autograd.grad(total, list(leaves.values()))
    for k, b in zip(leaves, back):
        assert not any(g[k].requires_grad for _, g in members)
        torch.testing.assert_close(b, sum(g[k] for _, g in members), rtol=1e-6, atol=1e-6)
    for c in range(C):
        one = per_chain({k: v[c].detach() for k, v in leaves.items()})
        for (lp, g), (lp1, g1), yk in zip(members, one, ys):
            torch.testing.assert_close(lp[c].detach(), lp1.detach(), rtol=RTOL, atol=0.0)
            jv, jg = jax_kernel_fn(x.numpy(), yk.numpy(), mask.numpy(), interpret=True)(
                {k: jnp.asarray(v[c], jnp.float32) for k, v in chains.items()})
            np.testing.assert_allclose(float(lp[c].detach()), float(jv), rtol=RTOL)
            for k in leaves:
                torch.testing.assert_close(g[k][c], g1[k], rtol=GTOL, atol=1e-5)
                np.testing.assert_allclose(g[k][c].numpy(), np.asarray(jg[k]),
                                           rtol=GTOL, atol=1e-4)

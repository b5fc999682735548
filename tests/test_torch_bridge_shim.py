"""The port's bridge glue (``bridge/pytensor_ops.py`` + ``fusion.py``)
under the port's fake pytensor (``tests/torch_pytensor_shim.py``): every
case of ``tests/test_bridge_shim.py``, with the PyTorch lane
(``pytorch_funcify`` and ``compile_graph_to_torch``) in place of the JAX
one, plus the fused op's PyTorch lane composing ``fed`` potentials into
one program and the same graphs held against the JAX package's glue
under its own fake (the two fakes installed one after the other).

These prove our-side logic against the pinned API shapes — not
compatibility with real PyTensor.
"""

import pickle
import time

import numpy as np
import pytest
import torch

from torch_pytensor_shim import bridge_under_torch_shim


@pytest.fixture()
def env():
    with bridge_under_torch_shim() as ns:
        yield ns


def _quad_logp_grad(target):
    """logp(x) = -sum((x-target)^2), grad = -2(x-target) — closed-form
    oracle used throughout."""

    def fn(*inputs):
        logp = 0.0
        grads = []
        for x in inputs:
            x = np.asarray(x, dtype=np.float64)
            logp -= np.sum((x - target) ** 2)
            grads.append(-2.0 * (x - target))
        return np.asarray(logp), grads

    return fn


def _quad_at_zero(*inputs):
    return _quad_logp_grad(0.0)(*inputs)


def _quad_at_one(*inputs):
    return _quad_logp_grad(1.0)(*inputs)


def _torch_quad(target):
    def fn(x):
        return -torch.sum((x - target) ** 2), [-2.0 * (x - target)]

    return fn


# ---------------------------------------------------------------------------
# FederatedLogpGradOp
# ---------------------------------------------------------------------------


class TestLogpGradOp:
    def test_make_node_shapes_and_dtypes(self, env):
        op = env.pytensor_ops.FederatedLogpGradOp(_quad_logp_grad(0.0))
        x = env.TensorType("float32", (3,))()
        node = op.make_node(x, 2)  # raw python int coerces
        assert len(node.inputs) == 2
        assert len(node.outputs) == 3  # logp + one grad per input
        assert node.outputs[0].type.shape == ()
        assert node.outputs[1].type.dtype == "float32"
        # int input's grad upcasts to floatX, not int (core policy)
        assert node.outputs[2].type.dtype == env.config.floatX

    def test_perform_numerics(self, env):
        op = env.pytensor_ops.FederatedLogpGradOp(_quad_logp_grad(1.0))
        x = env.TensorType("float64", (3,))()
        logp, g = op(x)
        xv = np.array([0.0, 1.0, 3.0])
        lv, gv = env.eval_graph([logp, g], {x: xv})
        np.testing.assert_allclose(lv, -(1.0 + 0.0 + 4.0))
        np.testing.assert_allclose(gv, -2.0 * (xv - 1.0))

    def test_grad_is_scaled_product(self, env):
        """``.grad`` returns ``g_logp * grad_i`` evaluated through the
        re-applied op."""
        op = env.pytensor_ops.FederatedLogpGradOp(_quad_logp_grad(0.0))
        x = env.TensorType("float64", (2,))()
        op(x)
        g_logp = env.scalar()
        disconnected = env.DisconnectedType()()
        (gx,) = op.grad([x], [g_logp, disconnected])
        xv = np.array([1.0, -2.0])
        (gxv,) = env.eval_graph([gx], {x: xv, g_logp: np.asarray(3.0)})
        np.testing.assert_allclose(gxv, 3.0 * (-2.0 * xv))

    def test_second_order_rejected(self, env):
        op = env.pytensor_ops.FederatedLogpGradOp(_quad_logp_grad(0.0))
        x = env.TensorType("float64", (2,))()
        op(x)
        g_logp = env.scalar()
        connected = env.TensorType("float64", (2,))()  # NOT disconnected
        with pytest.raises(NotImplementedError, match="second-order"):
            op.grad([x], [g_logp, connected])

    def test_connection_pattern(self, env):
        op = env.pytensor_ops.FederatedLogpGradOp(_quad_logp_grad(0.0))
        x = env.TensorType("float64", (2,))()
        y = env.TensorType("float64", ())()
        node = op.make_node(x, y)
        assert op.connection_pattern(node) == [
            [True, False, False],
            [True, False, False],
        ]

    def test_scalar_logp_contract(self, env):
        def bad(*inputs):
            return np.ones(3), [np.zeros_like(i) for i in inputs]

        op = env.pytensor_ops.FederatedLogpGradOp(bad)
        x = env.TensorType("float64", (2,))()
        logp, _ = op(x)
        with pytest.raises(ValueError, match="scalar"):
            env.eval_graph([logp], {x: np.zeros(2)})

    def test_grad_arity_contract(self, env):
        def bad(*inputs):
            return np.asarray(0.0), []  # no grads for one input

        op = env.pytensor_ops.FederatedLogpGradOp(bad)
        x = env.TensorType("float64", (2,))()
        logp, _ = op(x)
        with pytest.raises(ValueError, match="grads"):
            env.eval_graph([logp], {x: np.zeros(2)})

    def test_federated_potential_front_door(self, env):
        x = env.TensorType("float64", (2,))()
        logp = env.pytensor_ops.federated_potential(_quad_logp_grad(0.0), x)
        assert isinstance(logp.owner.op, env.pytensor_ops.FederatedLogpGradOp)
        assert logp.index == 0

    def test_federated_potential_reads_the_evaluators_torch_fn(self, env):
        """An evaluator carrying ``torch_fn`` (a ``fed.FederatedLogpGrad``)
        is picked up without ``torch_fn=``; an explicit one wins."""
        from pytensor_federated_torch import fed

        ev = fed.FederatedLogpGrad(lambda p, d: -torch.sum((d - p) ** 2),
                                   np.ones((4, 3), np.float32), device="cpu")
        x = env.TensorType("float32", ())()
        op = env.pytensor_ops.federated_potential(ev, x).owner.op
        assert op.torch_fn == ev.torch_fn and op.logp_grad_fn is ev
        other = _torch_quad(0.0)
        assert env.pytensor_ops.federated_potential(ev, x, torch_fn=other).owner.op.torch_fn is other


# ---------------------------------------------------------------------------
# FederatedLogpOp / FederatedArraysToArraysOp
# ---------------------------------------------------------------------------


class TestOtherOps:
    def test_logp_op(self, env):
        op = env.pytensor_ops.FederatedLogpOp(lambda x: np.asarray(-np.sum(x**2)))
        x = env.TensorType("float64", (3,))()
        logp = op(x)
        (lv,) = env.eval_graph([logp], {x: np.array([1.0, 2.0, 3.0])})
        np.testing.assert_allclose(lv, -14.0)

    def test_arrays_op_output_types_and_arity(self, env):
        op = env.pytensor_ops.FederatedArraysToArraysOp(
            lambda a, b: [a + b, a * b],
            [env.TensorType("float64", (2,)), env.TensorType("float64", (2,))],
        )
        a = env.TensorType("float64", (2,))()
        b = env.TensorType("float64", (2,))()
        s, p = op(a, b)
        sv, pv = env.eval_graph([s, p], {a: np.array([1.0, 2.0]), b: np.array([3.0, 4.0])})
        np.testing.assert_allclose(sv, [4.0, 6.0])
        np.testing.assert_allclose(pv, [3.0, 8.0])

        bad = env.pytensor_ops.FederatedArraysToArraysOp(
            lambda a: [a, a, a], [env.TensorType("float64", (2,))]
        )
        out = bad(a)
        with pytest.raises(ValueError, match="outputs"):
            env.eval_graph([out], {a: np.zeros(2)})

    def test_distinct_instances_never_equal(self, env):
        """No __props__: two ops over different fns must not compare
        equal (merge-optimizer safety)."""
        mk = env.pytensor_ops.FederatedLogpOp
        assert mk(lambda x: x) != mk(lambda x: x)


# ---------------------------------------------------------------------------
# pytorch_funcify dispatch
# ---------------------------------------------------------------------------


class TestTorchDispatch:
    def test_member_dispatch_matches_perform(self, env):
        op = env.pytensor_ops.FederatedLogpGradOp(_quad_logp_grad(1.0), torch_fn=_torch_quad(1.0))
        x = env.TensorType("float64", (3,))()
        logp, g = op(x)
        fn = env.compile_graph_to_torch([logp, g], [x], env.pytorch_funcify)
        xv = np.array([0.0, 1.0, 3.0])
        lv, gv = fn(torch.as_tensor(xv))
        pl, pg = env.eval_graph([logp, g], {x: xv})
        np.testing.assert_allclose(lv.numpy(), pl)
        np.testing.assert_allclose(gv.numpy(), pg)

    def test_missing_torch_fn_is_loud(self, env):
        op = env.pytensor_ops.FederatedLogpOp(lambda x: np.asarray(0.0))
        with pytest.raises(NotImplementedError, match="FederatedLogpOp"):
            env.pytorch_funcify(op)

    def test_differentiable_end_to_end(self, env):
        """The compiled graph is ordinary torch: autograd runs through the
        op's ``torch_fn`` (the JAX case jits it)."""
        op = env.pytensor_ops.FederatedLogpOp(
            lambda x: np.asarray(-np.sum(x**2)), torch_fn=lambda x: -torch.sum(x**2)
        )
        x = env.TensorType("float64", (3,))()
        fn = env.compile_graph_to_torch([op(x)], [x], env.pytorch_funcify)
        xv = torch.tensor([1.0, 2.0, 3.0], requires_grad=True)
        (lv,) = fn(xv)
        assert float(lv.detach()) == -14.0
        (g,) = torch.autograd.grad(lv, xv)
        np.testing.assert_allclose(g.numpy(), [-2.0, -4.0, -6.0])


# ---------------------------------------------------------------------------
# The fusion rewrite, end-to-end on a FunctionGraph
# ---------------------------------------------------------------------------


def _build_two_member_graph(env, delay=0.0):
    """Two INDEPENDENT federated applies + a downstream consumer
    combining their logps."""

    def slow(target):
        base = _quad_logp_grad(target)

        def fn(*inputs):
            if delay:
                time.sleep(delay)
            return base(*inputs)

        return fn

    opA = env.pytensor_ops.FederatedLogpGradOp(slow(0.0))
    opB = env.pytensor_ops.FederatedLogpGradOp(slow(1.0))
    x = env.TensorType("float64", (2,))()
    y = env.TensorType("float64", (2,))()
    logpA, gA = opA(x)
    logpB, gB = opB(y)
    fg = env.FunctionGraph([x, y], [logpA + logpB, gA, gB])
    return fg, (x, y)


def _fused_nodes(env, fg):
    return [n for n in fg.toposort() if isinstance(n.op, env.fusion.ParallelFederatedOp)]


class TestFusionRewrite:
    def test_rewrite_fuses_independent_applies(self, env):
        fg, (x, y) = _build_two_member_graph(env)
        xv, yv = np.array([1.0, 2.0]), np.array([3.0, 4.0])
        before = env.eval_graph(fg.outputs, {x: xv, y: yv})

        env.fusion.FederatedFusionRewriter().rewrite(fg)

        fused = _fused_nodes(env, fg)
        assert len(fused) == 1, "expected exactly one fused apply"
        assert len(fused[0].op.members) == 2
        leftovers = [n for n in fg.toposort()
                     if isinstance(n.op, env.pytensor_ops.FederatedLogpGradOp)]
        assert not leftovers
        after = env.eval_graph(fg.outputs, {x: xv, y: yv})
        for b, a in zip(before, after):
            np.testing.assert_allclose(a, b)

    def test_rewrite_leaves_dependent_chain_alone(self, env):
        """B consumes A's output: fusing would cycle — the grouping must
        keep them separate applies."""
        opA = env.pytensor_ops.FederatedLogpGradOp(_quad_logp_grad(0.0))
        opB = env.pytensor_ops.FederatedLogpGradOp(_quad_logp_grad(1.0))
        x = env.TensorType("float64", (2,))()
        logpA, gA = opA(x)
        logpB, gB = opB(gA)  # dependent!
        fg = env.FunctionGraph([x], [logpB])
        env.fusion.FederatedFusionRewriter().rewrite(fg)
        assert not _fused_nodes(env, fg)
        xv = np.array([0.5, -0.5])
        (lv,) = env.eval_graph([fg.outputs[0]], {x: xv})
        gAv = -2.0 * xv
        np.testing.assert_allclose(lv, -np.sum((gAv - 1.0) ** 2))

    def test_fused_wallclock_is_max_not_sum(self, env):
        """Two 0.35 s members through the fused perform take ~0.35 s,
        not ~0.7 s."""
        fg, (x, y) = _build_two_member_graph(env, delay=0.35)
        env.fusion.FederatedFusionRewriter().rewrite(fg)
        xv, yv = np.zeros(2), np.zeros(2)
        env.eval_graph(fg.outputs, {x: xv, y: yv})  # warm the pool
        t0 = time.perf_counter()
        env.eval_graph(fg.outputs, {x: xv, y: yv})
        wall = time.perf_counter() - t0
        assert wall < 0.6, f"members ran sequentially: {wall:.3f}s"

    def test_replace_requires_validate_feature(self, env):
        """add_requirements is load-bearing: replacement without the
        ReplaceValidate feature must refuse."""
        fg, _ = _build_two_member_graph(env)
        with pytest.raises(RuntimeError, match="ReplaceValidate"):
            env.fusion.FederatedFusionRewriter().apply(fg)  # no add_requirements first

    def test_fused_torch_path_matches_perform(self, env):
        opA = env.pytensor_ops.FederatedLogpGradOp(_quad_logp_grad(0.0), torch_fn=_torch_quad(0.0))
        opB = env.pytensor_ops.FederatedLogpGradOp(_quad_logp_grad(1.0), torch_fn=_torch_quad(1.0))
        x = env.TensorType("float64", (2,))()
        y = env.TensorType("float64", (2,))()
        logpA, gA = opA(x)
        logpB, gB = opB(y)
        fg = env.FunctionGraph([x, y], [logpA + logpB, gA, gB])
        env.fusion.FederatedFusionRewriter().rewrite(fg)
        xv, yv = np.array([1.0, 2.0]), np.array([3.0, 4.0])
        perform_vals = env.eval_graph(fg.outputs, {x: xv, y: yv})
        fn = env.compile_graph_to_torch(fg.outputs, [x, y], env.pytorch_funcify)
        torch_vals = fn(torch.as_tensor(xv), torch.as_tensor(yv))
        for p, t in zip(perform_vals, torch_vals):
            np.testing.assert_allclose(t.numpy(), p)

    def test_fused_pickle_roundtrip(self, env):
        """__getstate__ drops the member templates and executor pool;
        both rebuild lazily on the unpickled op.  Members wrap
        module-level compute fns (closures do not pickle)."""
        opA = env.pytensor_ops.FederatedLogpGradOp(_quad_at_zero)
        opB = env.pytensor_ops.FederatedLogpGradOp(_quad_at_one)
        x = env.TensorType("float64", (2,))()
        y = env.TensorType("float64", (2,))()
        logpA, gA = opA(x)
        logpB, gB = opB(y)
        fg = env.FunctionGraph([x, y], [logpA + logpB, gA, gB])
        env.fusion.FederatedFusionRewriter().rewrite(fg)
        (fused_node,) = _fused_nodes(env, fg)
        op2 = pickle.loads(pickle.dumps(fused_node.op))
        assert not hasattr(op2, "_member_nodes")
        assert not hasattr(op2, "_pool")
        x2 = env.TensorType("float64", (2,))()
        y2 = env.TensorType("float64", (2,))()
        outs = op2(x2, y2)
        xv, yv = np.array([1.0, 2.0]), np.array([3.0, 4.0])
        vals = env.eval_graph(outs, {x2: xv, y2: yv})
        np.testing.assert_allclose(vals[0], -np.sum(xv**2))
        np.testing.assert_allclose(vals[2], -np.sum((yv - 1.0) ** 2))

    def test_fused_input_arity_check(self, env):
        op = env.fusion.ParallelFederatedOp(
            [env.pytensor_ops.FederatedLogpOp(lambda x: np.asarray(0.0))], [1], [1]
        )
        a = env.TensorType("float64", (2,))()
        b = env.TensorType("float64", (2,))()
        with pytest.raises(ValueError, match="inputs"):
            op.make_node(a, b)

    def test_optdb_registration_slot(self, env):
        """Importing fusion registers the rewrite: fast_run tag, position
        90, once."""
        assert "federated_parallel_fusion" in env.optdb
        rec = env.optdb.query("federated_parallel_fusion")
        assert "fast_run" in rec["tags"]
        assert rec["position"] == 90
        assert isinstance(rec["obj"], env.fusion.FederatedFusionRewriter)
        # The module's guard keeps a second import from registering again.
        import importlib

        importlib.reload(env.fusion)
        assert env.optdb.query("federated_parallel_fusion")["obj"] is rec["obj"]

    def test_fused_fed_potentials_compose_one_program(self, env):
        """Two ``fed.FederatedLogpGrad`` potentials on one mesh (each with
        its own ``MeshPlacement``) rewritten into one ``ParallelFederatedOp``:
        its PyTorch lane composes them into ONE ``fed.program`` and gives
        the perform lane's values and gradients."""
        from pytensor_federated_torch import fed
        from pytensor_federated_torch.parallel import make_mesh

        rng = np.random.default_rng(0)
        mesh = make_mesh({"shards": 2}, devices=["cpu"] * 2)
        per_shard = lambda p, d: -torch.sum((d[1] - p[0] - p[1] * d[0]) ** 2)
        evs = [fed.FederatedLogpGrad(per_shard, tuple(rng.normal(size=(4, 5)).astype(np.float32)
                                                      for _ in range(2)),
                                     placement=fed.MeshPlacement(mesh), device="cpu")
               for _ in range(2)]
        x = env.TensorType("float32", (2,))()
        y = env.TensorType("float32", (2,))()
        outs = [*env.pytensor_ops.federated_potential(evs[0], x).owner.outputs,
                *env.pytensor_ops.federated_potential(evs[1], y).owner.outputs]
        fg = env.FunctionGraph([x, y], outs)
        env.fusion.FederatedFusionRewriter().rewrite(fg)
        (fused,) = _fused_nodes(env, fg)
        composed = env.pytorch_funcify(fused.op)
        assert composed.__qualname__.startswith("_fused_fed_callable")
        xv, yv = np.float32([0.3, -0.2]), np.float32([1.0, 0.5])
        perform_vals = env.eval_graph(fg.outputs, {x: xv, y: yv})
        fn = env.compile_graph_to_torch(fg.outputs, [x, y], env.pytorch_funcify)
        torch_vals = fn(torch.as_tensor(xv), torch.as_tensor(yv))
        for p, t in zip(perform_vals, torch_vals):
            np.testing.assert_allclose(t.detach().numpy(), p, rtol=1e-6)


def test_the_same_graph_under_both_fakes():
    """The same two-member graph, rewritten and evaluated by the JAX
    package's glue under its fake and by the port's under its own (one
    after the other): the same fused shape and the same numbers on both
    lanes (perform; the JAX linker's and the PyTorch linker's)."""
    import jax.numpy as jnp
    from pytensor_shim import bridge_under_shim

    xv, yv = np.array([1.0, 2.0]), np.array([3.0, 4.0])

    def run(ns, linker, to_backend, member_fn):
        opA = ns.pytensor_ops.FederatedLogpGradOp(_quad_at_zero, **{linker: member_fn(0.0)})
        opB = ns.pytensor_ops.FederatedLogpGradOp(_quad_at_one, **{linker: member_fn(1.0)})
        x = ns.TensorType("float64", (2,))()
        y = ns.TensorType("float64", (2,))()
        logpA, gA = opA(x)
        logpB, gB = opB(y)
        fg = ns.FunctionGraph([x, y], [logpA + logpB, gA, gB])
        ns.fusion.FederatedFusionRewriter().rewrite(fg)
        fused = [n for n in fg.toposort() if isinstance(n.op, ns.fusion.ParallelFederatedOp)]
        perform_vals = ns.eval_graph(fg.outputs, {x: xv, y: yv})
        compile_ = getattr(ns, "compile_graph_to_torch", None) or ns.compile_graph_to_jax
        registry = getattr(ns, "pytorch_funcify", None) or ns.jax_funcify
        compiled = compile_(fg.outputs, [x, y], registry)(to_backend(xv), to_backend(yv))
        return ([len(n.op.members) for n in fused], perform_vals,
                [np.asarray(v.numpy() if torch.is_tensor(v) else v) for v in compiled])

    def jax_member(t):
        return lambda x: (-jnp.sum((x - t) ** 2), [-2.0 * (x - t)])

    with bridge_under_shim() as jns:
        jax_run = run(jns, "jax_fn", jnp.asarray, jax_member)
    with bridge_under_torch_shim() as tns:
        torch_run = run(tns, "torch_fn", torch.as_tensor, _torch_quad)
    assert jax_run[0] == torch_run[0] == [2]
    for a, b in zip(jax_run[1], torch_run[1]):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(jax_run[2], torch_run[2]):
        np.testing.assert_allclose(a, b, rtol=1e-6)

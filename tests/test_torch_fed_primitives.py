"""The port's ``fed`` primitives (``pytensor_federated_torch/fed/``)
against the JAX package, on the same numpy inputs.

The JAX package's own ``fed_map`` cannot be traced under every JAX
version (``fed/primitives.py`` calls
``jax.interpreters.partial_eval.convert_constvars_jaxpr``, which JAX
0.9.0 removed), so these tests hold the port against what the JAX
package's tests hold its primitives against: ``jax.vmap``, a plain sum
and ``jax.value_and_grad`` of the same per-shard function
(``tests/test_fed_primitives.py``'s ``_reference``), and the plain
unsharded sum of ``tests/test_fed_properties.py``.  Tolerances are the
JAX tests' in float32 (rtol 1e-5 on values, 1e-4 on gradients) and
1e-12 in float64 (JAX under x64).  The window-fusion plan is held to
the JAX package's pure grouping algorithm on random graphs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from pytensor_federated_tpu.bridge import grouping as jgrouping
from pytensor_federated_torch import fed
from pytensor_federated_torch.bridge import grouping as tgrouping
from pytensor_federated_torch.fed.lowering import _record
from pytensor_federated_torch.parallel import make_mesh

N = 8
RTOL, GTOL, RTOL64 = 1e-5, 1e-4, 1e-12
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """The port's side on one intra-op thread: its calls are small ops,
    where threads add only their synchronisation on a loaded host."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def shard_xy():
    rng = np.random.default_rng(7)
    x = rng.normal(size=(N, 16)).astype(np.float32)
    y = (0.5 + 1.5 * x + 0.1 * rng.normal(size=(N, 16))).astype(np.float32)
    return x, y


@pytest.fixture(scope="module")
def params():
    return np.float32([0.3, -0.7, 0.2])


def _shard_logp(p, xs, ys):
    pred = p[0] + p[1] * xs + p[2] * xs**2
    return -(ys - pred).pow(2).sum() if isinstance(xs, torch.Tensor) else -jnp.sum((ys - pred) ** 2)


def _model(p, x, y):
    pb = fed.fed_broadcast(p, N)
    lps = fed.fed_map(lambda s: _shard_logp(s[0], s[1], s[2]), (pb, x, y))
    return fed.fed_sum(lps)


def _reference(p, x, y):
    """The JAX test's reference: a plain sum over shards, in JAX."""
    return sum(_shard_logp(p, x[i], y[i]) for i in range(N))


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.asarray(a)).to(dtype)


def _torch_value_and_grad(fn, *args):
    leaves = [a.detach().clone().requires_grad_(True) for a in args]
    value = fn(*leaves)
    return value.detach(), torch.autograd.grad(value, leaves)


class TestDenseSemantics:
    def test_map_matches_vmap(self, shard_xy):
        x, y = shard_xy
        out = fed.fed_map(lambda s: torch.sum(s[0] * s[1]), (_t(x), _t(y)))
        want = jax.vmap(lambda a, b: jnp.sum(a * b))(jnp.asarray(x), jnp.asarray(y))
        np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=1e-6)

    def test_sum_broadcast_roundtrip(self):
        v = _t([[1.0, 2.0], [3.0, 4.0]])
        np.testing.assert_allclose(fed.fed_sum(v).numpy(), [4.0, 6.0])
        b = fed.fed_broadcast(torch.tensor(2.0), 4)
        assert b.shape == (4,)
        assert float(fed.fed_sum(b)) == 8.0
        with pytest.raises(ValueError, match="n_shards must be >= 1"):
            fed.fed_broadcast(torch.tensor(2.0), 0)
        with pytest.raises(ValueError, match="leading shards axis"):
            fed.fed_sum(torch.tensor(1.0))

    def test_mean_weighted_and_validated(self):
        vals = _t([[1.0], [3.0]])
        np.testing.assert_allclose(fed.fed_mean(vals).numpy(), [2.0])
        np.testing.assert_allclose(fed.fed_mean(vals, _t([3.0, 1.0])).numpy(), [1.5])
        # A length-1 weights vector broadcasts but weights the WRONG axis.
        with pytest.raises(ValueError, match="one weight per shard"):
            fed.fed_mean(vals, torch.ones(1))
        with pytest.raises(ValueError, match="one weight per shard"):
            fed.fed_mean(vals, torch.ones(2, 1))

    def test_errors_match_the_jax_package(self):
        with pytest.raises(ValueError, match="fed_map data pytree has no leaves"):
            fed.fed_map(lambda s: s, ())
        with pytest.raises(ValueError, match="share a leading shard axis"):
            fed.fed_map(lambda s: s[0].sum(), (torch.zeros(2, 3), torch.zeros(3, 3)))

    def test_model_and_chain_batch_match_jax(self, shard_xy, params):
        """The model, and a batch of chains under ``torch.func.vmap`` (the
        samplers' lockstep batch), against ``jax.vmap`` of the plain sum."""
        x, y = shard_xy
        got = _model(_t(params), _t(x), _t(y))
        want = _reference(jnp.asarray(params), jnp.asarray(x), jnp.asarray(y))
        np.testing.assert_allclose(float(got), float(want), rtol=RTOL)
        batch = np.stack([params, params + 0.1, params - 0.2])
        got = torch.func.vmap(lambda p: _model(p, _t(x), _t(y)))(_t(batch))
        want = jax.vmap(lambda p: _reference(p, jnp.asarray(x), jnp.asarray(y)))(
            jnp.asarray(batch))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL)

    def test_float64_value_and_grad_match_jax(self, shard_xy, params):
        x, y = (a.astype(np.float64) for a in shard_xy)
        p = params.astype(np.float64)
        v, (g,) = _torch_value_and_grad(
            lambda q: _model(q, _t(x, torch.float64), _t(y, torch.float64)),
            _t(p, torch.float64))
        with jax.enable_x64(True):
            jv, jg = jax.value_and_grad(
                lambda q: _reference(q, jnp.asarray(x), jnp.asarray(y)))(jnp.asarray(p))
            jv, jg = float(jv), np.asarray(jg)
        np.testing.assert_allclose(float(v), jv, rtol=RTOL64)
        np.testing.assert_allclose(g.numpy(), jg, rtol=RTOL64)


class TestAutodiffIdentities:
    def test_adjoint_of_broadcast_is_sum(self):
        v = torch.zeros(3, requires_grad=True)
        (ct,) = torch.autograd.grad(fed.fed_broadcast(v, 4), v, torch.ones(4, 3))
        (jct,) = jax.linear_transpose(lambda a: jnp.broadcast_to(a, (4, 3)),
                                      jnp.zeros((3,), jnp.float32))(jnp.ones((4, 3), jnp.float32))
        np.testing.assert_array_equal(ct.numpy(), np.asarray(jct))
        np.testing.assert_array_equal(ct.numpy(), np.full((3,), 4.0))

    def test_adjoint_of_sum_is_broadcast(self):
        v = torch.zeros(4, 3, requires_grad=True)
        (ct,) = torch.autograd.grad(fed.fed_sum(v), v, torch.ones(3))
        np.testing.assert_array_equal(ct.numpy(), np.ones((4, 3)))

    def test_grad_matches_unsharded(self, shard_xy, params):
        x, y = shard_xy
        _, (g,) = _torch_value_and_grad(lambda p: _model(p, _t(x), _t(y)), _t(params))
        jg = jax.grad(_reference)(jnp.asarray(params), jnp.asarray(x), jnp.asarray(y))
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=GTOL)

    def test_grad_through_closure_consts(self, shard_xy, params):
        """Replicated params captured by CLOSURE: their gradient is the
        sum of the shards' cotangents."""
        x, y = shard_xy

        def model(p):
            return fed.fed_sum(fed.fed_map(lambda s: _shard_logp(p, s[0], s[1]), (_t(x), _t(y))))

        _, (g,) = _torch_value_and_grad(model, _t(params))
        jg = jax.grad(_reference)(jnp.asarray(params), jnp.asarray(x), jnp.asarray(y))
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=GTOL)

    def test_grad_wrt_mapped_data(self, shard_xy, params):
        x, y = shard_xy
        _, (gx,) = _torch_value_and_grad(lambda xx: _model(_t(params), xx, _t(y)), _t(x))
        jgx = jax.grad(lambda xx: _reference(jnp.asarray(params), xx, jnp.asarray(y)))(
            jnp.asarray(x))
        np.testing.assert_allclose(gx.numpy(), np.asarray(jgx), rtol=GTOL)

    def test_jvp_and_torch_func_grad(self, shard_xy, params):
        x, y = shard_xy
        f = lambda p: _model(p, _t(x), _t(y))
        _, d = torch.func.jvp(f, (_t(params),), (torch.ones(3),))
        _, jd = jax.jvp(lambda p: _reference(p, jnp.asarray(x), jnp.asarray(y)),
                        (jnp.asarray(params),), (jnp.ones(3, jnp.float32),))
        np.testing.assert_allclose(float(d), float(jd), rtol=GTOL)
        g = torch.func.grad(f)(_t(params))
        jg = jax.grad(_reference)(jnp.asarray(params), jnp.asarray(x), jnp.asarray(y))
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=GTOL)

    def test_second_order(self, shard_xy, params):
        x, y = shard_xy
        h = torch.func.hessian(lambda p: _model(p, _t(x), _t(y)))(_t(params))
        jh = jax.hessian(lambda p: _reference(p, jnp.asarray(x), jnp.asarray(y)))(
            jnp.asarray(params))
        np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=1e-3, atol=1e-2)

    def test_int_data_leaves(self, params):
        """Integer mapped leaves (count data) take no gradient and break
        nothing."""
        counts = np.random.default_rng(0).poisson(3.0, size=(N, 16)).astype(np.int32)

        def model(p):
            lps = fed.fed_map(
                lambda s: torch.sum(s[0] * p[0] - torch.exp(p[0]) - 0.0 * p[1] * p[2]),
                (torch.as_tensor(counts),),
            )
            return fed.fed_sum(lps)

        def ref(p):
            return jnp.sum(jnp.asarray(counts) * p[0] - jnp.exp(p[0]))

        v, (g,) = _torch_value_and_grad(model, _t(params))
        np.testing.assert_allclose(float(v), float(ref(jnp.asarray(params))), rtol=RTOL)
        np.testing.assert_allclose(g.numpy(), np.asarray(jax.grad(ref)(jnp.asarray(params))),
                                   rtol=GTOL, atol=1e-6)


class TestMeshPlacement:
    def test_forward_and_grad_match_dense(self, shard_xy, params):
        x, y = shard_xy
        mesh = make_mesh({"shards": 8}, devices=[CPU] * 8)
        run = fed.program(lambda p: _model(p, _t(x), _t(y)), fed.MeshPlacement(mesh))
        v, (g,) = _torch_value_and_grad(run, _t(params))
        jv, jg = jax.value_and_grad(_reference)(
            jnp.asarray(params), jnp.asarray(x), jnp.asarray(y))
        np.testing.assert_allclose(float(v), float(jv), rtol=RTOL)
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=GTOL)

    def test_grad_inside_a_slot_stays_the_slots(self, shard_xy, params):
        """Params reach the shard body as closure values and the body
        takes a gradient of its own: each shard's stays its own (the JAX
        package's ``mark_varying`` invariant)."""
        x, y = shard_xy
        mesh = make_mesh({"shards": 8}, devices=[CPU] * 8)

        def model(p):
            def local_step(s):
                g = torch.func.grad(_shard_logp)(p, s[0], s[1])
                return torch.sum(g**2)

            return fed.fed_sum(fed.fed_map(local_step, (_t(x), _t(y))))

        def ref(p):
            g = jax.vmap(jax.grad(_shard_logp), in_axes=(None, 0, 0))(
                p, jnp.asarray(x), jnp.asarray(y))
            return jnp.sum(g**2)

        run = fed.program(model, fed.MeshPlacement(mesh))
        np.testing.assert_allclose(float(run(_t(params))), float(ref(jnp.asarray(params))),
                                   rtol=2e-4)

    def test_errors_match_the_jax_package(self, shard_xy, params):
        x, y = shard_xy
        mesh = make_mesh({"shards": 3}, devices=[CPU] * 3)
        with pytest.raises(ValueError, match="mesh has no axis 'seq'"):
            fed.MeshPlacement(mesh, axis="seq")
        run = fed.program(lambda p: _model(p, _t(x), _t(y)), fed.MeshPlacement(mesh))
        with pytest.raises(ValueError, match="n_shards=8 not divisible by mesh axis 'shards'"):
            run(_t(params))


def _graph(model, *args):
    rec, _ = _record(model, args, [torch.as_tensor(a) for a in args])
    return rec.graph


class TestBatchingPlan:
    def test_independent_maps_group(self, shard_xy, params):
        x, y = (_t(a) for a in shard_xy)

        def model(p):
            pb = fed.fed_broadcast(p, N)
            a = fed.fed_sum(fed.fed_map(lambda s: _shard_logp(*s), (pb, x, y)))
            b = fed.fed_sum(fed.fed_map(lambda s: _shard_logp(*s), (pb, x + 1, y)))
            return a + b

        plan = fed.plan_windows(_graph(model, _t(params)))
        groups = {tuple(g) for g in plan.values()}
        assert len(groups) == 1
        (group,) = groups
        assert len(group) == 2
        assert all(n.target is fed.fed_map_p for n in group)

    def test_dependent_maps_do_not_group(self, shard_xy, params):
        x, y = (_t(a) for a in shard_xy)

        def model(p):
            pb = fed.fed_broadcast(p, N)
            a = fed.fed_map(lambda s: _shard_logp(*s), (pb, x, y))
            # The second map CONSUMES the first's output: dependent.
            b = fed.fed_map(lambda s: s[0] * 2.0, (a,))
            return fed.fed_sum(b)

        assert fed.plan_windows(_graph(model, _t(params))) == {}


def test_program_without_placement_is_identity(shard_xy, params):
    x, y = shard_xy
    fn = lambda p: _model(p, _t(x), _t(y))
    assert fed.program(fn, None) is fn


@settings(max_examples=40, deadline=None)
@given(st.integers(2, 14), st.floats(0.05, 0.6), st.floats(0.2, 0.9),
       st.integers(0, 2**31 - 1))
def test_group_independent_matches_the_jax_packages(n, p_edge, p_cand, seed):
    """The port's copy of ``bridge/grouping.py`` groups a random DAG's
    candidates exactly as the JAX package's does."""
    rng = np.random.default_rng(seed)
    parents = {i: [j for j in range(i) if rng.random() < p_edge] for i in range(n)}
    cands = {i for i in range(n) if rng.random() < p_cand}
    args = (range(n), parents.__getitem__, cands.__contains__)
    assert tgrouping.group_independent(*args) == jgrouping.group_independent(*args)


# -- the oracle of tests/test_fed_properties.py ------------------------------

_PROP = settings(max_examples=6, deadline=None)
_dims = st.integers(min_value=1, max_value=4)
_param_shapes = st.lists(st.lists(_dims, min_size=0, max_size=2).map(tuple),
                         min_size=1, max_size=2)
_data_shapes = st.lists(st.lists(_dims, min_size=1, max_size=2).map(tuple),
                        min_size=1, max_size=3)


def _make_case(seed, param_shapes, data_shapes):
    rng = np.random.default_rng(seed)
    params = tuple(rng.normal(size=s).astype(np.float32) for s in param_shapes)
    data = {f"d{i}": rng.normal(size=(N,) + s).astype(np.float32)
            for i, s in enumerate(data_shapes)}
    return params, data


def _per_shard(params, shard, lib):
    acc, scale = 0.0, 1.0
    for p in params:
        scale = scale + lib.sum(lib.tanh(p))
    for k in sorted(shard):
        leaf = shard[k]
        acc = acc + lib.sum(lib.sin(leaf) * scale + 0.1 * leaf**2)
    return acc


def _unsharded(params, data, lib):
    return sum(_per_shard(params, {k: v[i] for k, v in data.items()}, lib) for i in range(N))


def _references(params, data):
    """Value and gradients of the plain unsharded sum, in torch and in
    JAX (the oracle the JAX package's property test uses)."""
    tparams = [_t(p) for p in params]
    tdata = {k: _t(a) for k, a in data.items()}
    v_ref, g_ref = _torch_value_and_grad(lambda *ps: _unsharded(ps, tdata, torch), *tparams)
    jdata = {k: jnp.asarray(a) for k, a in data.items()}
    jv, jg = jax.value_and_grad(lambda *ps: _unsharded(ps, jdata, jnp),
                                argnums=tuple(range(len(params))))(*map(jnp.asarray, params))
    return [(float(v_ref), [a.numpy() for a in g_ref]), (float(jv), [np.asarray(a) for a in jg])]


def _assert_matches_unsharded(run, params, refs):
    v, g = _torch_value_and_grad(run, *[_t(p) for p in params])
    for want_v, want_g in refs:
        np.testing.assert_allclose(float(v), want_v, rtol=2e-4, atol=1e-4)
        for a, b in zip(g, want_g):
            np.testing.assert_allclose(a.numpy(), b, rtol=2e-4, atol=1e-4)


def _forms(data):
    tdata = {k: _t(a) for k, a in data.items()}

    def broadcast_form(*ps):
        pb = fed.fed_broadcast(tuple(ps), N)
        return fed.fed_sum(fed.fed_map(lambda s: _per_shard(s[0], s[1], torch), (pb, tdata)))

    def closure_form(*ps):
        return fed.fed_sum(fed.fed_map(lambda s: _per_shard(ps, s, torch), tdata))

    return broadcast_form, closure_form


@_PROP
@given(seed=st.integers(min_value=0, max_value=2**31 - 1),
       param_shapes=_param_shapes, data_shapes=_data_shapes)
def test_grad_map_sum_matches_unsharded_single_device(seed, param_shapes, data_shapes):
    params, data = _make_case(seed, param_shapes, data_shapes)
    refs = _references(params, data)
    for form in _forms(data):
        _assert_matches_unsharded(form, params, refs)


@_PROP
@given(seed=st.integers(min_value=0, max_value=2**31 - 1),
       param_shapes=_param_shapes, data_shapes=_data_shapes)
def test_grad_map_sum_matches_unsharded_mesh8(seed, param_shapes, data_shapes):
    params, data = _make_case(seed, param_shapes, data_shapes)
    placement = fed.MeshPlacement(make_mesh({"shards": 8}, devices=[CPU] * 8))
    refs = _references(params, data)
    for form in _forms(data):
        _assert_matches_unsharded(fed.program(form, placement), params, refs)

"""The port's tensor-parallel logistic (``parallel/tensor.py``) and
expert-parallel mixture (``parallel/expert.py``) against the JAX
package's, on the same numpy inputs and parameters.

The port runs on CPU meshes (``[cpu] * n``), the JAX package on its own
CPU meshes over ``tests/conftest.py``'s ``devices8``.  Float64 (JAX
under x64; the JAX modules hold the data in float32, which float64
represents exactly): rtol 1e-12 on values and gradients.  Float32: the
JAX tests' tolerances (``tests/test_tensor_expert_parallel.py``: value
rtol 2e-5, gradient rtol 1e-4 / atol 1e-5).
"""

import jax
import numpy as np
import pytest
import torch

from pytensor_federated_tpu.parallel import expert as jexpert
from pytensor_federated_tpu.parallel import tensor as jtensor
from pytensor_federated_tpu.parallel.mesh import make_mesh as jmake_mesh
from pytensor_federated_torch.parallel import (
    EXPERTS_AXIS,
    TP_AXIS,
    ExpertShardedMixture,
    TensorParallelLogistic,
    make_mesh,
)
from pytensor_federated_torch.parallel.expert import generate_expert_mixture_data
from pytensor_federated_torch.parallel.tensor import generate_wide_logistic_data

RTOL64 = 1e-12
CPU = torch.device("cpu")
TOL32 = dict(value=2e-5, grad_rtol=1e-4, grad_atol=1e-5)


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """The port's side on one intra-op thread.  Its steps are a few small
    ops per slot, where threads add only their synchronisation: a
    ``find_map`` step took ~0.25 s on a loaded 8-core CPU host against
    ~3 ms on one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _mesh(shape):
    return make_mesh(shape, devices=[CPU] * int(np.prod(list(shape.values()))))


def _flat(x):
    """A parameter (a tensor or a tuple of per-slot blocks) as one numpy
    vector."""
    if isinstance(x, (tuple, list)):
        return np.concatenate([b.detach().numpy().reshape(-1) for b in x])
    return x.detach().numpy()


def _blocks(a, n, dtype):
    a = np.asarray(a)
    per = a.shape[0] // n
    return tuple(torch.as_tensor(a[j * per:(j + 1) * per], dtype=dtype) for j in range(n))


def _check(got, want, dtype):
    if dtype == torch.float64:
        np.testing.assert_allclose(got, want, rtol=RTOL64,
                                   atol=RTOL64 * float(np.max(np.abs(want))))
    else:
        np.testing.assert_allclose(got, want, rtol=TOL32["grad_rtol"], atol=TOL32["grad_atol"])


def _check_value(got, want, dtype):
    np.testing.assert_allclose(float(got), float(want),
                               rtol=RTOL64 if dtype == torch.float64 else TOL32["value"])


def test_generators_give_the_jax_packages_bytes():
    for args in ((128, 64), (33, 16)):
        for a, b in zip(generate_wide_logistic_data(*args, seed=5),
                        jtensor.generate_wide_logistic_data(*args, seed=5)):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    y, truth = generate_expert_mixture_data(256, seed=29)
    jy, jtruth = jexpert.generate_expert_mixture_data(256, seed=29)
    assert y.tobytes() == jy.tobytes() and y.dtype == jy.dtype
    assert all(np.array_equal(truth[k], jtruth[k]) for k in truth)


# ---- tensor parallelism -----------------------------------------------------


def _tp_jax(X, y, mesh, x64, rows_axis=None):
    with jax.enable_x64(x64):
        tp = jtensor.TensorParallelLogistic(X, y, mesh=mesh, rows_axis=rows_axis)
        ref = jtensor.TensorParallelLogistic(X, y)
        out = []
        for shift in (0.0, 0.25):
            for model in (tp, ref):
                p = jax.tree_util.tree_map(lambda a: a + shift, model.init_params())
                v, g = model.logp_and_grad(p)
                out.append((float(v), np.asarray(g["w"]), float(g["b"])))
        return out


def _tp_torch(X, y, mesh, dtype, rows_axis=None):
    tp = TensorParallelLogistic(X, y, mesh=mesh, rows_axis=rows_axis, dtype=dtype)
    ref = TensorParallelLogistic(X, y, device="cpu", dtype=dtype)
    out = []
    for shift in (0.0, 0.25):
        for model in (tp, ref):
            p = model.init_params()
            p = {"w": (tuple(b + shift for b in p["w"]) if isinstance(p["w"], tuple)
                       else p["w"] + shift), "b": p["b"] + shift}
            v, g = model.logp_and_grad(p)
            out.append((float(v), _flat(g["w"]), float(g["b"])))
    return out


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["float64", "float32"])
@pytest.mark.parametrize("layout", ["tp8", "rows2_tp4"])
def test_tp_matches_jax(devices8, dtype, layout):
    """Sharded and unsharded values and gradients at two points, against
    the JAX package's on the same layout."""
    X, y, _ = generate_wide_logistic_data(128, 64, seed=3)
    if layout == "tp8":
        shape, rows_axis = {"tp": 8}, None
    else:
        shape, rows_axis = {"shards": 2, "tp": 4}, "shards"
    got = _tp_torch(X, y, _mesh(shape), dtype, rows_axis)
    want = _tp_jax(X, y, jmake_mesh(shape, devices=devices8), dtype == torch.float64, rows_axis)
    for (v, gw, gb), (jv, jgw, jgb) in zip(got, want):
        _check_value(v, jv, dtype)
        _check(gw, jgw, dtype)
        _check(np.array([gb]), np.array([jgb]), dtype)


@pytest.mark.parametrize("n,d", [(8, 8), (33, 16), (5, 48)])
def test_tp_equality_across_shapes(devices8, n, d):
    """The JAX property sweep's shapes, float64 against the JAX mesh."""
    X, y, _ = generate_wide_logistic_data(n, d, seed=n * d)
    got = _tp_torch(X, y, _mesh({"tp": 8}), torch.float64)
    want = _tp_jax(X, y, jmake_mesh({"tp": 8}, devices=devices8), True)
    for (v, gw, _), (jv, jgw, _) in zip(got, want):
        _check_value(v, jv, torch.float64)
        _check(gw, jgw, torch.float64)


def test_tp_stays_per_slot():
    """X's column block j and w's block j (and its gradient) belong to
    slot j: 8 blocks of d/8, each on its slot's device; on a 2-D mesh X
    is tiled over both axes."""
    mesh = _mesh({TP_AXIS: 8})
    X, y, _ = generate_wide_logistic_data(64, 64)
    tp = TensorParallelLogistic(X, y, mesh=mesh)
    assert tp.X.shape == (1, 8) and tp.tile_shape == (64, 8)
    p = tp.init_params()
    assert len(p["w"]) == 8 and all(b.shape == (8,) for b in p["w"])
    _, g = tp.logp_and_grad(p)
    assert isinstance(g["w"], tuple) and len(g["w"]) == 8
    assert [b.device for b in g["w"]] == mesh.slot_devices(TP_AXIS)
    tp2 = TensorParallelLogistic(X, y, mesh=_mesh({"shards": 2, "tp": 4}), rows_axis="shards")
    assert tp2.X.shape == (2, 4) and tp2.tile_shape == (32, 16)
    assert len(tp2.y) == 2 and tp2.y[0].shape == (32,)


def test_tp_errors_match_jax(devices8):
    X, y, _ = generate_wide_logistic_data(32, 12)
    with pytest.raises(ValueError) as got:
        TensorParallelLogistic(X, y, mesh=_mesh({"tp": 8}))
    with pytest.raises(ValueError) as want:
        jtensor.TensorParallelLogistic(X, y, mesh=jmake_mesh({"tp": 8}, devices=devices8))
    assert str(got.value) == str(want.value) and "not divisible" in str(got.value)
    X, y, _ = generate_wide_logistic_data(33, 16)
    shape = {"shards": 2, "tp": 4}
    with pytest.raises(ValueError) as got:
        TensorParallelLogistic(X, y, mesh=_mesh(shape), rows_axis="shards")
    with pytest.raises(ValueError) as want:
        jtensor.TensorParallelLogistic(X, y, mesh=jmake_mesh(shape, devices=devices8),
                                       rows_axis="shards")
    assert str(got.value) == str(want.value)


def test_tp_find_map(devices8):
    """``find_map`` through the port's samplers on the sharded model:
    against the JAX package's at 200 steps (float32 Adam; both packages
    follow optax's update order), and the coefficients recovered (the
    JAX test's correlation gate) after 1,500."""
    X, y, w_true = generate_wide_logistic_data(2048, 16, seed=5)
    tp = TensorParallelLogistic(X, y, mesh=_mesh({"tp": 8}), prior_scale=10.0)
    jtp = jtensor.TensorParallelLogistic(X, y, mesh=jmake_mesh({"tp": 8}, devices=devices8),
                                         prior_scale=10.0)
    est = tp.find_map(num_steps=200, learning_rate=0.05)
    jest = jtp.find_map(num_steps=200, learning_rate=0.05)
    assert len(est["w"]) == 8
    np.testing.assert_allclose(_flat(est["w"]), np.asarray(jest["w"]), rtol=1e-4, atol=1e-5)
    w_est = _flat(tp.find_map(num_steps=1500, learning_rate=0.05)["w"])
    assert np.corrcoef(w_est, w_true)[0, 1] > 0.8


# ---- expert parallelism -----------------------------------------------------


def _ep_pairs(y, k, n_dev, devices8, dtype, shifts):
    """Per shift: (port sharded, port unsharded) and (JAX sharded, JAX
    unsharded) value and gradient, at the JAX sharded model's init +
    shift (the JAX evaluations jitted: one compile per model)."""
    x64 = dtype == torch.float64
    with jax.enable_x64(x64):
        jep = jexpert.ExpertShardedMixture(
            y, k, mesh=jmake_mesh({"experts": n_dev}, devices=devices8[:n_dev]))
        jref = jexpert.ExpertShardedMixture(y, k)
        fns = [jax.jit(jep.logp_and_grad), jax.jit(jref.logp_and_grad)]
        points = [jax.tree_util.tree_map(lambda a: a + s, jep.init_params()) for s in shifts]
        want = [[(float(v), {key: np.asarray(g[key]) for key in g})
                 for v, g in (fn(jp) for fn in fns)] for jp in points]
        points = [{key: np.asarray(v) for key, v in jp.items()} for jp in points]
    ep = ExpertShardedMixture(y, k, mesh=_mesh({EXPERTS_AXIS: n_dev}), dtype=dtype)
    ref = ExpertShardedMixture(y, k, device="cpu", dtype=dtype)
    got = []
    for p_np in points:
        p_sharded = {key: _blocks(v, n_dev, dtype) for key, v in p_np.items()}
        p_whole = {key: torch.as_tensor(v, dtype=dtype) for key, v in p_np.items()}
        got.append([(float(v), {key: _flat(g[key]) for key in g})
                    for v, g in (ep.logp_and_grad(p_sharded), ref.logp_and_grad(p_whole))])
    return got, want


def _check_ep(got, want, dtype):
    for pair, jpair in zip(got, want):
        for (v, g), (jv, jg) in zip(pair, jpair):
            _check_value(v, jv, dtype)
            for key in jg:
                _check(g[key], jg[key], dtype)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["float64", "float32"])
def test_ep_matches_jax(devices8, dtype):
    """Sharded and unsharded values and gradients at the init and at the
    init + 0.1, against the JAX package's (4 slots, 8 components)."""
    y, _ = generate_expert_mixture_data(256)
    _check_ep(*_ep_pairs(y, 8, 4, devices8, dtype, (0.0, 0.1)), dtype)


@pytest.mark.parametrize("n_obs,k,n_dev", [(17, 8, 2), (64, 12, 4), (9, 16, 8)])
def test_ep_equality_across_shapes(devices8, n_obs, k, n_dev):
    """The JAX property sweep's shapes, float64 against the JAX mesh."""
    y, _ = generate_expert_mixture_data(n_obs, seed=n_obs + k)
    _check_ep(*_ep_pairs(y, k, n_dev, devices8, torch.float64, (0.05,)), torch.float64)


def test_ep_unsharded_is_log_softmax_logsumexp():
    """The unsharded branch is ``log_softmax`` + ``logsumexp`` in float64."""
    y, _ = generate_expert_mixture_data(64, seed=3)
    ref = ExpertShardedMixture(y, 4, device="cpu", dtype=torch.float64)
    p = {k: v + 0.2 for k, v in ref.init_params().items()}
    yy = torch.as_tensor(y, dtype=torch.float64)
    log_w = torch.log_softmax(p["weight_logits"], 0)
    sigma = torch.exp(p["log_sigma"])
    t = log_w + torch.distributions.Normal(p["mu"], sigma).log_prob(yy[:, None])
    np.testing.assert_allclose(float(ref._loglik(p)), float(torch.logsumexp(t, 1).sum()),
                               rtol=1e-13)


def test_ep_component_params_stay_per_slot():
    mesh = _mesh({EXPERTS_AXIS: 8})
    y, _ = generate_expert_mixture_data(128)
    ep = ExpertShardedMixture(y, 16, mesh=mesh)
    p = ep.init_params()
    assert all(len(p[k]) == 8 and all(b.shape == (2,) for b in p[k]) for k in p)
    _, g = ep.logp_and_grad(p)
    for k in g:
        assert isinstance(g[k], tuple) and [b.device for b in g[k]] == mesh.slot_devices(
            EXPERTS_AXIS)
    np.testing.assert_allclose(_flat(p["mu"]), np.linspace(y.min(), y.max(), 16), rtol=1e-6)


def test_ep_errors_match_jax(devices8):
    y, _ = generate_expert_mixture_data(64)
    with pytest.raises(ValueError) as got:
        ExpertShardedMixture(y, 6, mesh=_mesh({EXPERTS_AXIS: 8}))
    with pytest.raises(ValueError) as want:
        jexpert.ExpertShardedMixture(y, 6, mesh=jmake_mesh({"experts": 8}, devices=devices8))
    assert str(got.value) == str(want.value) and "not divisible" in str(got.value)


def test_ep_find_map_finds_components():
    """The JAX test's MAP gate (four components' means within 0.5), at
    1,000 Adam steps where the JAX test takes 2,000."""
    y, truth = generate_expert_mixture_data(1024, seed=29)
    ep = ExpertShardedMixture(y, 4, mesh=_mesh({EXPERTS_AXIS: 4}))
    est = ep.find_map(num_steps=1000, learning_rate=0.05)
    assert len(est["mu"]) == 4
    np.testing.assert_allclose(np.sort(_flat(est["mu"])), np.sort(truth["mu"]), atol=0.5)

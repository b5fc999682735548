"""The port's radon GLM, logistic regressions and Lotka-Volterra ODE
against the JAX package's, on the same seeded numpy inputs, on the CPU.

Data generation is numpy in both packages, so the radon and logistic
data agree byte for byte; the LV observations go through a float32 RK4
in each framework, so they agree to rtol 1e-6.  logp is float32 in both
with different reduction orders: value within rtol 1e-5, gradient within
rtol 1e-4 / atol 1e-5 (tests/test_models_more.py's radon mesh test
tolerance), at ``init_params()``, at ``+0.05`` and at a seeded normal
perturbation.  The three logistic forms also agree with one another
behind bench.py's equality gate (value rtol 2e-4; gradient rtol 2e-3 /
atol 1e-3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytensor_federated_tpu.models import glm as jglm
from pytensor_federated_tpu.models import logistic as jlog
from pytensor_federated_tpu.models import ode as jode
from pytensor_federated_tpu.parallel.packing import pack_shards as jax_pack
from pytensor_federated_tpu.parallel.sharded import NoFederatedShards as JaxNoShards
import pytensor_federated_torch as pft
from pytensor_federated_torch.models import ode as tode
from pytensor_federated_torch.utils import tree_leaves

VALUE_RTOL = 1e-5
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
GATE_VALUE_RTOL = 2e-4
GATE_GRAD_TOL = dict(rtol=2e-3, atol=1e-3)
LOGISTIC_FORMS = [{}, {"use_suffstats": True}, {"flatten": True}]


def _np(t):
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def _bytes_equal(a, b):
    a, b = _np(a), _np(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def _points(jax_init, seed=0):
    """init_params, +0.05, and a seeded normal perturbation (numpy)."""
    rng = np.random.default_rng(seed)
    base = {k: np.asarray(v) for k, v in jax_init.items()}
    return [
        base,
        {k: v + np.float32(0.05) for k, v in base.items()},
        {k: v + (0.3 * rng.normal(size=v.shape)).astype(np.float32) for k, v in base.items()},
    ]


def _assert_matches_jax(jm, tm, points, *, value_rtol=VALUE_RTOL, grad_tol=GRAD_TOL):
    for p in points:
        jv, jg = jm.logp_and_grad({k: jnp.asarray(v) for k, v in p.items()})
        tv, tg = tm.logp_and_grad(pft.params_from_jax(p, device="cpu"))
        np.testing.assert_allclose(float(tv), float(jv), rtol=value_rtol)
        assert set(tg) == set(jg)
        for k in jg:
            np.testing.assert_allclose(_np(tg[k]), np.asarray(jg[k]), **grad_tol)


# ---- data ----


@pytest.mark.parametrize("n,mean_obs,seed", [(16, 24, 12), (5, 9, 3)])
def test_radon_data_is_byte_identical(n, mean_obs, seed):
    jd, jtrue = jglm.generate_radon_data(n, mean_obs=mean_obs, seed=seed)
    td, ttrue = pft.generate_radon_data(n, mean_obs=mean_obs, seed=seed, device="cpu")
    assert jtrue == ttrue
    _bytes_equal(jd.mask, td.mask)
    for j, t in zip(jax.tree_util.tree_leaves(jd.data), tree_leaves(td.data)):
        _bytes_equal(j, t)


@pytest.mark.parametrize("hier", [False, True], ids=["flat", "hier"])
def test_logistic_data_is_byte_identical(hier):
    if hier:
        jd, jtrue = jlog.generate_hier_logistic_data(6, n_obs=16, n_features=3)
        td, ttrue = pft.generate_hier_logistic_data(6, n_obs=16, n_features=3, device="cpu")
    else:
        jd, jtrue = jlog.generate_logistic_data(n_shards=64, n_obs=64, n_features=8)
        td, ttrue = pft.generate_logistic_data(n_shards=64, n_obs=64, n_features=8, device="cpu")
    for k in jtrue:
        _bytes_equal(np.asarray(jtrue[k]), np.asarray(ttrue[k]))
    _bytes_equal(jd.mask, td.mask)
    for j, t in zip(jax.tree_util.tree_leaves(jd.data), tree_leaves(td.data)):
        _bytes_equal(j, t)


def test_lv_data_matches_within_float32_integration():
    jobs, jmeta = jode.generate_lv_data(8)
    tobs, tmeta = pft.generate_lv_data(8, device="cpu")
    assert tobs.dtype == torch.float32 and tuple(tobs.shape) == jobs.shape
    np.testing.assert_allclose(_np(tobs), np.asarray(jobs), rtol=1e-6)
    assert set(jmeta) == set(tmeta)
    for k in jmeta:
        np.testing.assert_array_equal(np.asarray(tmeta[k]), np.asarray(jmeta[k]))


def test_lv_vector_field_forms_agree_bitwise():
    """rk4_integrate's coefficient-vector field rounds as the JAX
    expression does, which lv_vector_field keeps verbatim."""
    rng = np.random.default_rng(4)
    for _ in range(20):
        y = torch.tensor(rng.uniform(0.1, 3.0, size=2).astype(np.float32))
        theta = torch.tensor(rng.uniform(0.1, 1.0, size=4).astype(np.float32))
        assert torch.equal(tode._lv_field_fn(theta)(y), tode.lv_vector_field(y, theta))
    jy, jt = jnp.asarray(np.asarray(y)), jnp.asarray(np.asarray(theta))
    np.testing.assert_allclose(_np(tode.lv_vector_field(y, theta)),
                               np.asarray(jode.lv_vector_field(jy, jt)), rtol=1e-6)


# ---- logp and gradient against the JAX models ----


def _carried(jd):
    """The JAX package's packed data handed to the port."""
    return pft.sharded_data_from_jax(
        jax.tree_util.tree_map(np.asarray, jd.data), np.asarray(jd.mask), device="cpu"
    )


def test_radon_logp_and_grad_match_jax():
    jd, _ = jglm.generate_radon_data(16, seed=12)
    jm, tm = jglm.HierarchicalRadonGLM(jd), pft.HierarchicalRadonGLM(_carried(jd))
    _assert_matches_jax(jm, tm, _points(jm.init_params()))


@pytest.fixture(scope="module")
def logistic_data():
    jd, _ = jlog.generate_logistic_data(n_shards=16, n_obs=32, n_features=4)
    return jd, _carried(jd)


@pytest.mark.parametrize("form", LOGISTIC_FORMS, ids=["plain", "suffstats", "flatten"])
def test_logistic_forms_match_jax(logistic_data, form):
    jd, td = logistic_data
    jm = jlog.FederatedLogisticRegression(jd, **form)
    tm = pft.FederatedLogisticRegression(td, **form)
    _assert_matches_jax(jm, tm, _points(jm.init_params()))


def test_logistic_forms_agree_behind_the_equality_gate(logistic_data):
    _, td = logistic_data
    models = [pft.FederatedLogisticRegression(td, **form) for form in LOGISTIC_FORMS]
    for p in _points({k: _np(v) for k, v in models[0].init_params().items()}):
        tp = pft.params_from_jax(p, device="cpu")
        va, ga = models[0].logp_and_grad(tp)
        for other in models[1:]:
            vb, gb = other.logp_and_grad(tp)
            np.testing.assert_allclose(float(vb), float(va), rtol=GATE_VALUE_RTOL)
            for k in ga:
                np.testing.assert_allclose(_np(gb[k]), _np(ga[k]), **GATE_GRAD_TOL)


def test_hier_logistic_matches_jax():
    jd, _ = jlog.generate_hier_logistic_data(8, n_obs=32, n_features=4)
    jm = jlog.HierarchicalLogisticRegression(jd)
    tm = pft.HierarchicalLogisticRegression(_carried(jd))
    _assert_matches_jax(jm, tm, _points(jm.init_params()))
    np.testing.assert_allclose(
        _np(tm.intercepts(pft.params_from_jax(_points(jm.init_params())[2], device="cpu"))),
        np.asarray(jm.intercepts({k: jnp.asarray(v) for k, v in _points(jm.init_params())[2].items()})),
        rtol=1e-6,
    )


def test_lv_logp_and_grad_match_jax():
    jm, meta = jode.make_lv_model(8)
    obs = pft.convert.array_from_jax(np.asarray(jm.observations), device="cpu")
    tm = pft.LotkaVolterraModel(obs, meta["y0"], meta["dt"], meta["n_steps"], meta["obs_idx"])
    _assert_matches_jax(jm, tm, _points(jm.init_params(), seed=1))


def test_hier_logistic_golden_logp():
    """Hand-computed log-posterior on a tiny case (the JAX package's
    golden test, against the port)."""
    data, _ = pft.generate_hier_logistic_data(n_shards=4, n_obs=8, n_features=2, device="cpu")
    model = pft.HierarchicalLogisticRegression(data)
    rng = np.random.default_rng(0)
    w = rng.normal(size=2).astype(np.float32)
    b_raw = rng.normal(size=4).astype(np.float32)
    params = pft.params_from_jax(
        {"w": w, "b0": np.float32(0.3), "log_tau": np.float32(-0.2), "b_raw": b_raw}, device="cpu"
    )
    (X, y), mask = data.tree()
    Xn, yn, mn = (_np(a).astype(np.float64) for a in (X, y, mask))
    b0, log_tau = 0.3, -0.2
    tau = np.exp(log_tau)
    b = b0 + tau * b_raw.astype(np.float64)
    want = 0.0
    for i in range(4):
        logits = Xn[i] @ w.astype(np.float64) + b[i]
        want += np.sum(mn[i] * (yn[i] * logits - np.logaddexp(0.0, logits)))
    s = 5.0
    want += np.sum(-0.5 * (w.astype(np.float64) / s) ** 2 - np.log(s) - 0.5 * np.log(2 * np.pi))
    want += -0.5 * (b0 / s) ** 2 - np.log(s) - 0.5 * np.log(2 * np.pi)
    want += -0.5 * tau**2 + log_tau
    want += np.sum(-0.5 * b_raw.astype(np.float64) ** 2 - 0.5 * np.log(2 * np.pi))
    np.testing.assert_allclose(float(model.logp(params)), want, rtol=1e-5)


# ---- errors ----


def test_flatten_with_suffstats_raises_the_jax_message(logistic_data):
    jd, td = logistic_data
    with pytest.raises(ValueError) as jerr:
        jlog.FederatedLogisticRegression(jd, flatten=True, use_suffstats=True)
    with pytest.raises(ValueError) as terr:
        pft.FederatedLogisticRegression(td, flatten=True, use_suffstats=True)
    assert str(terr.value) == str(jerr.value)


def test_flattened_model_has_no_federated_shards(logistic_data):
    jd, td = logistic_data
    jm = jlog.FederatedLogisticRegression(jd, flatten=True)
    tm = pft.FederatedLogisticRegression(td, flatten=True)
    assert isinstance(tm.fed, pft.NoFederatedShards) and not tm.fed
    assert isinstance(jm.fed, JaxNoShards)
    with pytest.raises(AttributeError) as jerr:
        jm.fed.logp_minibatch
    with pytest.raises(AttributeError) as terr:
        tm.fed.logp_minibatch
    assert str(terr.value) == str(jerr.value)


# ---- per-observation and simulated output ----


def _ragged_logistic_shards():
    """Shards of different lengths, so packing pads some of them."""
    rng = np.random.default_rng(9)
    shards = []
    for n in (5, 12, 9):
        X = rng.normal(size=(n, 3)).astype(np.float32)
        y = (rng.uniform(size=n) < 0.5).astype(np.float32)
        shards.append((X, y))
    return shards


def test_pointwise_loglik_matches_jax_and_zeroes_padding():
    shards = _ragged_logistic_shards()
    jm = jlog.HierarchicalLogisticRegression(jax_pack(shards, pad_to_multiple=8))
    tm = pft.HierarchicalLogisticRegression(pft.pack_shards(shards, pad_to_multiple=8, device="cpu"))
    p = _points(jm.init_params(), seed=2)[2]
    got = _np(tm.pointwise_loglik(pft.params_from_jax(p, device="cpu")))
    want = np.asarray(jm.pointwise_loglik({k: jnp.asarray(v) for k, v in p.items()}))
    assert got.shape == want.shape == (3, 16)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert np.all(got[_np(tm.data.mask) == 0] == 0)


def test_predictive_and_prior_draws_are_shaped_and_padded():
    shards = _ragged_logistic_shards()
    tm = pft.HierarchicalLogisticRegression(pft.pack_shards(shards, pad_to_multiple=8, device="cpu"))
    gen = torch.Generator().manual_seed(0)
    prior = tm.sample_prior(gen)
    init = tm.init_params()
    assert set(prior) == set(init)
    for k in init:
        assert prior[k].shape == init[k].shape and prior[k].dtype == torch.float32
    assert torch.isfinite(prior["log_tau"])
    sim = tm.predictive(prior, gen)
    mask = tm.data.mask
    assert sim.shape == mask.shape
    assert torch.all(sim[mask == 0] == 0)
    assert set(torch.unique(sim).tolist()) <= {0.0, 1.0}


# ---- entry points ----


def test_models_run_on_the_device_of_their_data():
    data, _ = pft.generate_radon_data(4, mean_obs=6, seed=1, device="cpu")
    m = pft.HierarchicalRadonGLM(data)
    assert all(v.device.type == "cpu" for v in m.init_params().values())
    lv, _ = pft.make_lv_model(2, n_obs=4, device="cpu")
    assert lv.init_params()["log_theta"].device.type == "cpu"

"""The port's shards axis as a single-controller mesh, against the JAX
package's 8-device CPU mesh (``tests/conftest.py``'s ``mesh8``).

- ``FederatedLogp`` over an 8-slot CPU mesh (``[cpu] * 8``, 16 shards:
  two per slot): values, gradients, ``per_shard_logps``,
  ``sharded_compute`` and the minibatch estimator (the JAX package's
  per-device indices injected) equal the JAX mesh's at rtol 1e-12 in
  float64 under x64.
- The replicated parameters' gradient over the mesh equals the
  unsharded one, and a gradient taken inside a slot stays the slot's:
  the pin for the JAX package's ``mark_varying``.
- Each model with ``mesh=`` equals itself without one to float32
  summation order (value rtol 1e-5; gradient within 1e-4 |g| + 1e-5
  max|g|).
- The JAX package's error strings; ``diagnostics`` counts and times as
  the JAX package's does.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytensor_federated_tpu import diagnostics as jdiag
from pytensor_federated_tpu.models import linear as jlinear
from pytensor_federated_tpu.models import logistic as jlogistic
from pytensor_federated_tpu.parallel import make_mesh as jax_make_mesh
from pytensor_federated_tpu.parallel import mesh as jmesh
from pytensor_federated_tpu.parallel.sharded import FederatedLogp as JFederatedLogp
from pytensor_federated_tpu.parallel.sharded import sharded_compute as jsharded_compute
import pytensor_federated_torch as pft
from pytensor_federated_torch import diagnostics as tdiag
from pytensor_federated_torch.parallel import mesh as tmesh
from pytensor_federated_torch.parallel.sharded import FederatedLogp, sharded_compute
from pytensor_federated_torch.utils import value_and_grad

LOG_2PI = float(np.log(2 * np.pi))
N_SHARDS, N_OBS = 16, 24
RTOL64 = 1e-12
CPU8 = [torch.device("cpu")] * 8


def _jax_shard(params, shard):
    (x, y), m, sid = shard
    mu = params["intercept"] + jnp.take(params["offsets"], sid) + params["slope"] * x
    z = (y - mu) / jnp.exp(params["log_sigma"])
    return jnp.sum((-0.5 * z * z - params["log_sigma"] - 0.5 * LOG_2PI) * m)


def _torch_shard(params, shard):
    (x, y), m, sid = shard
    mu = params["intercept"] + torch.take(params["offsets"], sid) + params["slope"] * x
    z = (y - mu) / torch.exp(params["log_sigma"])
    return torch.sum((-0.5 * z * z - params["log_sigma"] - 0.5 * LOG_2PI) * m)


@pytest.fixture(scope="module")
def flagship64():
    """The flagship's data at 16 x 24 and a parameter point, as float64
    numpy: ``(((x, y), mask, sid), params)``."""
    data, _ = pft.generate_node_data(N_SHARDS, n_obs=N_OBS, seed=5, device="cpu")
    (x, y), mask = data.tree()
    tree = ((x.double().numpy(), y.double().numpy()), mask.double().numpy(),
            np.arange(N_SHARDS))
    rng = np.random.default_rng(2)
    params = {"intercept": np.float64(1.3), "slope": np.float64(1.9),
              "log_sigma": np.float64(-0.6), "offsets": 0.3 * rng.normal(size=N_SHARDS)}
    return tree, params


def _torch_tree(tree):
    return tuple(_torch_tree(t) if isinstance(t, tuple) else torch.as_tensor(t) for t in tree)


def _jax_tree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _tparams(params):
    return {k: torch.as_tensor(v) for k, v in params.items()}


def _assert_tree_close(got, want, rtol=RTOL64):
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]), rtol=rtol, atol=0)


def test_logp_and_grad_match_the_jax_mesh(mesh8, flagship64):
    tree, params = flagship64
    fed = FederatedLogp(_torch_shard, _torch_tree(tree), mesh=pft.make_mesh({"shards": 8},
                                                                             devices=CPU8))
    v, g = fed.logp_and_grad(_tparams(params))
    with jax.enable_x64(True):
        jfed = JFederatedLogp(_jax_shard, _jax_tree(tree), mesh=mesh8)
        jv, jg = jfed.logp_and_grad(jax.tree_util.tree_map(jnp.asarray, params))
        jv, jg = float(jv), {k: np.asarray(a) for k, a in jg.items()}
        jlb = np.asarray(jfed.logp_batch({k: jnp.stack([jnp.asarray(a)] * 3) for k, a in
                                          params.items()}))
    np.testing.assert_allclose(float(v), jv, rtol=RTOL64)
    _assert_tree_close({k: t.numpy() for k, t in g.items()}, jg)
    lb = fed.logp_batch({k: torch.stack([t] * 3) for k, t in _tparams(params).items()})
    np.testing.assert_allclose(lb.numpy(), jlb, rtol=RTOL64)


def test_per_shard_logps_match_the_jax_mesh(mesh8, flagship64):
    tree, params = flagship64
    fed = FederatedLogp(_torch_shard, _torch_tree(tree), mesh=pft.make_mesh({"shards": 8},
                                                                             devices=CPU8))
    with jax.enable_x64(True):
        want = np.asarray(JFederatedLogp(_jax_shard, _jax_tree(tree), mesh=mesh8)
                          .per_shard_logps(jax.tree_util.tree_map(jnp.asarray, params)))
    got = fed.per_shard_logps(_tparams(params))
    assert got.shape == (N_SHARDS,)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL64)


def test_sharded_compute_matches_the_jax_mesh(mesh8, flagship64):
    """Per shard: its logp and the gradient of its logp taken inside the
    per-shard function, which the mesh must leave the shard's own."""
    tree, params = flagship64

    def jfn(p, shard):
        return {"ll": _jax_shard(p, shard), "g": jax.grad(_jax_shard)(p, shard)["slope"]}

    def tfn(p, shard):
        return {"ll": _torch_shard(p, shard),
                "g": torch.func.grad(_torch_shard)(p, shard)["slope"]}

    with jax.enable_x64(True):
        want = jsharded_compute(jfn, _jax_tree(tree), mesh=mesh8)(
            jax.tree_util.tree_map(jnp.asarray, params))
        want = {k: np.asarray(v) for k, v in want.items()}
    mesh = pft.make_mesh({"shards": 8}, devices=CPU8)
    got = sharded_compute(tfn, _torch_tree(tree), mesh=mesh)(_tparams(params))
    plain = sharded_compute(tfn, _torch_tree(tree))(_tparams(params))
    assert got["ll"].shape == got["g"].shape == (N_SHARDS,)
    _assert_tree_close({k: v.numpy() for k, v in got.items()}, want)
    _assert_tree_close({k: v.numpy() for k, v in got.items()},
                       {k: v.numpy() for k, v in plain.items()})


@pytest.mark.parametrize("num_shards", [8, 16])
def test_minibatch_estimator_matches_the_jax_mesh(mesh8, flagship64, num_shards):
    """The JAX mesh estimator draws ``num_shards / 8`` of each device's
    two shards with ``choice(fold_in(key, device))``; the same local
    indices, injected, give the same estimate and gradient."""
    tree, params = flagship64
    key = jax.random.PRNGKey(11)
    k_local = num_shards // 8
    with jax.enable_x64(True):
        jfed = JFederatedLogp(_jax_shard, _jax_tree(tree), mesh=mesh8)
        jp = jax.tree_util.tree_map(jnp.asarray, params)
        jv, jg = jfed.logp_and_grad_minibatch(jp, key, num_shards)
        jv, jg = float(jv), {k: np.asarray(a) for k, a in jg.items()}
        idx = np.stack([np.asarray(jax.random.choice(jax.random.fold_in(key, j), 2, (k_local,),
                                                     replace=False)) for j in range(8)])
    fed = FederatedLogp(_torch_shard, _torch_tree(tree), mesh=pft.make_mesh({"shards": 8},
                                                                             devices=CPU8))
    v, g = value_and_grad(lambda p: fed._minibatch_estimate(p, torch.as_tensor(idx)),
                          _tparams(params))
    np.testing.assert_allclose(float(v), jv, rtol=RTOL64)
    _assert_tree_close({k: t.numpy() for k, t in g.items()}, jg)
    # The port's own draws: k_local distinct local shards per slot.
    drawn = fed._draw_shards(torch.Generator().manual_seed(3), num_shards)
    assert drawn.shape == (8, k_local)
    assert all(len(set(row.tolist())) == k_local and max(row.tolist()) < 2 for row in drawn)
    gen = torch.Generator().manual_seed(3)
    np.testing.assert_array_equal(fed.logp_minibatch(_tparams(params), gen, num_shards).numpy(),
                                  fed._minibatch_estimate(_tparams(params), drawn).numpy())


def test_shared_parameter_gradient_is_not_scaled_by_the_slot_count(flagship64):
    """The pin for ``mark_varying``: each slot's copy of a replicated
    parameter sends its gradient back once, so the mesh gradient equals
    the unsharded one (a gradient multiplied by the slot count would be
    8x it), and a mesh run is bit-identical to a rerun of itself."""
    tree, params = flagship64
    data = _torch_tree(tree)
    mesh_fed = FederatedLogp(_torch_shard, data, mesh=pft.make_mesh({"shards": 8}, devices=CPU8))
    plain_fed = FederatedLogp(_torch_shard, data)
    p = _tparams(params)
    v, g = mesh_fed.logp_and_grad(p)
    v0, g0 = plain_fed.logp_and_grad(p)
    np.testing.assert_allclose(float(v), float(v0), rtol=RTOL64)
    for k in ("intercept", "slope", "log_sigma", "offsets"):
        np.testing.assert_allclose(g[k].numpy(), g0[k].numpy(), rtol=1e-11, atol=1e-11)
    assert abs(float(g["slope"]) / float(g0["slope"]) - 1.0) < 1e-9
    v2, g2 = mesh_fed.logp_and_grad(p)
    assert torch.equal(v, v2) and all(torch.equal(g[k], g2[k]) for k in g)


def test_mesh_object_and_repeated_devices(devices8):
    """A device may repeat, as in ``jax.sharding.Mesh``; shapes, names
    and the slots' devices carry over."""
    jm = jax_make_mesh({"shards": 4}, devices=[devices8[0]] * 4)
    tm = pft.make_mesh({"shards": 4}, devices=["cpu"] * 4)
    assert tm.axis_names == jm.axis_names and dict(tm.shape) == dict(jm.shape)
    assert tm.devices.shape == jm.devices.shape == (4,)
    two = pft.make_mesh({"chains": 2, "shards": 4}, devices=CPU8)
    assert two.axis_names == ("chains", "shards") and two.shape["shards"] == 4
    assert two.slot_devices("shards") == [torch.device("cpu")] * 4
    assert pft.single_device_mesh(device="cpu").shape == {"shards": 1}
    assert (pft.SHARDS_AXIS, pft.CHAINS_AXIS, pft.SEQ_AXIS) == (
        jmesh.SHARDS_AXIS, jmesh.CHAINS_AXIS, jmesh.SEQ_AXIS)


def _error(fn):
    try:
        fn()
    except (ValueError, KeyError) as e:
        return type(e).__name__, str(e)
    return None


_PARAMS = {"intercept": np.float32(1.0), "slope": np.float32(2.0), "log_sigma": np.float32(0.0),
           "offsets": np.zeros(N_SHARDS, np.float32)}


def _cut(a, n):
    return tuple(_cut(b, n) for b in a) if isinstance(a, tuple) else a[:n]


def _error_cases(pkg, mesh8, tree):
    """The same misuse against each package: ``(class, message)`` each."""
    if pkg == "jax":
        make, fl, sc = jax_make_mesh, JFederatedLogp, jsharded_compute
        shard, t = _jax_shard, _jax_tree(tree)
        m8, devs = mesh8, list(mesh8.devices.reshape(-1))
        p = jax.tree_util.tree_map(jnp.asarray, _PARAMS)
        minibatch = lambda fed: fed.logp_minibatch(p, jax.random.PRNGKey(0), 4)
    else:
        make, fl, sc = pft.make_mesh, FederatedLogp, sharded_compute
        shard, t = _torch_shard, _torch_tree(tree)
        m8, devs = pft.make_mesh({"shards": 8}, devices=CPU8), CPU8
        minibatch = lambda fed: fed.logp_minibatch(_tparams(_PARAMS), torch.Generator(), 4)
    return [
        _error(lambda: fl(shard, _cut(t, 12), mesh=m8)),
        _error(lambda: fl(shard, t, mesh=make({"chains": 8}, devices=devs))),
        _error(lambda: minibatch(fl(shard, t, mesh=m8))),
        _error(lambda: sc(lambda p, d: d, _cut(t, 12), mesh=m8)),
        _error(lambda: make({"shards": 16}, devices=devs)),
    ]


def test_error_strings_match_jax(mesh8, flagship64):
    tree, _ = flagship64
    tree32 = ((tree[0][0].astype(np.float32), tree[0][1].astype(np.float32)),
              tree[1].astype(np.float32), tree[2])
    got = _error_cases("torch", mesh8, tree32)
    want = _error_cases("jax", mesh8, tree32)
    assert got == want
    assert all(e is not None for e in got)


def test_logistic_flatten_refuses_a_mesh(mesh8):
    jdata, _ = jlogistic.generate_logistic_data(8, n_obs=8, n_features=2, seed=1)
    tdata, _ = pft.generate_logistic_data(8, n_obs=8, n_features=2, seed=1, device="cpu")
    with pytest.raises(ValueError) as je:
        jlogistic.FederatedLogisticRegression(jdata, mesh=mesh8, flatten=True)
    with pytest.raises(ValueError) as te:
        pft.FederatedLogisticRegression(tdata, mesh=pft.make_mesh({"shards": 8}, devices=CPU8),
                                        flatten=True)
    assert str(te.value) == str(je.value)


def test_flagship_model_with_mesh_matches_jax(mesh8):
    """``FederatedLinearRegression(mesh=)`` in both packages at 16 x 24,
    float32: value rtol 1e-5, gradient within 1e-4 |g| + 1e-5 max|g|."""
    jdata, _ = jlinear.generate_node_data(N_SHARDS, n_obs=N_OBS, seed=5)
    tdata, _ = pft.generate_node_data(N_SHARDS, n_obs=N_OBS, seed=5, device="cpu")
    jm = jlinear.FederatedLinearRegression(jdata, mesh=mesh8)
    tm = pft.FederatedLinearRegression(tdata, mesh=pft.make_mesh({"shards": 8}, devices=CPU8))
    p = {k: v + 0.1 for k, v in tm.init_params().items()}
    jv, jg = jm.logp_and_grad({k: jnp.asarray(v.numpy()) for k, v in p.items()})
    v, g = tm.logp_and_grad(p)
    _close32(v, g, float(jv), {k: np.asarray(a) for k, a in jg.items()})


def _close32(v, g, want_v, want_g):
    np.testing.assert_allclose(float(v), want_v, rtol=1e-5)
    for k, w in want_g.items():
        w = np.asarray(w, np.float64)
        err = np.abs(np.asarray(g[k].detach(), np.float64) - w)
        assert (err <= 1e-4 * np.abs(w) + 1e-5 * np.abs(w).max()).all(), (k, err.max())


def _models(mesh):
    """One small instance of each model whose JAX twin passes ``mesh=``
    on, built with ``mesh``."""
    cpu = {"device": "cpu"}
    from pytensor_federated_torch.models import countdata, mixture, multinomial

    return {
        "linear": lambda: pft.FederatedLinearRegression(
            pft.generate_node_data(8, n_obs=16, seed=1, **cpu)[0], mesh=mesh),
        "linear_suffstats": lambda: pft.FederatedLinearRegression(
            pft.generate_node_data(8, n_obs=16, seed=1, **cpu)[0], mesh=mesh, use_suffstats=True),
        "radon": lambda: pft.HierarchicalRadonGLM(
            pft.generate_radon_data(8, mean_obs=6, seed=2, **cpu)[0], mesh=mesh),
        "logistic": lambda: pft.FederatedLogisticRegression(
            pft.generate_logistic_data(8, n_obs=8, n_features=3, seed=3, **cpu)[0], mesh=mesh),
        "logistic_suffstats": lambda: pft.FederatedLogisticRegression(
            pft.generate_logistic_data(8, n_obs=8, n_features=3, seed=3, **cpu)[0], mesh=mesh,
            use_suffstats=True),
        "hier_logistic": lambda: pft.HierarchicalLogisticRegression(
            pft.generate_hier_logistic_data(8, n_obs=8, n_features=3, seed=4, **cpu)[0],
            mesh=mesh),
        "poisson": lambda: countdata.FederatedPoissonGLM(
            countdata.generate_count_data(8, n_obs=8, n_features=3, seed=5, **cpu)[0], mesh=mesh),
        "softmax": lambda: multinomial.FederatedSoftmaxRegression(
            multinomial.generate_multinomial_data(8, n_obs=8, n_features=3, seed=6, **cpu)[0],
            3, mesh=mesh),
        "mixture": lambda: mixture.FederatedGaussianMixture(
            mixture.generate_mixture_data(8, n_obs=16, seed=7, **cpu)[0], 3, mesh=mesh),
        "lv_ode": lambda: pft.make_lv_model(8, mesh=mesh, n_obs=8, **cpu)[0],
        "exact_gp": lambda: pft.FederatedExactGP(
            pft.generate_gp_data(8, n_obs=8, seed=8, **cpu)[0], mesh=mesh),
        "sparse_gp": lambda: pft.FederatedSparseGP(
            pft.generate_gp_data(8, n_obs=8, seed=8, **cpu)[0], np.linspace(-1, 1, 4),
            mesh=mesh),
    }


@pytest.mark.parametrize("name", sorted(_models(None)))
def test_each_model_with_a_mesh_equals_itself_without(name):
    mesh = pft.make_mesh({"shards": 4}, devices=["cpu"] * 4)
    with_mesh, plain = _models(mesh)[name](), _models(None)[name]()
    assert (with_mesh if name == "sparse_gp" else with_mesh.fed).mesh is mesh
    rng = np.random.default_rng(9)
    p = {k: v + torch.as_tensor(0.05 * rng.normal(size=tuple(v.shape)), dtype=v.dtype)
         for k, v in plain.init_params().items()}
    v, g = with_mesh.logp_and_grad(p)
    v0, g0 = plain.logp_and_grad(p)
    assert torch.isfinite(v)
    _close32(v, g, float(v0), {k: t.numpy() for k, t in g0.items()})


def test_diagnostics_count_and_time_as_jax():
    """The same calls on each package's registry give the same counters
    and timer call counts; ``instrument_logp`` counts evaluations."""
    snaps = []
    for diag, lp in ((jdiag, lambda p: jnp.sum(p ** 2)), (tdiag, lambda p: torch.sum(p ** 2))):
        reg = diag.Metrics()
        reg.count("a")
        reg.count("a", 3)
        with reg.timed("t"):
            pass
        f = diag.instrument_logp(lp, "lp", registry=reg, block=True)
        x = jnp.ones(3) if diag is jdiag else torch.ones(3)
        assert float(f(x)) == 3.0 and float(f(x)) == 3.0
        snap = reg.snapshot()
        snaps.append((snap["counters"], {k: v["calls"] for k, v in snap["timers"].items()},
                      sorted(snap["timers"]["t"])))
        reg.reset()
        assert reg.snapshot() == {"counters": {}, "timers": {}}
    assert snaps[0] == snaps[1]
    assert snaps[1][0] == {"a": 4, "lp.evals": 2}


def test_diagnostics_profile_annotate_and_device_load(tmp_path, caplog):
    with tdiag.profile_trace(str(tmp_path)) as log_dir:
        with tdiag.annotate("region"):
            torch.ones(4).sum()
    assert log_dir == str(tmp_path) and any(tmp_path.iterdir())
    with caplog.at_level(logging.INFO, logger="pytensor_federated_torch"):
        loads = tdiag.log_device_load(devices=["cpu", "cpu"])
    assert [type(x).__name__ for x in loads] == ["DeviceLoad"] * 2
    assert loads[0].platform == "cpu" and loads[0].percent_hbm is None
    assert sum("device_load" in r.message for r in caplog.records) == 2
    assert [f for f in tmesh.DeviceLoad.__dataclass_fields__] == [
        f for f in jmesh.DeviceLoad.__dataclass_fields__]
    assert pft.healthy_devices(["cpu"] * 2) == [torch.device("cpu")] * 2
    pft.instrument_logp  # exported at the top level, as in the JAX package
    pft.profile_trace

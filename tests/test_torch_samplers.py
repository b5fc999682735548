"""The port's samplers and diagnostics against the JAX package's.

Deterministic pieces (flattening, checkpoint indices, leapfrog, one HMC
step, step-size search, Welford, dual averaging, the warmup schedule,
R̂/ESS/HDI) get the same inputs — random draws included, taken from
``jax.random`` and handed to the port — and must agree: exactly where
the arithmetic is integer or host-side, else at test_pallas.py's
float32 tolerances (rtol 5e-5 values, rtol/atol 5e-4 gradients and
positions).  Whole NUTS runs use different generators, so they agree in
distribution: posterior means within 4 Monte Carlo standard errors.
Every ``sample()`` run steps its four chains in lockstep; the
lockstep-specific tests are in tests/test_torch_chains.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from pytensor_federated_tpu.models.linear import (
    FederatedLinearRegression as JaxModel,
    generate_node_data as jax_generate,
)
from pytensor_federated_tpu.samplers import convergence as jconv
from pytensor_federated_tpu.samplers import hmc as jhmc
from pytensor_federated_tpu.samplers import nuts as jnuts
from pytensor_federated_tpu.samplers import util as jutil
from pytensor_federated_tpu.samplers.mcmc import sample as jax_sample
import pytensor_federated_torch as pft
from pytensor_federated_torch.samplers import convergence as tconv
from pytensor_federated_torch.samplers import hmc as thmc
from pytensor_federated_torch.samplers import nuts as tnuts
from pytensor_federated_torch.samplers import util as tutil
from pytensor_federated_torch.samplers.mcmc import make_flat_logp_and_grad
from pytensor_federated_torch.utils import tree_leaves

VALUE_RTOL = 5e-5
GRAD_TOL = dict(rtol=5e-4, atol=5e-4)
DIM = 11  # intercept, log_sigma, offsets[8], slope


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(t, j, **tol):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **(tol or {"rtol": VALUE_RTOL}))


@pytest.fixture(scope="module")
def flagship():
    """The flagship posterior as flat value+grad functions of both packages."""
    jdata, _ = jax_generate(8, n_obs=64, seed=123)
    tdata, _ = pft.generate_node_data(8, n_obs=64, seed=123, device="cpu")
    jm, tm = JaxModel(jdata), pft.FederatedLinearRegression(tdata)
    jflat, junravel = ravel_pytree(jm.init_params())
    jlg = jax.jit(jax.value_and_grad(lambda x: jm.logp(junravel(x))))
    _, _, _, tlg = make_flat_logp_and_grad(tm.logp, tm.init_params())
    return jm, tm, jlg, tlg


def _inv_mass(kind):
    if kind == "diag":
        return np.linspace(0.5, 1.5, DIM).astype(np.float32)
    a = np.random.default_rng(2).normal(size=(DIM, DIM)) * 0.1
    return (a @ a.T + np.eye(DIM)).astype(np.float32)


def _x0(seed=1):
    return (np.random.default_rng(seed).normal(size=DIM) * 0.2).astype(np.float32)


def test_flatten_order_matches_ravel_pytree():
    params = {
        "slope": np.float32(2.0),
        "b": {"z": np.arange(3, dtype=np.float32), "a": np.ones((2, 2), np.float32)},
        "a": np.float32(-1.0),
    }
    jflat, _ = ravel_pytree({k: jax.tree_util.tree_map(jnp.asarray, v) for k, v in params.items()})
    tparams = {
        "slope": _t(params["slope"]),
        "b": {"z": _t(params["b"]["z"]), "a": _t(params["b"]["a"])},
        "a": _t(params["a"]),
    }
    tflat, unravel = tutil.ravel(tparams)
    np.testing.assert_array_equal(tflat.numpy(), np.asarray(jflat))
    back = unravel(tflat)
    for a, b in zip(tree_leaves(back), tree_leaves(tparams)):
        assert torch.equal(a, b)
    batch = unravel(torch.stack([tflat, 2 * tflat]))
    assert batch["b"]["a"].shape == (2, 2, 2)


def test_leaf_to_ckpt_idxs_matches_jax_exactly():
    jmin, jmax = jax.vmap(jnuts._leaf_to_ckpt_idxs)(jnp.arange(256, dtype=jnp.int32))
    got = np.array([tnuts._leaf_to_ckpt_idxs(n) for n in range(256)])
    np.testing.assert_array_equal(got[:, 0], np.asarray(jmin))
    np.testing.assert_array_equal(got[:, 1], np.asarray(jmax))


@pytest.mark.parametrize("kind", ["diag", "dense"])
def test_leapfrog_and_kinetic_energy_match_jax(flagship, kind):
    _, _, jlg, tlg = flagship
    inv_mass, x0 = _inv_mass(kind), _x0()
    r0 = np.random.default_rng(4).normal(size=DIM).astype(np.float32)
    jl, jg = jlg(jnp.asarray(x0))
    tl, tg = tlg(_t(x0))
    _close(tl, jl)
    _close(tg, jg, **GRAD_TOL)
    _close(thmc.kinetic_energy(_t(r0), _t(inv_mass)), jhmc.kinetic_energy(jnp.asarray(r0), jnp.asarray(inv_mass)))
    jstate = jhmc.IntegratorState(jnp.asarray(x0), jnp.asarray(r0), jl, jg)
    tstate = thmc.IntegratorState(_t(x0), _t(r0), tl, tg)
    step = np.float32(0.01)
    for _ in range(3):
        jstate = jhmc.leapfrog(jlg, jstate, step, jnp.asarray(inv_mass))
        tstate = thmc.leapfrog(tlg, tstate, _t(step), _t(inv_mass))
    _close(tstate.x, jstate.x, **GRAD_TOL)
    _close(tstate.r, jstate.r, **GRAD_TOL)
    _close(tstate.logp, jstate.logp)


@pytest.mark.parametrize("kind", ["diag", "dense"])
def test_hmc_step_matches_jax_on_the_same_draws(flagship, kind):
    """One HMC transition with the JAX step's own momentum and accept
    draws handed to the port."""
    _, _, jlg, tlg = flagship
    inv_mass, x0 = _inv_mass(kind), _x0()
    key = jax.random.PRNGKey(3)
    k_mom, k_acc = jax.random.split(key)
    z = np.asarray(jax.random.normal(k_mom, (DIM,), jnp.float32))
    u = np.asarray(jax.random.uniform(k_acc, dtype=jnp.float32))
    jstate = jhmc.hmc_init(jlg, jnp.asarray(x0))
    tstate = thmc.hmc_init(tlg, _t(x0))
    kw = dict(step_size=np.float32(0.01), num_steps=8)
    jnew, jinfo = jhmc.hmc_step(jlg, jstate, key, inv_mass=jnp.asarray(inv_mass), **kw)
    tnew, tinfo = thmc.hmc_step(
        tlg, tstate, None, inv_mass=_t(inv_mass), z=_t(z), u=_t(u),
        step_size=_t(kw["step_size"]), num_steps=kw["num_steps"],
    )
    assert bool(tinfo.accepted) == bool(jinfo.accepted)
    assert bool(tinfo.diverging) == bool(jinfo.diverging)
    _close(tinfo.accept_prob, jinfo.accept_prob, **GRAD_TOL)
    _close(tinfo.energy, jinfo.energy, rtol=5e-4)
    _close(tnew.x, jnew.x, **GRAD_TOL)
    _close(tnew.logp, jnew.logp)


def test_find_reasonable_step_size_matches_jax(flagship):
    _, _, jlg, tlg = flagship
    key = jax.random.PRNGKey(8)
    z = np.asarray(jax.random.normal(key, (DIM,), jnp.float32))
    inv_mass = np.ones(DIM, np.float32)
    want = jhmc.find_reasonable_step_size(jlg, jnp.asarray(_x0()), key, jnp.asarray(inv_mass))
    got = thmc.find_reasonable_step_size(tlg, _t(_x0()), None, _t(inv_mass), z=_t(z))
    assert float(got) == float(want)  # a power of two


@pytest.mark.parametrize("dense", [False, True])
def test_welford_matches_jax(dense):
    xs = np.random.default_rng(6).normal(size=(40, 4)).astype(np.float32) * [1, 2, 3, 4]
    js = jutil.welford_init(4, dense=dense)
    ts = tutil.welford_init(4, dense=dense)
    for x in xs:
        js = jutil.welford_update(js, jnp.asarray(x))
        ts = tutil.welford_update(ts, _t(x))
    for name in ("mean", "m2", "count"):
        _close(getattr(ts, name), getattr(js, name))
    if dense:
        _close(tutil.welford_covariance(ts), jutil.welford_covariance(js))
    else:
        _close(tutil.welford_variance(ts), jutil.welford_variance(js))
        _close(
            tutil.welford_variance(ts, regularize=False),
            jutil.welford_variance(js, regularize=False),
        )


def test_dual_averaging_matches_jax():
    accept = np.random.default_rng(7).uniform(size=60).astype(np.float32)
    jd = jutil.da_init(jnp.float32(0.3))
    td = tutil.da_init(_t(np.float32(0.3)))
    for a in accept:
        jd = jutil.da_update(jd, jnp.float32(a), target=0.8)
        td = tutil.da_update(td, _t(a), target=0.8)
    for name in jd._fields:
        _close(getattr(td, name), getattr(jd, name))


@pytest.mark.parametrize("num_warmup", [0, 10, 19, 20, 100, 150, 300, 500, 1000])
def test_adapt_schedule_matches_jax_exactly(num_warmup):
    j = jutil.AdaptSchedule.make(num_warmup)
    t = tutil.AdaptSchedule.make(num_warmup)
    np.testing.assert_array_equal(t.update_mass, np.asarray(j.update_mass))
    np.testing.assert_array_equal(t.in_slow, np.asarray(j.in_slow))


def _ar1_draws(chains=4, n=301, event=(3,), seed=0):
    """Autocorrelated draws, one chain offset, so R̂ and ESS are non-trivial."""
    rng = np.random.default_rng(seed)
    x = np.zeros((chains, n) + event, np.float32)
    for t in range(1, n):
        x[:, t] = 0.7 * x[:, t - 1] + rng.normal(size=(chains,) + event)
    x[0] += 0.5
    return {"a": x, "b": x[..., 0] * 2.0 + 1.0}


@pytest.mark.parametrize("rank_normalized", [False, True])
def test_convergence_diagnostics_match_jax(rank_normalized):
    draws = _ar1_draws()
    jd = {k: jnp.asarray(v) for k, v in draws.items()}
    td = {k: _t(v) for k, v in draws.items()}
    kw = dict(rank_normalized=rank_normalized)
    for tfn, jfn in [
        (tconv.split_rhat, jconv.split_rhat),
        (tconv.effective_sample_size, jconv.effective_sample_size),
    ]:
        t, j = tfn(td, **kw), jfn(jd, **kw)
        for k in draws:
            _close(t[k], j[k], rtol=1e-4)
    ts, js = tconv.summary(td, **kw), jconv.summary(jd, **kw)
    for stat in ("mean", "sd", "hdi", "rhat", "ess", "ess_tail"):
        for k in draws:
            _close(ts[stat][k], js[stat][k], rtol=1e-4, atol=1e-5)


def test_sample_rejects_unknown_kernel(flagship):
    _, tm, _, _ = flagship
    with pytest.raises(ValueError, match="unknown kernel"):
        pft.samplers.sample(tm.logp, tm.init_params(), generator=torch.Generator(), kernel="gibbs")


def _kernel_posterior(tm):
    """The flagship posterior through the kernel's composition (prior +
    data_logp)."""
    (x, y), mask = tm.data.tree()
    kern = pft.linreg_logp_grad_fn(x, y, mask)
    return lambda p: tm.prior_logp(p) + kern.data_logp(p)


def _means_agree(jres, tres):
    """Every posterior mean within 4 combined Monte Carlo standard
    errors of the JAX run's."""
    jsum, tsum = jconv.summary(jres.samples), tconv.summary(tres.samples)
    for k in jsum["mean"]:
        jmcse = np.asarray(jsum["sd"][k]) / np.sqrt(np.asarray(jsum["ess"][k]))
        tmcse = tsum["sd"][k].numpy() / np.sqrt(tsum["ess"][k].numpy())
        diff = np.abs(tsum["mean"][k].numpy() - np.asarray(jsum["mean"][k]))
        assert np.all(diff <= 4 * np.sqrt(jmcse**2 + tmcse**2)), k
    return max(float(v.max()) for v in tsum["rhat"].values())


def test_hmc_sample_shapes(flagship):
    """Four HMC chains in lockstep: the JAX package's result shapes, its
    posterior means within 4 MCSE, and split R-hat < 1.05."""
    jm, tm, _, _ = flagship
    kw = dict(kernel="hmc", num_warmup=250, num_samples=250, num_chains=4, num_hmc_steps=12)
    jres = jax_sample(jm.logp, jm.init_params(), key=jax.random.PRNGKey(1), **kw)
    res = pft.samplers.sample(
        _kernel_posterior(tm), tm.init_params(), generator=torch.Generator().manual_seed(1), **kw
    )
    assert res.samples["offsets"].shape == (4, 250, 8)
    assert res.samples["slope"].shape == (4, 250)
    assert set(res.stats) == {"accept_prob", "diverging", "energy"}
    assert {k: v.shape for k, v in res.stats.items()} == {k: v.shape for k, v in jres.stats.items()}
    assert res.step_size.shape == (4,) and res.inv_mass.shape == (4, DIM)
    assert _means_agree(jres, res) < 1.05


def test_nuts_sample_agrees_with_jax(flagship):
    """A NUTS run of four chains in lockstep on the flagship posterior
    through the kernel's composition (prior + data_logp) against the JAX
    sample() run on the same data: every posterior mean within 4
    combined MCSE, split R-hat < 1.05."""
    jm, tm, _, _ = flagship
    kw = dict(num_warmup=150, num_samples=150, num_chains=4)
    jres = jax_sample(jm.logp, jm.init_params(), key=jax.random.PRNGKey(0), **kw)
    tres = pft.samplers.sample(
        _kernel_posterior(tm), tm.init_params(), generator=torch.Generator().manual_seed(0), **kw,
    )
    assert tres.stats["depth"].shape == (4, 150)
    assert not bool(tres.stats["diverging"].any())
    assert _means_agree(jres, tres) < 1.05


def test_metropolis_sample_agrees_with_jax(flagship):
    """Four Metropolis chains in lockstep on the flagship: every posterior
    mean within 4 MCSE of the JAX package's.  (Random-walk Metropolis
    crawls along this posterior's intercept/offsets ridge: at this
    length split R-hat is ~1.1-1.3 in the port and ~1.5 in the JAX
    package; test_metropolis_sample_recovers_gaussian holds R-hat.)"""
    jm, tm, _, _ = flagship
    kw = dict(kernel="metropolis", num_warmup=1000, num_samples=4000, num_chains=4)
    jres = jax_sample(jm.logp, jm.init_params(), key=jax.random.PRNGKey(2), **kw)
    tres = pft.samplers.sample(
        _kernel_posterior(tm), tm.init_params(), generator=torch.Generator().manual_seed(2), **kw
    )
    assert tres.stats["accept_total"].shape == (4, 4000)
    _means_agree(jres, tres)


# ---- Metropolis, find_map and a supplied value+grad ----


def test_metropolis_step_matches_jax_on_the_same_draws(flagship):
    """One step of each package from the same state with the same
    proposal normal and uniform (the JAX step's own draws, handed to the
    port): identical accept decisions, positions within rtol 5e-5."""
    from pytensor_federated_tpu.samplers import metropolis as jmet
    from pytensor_federated_torch.samplers import metropolis as tmet

    jm, tm, _, _ = flagship
    jflat, junravel = ravel_pytree(jm.init_params())
    jlogp = jax.jit(lambda x: jm.logp(junravel(x)))
    tlogp = make_flat_logp_and_grad(tm.logp, tm.init_params())[0]
    accepted = set()
    for seed, step in [(0, 0.05), (1, 0.05), (2, 0.5), (3, 0.01), (4, 2.0), (5, 0.1)]:
        x0 = jnp.asarray(_x0(seed))
        key = jax.random.PRNGKey(seed)
        k_prop, k_acc = jax.random.split(key)
        z = jax.random.normal(k_prop, x0.shape, x0.dtype)
        u = jax.random.uniform(k_acc, dtype=x0.dtype)
        jnew = jmet.metropolis_step(jlogp, jmet.metropolis_init(jlogp, x0), key, step_size=step)
        with torch.no_grad():
            tstate = tmet.metropolis_init(tlogp, _t(x0))
            tnew = tmet.metropolis_step(tlogp, tstate, None, step_size=step, draws=(_t(z), _t(u)))
        assert float(tnew.n_accept) == float(jnew.n_accept)
        accepted.add(float(tnew.n_accept))
        _close(tnew.x, jnew.x, rtol=5e-5, atol=1e-7)
        _close(tnew.logp, jnew.logp)
    assert accepted == {0.0, 1.0}  # both branches of the accept were taken


def test_metropolis_sample_recovers_gaussian():
    """Posterior mean/sd of the N(3, 2) target of tests/test_samplers.py,
    at its gates (mean atol 0.35, sd rtol 0.25), from four chains in
    lockstep; split R-hat < 1.05."""
    mu, sigma = 3.0, 2.0
    res = pft.samplers.sample(
        lambda p: torch.sum(-0.5 * ((p["x"] - mu) / sigma) ** 2),
        {"x": torch.zeros(3)},
        generator=torch.Generator().manual_seed(42),
        num_warmup=400, num_samples=3000, num_chains=4, kernel="metropolis",
    )
    draws = res.samples["x"].numpy()
    assert draws.shape == (4, 3000, 3)
    np.testing.assert_allclose(draws.mean(axis=(0, 1)), mu, atol=0.35)
    np.testing.assert_allclose(draws.std(axis=(0, 1)), sigma, rtol=0.25)
    assert float(tconv.split_rhat(res.samples)["x"].max()) < 1.05
    assert res.stats["accept_total"].shape == (4, 3000)
    assert torch.all(res.stats["accept_total"][:, 1:] >= res.stats["accept_total"][:, :-1])
    assert torch.equal(res.inv_mass, torch.ones(4, 3)) and res.step_size.shape == (4,)


@pytest.mark.parametrize("model_name", ["radon", "linear"])
def test_find_map_matches_jax(model_name, flagship):
    """Adam in optax's update order: the same steps and rate end at the
    JAX package's point within rtol 1e-3 on every leaf (float32 rounding
    differs; atol 1e-4 for leaves that end near zero)."""
    from pytensor_federated_tpu.models.glm import HierarchicalRadonGLM, generate_radon_data

    if model_name == "radon":
        jm = HierarchicalRadonGLM(generate_radon_data(4, mean_obs=8, seed=3)[0])
        tm = pft.HierarchicalRadonGLM(pft.generate_radon_data(4, mean_obs=8, seed=3, device="cpu")[0])
    else:
        jm, tm, _, _ = flagship
    kw = dict(num_steps=200, learning_rate=0.05)
    want = jm.find_map(**kw)
    got = tm.find_map(**kw)
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k], rtol=1e-3, atol=1e-4)


def test_supplied_logp_and_grad_drives_find_map_and_sample():
    model = pft.HierarchicalRadonGLM(pft.generate_radon_data(4, mean_obs=8, seed=3, device="cpu")[0])
    plain = pft.samplers.find_map(model.logp, model.init_params(), num_steps=30)
    fused = pft.samplers.find_map(
        model.logp, model.init_params(), num_steps=30, logp_and_grad_fn=model.logp_and_grad
    )
    for k in plain:
        assert torch.equal(plain[k], fused[k])
    calls = []

    def lg(p):
        calls.append(1)
        return model.logp_and_grad(p)

    res = pft.samplers.sample(
        model.logp, model.init_params(), generator=torch.Generator().manual_seed(0),
        num_warmup=20, num_samples=10, num_chains=1, logp_and_grad_fn=lg,
    )
    assert res.samples["alpha_raw"].shape == (1, 10, 4)
    assert all(bool(torch.isfinite(v).all()) for v in res.samples.values())
    assert len(calls) > 30

"""The port's model-checking workflow against the JAX package's, on the
CPU: WAIC, PSIS-LOO, ``compare`` and the generalized-Pareto fit (numpy
in both packages: equal results on the same matrices, including the
heavy-tail and tie cases), the pointwise log-likelihood matrix (float32,
rtol 1e-5 / atol 1e-5), posterior and prior predictive shapes and the
subsampled draws (the same indices), the Laplace approximation (float64:
mode and covariance within rtol 1e-5), the arviz export's groups and
names, and one NUTS run of the port on a count family (2 chains x 100 +
100) that ranks as the JAX package's test expects.

Run as a script, it fits the JAX package on the CPU to the data of
``chip_smoke.py``'s ``model_check`` phase and prints that phase's gates
(the check that the gates hold for the reference, not only the port)::

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_model_comparison.py
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

from pytensor_federated_tpu.models import countdata as jc
from pytensor_federated_tpu.samplers import arviz_export as jaz
from pytensor_federated_tpu.samplers import laplace as jlap
from pytensor_federated_tpu.samplers import model_comparison as jmc
from pytensor_federated_tpu.samplers import predictive as jpred
from pytensor_federated_tpu.samplers.mcmc import SampleResult as JaxSampleResult
import pytensor_federated_torch as pft
from pytensor_federated_torch.models import countdata as tc
from pytensor_federated_torch.samplers import arviz_export as taz
from pytensor_federated_torch.samplers import model_comparison as tmc
from pytensor_federated_torch.samplers import predictive as tpred
from pytensor_federated_torch.samplers.mcmc import SampleResult

# ---- the numpy estimators: equal to the JAX package's ----

S2, T2, MU0 = 1.0, 4.0, 0.0  # known obs variance, prior variance and mean


def _draws_and_ll(y, n_draws=4000, seed=0):
    """(n_draws, n_points) log-likelihoods of iid Normal(mu, S2) data at
    exact conjugate posterior draws of mu (the JAX test's matrices)."""
    rng = np.random.default_rng(seed)
    prec = 1.0 / T2 + y.size / S2
    mean = (MU0 / T2 + y.sum() / S2) / prec
    mus = rng.normal(mean, np.sqrt(1.0 / prec), size=n_draws)
    return scipy.stats.norm.logpdf(y[None, :], mus[:, None], np.sqrt(S2))


def _matrix(case):
    if case == "conjugate":
        return _draws_and_ll(np.random.default_rng(42).normal(1.2, 1.0, size=40))
    if case == "heavy_tail":
        rng = np.random.default_rng(5)
        ll = _draws_and_ll(rng.normal(1.0, 1.0, size=30), n_draws=2000, seed=9)
        ll[:, 0] = -np.abs(rng.standard_cauchy(size=2000)) * 3.0
        return ll
    if case == "ties":
        rng = np.random.default_rng(3)
        ll = _draws_and_ll(rng.normal(1.0, 1.0, size=20), n_draws=500, seed=4)
        ll[:, 0] = np.repeat([-0.3, -0.2, 2.5], [300, 195, 5])[:500]
        return ll
    raise AssertionError(case)


def _assert_same_result(a, b):
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_equal(a[k], b[k])


CASES = ["conjugate", "heavy_tail", "ties"]


@pytest.mark.parametrize("case", CASES)
def test_waic_equals_jax(case):
    ll = _matrix(case)
    _assert_same_result(tmc.waic(ll), jmc.waic(ll))


@pytest.mark.parametrize("case", CASES)
def test_psis_loo_equals_jax(case):
    ll = _matrix(case)
    res = tmc.psis_loo(ll)
    _assert_same_result(res, jmc.psis_loo(ll))
    assert np.isfinite(res["elpd_loo"]) and not np.any(np.isnan(res["pareto_k"]))
    if case == "heavy_tail":
        assert res["pareto_k"][0] > 0.7 and res["n_bad_k"] >= 1


def test_compare_equals_jax():
    rng = np.random.default_rng(7)
    y = rng.normal(0.8, 1.0, size=50)
    good = _draws_and_ll(y, seed=2)
    bad = scipy.stats.norm.logpdf(y[None, :], (-3.0 + rng.normal(0, 0.01, 4000))[:, None], 1.0)
    models = {"true": good, "wrong": bad}
    rows = tmc.compare(models)
    want = jmc.compare(models)
    assert [r["model"] for r in rows] == [r["model"] for r in want] == ["true", "wrong"]
    for r, w in zip(rows, want):
        _assert_same_result(r, w)
    assert rows[1]["d_elpd"] < -5.0 and rows[1]["d_se"] > 0


@pytest.mark.parametrize("xi", [0.1, 0.4, 0.7, "ties"])
def test_gpd_fit_equals_jax(xi):
    if xi == "ties":
        x = np.sort(np.concatenate([np.full(60, 1e-30), [0.5, 1.0, 2.0]]))
    else:
        x = np.sort(scipy.stats.genpareto.rvs(
            xi, scale=1.0, size=4000, random_state=np.random.default_rng(0)))
    got = tmc._gpd_fit(x)
    np.testing.assert_equal(got, jmc._gpd_fit(x))
    if xi == "ties":
        assert np.isinf(got[0])
    else:
        assert abs(got[0] - xi) < 0.12 and abs(got[1] - 1.0) < 0.25


def test_psis_smooth_tail_equals_jax_on_ties():
    lr = np.ascontiguousarray(_matrix("ties")[:, 0])
    got, want = tmc._psis_smooth_tail(lr.copy()), jmc._psis_smooth_tail(lr.copy())
    np.testing.assert_equal(got, want)
    assert np.all(np.isfinite(got[0]))


# ---- the sweeps over draws ----


@pytest.fixture(scope="module")
def poisson():
    jd, _ = jc.generate_count_data(4, n_obs=37, n_features=3, seed=13)
    jm = jc.FederatedPoissonGLM(jd)
    tm = tc.FederatedPoissonGLM(pft.sharded_data_from_jax(
        jax.tree_util.tree_map(np.asarray, jd.data), np.asarray(jd.mask), device="cpu"))
    rng = np.random.default_rng(8)
    draws = {k: (np.asarray(v) + 0.2 * rng.normal(size=(2, 5) + np.shape(v))).astype(np.float32)
             for k, v in jm.init_params().items()}
    return jd, jm, tm, draws


@pytest.mark.parametrize("masked", [True, False], ids=["mask", "no_mask"])
def test_pointwise_loglik_matrix_matches_jax(poisson, masked):
    jd, jm, tm, draws = poisson
    want = jmc.pointwise_loglik_matrix(
        jm.pointwise_loglik, {k: jnp.asarray(v) for k, v in draws.items()},
        mask=jd.mask if masked else None)
    got = tmc.pointwise_loglik_matrix(
        tm.pointwise_loglik, pft.params_from_jax(draws, device="cpu"),
        mask=tm.data.mask if masked else None)
    assert got.shape == want.shape
    assert got.shape[1] == (int(np.asarray(jd.mask).sum()) if masked else jd.mask.size)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("total,num", [(600, 200), (300, 20), (1000, 7), (37, 36), (151, 150)])
def test_subsampling_indices_equal_jax(total, num):
    want = np.asarray(jnp.linspace(0, total - 1, num).astype(jnp.int32))
    np.testing.assert_array_equal(tpred._subsample_indices(total, num).numpy(), want)


def test_posterior_predictive_picks_jax_draws():
    a = np.arange(2 * 9, dtype=np.float32).reshape(2, 9)
    want = jpred.posterior_predictive(lambda p, k: p["a"], {"a": jnp.asarray(a)},
                                      jax.random.PRNGKey(0), num_draws=5)
    got = tpred.posterior_predictive(lambda p, g: p["a"], {"a": torch.from_numpy(a)},
                                     torch.Generator().manual_seed(0), num_draws=5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    full = tpred.posterior_predictive(lambda p, g: p["a"], {"a": torch.from_numpy(a)},
                                      torch.Generator(), num_draws=None)
    np.testing.assert_array_equal(full.numpy(), a.reshape(-1))


def test_posterior_predictive_tree_output():
    samples = {"a": torch.ones(2, 5), "b": torch.zeros(2, 5, 3)}

    def predictive(params, generator):
        d = params["a"].shape[0]
        return {"y": params["a"] + params["b"].sum(-1), "n": torch.ones(d)}

    out = tpred.posterior_predictive(predictive, samples, torch.Generator())
    assert tuple(out["y"].shape) == (10,) and tuple(out["n"].shape) == (10,)


def test_prior_predictive_spans_prior():
    def sample_prior(generator):
        return {"mu": 5.0 * torch.randn((), generator=generator)}

    def predictive(params, generator):
        mu = params["mu"]
        return mu[:, None] + 0.1 * torch.randn((mu.shape[0], 10), generator=generator)

    sims = tpred.prior_predictive(sample_prior, predictive, torch.Generator().manual_seed(0),
                                  num_draws=2000)
    assert tuple(sims.shape) == (2000, 10)
    assert 4.0 < float(sims.mean(1).std()) < 6.0


def test_family_posterior_predictive_shapes(poisson):
    _, _, tm, draws = poisson
    samples = pft.params_from_jax(draws, device="cpu")
    sims = pft.samplers.posterior_predictive(tm.predictive, samples,
                                             torch.Generator().manual_seed(3), num_draws=4)
    assert tuple(sims.shape) == (4,) + tuple(tm.data.mask.shape)
    assert (sims[:, tm.data.mask == 0] == 0).all()


# ---- the Laplace approximation ----


def test_laplace_matches_jax(poisson):
    """The MAP search (Adam, float32, followed to float32 rounding) gives
    JAX's mode within rtol 1e-5; the covariance, whose float32 Hessian
    is ~1e-3 off through a condition number of ~7e3, is held in float64
    around that mode, within rtol 1e-5."""
    jd, jm, tm, _ = poisson
    want_mode = jlap.find_map(jax.jit(jm.logp), jm.init_params())  # JAX's Laplace mode
    got32 = pft.samplers.laplace_approximation(tm.logp, tm.init_params())
    for k in want_mode:
        np.testing.assert_allclose(got32.mode[k].numpy(), np.asarray(want_mode[k]),
                                   rtol=1e-5, atol=1e-7)
    mode = {k: np.asarray(v, np.float64) for k, v in want_mode.items()}
    with jax.enable_x64(True):
        data = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), jd.data)
        mask = np.asarray(jd.mask, np.float64)
        jm64 = jc.FederatedPoissonGLM(type(jd)(
            data=jax.tree_util.tree_map(jnp.asarray, data), mask=jnp.asarray(mask)))
        tm64 = tc.FederatedPoissonGLM(pft.sharded_data_from_jax(data, mask, device="cpu"))
        jmode = {k: jnp.asarray(v) for k, v in mode.items()}
        want = jlap.laplace_approximation(jax.jit(jm64.logp), jmode, mode=jmode)
        tmode = pft.params_from_jax(mode, device="cpu")
        got = pft.samplers.laplace_approximation(tm64.logp, tmode, mode=tmode)
        np.testing.assert_allclose(got.mean_flat.numpy(), np.asarray(want.mean_flat), rtol=1e-12)
        np.testing.assert_allclose(got.cov_flat.numpy(), np.asarray(want.cov_flat), rtol=1e-5)
        np.testing.assert_allclose(got.logp_at_mode, want.logp_at_mode, rtol=1e-12)


def test_laplace_exact_for_a_gaussian():
    A = torch.tensor([[2.0, 0.5], [0.5, 1.0]])
    mu = torch.tensor([1.0, -2.0])

    def logp(p):
        d = p["x"] - mu
        return -0.5 * d @ A @ d

    res = pft.samplers.laplace_approximation(logp, {"x": torch.zeros(2)}, num_steps=2000,
                                             learning_rate=0.1)
    np.testing.assert_allclose(res.mean_flat.numpy(), mu.numpy(), atol=1e-3)
    np.testing.assert_allclose(res.cov_flat.numpy(), np.linalg.inv(A.numpy()), atol=1e-3)
    draws = res.sample(torch.Generator().manual_seed(0), num_draws=4000)
    assert tuple(draws["x"].shape) == (4000, 2)
    np.testing.assert_allclose(float(res.stddev()["x"][1]), np.sqrt(np.linalg.inv(A.numpy())[1, 1]),
                               atol=1e-3)
    np.testing.assert_allclose(float(draws["x"][:, 1].std()), float(res.stddev()["x"][1]), rtol=0.1)


@pytest.mark.parametrize("case", ["nan", "non_pd"])
def test_laplace_errors_match_jax(case):
    if case == "nan":
        jfn, tfn = (lambda p: jnp.sqrt(p["x"].sum())), (lambda p: torch.sqrt(p["x"].sum()))
    else:
        jfn, tfn = (lambda p: 0.5 * jnp.sum(p["x"] ** 2)), (lambda p: 0.5 * torch.sum(p["x"] ** 2))
    x = -np.ones(2, np.float32)
    with pytest.raises(ValueError) as je:
        jlap.laplace_approximation(jfn, {"x": jnp.asarray(x)}, mode={"x": jnp.asarray(x)})
    with pytest.raises(ValueError) as te:
        pft.samplers.laplace_approximation(tfn, {"x": torch.from_numpy(x)},
                                           mode={"x": torch.from_numpy(x)})
    assert str(te.value) == str(je.value)


# ---- the arviz export ----


def _fake_run(draws, package):
    rng = np.random.default_rng(2)
    stats = {"accept_prob": rng.uniform(size=(2, 5)).astype(np.float32),
             "diverging": rng.uniform(size=(2, 5)) < 0.1,
             "energy": rng.normal(size=(2, 5)).astype(np.float32),
             "depth": rng.integers(1, 5, size=(2, 5)).astype(np.int32)}
    if package == "jax":
        to = lambda t: jax.tree_util.tree_map(jnp.asarray, t)
        return JaxSampleResult(samples=to(draws), stats=to(stats), step_size=jnp.ones(2),
                               inv_mass=jnp.ones((2, 8)))
    to = lambda t: {k: torch.from_numpy(np.asarray(v)) for k, v in t.items()}
    return SampleResult(samples=to(draws), stats=to(stats), step_size=torch.ones(2),
                        inv_mass=torch.ones(2, 8))


def test_to_dataset_dict_has_jax_groups_and_names(poisson):
    jd, jm, tm, draws = poisson
    want = jaz.to_dataset_dict(_fake_run(draws, "jax"), pointwise_fn=jm.pointwise_loglik,
                               mask=jd.mask)
    got = taz.to_dataset_dict(_fake_run(draws, "torch"), pointwise_fn=tm.pointwise_loglik,
                              mask=tm.data.mask)
    assert set(got) == set(want) == {"posterior", "sample_stats", "log_likelihood"}
    for group in ("posterior", "sample_stats"):
        assert set(got[group]) == set(want[group])
        for k in want[group]:
            np.testing.assert_array_equal(got[group][k], np.asarray(want[group][k]))
    assert "tree_depth" in got["sample_stats"] and "acceptance_rate" in got["sample_stats"]
    ll = got["log_likelihood"]["obs"]
    assert ll.shape == want["log_likelihood"]["obs"].shape == (2, 5, int(tm.data.mask.sum()))
    np.testing.assert_allclose(ll, want["log_likelihood"]["obs"], rtol=1e-5, atol=1e-5)


def test_nested_param_trees_flatten_as_jax():
    tree = {"a": 1, "nest": {"b": 2, "c": 3}}
    assert taz._as_mapping(tree) == jaz._as_mapping(tree)
    assert set(taz._as_mapping([torch.zeros(1), torch.ones(2)])) == {"param_0", "param_1"}


def test_to_inference_data_without_arviz_raises_jax_error(poisson, monkeypatch):
    _, _, _, draws = poisson
    monkeypatch.setitem(sys.modules, "arviz", None)
    with pytest.raises(ImportError) as je:
        jaz.to_inference_data(_fake_run(draws, "jax"))
    with pytest.raises(ImportError) as te:
        taz.to_inference_data(_fake_run(draws, "torch"))
    assert str(te.value) == str(je.value)


def test_cuda_graph_needs_cuda():
    data, _ = tc.generate_count_data(2, n_obs=8, n_features=2, device="cpu")
    m = tc.FederatedPoissonGLM(data)
    with pytest.raises(ValueError, match="needs the chains on a CUDA device"):
        m.sample(generator=torch.Generator().manual_seed(0), num_warmup=2, num_samples=2,
                 num_chains=2, cuda_graph=True)


# ---- one NUTS run of the port, ranked as the JAX test expects ----


def test_end_to_end_ranking_on_a_count_family():
    """Poisson data: Poisson must win or tie (NB2 nests it, so the elpd
    difference must be small either way — within 3 SEs or 4 nats).

    NUTS with trees of at most 2^5 leapfrog steps (the default is 2^8):
    the transitions here average depth 4.4 with either cap, and the cap
    keeps the two fits under ~30 s on one CPU worker (~47 s without)."""
    data, _ = tc.generate_count_data(4, n_obs=48, n_features=2, seed=5, device="cpu")
    mask = data.mask
    lls = {}
    for name, cls in (("poisson", tc.FederatedPoissonGLM), ("negbin", tc.FederatedNegBinGLM)):
        m = cls(data)
        res = m.sample(generator=torch.Generator().manual_seed(1), num_warmup=100,
                       num_samples=100, num_chains=2, max_depth=5)
        lls[name] = tmc.pointwise_loglik_matrix(m.pointwise_loglik, res.samples, mask=mask)
        assert lls[name].shape == (200, int(mask.sum()))
    by_name = {r["model"]: r for r in tmc.compare(lls)}
    assert abs(by_name["negbin"]["d_elpd"]) < max(
        3.0 * by_name["negbin"]["d_se"], 3.0 * by_name["poisson"]["d_se"], 4.0)


# ---- chip_smoke.py's model_check gates, checked on the JAX package ----

# chip_smoke.py's model_check phase: config 3's 16 shards, width 8.
MODEL_CHECK_DATA = dict(n_shards=16, n_obs=256, n_features=8, pi=0.35, seed=5)
MODEL_CHECK_NUTS = dict(num_chains=4, num_warmup=150, num_samples=150)
MODEL_CHECK_PREDICTIVE_DRAWS = 200


# The R-hat gate of the model_check phase.  The slopes and the family's
# own parameters must have mixed (< 1.05).  The intercept hierarchy
# (b0 + tau * b_raw) is a ridge that 150 + 150 draws do not resolve:
# the JAX package on the same data reads 1.05-1.10 there, so it is held
# to bench_suite's < 1.2 instead.
RHAT_MIXED, RHAT_HIERARCHY = 1.05, 1.2
HIERARCHY_LEAVES = ("b0", "b_raw", "log_tau")


def model_check_gates(rows, rhat, obs_zero_share, sim_zero_shares):
    """The model_check phase's gates from ``compare``'s rows, the max
    split R-hat of each leaf of each family (``{family: {leaf: rhat}}``),
    the observed share of zeros and the simulated shares of the top
    family's predictive draws."""
    by_name = {r["model"]: r for r in rows}
    lo, hi = np.quantile(np.asarray(sim_zero_shares), [0.05, 0.95])
    zi = [rhat["zip"], rhat["zinb"]]
    return {
        "rhat_zi_mixed_below_1.05": all(
            v < RHAT_MIXED for r in zi for k, v in r.items() if k not in HIERARCHY_LEAVES),
        "rhat_zi_hierarchy_below_1.2": all(
            v < RHAT_HIERARCHY for r in zi for k, v in r.items() if k in HIERARCHY_LEAVES),
        "zero_inflated_first": rows[0]["model"] in ("zip", "zinb"),
        "poisson_beyond_2_se": -by_name["poisson"]["d_elpd"] > 2 * by_name["poisson"]["d_se"],
        "zero_share_in_central_90": bool(lo <= obs_zero_share <= hi),
        "zero_share_band": [float(lo), float(hi)],
    }


def _jax_model_check():
    import json
    import time

    import jax
    import jax.numpy as jnp

    from pytensor_federated_tpu.models import countdata as jc
    from pytensor_federated_tpu.samplers import (
        compare,
        laplace_approximation,
        pointwise_loglik_matrix,
        posterior_predictive,
        psis_loo,
        split_rhat,
        waic,
    )

    cfg = dict(MODEL_CHECK_DATA)
    data, _ = jc.generate_zi_count_data(cfg.pop("n_shards"), **cfg)
    (_X, y), mask = data.tree()
    keep = np.asarray(mask) > 0
    obs_zero = float(np.mean(np.asarray(y)[keep] == 0))
    families = {
        "poisson": jc.FederatedPoissonGLM,
        "negbin": jc.FederatedNegBinGLM,
        "zip": jc.FederatedZeroInflPoissonGLM,
        "zinb": jc.FederatedZeroInflNegBinGLM,
    }
    models, results, lls, rhat, out = {}, {}, {}, {}, {}
    for name, cls in families.items():
        t0 = time.perf_counter()
        m = cls(data)
        res = m.sample(key=jax.random.PRNGKey(1), **MODEL_CHECK_NUTS)
        models[name], results[name] = m, res
        lls[name] = pointwise_loglik_matrix(m.pointwise_loglik, res.samples, mask=mask)
        rhat[name] = {k: float(jnp.max(v)) for k, v in split_rhat(res.samples).items()}
        loo, w = psis_loo(lls[name]), waic(lls[name])
        out[name] = {"elpd_loo": loo["elpd_loo"], "n_bad_k": loo["n_bad_k"],
                     "elpd_waic": w["elpd_waic"], "split_rhat": rhat[name],
                     "seconds": time.perf_counter() - t0}
    rows = compare(lls)
    top = rows[0]["model"]
    sims = posterior_predictive(models[top].predictive, results[top].samples,
                                jax.random.PRNGKey(2), num_draws=MODEL_CHECK_PREDICTIVE_DRAWS)
    sim_zero = np.mean(np.asarray(sims)[:, keep] == 0, axis=1)
    lap = laplace_approximation(models["zinb"].logp, models["zinb"].init_params())
    gates = model_check_gates(rows, rhat, obs_zero, sim_zero)
    print(json.dumps({
        "package": "pytensor_federated_tpu (JAX, CPU)", "families": out, "compare": rows,
        "observed_zero_share": obs_zero, "simulated_zero_share_mean": float(sim_zero.mean()),
        "laplace_zinb_logit_pi": [float(lap.mode["logit_pi"]),
                                  float(lap.stddev()["logit_pi"])],
        "nuts_zinb_logit_pi": [float(jnp.mean(results["zinb"].samples["logit_pi"])),
                               float(jnp.std(results["zinb"].samples["logit_pi"]))],
        "gates": gates,
        "ok": all(v for k, v in gates.items() if k != "zero_share_band"),
    }, default=float))


if __name__ == "__main__":
    _jax_model_check()

"""The port's GLM families and Gaussian mixture against the JAX package's,
on the same seeded numpy inputs, on the CPU.

Ten classes (Poisson, NB2, ZIP, ZINB, Student-t, Gamma, ordinal, flat
and hierarchical softmax, Weibull AFT) and the Gaussian mixture, at 4
shards x 24-48 observations x 2-3 features.  Data generation is numpy in
both packages, so the packed data agree byte for byte.  Tolerances:

- float32: logp within rtol 1e-5, gradient within rtol 1e-4 / atol 1e-5
  (``_assert_matches_jax`` of tests/test_torch_models.py); pointwise
  log-likelihoods within rtol 1e-5 / atol 1e-5.
- float64 (JAX under ``jax.enable_x64``): logp within rtol 1e-12,
  gradient within rtol 1e-12 + 1e-12 max|g of the leaf| (the same sums
  in another order).
- The softmax forms (raw and sufficient statistics) agree behind
  bench.py's equality gate in float32 (value rtol 2e-4, gradient rtol
  2e-3 / atol 1e-3) and within rtol 1e-10 in float64.
- Predictive draws cannot equal JAX's (the PRNGs differ): 1,000
  replicated datasets at the generating parameters must match the
  observation model's mean within 5 standard errors of the grand mean,
  and its variance within 10%.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytensor_federated_tpu.models import countdata as jc
from pytensor_federated_tpu.models import gamma as jg
from pytensor_federated_tpu.models import mixture as jmix
from pytensor_federated_tpu.models import multinomial as jmn
from pytensor_federated_tpu.models import ordinal as jo
from pytensor_federated_tpu.models import robust as jr
from pytensor_federated_tpu.models import survival as js
from pytensor_federated_tpu.parallel.packing import ShardedData as JaxShardedData
import pytensor_federated_torch as pft
from pytensor_federated_torch.models import countdata as tc
from pytensor_federated_torch.models import gamma as tg
from pytensor_federated_torch.models import mixture as tmix
from pytensor_federated_torch.models import multinomial as tmn
from pytensor_federated_torch.models import ordinal as to
from pytensor_federated_torch.models import robust as tr
from pytensor_federated_torch.models import survival as ts
from pytensor_federated_torch.utils import tree_leaves, tree_map

from test_torch_models import _assert_matches_jax, _bytes_equal, _carried, _np, _points

F64_RTOL = 1e-12
PW_TOL = dict(rtol=1e-5, atol=1e-5)
GATE_VALUE_RTOL = 2e-4
GATE_GRAD_TOL = dict(rtol=2e-3, atol=1e-3)
SIM_DRAWS = 1000
MEAN_SE = 5.0
VAR_RTOL = 0.10

# name -> (JAX generator, port generator, generator kwargs, JAX class,
# port class, model kwargs)
FAMILIES = {
    "poisson": (jc.generate_count_data, tc.generate_count_data,
                dict(n_shards=4, n_obs=37, n_features=3),
                jc.FederatedPoissonGLM, tc.FederatedPoissonGLM, {}),
    "negbin": (jc.generate_count_data, tc.generate_count_data,
               dict(n_shards=4, n_obs=37, n_features=3, dispersion=4.0),
               jc.FederatedNegBinGLM, tc.FederatedNegBinGLM, {}),
    "zip": (jc.generate_zi_count_data, tc.generate_zi_count_data,
            dict(n_shards=4, n_obs=45, n_features=2, pi=0.3),
            jc.FederatedZeroInflPoissonGLM, tc.FederatedZeroInflPoissonGLM, {}),
    "zinb": (jc.generate_zi_count_data, tc.generate_zi_count_data,
             dict(n_shards=4, n_obs=45, n_features=2, pi=0.3, dispersion=4.0),
             jc.FederatedZeroInflNegBinGLM, tc.FederatedZeroInflNegBinGLM, {}),
    "robust": (jr.generate_robust_data, tr.generate_robust_data,
               dict(n_shards=4, n_obs=38, n_features=3),
               jr.FederatedRobustRegression, tr.FederatedRobustRegression, {}),
    "gamma": (jg.generate_gamma_data, tg.generate_gamma_data,
              dict(n_shards=4, n_obs=30, n_features=2),
              jg.FederatedGammaGLM, tg.FederatedGammaGLM, {}),
    "ordinal": (jo.generate_ordinal_data, to.generate_ordinal_data,
                dict(n_shards=4, n_obs=43, n_features=3, n_categories=5),
                jo.FederatedOrdinalRegression, to.FederatedOrdinalRegression,
                dict(n_categories=5)),
    "softmax": (jmn.generate_multinomial_data, tmn.generate_multinomial_data,
                dict(n_shards=4, n_obs=40, n_features=3, n_classes=4),
                jmn.FederatedSoftmaxRegression, tmn.FederatedSoftmaxRegression,
                dict(n_classes=4)),
    "softmax_suffstats": (jmn.generate_multinomial_data, tmn.generate_multinomial_data,
                          dict(n_shards=4, n_obs=40, n_features=3, n_classes=4),
                          jmn.FederatedSoftmaxRegression, tmn.FederatedSoftmaxRegression,
                          dict(n_classes=4, use_suffstats=True)),
    "hier_softmax": (jmn.generate_hier_multinomial_data, tmn.generate_hier_multinomial_data,
                     dict(n_shards=4, n_obs=24, n_features=2, n_classes=4),
                     jmn.HierarchicalSoftmaxRegression, tmn.HierarchicalSoftmaxRegression,
                     dict(n_classes=4)),
    "weibull": (js.generate_survival_data, ts.generate_survival_data,
                dict(n_shards=4, n_obs=33, n_features=3),
                js.FederatedWeibullAFT, ts.FederatedWeibullAFT, {}),
    "mixture": (jmix.generate_mixture_data, tmix.generate_mixture_data,
                dict(n_shards=4, n_obs=44),
                jmix.FederatedGaussianMixture, tmix.FederatedGaussianMixture,
                dict(n_components=3)),
}
NAMES = list(FAMILIES)
HIER = ["poisson", "negbin", "zip", "zinb", "robust", "gamma", "ordinal",
        "hier_softmax", "weibull"]


def _gen_args(kwargs):
    kwargs = dict(kwargs)
    return (kwargs.pop("n_shards"),), kwargs


class _Jitted:
    """A JAX model with its logp_and_grad and pointwise_loglik under
    ``jax.jit`` (one compile for the three points, ~5x faster on the CPU
    than eager dispatch); its ``logp`` is the value of
    ``logp_and_grad``."""

    def __init__(self, model):
        self.init_params = model.init_params
        self.logp_and_grad = jax.jit(model.logp_and_grad)
        self.pointwise_loglik = jax.jit(model.pointwise_loglik)

    def logp(self, params):
        return self.logp_and_grad(params)[0]


@pytest.fixture(scope="module", params=NAMES)
def family(request):
    """(name, JAX data, truth, JAX model (jitted), port model) with the
    port's model on the JAX package's packed data, on the CPU."""
    jgen, _, gkw, jcls, tcls, mkw = FAMILIES[request.param]
    args, kw = _gen_args(gkw)
    jd, truth = jgen(*args, **kw)
    return request.param, jd, truth, _Jitted(jcls(jd, **mkw)), tcls(_carried(jd), **mkw)


# ---- data and parameters ----


@pytest.mark.parametrize("name", NAMES)
def test_data_is_byte_identical(name):
    jgen, tgen, gkw, *_ = FAMILIES[name]
    args, kw = _gen_args(gkw)
    jd, jtrue = jgen(*args, **kw)
    td, ttrue = tgen(*args, **kw, device="cpu")
    assert set(jtrue) == set(ttrue)
    for k in jtrue:
        _bytes_equal(np.asarray(jtrue[k]), np.asarray(ttrue[k]))
    _bytes_equal(jd.mask, td.mask)
    jl, tl = jax.tree_util.tree_leaves(jd.data), tree_leaves(td.data)
    assert len(jl) == len(tl)
    for j, t in zip(jl, tl):
        _bytes_equal(j, t)


def test_init_params_have_jax_keys_shapes_and_dtypes(family):
    _, _, _, jm, tm = family
    jp, tp = jm.init_params(), tm.init_params()
    assert set(jp) == set(tp)
    for k in jp:
        assert tuple(tp[k].shape) == tuple(np.shape(jp[k])), k
        assert _np(tp[k]).dtype == np.asarray(jp[k]).dtype, k
        np.testing.assert_array_equal(_np(tp[k]), np.asarray(jp[k]))


# ---- logp, gradient and pointwise log-likelihoods ----


def test_logp_and_grad_match_jax_float32(family):
    _, _, _, jm, tm = family
    _assert_matches_jax(jm, tm, _points(jm.init_params(), seed=3))


def test_logp_and_pointwise_match_jax_float32(family):
    _, _, _, jm, tm = family
    p = _points(jm.init_params(), seed=4)[2]
    jv = jm.logp({k: jnp.asarray(v) for k, v in p.items()})
    tv = tm.logp(pft.params_from_jax(p, device="cpu"))
    np.testing.assert_allclose(float(tv), float(jv), rtol=1e-5)
    jp = jm.pointwise_loglik({k: jnp.asarray(v) for k, v in p.items()})
    tp = tm.pointwise_loglik(pft.params_from_jax(p, device="cpu"))
    assert tuple(tp.shape) == tuple(jp.shape)
    np.testing.assert_allclose(_np(tp), np.asarray(jp), **PW_TOL)


def _to_f64(jd):
    """The JAX package's data in float64 (call under enable_x64), and
    the same numbers as the port's float64 data."""
    data64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), jd.data)
    mask64 = np.asarray(jd.mask, np.float64)
    jd64 = JaxShardedData(
        data=jax.tree_util.tree_map(jnp.asarray, data64), mask=jnp.asarray(mask64)
    )
    return jd64, pft.sharded_data_from_jax(data64, mask64, device="cpu")


def test_logp_grad_and_pointwise_match_jax_float64(family):
    name, jd, _, jm32, _ = family
    *_, jcls, tcls, mkw = FAMILIES[name]
    points = [{k: v.astype(np.float64) for k, v in p.items()}
              for p in _points(jm32.init_params(), seed=5)[1:]]
    with jax.enable_x64(True):
        jd64, td64 = _to_f64(jd)
        jm, tm = _Jitted(jcls(jd64, **mkw)), tcls(td64, **mkw)
        for p in points:
            jp, tp = {k: jnp.asarray(v) for k, v in p.items()}, pft.params_from_jax(p, device="cpu")
            jv, jgrad = jm.logp_and_grad(jp)
            tv, tgrad = tm.logp_and_grad(tp)
            assert tv.dtype == torch.float64
            np.testing.assert_allclose(float(tv), float(jv), rtol=F64_RTOL)
            np.testing.assert_allclose(float(tm.logp(tp)), float(jm.logp(jp)), rtol=F64_RTOL)
            for k in jgrad:
                want = np.asarray(jgrad[k])
                np.testing.assert_allclose(
                    _np(tgrad[k]), want, rtol=F64_RTOL,
                    atol=F64_RTOL * float(np.max(np.abs(want))))
        want = np.asarray(jm.pointwise_loglik(jp))
        np.testing.assert_allclose(_np(tm.pointwise_loglik(tp)), want, rtol=F64_RTOL,
                                   atol=F64_RTOL * float(np.max(np.abs(want))))


def _extreme(params, sign):
    """Every slope and intercept leaf pushed to |eta| ~ 100s."""
    out = dict(params)
    for k in ("w", "W", "b0", "b", "kappa0", "mu0"):
        if k in out:
            out[k] = out[k] + sign * 60.0
    return out


@pytest.mark.parametrize("sign", [1.0, -1.0], ids=["high", "low"])
def test_padded_slots_stay_finite_at_extreme_eta(family, sign):
    """The clamps (exp(min(eta, 80)), the NB2 logaddexp, the Gamma and
    Weibull exponent clamps and tiny floors) keep the value, the gradient
    and the padded slots of the pointwise matrix finite."""
    _, jd, _, _, tm = family
    p = _extreme(tm.init_params(), sign)
    v, g = tm.logp_and_grad(p)
    assert math.isfinite(float(v))
    for k, t in g.items():
        assert torch.isfinite(t).all(), k
    pw = tm.pointwise_loglik(p)
    assert torch.isfinite(pw).all()
    mask = np.asarray(jd.mask).reshape(pw.shape)
    np.testing.assert_array_equal(_np(pw)[mask == 0], 0.0)


# ---- construction-time validation ----


def _raises_same(jfn, tfn):
    with pytest.raises(Exception) as je:
        jfn()
    with pytest.raises(Exception) as te:
        tfn()
    assert type(te.value) is type(je.value)
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("bad", ["too_high", "negative", "fractional"])
def test_ordinal_validation_matches_jax(bad):
    jd, _ = jo.generate_ordinal_data(3, n_obs=16, n_categories=4)
    (X, y), mask = jd.tree()
    y = np.array(y)
    y[0, 0] = {"too_high": 7.0, "negative": -1.0, "fractional": 1.5}[bad]
    jbad = JaxShardedData(data=(X, jnp.asarray(y)), mask=mask)
    tbad = pft.sharded_data_from_jax((np.asarray(X), y), np.asarray(mask), device="cpu")
    _raises_same(lambda: jo.FederatedOrdinalRegression(jbad, n_categories=4),
                 lambda: to.FederatedOrdinalRegression(tbad, n_categories=4))


@pytest.mark.parametrize("cls", ["FederatedSoftmaxRegression", "HierarchicalSoftmaxRegression"])
def test_softmax_validation_matches_jax(cls):
    jd, _ = jmn.generate_multinomial_data(2, n_obs=8, n_classes=3)
    _raises_same(lambda: getattr(jmn, cls)(jd, n_classes=1),
                 lambda: getattr(tmn, cls)(_carried(jd), n_classes=1))


# ---- the softmax forms behind the equality gate ----


def test_softmax_raw_equals_suffstats():
    jd, _ = jmn.generate_multinomial_data(4, n_obs=40, n_features=3, n_classes=4)
    td = _carried(jd)
    raw = tmn.FederatedSoftmaxRegression(td, n_classes=4)
    folded = tmn.FederatedSoftmaxRegression(td, n_classes=4, use_suffstats=True)
    for p in _points({k: _np(v) for k, v in raw.init_params().items()}, seed=7):
        tp = pft.params_from_jax(p, device="cpu")
        va, ga = raw.logp_and_grad(tp)
        vb, gb = folded.logp_and_grad(tp)
        np.testing.assert_allclose(float(vb), float(va), rtol=GATE_VALUE_RTOL)
        for k in ga:
            np.testing.assert_allclose(_np(gb[k]), _np(ga[k]), **GATE_GRAD_TOL)
    (X, y), mask = td.tree()
    td64 = pft.ShardedData(data=(X.double(), y.double()), mask=mask.double())
    raw64 = tmn.FederatedSoftmaxRegression(td64, n_classes=4)
    folded64 = tmn.FederatedSoftmaxRegression(td64, n_classes=4, use_suffstats=True)
    p = {k: v.double() + 0.2 for k, v in raw.init_params().items()}
    va, ga = raw64.logp_and_grad(p)
    vb, gb = folded64.logp_and_grad(p)
    np.testing.assert_allclose(float(vb), float(va), rtol=1e-10)
    for k in ga:
        np.testing.assert_allclose(_np(gb[k]), _np(ga[k]), rtol=1e-10, atol=1e-10)


# ---- predictive draws ----


def _true_params(name, truth, model):
    """The generating parameters in the model's parameterization."""
    p = {k: _np(v).copy() for k, v in model.init_params().items()}
    f = np.float32
    if name in ("poisson", "negbin", "zip", "zinb", "robust", "gamma", "weibull"):
        tau = 0.3
        p.update(w=truth["w"].astype(f), b0=f(truth["b0"]), log_tau=f(np.log(tau)),
                 b_raw=((truth["b"] - truth["b0"]) / tau).astype(f))
    if name in ("negbin", "zinb"):
        p["log_phi"] = f(np.log(4.0))
    if name in ("zip", "zinb"):
        p["logit_pi"] = f(np.log(0.3 / 0.7))
    if name == "robust":
        p.update(log_sigma=f(np.log(0.5)), log_numinus1=f(np.log(9.0)))
    if name == "gamma":
        p["log_alpha"] = f(np.log(truth["alpha"]))
    if name == "weibull":
        p["log_k"] = f(np.log(truth["k"]))
    if name == "ordinal":
        kappa = truth["kappa"]
        p.update(w=truth["w"].astype(f), log_tau=f(np.log(0.3)),
                 b_raw=(truth["b"] / 0.3).astype(f), kappa0=f(kappa[0]),
                 log_incr=np.log(np.diff(kappa)).astype(f))
    if name in ("softmax", "softmax_suffstats"):
        p.update(W=truth["W"].astype(f), b=truth["b"].astype(f))
    if name == "hier_softmax":
        p.update(w=truth["W"].astype(f), b0=truth["b0"].astype(f),
                 log_tau=f(np.log(truth["tau"])))
    if name == "mixture":
        p.update(mu0=f(truth["mu"][0]), log_incr=np.log(np.diff(truth["mu"])).astype(f),
                 log_sigma=np.log(truth["sigma"]).astype(f),
                 weight_logits=np.log(truth["weights"]).astype(f))
    return pft.params_from_jax(p, device="cpu")


def _moments(name, model, p):
    """The observation model's mean and variance per observation, in
    float64, at ``p``."""
    d = {k: v.double() for k, v in p.items()}
    if name == "mixture":
        (y,), _ = model.data.tree()
        mu, sigma = model._components(d)
        w = torch.softmax(d["weight_logits"], -1)[:, None, :].expand(*y.shape, -1)
        mean = (w * mu).sum(-1)
        return mean, (w * (sigma**2 + mu**2)).sum(-1) - mean**2
    X = model.data.tree()[0][0].double()
    if name in ("softmax", "softmax_suffstats"):
        free = X @ d["W"] + d["b"]
    else:
        free = X @ d["w"] + model.intercepts(d)[:, None, ...]
    if name in ("softmax", "softmax_suffstats", "hier_softmax"):
        probs = torch.softmax(tmn._pinned_logits(free), -1)
        k = torch.arange(probs.shape[-1], dtype=torch.float64)
        mean = (probs * k).sum(-1)
        return mean, (probs * k**2).sum(-1) - mean**2
    eta = free
    if name == "ordinal":
        kappa = model._kappa(d)
        cdf = torch.sigmoid(kappa - eta[..., None])  # P(y <= c)
        pmf = torch.diff(torch.cat([torch.zeros_like(cdf[..., :1]), cdf,
                                    torch.ones_like(cdf[..., :1])], -1), dim=-1)
        k = torch.arange(pmf.shape[-1], dtype=torch.float64)
        mean = (pmf * k).sum(-1)
        return mean, (pmf * k**2).sum(-1) - mean**2
    mu = torch.exp(eta)
    if name == "poisson":
        return mu, mu
    if name in ("negbin", "zinb", "zip"):
        var = mu + mu**2 / torch.exp(d["log_phi"]) if name != "zip" else mu
        if name == "negbin":
            return mu, var
        pi = torch.sigmoid(d["logit_pi"])
        second = var + mu**2
        return (1 - pi) * mu, (1 - pi) * second - ((1 - pi) * mu) ** 2
    if name == "robust":
        nu = 1 + torch.exp(d["log_numinus1"])
        return eta, torch.exp(d["log_sigma"]) ** 2 * nu / (nu - 2) * torch.ones_like(eta)
    if name == "gamma":
        return mu, mu**2 / torch.exp(d["log_alpha"])
    if name == "weibull":
        k = torch.exp(d["log_k"])
        g1, g2 = math.gamma(1 + 1 / float(k)), math.gamma(1 + 2 / float(k))
        return mu * g1, mu**2 * (g2 - g1**2)
    raise AssertionError(name)


def test_predictive_shape_padding_and_moments(family):
    name, jd, truth, _, tm = family
    p = _true_params(name, truth, tm)
    mask = tm.data.mask
    gen = torch.Generator().manual_seed(11)
    one = tm.predictive(p, gen)
    assert tuple(one.shape) == tuple(mask.shape)
    batch = tree_map(lambda v: v.expand((SIM_DRAWS,) + tuple(v.shape)).clone(), p)
    sims = tm.predictive(batch, gen).double()
    assert tuple(sims.shape) == (SIM_DRAWS,) + tuple(mask.shape)
    real = mask > 0
    if name in ("softmax", "softmax_suffstats"):
        # labels on every row (the mask is applied downstream)
        assert set(np.unique(_np(sims))) <= set(range(4))
    else:
        assert (sims[:, ~real] == 0).all()
    assert torch.isfinite(sims).all()
    mean, var = _moments(name, tm, p)
    n = int(real.sum())
    grand = float(sims[:, real].mean())
    want = float(mean[real].mean())
    se = math.sqrt(float(var[real].sum()) / (SIM_DRAWS * n * n))
    assert abs(grand - want) < MEAN_SE * se, (grand, want, se)
    sample_var = float(sims[:, real].var(dim=0).mean())
    assert abs(sample_var / float(var[real].mean()) - 1) < VAR_RTOL


@pytest.mark.parametrize("name", HIER)
def test_prior_predictive_runs(name):
    jgen, tgen, gkw, _, tcls, mkw = FAMILIES[name]
    args, kw = _gen_args(gkw)
    td, _ = tgen(*args, **kw, device="cpu")
    m = tcls(td, **mkw)
    gen = torch.Generator().manual_seed(0)
    sims = pft.samplers.prior_predictive(m.sample_prior, m.predictive, gen, num_draws=20)
    assert tuple(sims.shape) == (20,) + tuple(td.mask.shape)
    assert torch.isfinite(sims).all()
    if name in ("poisson", "negbin", "zip", "zinb"):
        assert float(sims.max()) < 2**31 - 1
    p0, p1 = m.init_params(), m.sample_prior(gen)
    assert set(p0) == set(p1)
    for k in p0:
        assert p0[k].shape == p1[k].shape and p1[k].dtype == p0[k].dtype, k
    assert math.isfinite(float(m.prior_logp(p1)))


def test_poisson_predictive_calibrated_at_map():
    """The JAX test's check: at the MAP, the replicated data's masked
    mean lies within 20% of the observed mean."""
    data, _ = tc.generate_count_data(4, n_obs=64, n_features=3, seed=11, device="cpu")
    m = tc.FederatedPoissonGLM(data)
    est = m.find_map()
    (_X, y), mask = data.tree()
    sims = pft.samplers.posterior_predictive(
        m.predictive, tree_map(lambda a: a[None, None], est), torch.Generator().manual_seed(1))
    assert tuple(sims.shape) == (1,) + tuple(y.shape)
    sim_mean = float(sims[0].sum() / mask.sum())
    obs_mean = float((y * mask).sum() / mask.sum())
    assert abs(sim_mean - obs_mean) / obs_mean < 0.2

"""The port's ELBO core, ADVI, RealNVP flows and Pathfinder against the
JAX package's.

The port's estimators take their noise as a tensor or a generator; the
tests draw the noise from the JAX package's keys exactly as its
functions do (``jax.random.split(key, num_steps)`` per step, and so on)
and hand the same numbers to both.  Tolerances: float64 (the JAX side
under ``jax.enable_x64``) rtol 1e-10 on parameters, traces and
iterates; float32 rtol 1e-5 / atol 1e-6 on a few Adam steps (a few
roundings each) and rtol 1e-4 / atol 1e-5 on Pathfinder's fits (a
Cholesky and a windowed BFGS recurrence of 20 rank-two updates after
the L-BFGS path).  Whole runs are held to the JAX tests' moment gates
(tests/test_samplers_more.py, tests/test_pathfinder.py) at reduced
lengths, and the flagship's float32 posterior through the port's
linreg path against the JAX model's.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pytensor_federated_tpu.ppl import elbo as jelbo
from pytensor_federated_tpu.samplers import advi as jadvi
from pytensor_federated_tpu.samplers import flows as jflows
from pytensor_federated_torch.ppl import elbo as telbo
from pytensor_federated_torch.samplers import advi as tadvi
from pytensor_federated_torch.samplers import flows as tflows

# ``samplers.pathfinder`` is the function; the modules by their names.
jpf = importlib.import_module("pytensor_federated_tpu.samplers.pathfinder")
tpf = importlib.import_module("pytensor_federated_torch.samplers.pathfinder")

F64 = dict(rtol=1e-10, atol=1e-12)
F32 = dict(rtol=1e-5, atol=1e-6)
PF32 = dict(rtol=1e-4, atol=1e-5)


def _gaussian(dim, seed, dtype=np.float64):
    rng = np.random.default_rng(seed)
    m = rng.normal(size=dim).astype(dtype)
    a = rng.normal(size=(dim, dim)).astype(dtype)
    cov = a @ a.T + dim * np.eye(dim, dtype=dtype)
    return m, cov, np.linalg.inv(cov).astype(dtype)


def _pair(m, prec):
    """The same Gaussian logp over ``{"x": ...}`` in both packages.  The
    JAX side converts its constants at each call, so under
    ``jax.enable_x64`` they stay float64."""
    mt, pt = torch.as_tensor(m), torch.as_tensor(prec)

    def jlogp(p):
        d = p["x"] - jnp.asarray(m)
        return -0.5 * d @ jnp.asarray(prec) @ d

    def tlogp(p):
        d = p["x"] - mt
        return -0.5 * d @ pt @ d

    return jlogp, tlogp


def _close(t, j, tol):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **tol)


def _injected(estimator, noises):
    """A ``neg_elbo(var, generator)`` for ``scan_vi`` that hands the
    estimator the next injected draw at each step instead."""
    it = iter(noises)
    return lambda var, _gen: estimator(var, next(it))


@pytest.mark.parametrize("x64", [True, False], ids=["float64", "float32"])
def test_meanfield_adam_steps_match(x64):
    dim, n_mc, steps, lr = 3, 4, 5, 2e-2
    dtype = np.float64 if x64 else np.float32
    m, _, prec = _gaussian(dim, 1, dtype)
    jlogp, tlogp = _pair(m, prec)
    key = jax.random.PRNGKey(3)
    with jax.enable_x64(x64):
        jflat, jinit, _ = jadvi.flatten_logp(jlogp, {"x": jnp.zeros(dim, dtype)})
        jbatch = jax.vmap(jflat)
        jneg = jelbo.meanfield_neg_elbo(lambda x, k: jnp.mean(jbatch(x)), dim, n_mc=n_mc,
                                        split_keys=False)
        var0 = (jinit, jnp.full((dim,), -2.0, dtype))
        (jmu, jls), jtrace = jelbo.scan_vi(jneg, var0, key=key, num_steps=steps,
                                           optimizer=optax.adam(lr))
        eps = [np.asarray(jax.random.normal(k, (n_mc, dim), dtype))
               for k in jax.random.split(key, steps)]
    tbatch = torch.func.vmap(lambda x: tlogp({"x": x}))
    tneg = telbo.meanfield_neg_elbo(lambda x, _g: torch.mean(tbatch(x)), dim, n_mc=n_mc,
                                    split_keys=False)
    tvar0 = (torch.zeros(dim, dtype=getattr(torch, dtype.__name__)),
             torch.full((dim,), -2.0, dtype=getattr(torch, dtype.__name__)))
    (tmu, tls), ttrace = telbo.scan_vi(
        _injected(tneg, [torch.tensor(e) for e in eps]), tvar0, generator=None,
        num_steps=steps, learning_rate=lr)
    tol = F64 if x64 else F32
    _close(tmu, jmu, tol)
    _close(tls, jls, tol)
    _close(ttrace, jtrace, tol)


def test_entropy_and_draws_match():
    assert telbo.gaussian_entropy(5, 0.25) == pytest.approx(float(jelbo.gaussian_entropy(5, 0.25)))
    mu, log_sd = np.array([0.5, -1.0]), np.array([-0.3, 0.2])
    with jax.enable_x64(True):
        key = jax.random.PRNGKey(0)
        jx = jelbo.meanfield_draws(jnp.asarray(mu), jnp.asarray(log_sd), key, 3)
        eps = np.asarray(jax.random.normal(key, (3, 2), jnp.float64))
    tx = telbo.meanfield_draws(torch.as_tensor(mu), torch.as_tensor(log_sd),
                               torch.as_tensor(eps), 3)
    _close(tx, jx, F64)
    with pytest.raises(ValueError, match="injected noise"):
        telbo.meanfield_draws(torch.as_tensor(mu), torch.as_tensor(log_sd),
                              torch.zeros(4, 2, dtype=torch.float64), 3)


def test_fullrank_steps_match_the_jax_fit():
    """fullrank_advi_fit's first steps, the JAX noise injected into the
    port's estimator (its key is split once per step)."""
    dim, n_mc, steps, lr = 3, 8, 4, 5e-3
    m, _, prec = _gaussian(dim, 2)
    jlogp, tlogp = _pair(m, prec)
    key = jax.random.PRNGKey(7)
    with jax.enable_x64(True):
        jres, _ = jadvi.fullrank_advi_fit(jlogp, {"x": jnp.zeros(dim)}, key=key,
                                          num_steps=steps, n_mc=n_mc, learning_rate=lr)
        eps = [torch.as_tensor(np.asarray(jax.random.normal(k, (n_mc, dim), jnp.float64)))
               for k in jax.random.split(key, steps)]
    tril = tuple(torch.tril_indices(dim, dim))
    tneg = tadvi.fullrank_neg_elbo(torch.func.vmap(lambda x: tlogp({"x": x})), dim, n_mc, tril)
    theta0 = torch.zeros(dim * (dim + 1) // 2, dtype=torch.float64)
    theta0[[0, 2, 5]] = -2.0
    (mu, theta), trace = telbo.scan_vi(_injected(tneg, eps), (torch.zeros(dim, dtype=torch.float64),
                                                              theta0),
                                       generator=None, num_steps=steps, learning_rate=lr)
    _close(mu, jres.flat_mean, F64)
    _close(tadvi._chol_from_theta(theta, dim, tril), jres.flat_chol, F64)
    _close(trace, jres.elbo_trace, F64)


def test_coupling_layer_and_logdet_match():
    rng = np.random.default_rng(4)
    d, h = 4, 6
    p = {"w1": rng.normal(size=(d, h)), "b1": rng.normal(size=h),
         "w2": 0.3 * rng.normal(size=(h, 2 * d)), "b2": 0.1 * rng.normal(size=2 * d)}
    x = rng.normal(size=(5, d))
    mask = (np.arange(d) % 2).astype(np.float64)
    with jax.enable_x64(True):
        jy, jld = jflows._coupling_forward({k: jnp.asarray(v) for k, v in p.items()},
                                           jnp.asarray(x), jnp.asarray(mask))
    ty, tld = tflows._coupling_forward({k: torch.as_tensor(v) for k, v in p.items()},
                                       torch.as_tensor(x), torch.as_tensor(mask))
    _close(ty, jy, F64)
    _close(tld, jld, F64)


def test_realnvp_steps_match_the_jax_fit():
    """realnvp_advi_fit's init and first steps: the nets' first layers
    and each step's base draws taken from the JAX keys."""
    dim, layers, hidden, n_mc, steps, lr = 3, 4, 5, 6, 3, 3e-3
    m, _, prec = _gaussian(dim, 3)
    jlogp, tlogp = _pair(m, prec)
    key = jax.random.PRNGKey(11)
    with jax.enable_x64(True):
        jres, _ = jflows.realnvp_advi_fit(jlogp, {"x": jnp.zeros(dim)}, key=key,
                                          num_layers=layers, hidden=hidden, num_steps=steps,
                                          n_mc=n_mc, learning_rate=lr)
        k_init, k_fit = jax.random.split(key)
        w1 = [np.asarray(jax.random.normal(jax.random.split(k)[0], (dim, hidden), jnp.float64))
              for k in jax.random.split(k_init, layers)]
        zs = [torch.as_tensor(np.asarray(jax.random.normal(k, (n_mc, dim), jnp.float64)))
              for k in jax.random.split(k_fit, steps)]
    shift = torch.zeros(dim, dtype=torch.float64)
    flow0 = [tflows._mlp_init(torch.as_tensor(w), dim, hidden, dim, shift) for w in w1]
    base = (torch.arange(dim) % 2).double()
    masks = torch.stack([base if i % 2 == 0 else 1.0 - base for i in range(layers)])
    tneg = tflows.flow_neg_elbo(torch.func.vmap(lambda x: tlogp({"x": x})), masks, shift, n_mc)
    flow, trace = telbo.scan_vi(_injected(tneg, zs), flow0, generator=None, num_steps=steps,
                                learning_rate=lr)
    for tp, jp in zip(flow, jres.flow_params):
        for k in tp:
            _close(tp[k], jp[k], F64)
    _close(trace, jres.elbo_trace, F64)
    _close(masks, jres.masks, F64)
    # The fitted map and its log-density, on the same base draws.
    res = tflows.FlowADVIResult(flow, masks, shift, trace, dim)
    z = np.random.default_rng(0).normal(size=(7, dim))
    with jax.enable_x64(True):
        jx, jld = jres._forward(jnp.asarray(z))
    tx, tld = res._forward(torch.as_tensor(z))
    _close(tx, jx, F64)
    _close(tld, jld, F64)


def test_realnvp_rejects_dim1():
    with pytest.raises(ValueError, match="d >= 2"):
        tflows.realnvp_advi_fit(lambda p: -p["x"] ** 2, {"x": torch.zeros(())},
                                generator=torch.Generator().manual_seed(0))


def _jax_fit_paths(jlogp, inits, eps, steps):
    """The JAX package's paths from each init, mapped as
    ``multipath_pathfinder`` maps them."""
    jflat, _, _ = jpf.flatten_logp(jlogp, {"x": inits[0]})
    return jax.jit(jax.vmap(
        lambda x0: jpf._fit_path(jflat, x0, eps, num_steps=steps, jitter=1e-6)))(inits)


@pytest.mark.parametrize("x64", [True, False], ids=["float64", "float32"])
def test_pathfinder_fits_match(x64):
    """The L-BFGS path (optax's update and zoom line search) and every
    iterate's Newton-corrected mean and windowed-BFGS covariance on a
    Gaussian target, one path and three in lockstep, with the JAX
    common random numbers; and the ELBOs scored from them."""
    dim, steps, K = 3, 8, 5
    dtype = np.float64 if x64 else np.float32
    m, _, prec = _gaussian(dim, 5, dtype)
    jlogp, tlogp = _pair(m, prec)
    rng = np.random.default_rng(1)
    inits = (2.0 * rng.normal(size=(3, dim))).astype(dtype)
    eps = rng.normal(size=(K, dim)).astype(dtype)
    with jax.enable_x64(x64):
        jout = _jax_fit_paths(jlogp, jnp.asarray(inits), jnp.asarray(eps), steps)
        jout = [tuple(np.asarray(a)[p] for a in jout) for p in range(len(inits))]
    tflat = lambda x: tlogp({"x": x})
    counter = {"evals": 0, "elbo_evals": 0, "syncs": 0}
    telbos, tmus, tcovs, tcurv = tpf._fit_paths(
        tflat, lambda v: {"x": v}, torch.as_tensor(inits), torch.as_tensor(eps),
        num_steps=steps, jitter=1e-6, counter=counter)
    tol = F64 if x64 else PF32
    for p, (jel, jmu, jcov, jcurv) in enumerate(jout):
        _close(tmus[p], jmu, tol)
        _close(tcovs[p], jcov, tol)
        assert tcurv[p].tolist() == np.asarray(jcurv).tolist()
        _close(telbos[p], jel, F64 if x64 else dict(rtol=1e-3, atol=1e-4))
    # One batched evaluation of every path per L-BFGS/line-search step,
    # and one of every ELBO draw of every point of every path.
    assert counter["elbo_evals"] == 1
    assert counter["evals"] >= steps + 1
    single = tpf._fit_paths(tflat, lambda v: {"x": v}, torch.as_tensor(inits[:1]),
                            torch.as_tensor(eps), num_steps=steps, jitter=1e-6,
                            counter={"evals": 0, "elbo_evals": 0, "syncs": 0})
    _close(single[1][0], jout[0][1], tol)


def test_pathfinder_recovers_moments_and_raises_at_a_stationary_point():
    m, cov, prec = _gaussian(2, 6)
    _, tlogp = _pair(m, prec)
    gen = torch.Generator().manual_seed(0)
    res = tpf.pathfinder(tlogp, {"x": torch.zeros(2, dtype=torch.float64)}, gen,
                         num_steps=60, num_draws=2000)
    xs = res.samples["x"].numpy()
    # tests/test_pathfinder.py:38-54's gates.
    np.testing.assert_allclose(xs.mean(0), m, atol=0.15)
    np.testing.assert_allclose(np.cov(xs.T), cov, atol=0.3 * np.abs(cov).max())
    assert float(res.elbo) > -2.0 and int(res.best_path) == 0
    multi = tpf.multipath_pathfinder(tlogp, {"x": torch.zeros(2, dtype=torch.float64)}, gen,
                                     num_paths=3, num_steps=40, num_draws=900)
    assert multi.samples["x"].shape == (900, 2)
    np.testing.assert_allclose(multi.samples["x"].numpy().mean(0), m, atol=0.2)
    with pytest.raises(ValueError, match="stationary point"):
        tpf.pathfinder(lambda p: -0.5 * torch.sum(p["x"] ** 2), {"x": torch.zeros(2)}, gen,
                       num_steps=10)


def test_advi_fits_recover_gaussians():
    """tests/test_samplers_more.py's ADVI gates at reduced lengths."""
    m, cov, prec = _gaussian(3, 4)
    _, tlogp = _pair(m.astype(np.float32), prec.astype(np.float32))
    gen = torch.Generator().manual_seed(4)
    res, unravel = tadvi.advi_fit(tlogp, {"x": torch.zeros(3)}, generator=gen, num_steps=800,
                                  n_mc=16, learning_rate=2e-2)
    np.testing.assert_allclose(res.mean["x"].numpy(), m, atol=0.15)
    want_sd = 1.0 / np.sqrt(np.diag(prec))
    np.testing.assert_allclose(res.sd["x"].numpy(), want_sd, rtol=0.25)
    elbo = res.elbo_trace.numpy()
    assert elbo[-100:].mean() > elbo[:100].mean()
    assert res.sample(gen, 10, unravel)["x"].shape == (10, 3)

    cov2 = np.array([[1.0, 0.8], [0.8, 2.0]], np.float32)
    mu2 = np.array([1.0, -0.5], np.float32)
    _, tlogp2 = _pair(mu2, np.linalg.inv(cov2))
    fr, unravel = tadvi.fullrank_advi_fit(tlogp2, {"x": torch.zeros(2)}, generator=gen,
                                          num_steps=1200, learning_rate=1e-2)
    np.testing.assert_allclose(fr.mean["x"].numpy(), mu2, atol=0.1)
    np.testing.assert_allclose(fr.covariance.numpy(), cov2, atol=0.3)
    draws = fr.sample(gen, 4000, unravel)["x"].numpy()
    np.testing.assert_allclose(np.cov(draws.T), cov2, atol=0.3)


def test_flagship_vi_matches_the_jax_model():
    """The flagship at 4 x 16 through the port's kernel path (its plain
    version here), float32: a few Adam steps of mean-field ADVI with the
    JAX noise against the JAX model's, and Pathfinder's first fits."""
    import pytensor_federated_torch as pft
    from pytensor_federated_tpu.models import linear as jlinear

    jdata, _ = jlinear.generate_node_data(4, n_obs=16, seed=123)
    jmodel = jlinear.FederatedLinearRegression(jdata)
    data, _ = pft.generate_node_data(4, n_obs=16, seed=123, device="cpu")
    model = pft.FederatedLinearRegression(data)
    (x, y), mask = data.tree()
    kern = pft.linreg_logp_grad_fn(x, y, mask)

    def tpost(p):
        return model.prior_logp(p) + kern.data_logp(p)

    n_mc, steps, key = 4, 3, jax.random.PRNGKey(2)
    jres, _ = jadvi.advi_fit(jmodel.logp, jmodel.init_params(), key=key, num_steps=steps,
                             n_mc=n_mc)
    dim = int(jres.flat_mean.shape[0])
    eps = [torch.as_tensor(np.asarray(jax.random.normal(k, (n_mc, dim))))
           for k in jax.random.split(key, steps)]
    flat, init, _ = tadvi.flatten_logp(tpost, model.init_params())
    batch = torch.func.vmap(flat)
    tneg = telbo.meanfield_neg_elbo(lambda xs, _g: torch.mean(batch(xs)), dim, n_mc=n_mc,
                                    split_keys=False)
    (mu, log_sd), trace = telbo.scan_vi(_injected(tneg, eps),
                                        (init, torch.full((dim,), -2.0)), generator=None,
                                        num_steps=steps, learning_rate=1e-2)
    _close(mu, jres.flat_mean, F32)
    _close(log_sd, jres.flat_log_sd, F32)
    _close(trace, jres.elbo_trace, dict(rtol=1e-5, atol=1e-3))


def test_doubly_stochastic_advi_with_every_shard_is_the_full_fit():
    """``stochastic_logp_fn`` over every shard (the minibatch estimate is
    then the full logp, scale 1): one step equals the deterministic fit's
    (both draw the step's Monte Carlo noise first from the generator)."""
    import pytensor_federated_torch as pft

    data, _ = pft.generate_node_data(4, n_obs=16, seed=7, device="cpu")
    model = pft.FederatedLinearRegression(data)

    def mb_logp(p, g):
        return model.prior_logp(p) + model.fed.logp_minibatch(p, g, num_shards=4)

    full, _ = tadvi.advi_fit(model.logp, model.init_params(),
                             generator=torch.Generator().manual_seed(0), num_steps=1)
    mb, _ = tadvi.advi_fit(model.logp, model.init_params(),
                           generator=torch.Generator().manual_seed(0), num_steps=1,
                           stochastic_logp_fn=mb_logp)
    _close(mb.flat_mean, full.flat_mean.numpy(), F32)
    _close(mb.flat_log_sd, full.flat_log_sd.numpy(), F32)
    _close(mb.elbo_trace, full.elbo_trace.numpy(), dict(rtol=1e-5, atol=1e-3))

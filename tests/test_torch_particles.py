"""The port's SMC, ensemble sampler, SGLD family and SBC against the JAX
package's.

The port's steps take their random numbers as arguments; the tests draw
them from the JAX package's keys exactly as its functions split them
(``smc.py:122-193``, ``ensemble.py:62-90``, ``sgld.py:104-113``) and
hand the same numbers to both.  Tolerances: float64 (the JAX side under
``jax.enable_x64``) rtol 1e-10 on particles, weights, evidence and
iterates, and exact equality of resampling indices and accept
decisions.  Whole runs are held to the JAX tests' moment and uniformity
gates (tests/test_samplers_more.py, tests/test_sgld.py,
tests/test_sbc.py) at reduced lengths.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytensor_federated_tpu.samplers import ensemble as jens
from pytensor_federated_tpu.samplers import sbc as jsbc
from pytensor_federated_tpu.samplers import sgld as jsgld
from pytensor_federated_tpu.samplers import smc as jsmc
from pytensor_federated_torch.parallel.sharded import FederatedLogp
from pytensor_federated_torch.samplers import ensemble as tens
from pytensor_federated_torch.samplers import sbc as tsbc
from pytensor_federated_torch.samplers import sgld as tsgld
from pytensor_federated_torch.samplers import smc as tsmc
from pytensor_federated_torch.utils import value_and_grad

F64 = dict(rtol=1e-10, atol=1e-12)


def _gaussian(dim, seed):
    rng = np.random.default_rng(seed)
    m = rng.normal(size=dim)
    a = rng.normal(size=(dim, dim))
    cov = a @ a.T + dim * np.eye(dim)
    return m, cov, np.linalg.inv(cov)


def _pair(m, prec):
    """The same Gaussian logp in both packages; the JAX constants are
    converted at each call, so under ``jax.enable_x64`` they stay float64."""
    mt, pt = torch.as_tensor(m), torch.as_tensor(prec)

    def jlogp(p):
        d = p["x"] - jnp.asarray(m)
        return -0.5 * d @ jnp.asarray(prec) @ d

    def tlogp(p):
        d = p["x"] - mt.to(p["x"].dtype)
        return -0.5 * d @ pt.to(p["x"].dtype) @ d

    return jlogp, tlogp


def _np(a):
    return np.asarray(a.detach().numpy() if isinstance(a, torch.Tensor) else a)


def _t(a):
    return torch.tensor(np.asarray(a))


def test_systematic_resample_and_ess_match():
    rng = np.random.default_rng(0)
    log_w = rng.normal(size=64) * 2.0
    with jax.enable_x64(True):
        key = jax.random.PRNGKey(5)
        jidx = jsmc._systematic_resample(key, jnp.asarray(log_w), 64)
        u = jax.random.uniform(key, dtype=jnp.float64)
        jess = jsmc._ess(jnp.asarray(log_w))
    assert _np(tsmc._systematic_indices(_t(u), _t(log_w), 64)).tolist() == _np(jidx).tolist()
    np.testing.assert_allclose(float(tsmc._ess(_t(log_w))), float(jess), **F64)


def test_smc_stage_matches_the_jax_sampler():
    """One tempering stage (bisection, evidence increment, resampling,
    two mutations) from the JAX key stream: the JAX sampler with
    ``max_stages=1`` against the port's ``_stage``."""
    m, _, prec = _gaussian(3, 1)
    jlogp, tlogp = _pair(m, prec)
    n, n_mut, jitter, scale = 256, 2, 3.0, 0.5
    key = jax.random.PRNGKey(0)
    with jax.enable_x64(True):
        jres = jsmc.smc_sample(jlogp, {"x": jnp.zeros(3)}, key=key, n_particles=n,
                               n_mutations=n_mut, max_stages=1, init_jitter=jitter,
                               step_scale=scale)
        k_init, k_loop = jax.random.split(key)
        x0 = jitter * jax.random.normal(k_init, (n, 3), jnp.float64)
        k_res, k_mut, _ = jax.random.split(k_loop, 3)
        u_res = jax.random.uniform(k_res, dtype=jnp.float64)
        draws = []
        for kk in jax.random.split(k_mut, n_mut):
            k1, k2 = jax.random.split(kk)
            draws.append((_t(jax.random.normal(k1, (n, 3), jnp.float64)),
                          _t(jax.random.uniform(k2, (n,), dtype=jnp.float64))))
        x0, u_res = _t(x0), _t(u_res)
    batch = torch.func.vmap(lambda x: tlogp({"x": x}))
    log_q0 = tsmc.make_log_q0(x0)
    zero = torch.zeros((), dtype=torch.float64)
    (x, lp, lq, beta, log_z), acc = tsmc._stage(batch, log_q0, (x0, batch(x0), log_q0(x0), zero,
                                                                zero), 0.5 * n, scale, u_res, draws)
    np.testing.assert_allclose(_np(x), _np(jres.samples["x"]), **F64)
    np.testing.assert_allclose(float(beta), float(jres.final_beta), **F64)
    np.testing.assert_allclose(float(log_z), float(jres.log_evidence), **F64)
    np.testing.assert_allclose(float(acc), float(jres.accept_rate), **F64)


def test_stretch_move_matches_the_jax_sampler():
    """One ensemble step (both half-ensembles) from the JAX key stream."""
    m, _, prec = _gaussian(3, 3)
    jlogp, tlogp = _pair(m, prec)
    W, half, jitter, a = 16, 8, 0.7, 2.0
    key = jax.random.PRNGKey(2)
    with jax.enable_x64(True):
        jres = jens.ensemble_sample(jlogp, {"x": jnp.zeros(3)}, key=key, n_walkers=W,
                                    num_warmup=0, num_samples=1, init_jitter=jitter,
                                    stretch_a=a)
        k_init, k_run = jax.random.split(key)
        x0 = _t(jitter * jax.random.normal(k_init, (W, 3), jnp.float64))
        halves = []
        for k in jax.random.split(jax.random.split(k_run, 1)[0]):
            k_z, k_c, k_u = jax.random.split(k, 3)
            halves.append((_t(jax.random.uniform(k_z, (half,), dtype=jnp.float64)),
                           _t(jax.random.randint(k_c, (half,), 0, half)),
                           _t(jax.random.uniform(k_u, (half,), dtype=jnp.float64))))
    batch = torch.func.vmap(lambda x: tlogp({"x": x}))
    lp0 = batch(x0)
    pa, pa_lp, acc_a = tens._stretch_move(batch, x0[:half], lp0[:half], x0[half:], *halves[0], a)
    pb, pb_lp, acc_b = tens._stretch_move(batch, x0[half:], lp0[half:], pa, *halves[1], a)
    np.testing.assert_allclose(_np(torch.cat([pa, pb])), _np(jres.samples["x"][0]), **F64)
    np.testing.assert_allclose(_np(torch.cat([pa_lp, pb_lp])), _np(jres.logps[0]), **F64)
    np.testing.assert_allclose(float(0.5 * (acc_a + acc_b)), float(jres.accept_rate), **F64)


def _oracles(m, prec):
    jlogp, tlogp = _pair(m, prec)
    return ((lambda p, _k: jax.value_and_grad(jlogp)(p)),
            (lambda p, _g: value_and_grad(tlogp, p)))


@pytest.mark.parametrize("name", ["sgld", "psgld", "sghmc"])
def test_langevin_steps_match_the_jax_samplers(name):
    """Two steps of each sampler from the JAX key stream (the chain key
    split into carry, oracle and noise keys each step)."""
    m, _, prec = _gaussian(2, 4)
    joracle, toracle = _oracles(m, prec)
    x0 = np.array([0.3, -0.2])
    eps = 0.05
    key = jax.random.PRNGKey(8)
    with jax.enable_x64(True):
        kw = dict(num_samples=3, num_burnin=0, step_size=eps)
        if name == "psgld":
            jres = jsgld.psgld_sample(joracle, {"x": jnp.asarray(x0)}, key, beta=0.9, **kw)
            key, _ = jax.random.split(key)
        elif name == "sghmc":
            jres = jsgld.sghmc_sample(joracle, {"x": jnp.asarray(x0)}, key, friction=1.5, **kw)
        else:
            jres = jsgld.sgld_sample(joracle, {"x": jnp.asarray(x0)}, key, **kw)
        zs, k = [], key
        for _ in range(2):
            k, _, k_noise = jax.random.split(k, 3)
            zs.append(_t(jax.random.normal(k_noise, (2,), jnp.float64)))
    x = torch.tensor(x0)
    g = lambda x: toracle({"x": x}, None)[1]["x"]
    carry = {"sgld": (x,), "psgld": (x, g(x) ** 2), "sghmc": (x, torch.zeros_like(x))}[name]
    step = {"sgld": tsgld.sgld_step,
            "psgld": lambda c, gr, e, z: tsgld.psgld_step(c, gr, e, z, beta=0.9),
            "sghmc": lambda c, gr, e, z: tsgld.sghmc_step(c, gr, e, z, friction=1.5)}[name]
    xs = [carry[0]]
    for z in zs:
        carry = step(carry, g(carry[0]), torch.tensor(eps, dtype=torch.float64), z)
        xs.append(carry[0])
    np.testing.assert_allclose(_np(torch.stack(xs)), _np(jres.samples["x"]), **F64)


def test_polynomial_decay_matches():
    t = np.arange(5)
    np.testing.assert_allclose(_np(tsgld.polynomial_decay(2e-3)(torch.tensor(t))),
                               _np(jsgld.polynomial_decay(2e-3)(jnp.asarray(t))), rtol=1e-6)


def test_sbc_uniformity_matches_and_rejects_a_u_shape():
    rng = np.random.default_rng(0)
    levels = 33
    good = rng.integers(0, levels, size=(128, 2))
    bad = np.where(rng.uniform(size=128) < 0.5, rng.integers(0, 4, size=128),
                   rng.integers(levels - 4, levels, size=128))[:, None]
    for ranks in (good, bad):
        t = tsbc.sbc_uniformity(tsbc.SBCResult(torch.tensor(ranks), levels, ["mu"]))
        j = jsbc.sbc_uniformity(jsbc.SBCResult(jnp.asarray(ranks), levels, ["mu"]))
        np.testing.assert_allclose(t[0], j[0], rtol=1e-12)
        assert t[1] == j[1]
    stats, dof = t
    assert stats[0] > dof + 4.0 * np.sqrt(2.0 * dof)  # tests/test_sbc.py:54's negative control


N_OBS = 16


def _sbc_model():
    def prior_sample(gen):
        return {"mu": torch.randn((), generator=gen)}

    def simulate(gen, params):
        return params["mu"] + torch.randn((N_OBS,), generator=gen)

    def logp(params, data):
        mu = params["mu"]
        return -0.5 * mu**2 - 0.5 * torch.sum((data - mu) ** 2)

    return prior_sample, simulate, logp


def test_sbc_calibrated_sampler_passes_uniformity():
    """tests/test_sbc.py's positive control at 64 simulations, every
    simulation one chain of one lockstep batch."""
    counter = {}
    res = tsbc.sbc_ranks(*_sbc_model(), generator=torch.Generator().manual_seed(0), n_sims=64,
                         num_warmup=100, num_samples=64, thin=2, max_depth=4, counter=counter)
    assert res.ranks.shape == (64, 1) and res.n_levels == 33
    assert int(res.ranks.min()) >= 0 and int(res.ranks.max()) <= 32
    assert res.param_names == ["['mu']"]
    stats, dof = tsbc.sbc_uniformity(res)
    assert stats[0] < dof + 4.0 * np.sqrt(2.0 * dof), stats
    assert counter["evals"] > 164  # a batched evaluation per leaf, not per simulation
    with pytest.raises(ValueError, match="no draws"):
        tsbc.sbc_ranks(*_sbc_model(), generator=torch.Generator(), num_samples=2, thin=4)


def test_smc_and_ensemble_runs_meet_the_jax_gates():
    """tests/test_samplers_more.py's SMC and ensemble gates at reduced
    lengths, float32."""
    m, cov, prec = _gaussian(3, 1)
    _, tlogp = _pair(m, prec)
    gen = torch.Generator().manual_seed(0)
    res = tsmc.smc_sample(tlogp, {"x": torch.zeros(3)}, generator=gen, n_particles=2048,
                          n_mutations=8, init_jitter=3.0)
    assert float(res.final_beta) == 1.0 and int(res.n_stages) < 50
    assert res.host_syncs == int(res.n_stages) + 1
    xs = res.samples["x"].numpy()
    np.testing.assert_allclose(xs.mean(0), m, atol=0.25)
    np.testing.assert_allclose(np.cov(xs.T), cov, atol=0.2 * np.abs(cov).max() + 0.3)
    want_log_z = 0.5 * 3 * np.log(2 * np.pi) + 0.5 * np.linalg.slogdet(cov)[1]
    assert abs(float(res.log_evidence) - want_log_z) < 0.5
    assert 0.05 < float(res.accept_rate) <= 1.0

    m, cov, prec = _gaussian(3, 3)
    _, tlogp = _pair(m, prec)
    ens = tens.ensemble_sample(tlogp, {"x": torch.zeros(3)}, generator=gen, n_walkers=64,
                               num_warmup=600, num_samples=600, init_jitter=1.0)
    xs = ens.samples["x"].reshape(-1, 3).numpy()
    np.testing.assert_allclose(xs.mean(0), m, atol=0.3)
    np.testing.assert_allclose(xs.std(0), np.sqrt(np.diag(cov)), rtol=0.35)
    assert 0.1 < float(ens.accept_rate) < 0.9
    with pytest.raises(ValueError, match="even"):
        tens.ensemble_sample(tlogp, {"x": torch.zeros(3)}, generator=gen, n_walkers=7)
    with pytest.raises(ValueError, match="2\\*dim"):
        tens.ensemble_sample(tlogp, {"x": torch.zeros(3)}, generator=gen, n_walkers=4)


def test_langevin_runs_meet_the_jax_gates():
    """tests/test_sgld.py's Gaussian gates on the pooled draws of 4
    independent chains run as one (the targets factorize and every
    update is elementwise, so the chains never interact), each a quarter
    of the JAX test's draws after its full burn-in; and the federated
    minibatch SGLD on its quadratic."""
    chains = 4

    def oracle(mu, var):
        """The Gaussian's value and gradient in closed form (cheaper per
        step than an autograd pass)."""

        def lg(p, _g):
            r = (p["x"] - mu) / var
            return -0.5 * torch.sum(r * (p["x"] - mu)), {"x": -r}

        return lg

    # One generator per run, seeded as the JAX tests seed their keys.
    gen = lambda seed: torch.Generator().manual_seed(seed)
    z = torch.zeros(chains, 2)
    res = tsgld.sgld_sample(oracle(2.0, 0.25), {"x": z}, gen(0), num_samples=1000,
                            num_burnin=1000, step_size=0.01, thin=2)
    xs = res.samples["x"].reshape(-1, 2).numpy()
    np.testing.assert_allclose(xs.mean(0), [2.0, 2.0], atol=0.1)
    np.testing.assert_allclose(xs.var(0), [0.25, 0.25], rtol=0.25)
    res = tsgld.sghmc_sample(oracle(-1.0, 0.5), {"x": z}, gen(5), num_samples=750,
                             num_burnin=500, step_size=0.05, friction=2.0, thin=3)
    xs = res.samples["x"].reshape(-1, 2).numpy()
    np.testing.assert_allclose(xs.mean(0), [-1.0, -1.0], atol=0.1)
    np.testing.assert_allclose(xs.var(0), [0.5, 0.5], rtol=0.25)
    scales = torch.tensor([3.0, 0.1]).expand(chains, 2)
    res = tsgld.psgld_sample(
        lambda p, _g: (-0.5 * torch.sum((p["x"] / scales) ** 2), {"x": -p["x"] / scales**2}),
        {"x": scales.clone()}, gen(6), num_samples=1000, num_burnin=2000,
        step_size=0.02, beta=0.999, thin=3)
    xs = res.samples["x"].reshape(-1, 2).numpy()
    sd = xs.std(0)
    np.testing.assert_allclose(sd, [3.0, 0.1], rtol=0.45)
    assert all(abs(xs[:, i].mean()) < 0.4 * sd[i] for i in range(2))

    data = torch.tensor(np.random.default_rng(0).normal(size=(16, 8)).astype(np.float32))
    fed = FederatedLogp(lambda params, shard: -0.5 * torch.sum((shard - params["mu"]) ** 2), data)
    res = tsgld.sgld_sample(lambda p, g: fed.logp_and_grad_minibatch(p, g, num_shards=4),
                            {"mu": torch.tensor(0.0)}, gen(4), num_samples=1500, num_burnin=800,
                            step_size=tsgld.polynomial_decay(a=2e-3, gamma=0.55))
    assert abs(float(res.samples["mu"].mean()) - float(data.mean())) < 0.05
    assert bool(torch.isfinite(res.logps).all())

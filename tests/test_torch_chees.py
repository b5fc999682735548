"""The port's ChEES-HMC against the JAX package's ``samplers/chees.py``.

The Halton jitter must equal the JAX package's bit for bit (float32,
each bit times its power of two, summed: exact below 2^24); Adam on the
trajectory length agrees with JAX's in float64 at rtol 1e-12.  Whole
runs use different generators, so they agree in distribution: on the
flagship posterior, 16 chains x 150 warmup + 150 draws with jitter 0.1
(bench_suite.py's config 9 setting), every posterior mean within 4
combined Monte Carlo standard errors of JAX's run.  ``num_warmup=0``
falls back to the probed step size, and every result has JAX's shapes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytensor_federated_tpu.models.linear import (
    FederatedLinearRegression as JaxModel,
    generate_node_data as jax_generate,
)
from pytensor_federated_tpu.samplers import chees as jchees
from pytensor_federated_tpu.samplers import convergence as jconv
import pytensor_federated_torch as pft
from pytensor_federated_torch.samplers import chees as tchees
from pytensor_federated_torch.samplers import convergence as tconv


@pytest.fixture(scope="module")
def flagship():
    jdata, _ = jax_generate(8, n_obs=64, seed=123)
    tdata, _ = pft.generate_node_data(8, n_obs=64, seed=123, device="cpu")
    return JaxModel(jdata), pft.FederatedLinearRegression(tdata)


def test_halton_matches_jax_exactly():
    """Every index to 70,000, including each multiple of 2^16 (where a
    16-bit radical inverse would return 0)."""
    idx = np.arange(70_001)
    want = np.asarray(jax.vmap(jchees._halton)(jnp.asarray(idx, jnp.int32)))
    got = tchees._halton(torch.as_tensor(idx)).numpy()
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert float(tchees._halton(2**16 - 1)) > 0.0 and got.min() > 0.0 and got.max() < 1.0
    assert float(tchees._halton(5)) == float(jchees._halton(jnp.int32(5)))


def test_adam_update_matches_jax():
    grads = np.random.default_rng(0).normal(size=50) * np.logspace(-3, 2, 50)
    with jax.enable_x64(True):
        js = jchees._adam_init()
        ts = tchees._adam_init(torch.float64)
        for g in grads:
            js, jstep = jchees._adam_update(js, jnp.float64(g))
            ts, tstep = tchees._adam_update(ts, torch.tensor(g, dtype=torch.float64))
            np.testing.assert_allclose(float(tstep), float(jstep), rtol=1e-12)
        for a, b in zip(ts, js):
            np.testing.assert_allclose(float(a), float(b), rtol=1e-12)


def test_chees_sample_agrees_with_jax(flagship):
    jm, tm = flagship
    kw = dict(num_warmup=150, num_samples=150, num_chains=16, jitter=0.1)
    jres = jchees.chees_sample(jm.logp, jm.init_params(), key=jax.random.PRNGKey(0), **kw)
    tres = pft.samplers.chees_sample(
        tm.logp, tm.init_params(), generator=torch.Generator().manual_seed(0), **kw
    )
    jsum, tsum = jconv.summary(jres.samples), tconv.summary(tres.samples)
    for k in jsum["mean"]:
        jmcse = np.asarray(jsum["sd"][k]) / np.sqrt(np.asarray(jsum["ess"][k]))
        tmcse = tsum["sd"][k].numpy() / np.sqrt(tsum["ess"][k].numpy())
        diff = np.abs(tsum["mean"][k].numpy() - np.asarray(jsum["mean"][k]))
        assert np.all(diff <= 4 * np.sqrt(jmcse**2 + tmcse**2)), k
    assert all(bool(torch.isfinite(v).all()) for v in tres.samples.values())
    # The adapted trajectory spans several leapfrog steps in both.
    assert float(tres.stats["n_steps"].float().mean()) > 2


def test_num_warmup_zero_falls_back_and_shapes_match_jax(flagship):
    """With no warmup the step size is the probed one (a power of two,
    shared by every chain), the mass is unit, and every field of the
    result has the JAX package's shape."""
    jm, tm = flagship
    kw = dict(num_warmup=0, num_samples=6, num_chains=4)
    jres = jchees.chees_sample(jm.logp, jm.init_params(), key=jax.random.PRNGKey(1), **kw)
    tres = pft.samplers.chees_sample(
        tm.logp, tm.init_params(), generator=torch.Generator().manual_seed(1), **kw
    )
    step = float(tres.step_size[0])
    assert step > 0 and np.log2(step) == round(np.log2(step))
    assert torch.all(tres.step_size == step)
    assert torch.equal(tres.inv_mass, torch.ones(4, 11))
    assert {k: tuple(v.shape) for k, v in tres.samples.items()} == {
        k: tuple(v.shape) for k, v in jres.samples.items()}
    assert {k: tuple(v.shape) for k, v in tres.stats.items()} == {
        k: tuple(v.shape) for k, v in jres.stats.items()}
    assert tres.step_size.shape == jres.step_size.shape
    assert tres.inv_mass.shape == jres.inv_mass.shape
    assert tres.stats["n_steps"].dtype == torch.int32

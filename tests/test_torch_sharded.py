"""The rest of the port's ``FederatedLogp`` without a mesh: minibatch
estimators, ``sharded_compute`` and ``remat``, against the JAX package.

The minibatch RNG streams differ between the frameworks, so the
estimator is held on exact enumeration of its unbiasedness: the mean of
the ``S/k``-scaled estimates over all ``C(S, k)`` subsets equals
``logp`` (rtol 1e-6, float32 sums).  ``sharded_compute`` agrees with the
JAX package's at ``mesh=None`` to rtol 1e-6; ``remat=True`` changes
neither the value nor the gradient (bitwise: the same operations run).
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytensor_federated_tpu.models import glm as jglm
from pytensor_federated_tpu.parallel.sharded import (
    FederatedLogp as JaxFederatedLogp,
    sharded_compute as jax_sharded_compute,
)
import pytensor_federated_torch as pft
from pytensor_federated_torch.parallel.sharded import FederatedLogp
from pytensor_federated_torch.utils import value_and_grad


@pytest.fixture(scope="module")
def radon5():
    data, _ = pft.generate_radon_data(5, mean_obs=7, seed=4, device="cpu")
    model = pft.HierarchicalRadonGLM(data)
    rng = np.random.default_rng(0)
    params = {k: v + torch.tensor(0.3 * rng.normal(size=tuple(v.shape)), dtype=torch.float32)
              for k, v in model.init_params().items()}
    return model, params


def test_minibatch_is_unbiased_by_enumeration(radon5):
    model, params = radon5
    fed = model.fed
    S, k = fed.n_shards, 2
    estimates = [
        float(fed._minibatch_estimate(params, torch.tensor(idx)))
        for idx in itertools.combinations(range(S), k)
    ]
    assert len(estimates) == 10
    np.testing.assert_allclose(np.mean(estimates), float(fed.logp(params)), rtol=1e-6)


def test_minibatch_draws_k_distinct_shards(radon5):
    model, params = radon5
    fed = model.fed
    per_shard = fed.per_shard_logps(params)
    gen = torch.Generator().manual_seed(3)
    for _ in range(5):
        idx = fed._draw_shards(gen, 3)
        assert len(set(idx.tolist())) == 3 and all(0 <= i < 5 for i in idx.tolist())
    gen = torch.Generator().manual_seed(3)
    idx = fed._draw_shards(gen, 3)
    gen = torch.Generator().manual_seed(3)
    got = fed.logp_minibatch(params, gen, 3)
    np.testing.assert_allclose(float(got), float(per_shard[idx].sum()) * 5 / 3, rtol=1e-6)


def test_minibatch_over_every_shard_is_the_full_logp_and_grad(radon5):
    model, params = radon5
    v, g = model.fed.logp_and_grad_minibatch(params, torch.Generator().manual_seed(1), 5)
    v_full, g_full = model.fed.logp_and_grad(params)
    np.testing.assert_allclose(float(v), float(v_full), rtol=1e-6)
    for name in g_full:
        np.testing.assert_allclose(g[name].numpy(), g_full[name].numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("k", [0, 6, -1])
def test_minibatch_range_errors_match_jax(radon5, k):
    model, params = radon5
    jdata, _ = jglm.generate_radon_data(5, mean_obs=7, seed=4)
    jfed = jglm.HierarchicalRadonGLM(jdata).fed
    with pytest.raises(ValueError) as jerr:
        jfed.logp_minibatch({}, jax.random.PRNGKey(0), k)
    with pytest.raises(ValueError) as terr:
        model.fed.logp_minibatch(params, torch.Generator(), k)
    assert str(terr.value) == str(jerr.value)


def test_sharded_compute_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(6, 10, 3)).astype(np.float32)
    m = (rng.uniform(size=(6, 10)) > 0.3).astype(np.float32)
    w = rng.normal(size=3).astype(np.float32)

    def j_fn(params, shard):
        x, m = shard
        eta = x @ params["w"]
        return {"sum": jnp.sum(eta * m), "eta": eta * m}

    def t_fn(params, shard):
        x, m = shard
        eta = x @ params["w"]
        return {"sum": torch.sum(eta * m), "eta": eta * m}

    want = jax_sharded_compute(j_fn, (jnp.asarray(x), jnp.asarray(m)))({"w": jnp.asarray(w)})
    got = pft.sharded_compute(t_fn, (torch.from_numpy(x), torch.from_numpy(m)))({"w": torch.from_numpy(w)})
    assert got["sum"].shape == (6,) and got["eta"].shape == (6, 10)
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=1e-6, atol=1e-6)


def test_sharded_compute_rejects_ragged_leading_axes():
    with pytest.raises(ValueError, match="leading shard axis"):
        pft.sharded_compute(lambda p, d: d, (torch.zeros(3, 2), torch.zeros(4)))


def test_remat_gives_the_same_value_and_gradient(radon5):
    model, params = radon5
    calls = []

    def counted(p, shard):
        calls.append(1)
        return model.fed.per_shard_logp(p, shard)

    remat = FederatedLogp(counted, model.fed.data, remat=True)
    v0, g0 = value_and_grad(model.fed.logp, params)
    v1, g1 = value_and_grad(remat.logp, params)
    assert len(calls) == 2  # the backward pass ran the shard map again
    assert torch.equal(v0, v1)
    for name in g0:
        assert torch.equal(g0[name], g1[name])


def test_remat_matches_jax_remat():
    jdata, _ = jglm.generate_radon_data(5, mean_obs=7, seed=4)
    jm = jglm.HierarchicalRadonGLM(jdata)
    jfed = JaxFederatedLogp(jm.fed.per_shard_logp, jm.fed.data, remat=True)
    model = pft.HierarchicalRadonGLM(pft.generate_radon_data(5, mean_obs=7, seed=4, device="cpu")[0])
    fed = FederatedLogp(model.fed.per_shard_logp, model.fed.data, remat=True)
    p = {k: np.asarray(v) + np.float32(0.05) for k, v in jm.init_params().items()}
    jv, jg = jfed.logp_and_grad({k: jnp.asarray(v) for k, v in p.items()})
    tv, tg = fed.logp_and_grad(pft.params_from_jax(p, device="cpu"))
    np.testing.assert_allclose(float(tv), float(jv), rtol=1e-5)
    for name in jg:
        np.testing.assert_allclose(tg[name].numpy(), np.asarray(jg[name]), rtol=1e-4, atol=1e-5)

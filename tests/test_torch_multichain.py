"""The port's chains x shards mesh (``parallel/multichain.py``) and the
samplers' ``chain_sharding`` / ``temp_sharding``, against the JAX
package's on its 8-device CPU mesh (``tests/conftest.py``'s ``devices8``).

- On a ``{"chains": 2, "shards": 4}`` mesh of ``[cpu] * 8``, each
  chain's logp+grad equals the JAX mesh's (``FederatedLogp`` over 4
  devices, plus the prior) at rtol 1e-12 in float64 under x64.
- The first NUTS and HMC transition equals the JAX package's
  ``multichain_sample`` transition with the JAX run's initial points and
  draws injected (rtol 1e-9 in float64: a trajectory of up to 64
  leapfrog steps).
- Whole runs agree with the JAX package's in distribution: posterior
  means within 4 combined Monte Carlo standard errors.
- Shapes and error texts match; ``sample``'s and ``chees_sample``'s
  ``chain_sharding`` and ``pt_sample``'s ``temp_sharding`` give the
  unsharded run's draws bit for bit here, and refuse what the JAX
  package refuses with its texts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree
from jax.sharding import NamedSharding as JNamedSharding
from jax.sharding import PartitionSpec as P

from pytensor_federated_tpu.parallel import make_mesh as jax_make_mesh
from pytensor_federated_tpu.parallel.multichain import multichain_sample as jax_multichain
from pytensor_federated_tpu.parallel.sharded import FederatedLogp as JFederatedLogp
from pytensor_federated_tpu.samplers.mcmc import sample as jax_sample
from pytensor_federated_tpu.samplers.tempering import pt_sample as jax_pt_sample
import pytensor_federated_torch as pft
from pytensor_federated_torch.parallel.mesh import NamedSharding, make_mesh
from pytensor_federated_torch.parallel.multichain import (
    multichain_logp_and_grad,
    multichain_sample,
)
from pytensor_federated_torch.samplers import hmc as thmc
from pytensor_federated_torch.samplers import nuts as tnuts
from pytensor_federated_torch.samplers.chees import chees_sample
from pytensor_federated_torch.samplers.tempering import pt_sample
from pytensor_federated_torch.samplers.util import ravel

LOG_2PI = float(np.log(2 * np.pi))
N_SHARDS, N_OBS = 8, 24
RTOL64 = 1e-12
STEP_RTOL = 1e-9
CPU8 = [torch.device("cpu")] * 8
MAX_DEPTH = 6


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


def _jax_prior(params):
    return sum(-0.5 * jnp.sum(v**2) for v in params.values())


def _torch_prior(params):
    return sum(-0.5 * torch.sum(v**2) for v in params.values())


@pytest.fixture(scope="module")
def flagship64():
    """The flagship's data at 8 x 24 and the initial point, float64
    numpy: ``(((x, y), mask, sid), params)``."""
    data, _ = pft.generate_node_data(N_SHARDS, n_obs=N_OBS, seed=5, device="cpu")
    (x, y), mask = data.tree()
    tree = ((x.double().numpy(), y.double().numpy()), mask.double().numpy(),
            np.arange(N_SHARDS))
    params = {"intercept": np.float64(1.3), "slope": np.float64(1.9),
              "log_sigma": np.float64(-0.6), "offsets": np.zeros(N_SHARDS)}
    return tree, params


def _torch_tree(tree):
    return tuple(_torch_tree(t) if isinstance(t, tuple) else torch.as_tensor(t) for t in tree)


def _jax_tree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


@pytest.fixture(scope="module")
def meshes(devices8):
    return (jax_make_mesh({"chains": 2, "shards": 4}, devices=devices8),
            make_mesh({"chains": 2, "shards": 4}, devices=CPU8))


def test_per_chain_logp_and_grad_equals_the_jax_mesh(flagship64, meshes, devices8):
    tree, params = flagship64
    _, tmesh = meshes
    flat0, unravel = ravel({k: torch.as_tensor(v) for k, v in params.items()})
    lg = multichain_logp_and_grad(_torch_shard, _torch_tree(tree), unravel, mesh=tmesh,
                                  prior_logp=_torch_prior)
    X = flat0 + 0.1 * torch.as_tensor(np.random.default_rng(3).normal(size=(4, flat0.shape[0])))
    v, g = lg(X)
    assert v.shape == (4,) and g.shape == X.shape
    with jax.enable_x64(True):
        jmesh = jax_make_mesh({"shards": 4}, devices=devices8[:4])
        fed = JFederatedLogp(_jax_shard, _jax_tree(tree), mesh=jmesh)
        _, junravel = ravel_pytree(_jax_tree(params))
        for c in range(4):
            p = junravel(jnp.asarray(X[c].numpy()))
            jv, jg = fed.logp_and_grad(p)
            pv, pg = jax.value_and_grad(_jax_prior)(p)
            want_g = ravel_pytree(jax.tree_util.tree_map(jnp.add, jg, pg))[0]
            np.testing.assert_allclose(float(v[c]), float(jv + pv), rtol=RTOL64)
            np.testing.assert_allclose(g[c].numpy(), np.asarray(want_g), rtol=RTOL64, atol=1e-9)


def _jax_first_transition_draws(key, n_chains, dim, kernel, dtype):
    """The draws the JAX package's ``multichain_sample`` (no warmup, one
    sample) takes for its first transition: its initial normals, and per
    chain the momentum and accept (HMC) or tree (NUTS) draws, as the JAX
    kernels split their keys."""
    k_init, k_run = jax.random.split(key)
    init = jax.random.normal(k_init, (n_chains, dim), dtype)
    out = []
    for chain_key in jax.random.split(k_run, n_chains):
        step_key = jax.random.split(chain_key, 1)[0]
        k_mom, k_rest = jax.random.split(step_key)
        z = jax.random.normal(k_mom, (dim,), dtype)
        if kernel == "hmc":
            out.append((z, jax.random.uniform(k_rest, dtype=dtype)))
            continue
        go_right, u_merge = [], []
        u_leaf = np.zeros(2**MAX_DEPTH - 1)
        key = k_rest
        for j in range(MAX_DEPTH):
            key, k_dir, k_sub, k_comb = jax.random.split(key, 4)
            go_right.append(bool(jax.random.bernoulli(k_dir)))
            u_merge.append(float(jax.random.uniform(k_comb, dtype=dtype)))
            for k in range(2**j):
                k_sub, k_sel = jax.random.split(k_sub)
                u_leaf[2**j - 1 + k] = float(jax.random.uniform(k_sel, dtype=dtype))
        out.append((z, np.array(go_right), u_leaf, np.array(u_merge)))
    return np.asarray(init), out


@pytest.mark.parametrize("kernel", ["nuts", "hmc"])
def test_first_transition_equals_jax_on_injected_draws(flagship64, meshes, kernel):
    tree, params = flagship64
    jmesh, tmesh = meshes
    step, jitter, n_hmc = 0.01, 0.5, 8
    with jax.enable_x64(True):
        key = jax.random.PRNGKey(7)
        draws, _, _ = jax_multichain(
            _jax_shard, _jax_tree(tree), _jax_tree(params), mesh=jmesh, key=key,
            num_samples=1, step_size=step, kernel=kernel, max_depth=MAX_DEPTH,
            num_hmc_steps=n_hmc, prior_logp=_jax_prior, jitter=jitter)
        flat0, _ = ravel_pytree(_jax_tree(params))
        init, chain_draws = _jax_first_transition_draws(key, 2, flat0.shape[0], kernel,
                                                        jnp.float64)
    tflat0, unravel = ravel({k: torch.as_tensor(v) for k, v in params.items()})
    x0 = tflat0 + jitter * torch.as_tensor(init)
    lg = multichain_logp_and_grad(_torch_shard, _torch_tree(tree), unravel, mesh=tmesh,
                                  prior_logp=_torch_prior)
    state = thmc.hmc_init(lg, x0)
    inv_mass = torch.ones(x0.shape[1], dtype=torch.float64)
    stacked = [torch.as_tensor(np.stack([np.asarray(d[i]) for d in chain_draws]))
               for i in range(len(chain_draws[0]))]
    if kernel == "hmc":
        new, _ = thmc.hmc_step(lg, state, None, step_size=step, inv_mass=inv_mass,
                               num_steps=n_hmc, z=stacked[0], u=stacked[1])
    else:
        new, _ = tnuts.nuts_step(lg, state, None, step_size=step, inv_mass=inv_mass,
                                 max_depth=MAX_DEPTH, draws=tnuts.NUTSDraws(*stacked))
    np.testing.assert_allclose(new.x.numpy(), np.asarray(draws)[:, 0], rtol=STEP_RTOL,
                               atol=1e-12)


def _mu_shard_jax(params, shard):
    return jnp.sum(-0.5 * (shard - params["mu"]) ** 2)


def _mu_shard_torch(params, shard):
    return torch.sum(-0.5 * (shard - params["mu"]) ** 2)


def _means_and_mcse(draws):
    """Per-parameter mean over chains and draws, and its Monte Carlo
    standard error from the port's ESS."""
    d = torch.as_tensor(np.asarray(draws, dtype=np.float64))
    ess = pft.samplers.effective_sample_size({"x": d})["x"]
    return d.mean(dim=(0, 1)), d.std(dim=(0, 1)) / torch.sqrt(ess)


def test_whole_runs_agree_with_jax_in_moments(meshes, dense_mass=True):
    """Warmup with a dense mass and NUTS on the JAX multichain test's
    Gaussian: means within 4 combined MCSEs of the JAX run's."""
    jmesh, tmesh = meshes
    data = np.random.default_rng(1).normal(2.0, 1.0, size=(4, 32)).astype(np.float32)
    kw = dict(num_samples=120, num_warmup=100, kernel="nuts", jitter=0.2, dense_mass=dense_mass)
    jd, jacc, _ = jax_multichain(_mu_shard_jax, jnp.asarray(data), {"mu": jnp.zeros(())},
                                 mesh=jmesh, key=jax.random.PRNGKey(3), **kw)
    td, tacc, unravel = multichain_sample(_mu_shard_torch, torch.as_tensor(data),
                                          {"mu": torch.zeros(())}, mesh=tmesh,
                                          generator=torch.Generator().manual_seed(3), **kw)
    assert td.shape == tuple(jd.shape) == (2, 120, 1) and tacc.shape == tuple(jacc.shape)
    assert unravel(td[0, 0])["mu"].shape == ()
    (jm, jse), (tm, tse) = _means_and_mcse(jd), _means_and_mcse(td)
    assert float((tm - jm).abs().max()) <= 4 * float(torch.sqrt(jse**2 + tse**2).max())
    assert 0.5 < float(tacc.mean()) <= 1.0


def test_multichain_errors_match_jax(meshes):
    jmesh, tmesh = meshes
    data = np.zeros((6, 4), np.float32)  # 6 shards over a shards axis of 4
    msgs = []
    for run in (
        lambda: jax_multichain(_mu_shard_jax, jnp.asarray(data), {"mu": jnp.zeros(())},
                               mesh=jmesh, key=jax.random.PRNGKey(0)),
        lambda: multichain_sample(_mu_shard_torch, torch.as_tensor(data),
                                  {"mu": torch.zeros(())}, mesh=tmesh,
                                  generator=torch.Generator()),
    ):
        with pytest.raises(ValueError) as e:
            run()
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] == "n_shards=6 not divisible by mesh axis 'shards' of size 4"
    with pytest.raises(ValueError, match="unknown kernel 'mala'"):
        multichain_sample(_mu_shard_torch, torch.zeros(4, 4), {"mu": torch.zeros(())},
                          mesh=tmesh, generator=torch.Generator(), kernel="mala")


@pytest.fixture(scope="module")
def flagship32():
    data, _ = pft.generate_node_data(8, n_obs=32, seed=123, device="cpu")
    return pft.FederatedLinearRegression(data)


def _same_draws(a, b):
    return all(torch.equal(a.samples[k], b.samples[k]) for k in a.samples)


@pytest.mark.parametrize("kernel", ["nuts", "metropolis"])
def test_sample_chain_sharding_gives_the_unsharded_draws(flagship32, kernel):
    """The flagship (through the kernel's plain version here), 4 chains
    in 2 blocks of 2: the draws of the unsharded run, bit for bit."""
    model = flagship32
    sharding = NamedSharding(make_mesh({"chains": 2}, devices=CPU8[:2]), "chains")
    kw = dict(num_warmup=6, num_samples=4, num_chains=4, kernel=kernel, max_depth=5)
    plain = pft.samplers.sample(model.logp, model.init_params(),
                                generator=torch.Generator().manual_seed(2), **kw)
    sharded = pft.samplers.sample(model.logp, model.init_params(),
                                  generator=torch.Generator().manual_seed(2),
                                  chain_sharding=sharding, **kw)
    assert _same_draws(plain, sharded)


def _gaussian(params):
    return -0.5 * torch.sum((params["x"] / torch.tensor([0.5, 1.0, 2.0])) ** 2)


def test_chees_chain_sharding_gives_the_unsharded_draws():
    sharding = NamedSharding(make_mesh({"chains": 4}, devices=CPU8[:4]), "chains")
    kw = dict(num_warmup=20, num_samples=10, num_chains=8)
    init = {"x": torch.zeros(3)}
    plain = chees_sample(_gaussian, init, generator=torch.Generator().manual_seed(4), **kw)
    sharded = chees_sample(_gaussian, init, generator=torch.Generator().manual_seed(4),
                           chain_sharding=sharding, **kw)
    assert _same_draws(plain, sharded)
    assert float(plain.extra["traj_len"]) == float(sharded.extra["traj_len"])


def _bimodal(params):
    x = params["x"]
    return torch.logaddexp(-0.5 * torch.sum(((x + 2.0) / 0.5) ** 2),
                           -0.5 * torch.sum(((x - 2.0) / 0.5) ** 2))


def test_pt_temp_sharding_gives_the_unsharded_draws():
    sharding = NamedSharding(make_mesh({"temps": 4}, devices=CPU8[:4]), "temps")
    init = {"x": torch.zeros(2)}
    kw = dict(num_warmup=20, num_samples=15, num_temps=8, num_leapfrog=4)
    plain = pt_sample(_bimodal, init, generator=torch.Generator().manual_seed(6), **kw)
    sharded = pt_sample(_bimodal, init, generator=torch.Generator().manual_seed(6),
                        temp_sharding=sharding, **kw)
    assert _same_draws(plain, sharded)
    assert torch.equal(plain.extra["swap_rate_per_pair"], sharded.extra["swap_rate_per_pair"])


def _jax_sharding_error(run):
    with pytest.raises(ValueError) as e:
        run()
    return str(e.value)


def test_sharding_errors_carry_the_jax_texts(devices8):
    """``chain_sharding`` and ``temp_sharding`` refuse what the JAX
    package refuses, with its texts: the same head (``num_chains=3 is
    not shardable by sharding=...``) and tail, and the same refusal of
    ``num_chains > 1`` with ``temp_sharding``."""
    jmesh = jax_make_mesh({"chains": 2}, devices=devices8[:2])
    jsh = JNamedSharding(jmesh, P("chains"))
    tsh = NamedSharding(make_mesh({"chains": 2}, devices=CPU8[:2]), "chains")
    tail = ("— the leading dimension must be divisible by the mesh axis the spec "
            "partitions it over")
    jlogp = lambda p: -0.5 * jnp.sum(p["x"] ** 2)
    tlogp = lambda p: -0.5 * torch.sum(p["x"] ** 2)
    jmsg = _jax_sharding_error(lambda: jax_sample(
        jlogp, {"x": jnp.zeros(2)}, key=jax.random.PRNGKey(0), num_warmup=1, num_samples=1,
        num_chains=3, chain_sharding=jsh))
    tmsg = _jax_sharding_error(lambda: pft.samplers.sample(
        tlogp, {"x": torch.zeros(2)}, generator=torch.Generator(), num_warmup=1,
        num_samples=1, num_chains=3, chain_sharding=tsh))
    for msg, sh in ((jmsg, jsh), (tmsg, tsh)):
        assert msg.startswith(f"num_chains=3 is not shardable by sharding={sh}: ")
        assert msg.endswith(tail)
    tmsg = _jax_sharding_error(lambda: chees_sample(
        tlogp, {"x": torch.zeros(2)}, generator=torch.Generator(), num_warmup=1,
        num_samples=1, num_chains=3, chain_sharding=tsh))
    assert tmsg.startswith("num_chains=3 is not shardable by sharding=") and tmsg.endswith(tail)
    jmsg = _jax_sharding_error(lambda: jax_pt_sample(
        jlogp, {"x": jnp.zeros(2)}, key=jax.random.PRNGKey(0), num_temps=3, num_warmup=1,
        num_samples=1, temp_sharding=jsh))
    tmsg = _jax_sharding_error(lambda: pt_sample(
        tlogp, {"x": torch.zeros(2)}, generator=torch.Generator(), num_temps=3, num_warmup=1,
        num_samples=1, temp_sharding=tsh))
    for msg in (jmsg, tmsg):
        assert msg.startswith("num_temps=3 is not shardable by sharding=") and msg.endswith(tail)
    jmsg = _jax_sharding_error(lambda: jax_pt_sample(
        jlogp, {"x": jnp.zeros(2)}, key=jax.random.PRNGKey(0), num_chains=2, num_warmup=1,
        num_samples=1, temp_sharding=jsh))
    tmsg = _jax_sharding_error(lambda: pt_sample(
        tlogp, {"x": torch.zeros(2)}, generator=torch.Generator(), num_chains=2, num_warmup=1,
        num_samples=1, temp_sharding=tsh))
    assert jmsg == tmsg

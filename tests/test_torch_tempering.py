"""The port's parallel tempering against the JAX package's.

``_swap_pass`` and ``_hmc_step`` take their random numbers as
arguments in the port; the tests draw them from the JAX package's keys
exactly as its functions do and hand the same numbers to both.
Tolerances: float64 (the JAX side under ``jax.enable_x64``) rtol 1e-10
on positions, values, gradients and probabilities, and exact equality
of permutations and accept decisions; float32 rtol 1e-5 / atol 1e-6
(float32 rounding of eight leapfrog steps), decisions still exact.
Whole runs are short (dim 2, 4 temperatures, 2 stacks, 100 + 100) and
checked for shapes, keys, the ladder and the error messages, plus one
conjugate-normal run against its closed form.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytensor_federated_tpu.samplers import tempering as jpt
from pytensor_federated_torch.samplers import make_batch_logp_and_grad, make_flat_logp_and_grad
from pytensor_federated_torch.samplers import tempering as tpt
from pytensor_federated_torch.utils import value_and_grad

F64 = dict(rtol=1e-10, atol=1e-12)
F32 = dict(rtol=1e-5, atol=1e-6)


def _bimodal_jax(x):
    la = -0.5 * jnp.sum(((x + 1.5) / 0.7) ** 2)
    lb = -0.5 * jnp.sum(((x - 1.5) / 0.7) ** 2)
    return jnp.logaddexp(la, lb)


def _bimodal_torch(x):
    la = -0.5 * torch.sum(((x + 1.5) / 0.7) ** 2)
    lb = -0.5 * torch.sum(((x - 1.5) / 0.7) ** 2)
    return torch.logaddexp(la, lb)


@pytest.fixture(params=["float64", "float32"])
def precision(request):
    if request.param == "float64":
        with jax.enable_x64(True):
            yield np.float64, F64
    else:
        yield np.float32, F32


def _close(got, want, tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


@pytest.mark.parametrize("parity", [0, 1])
@pytest.mark.parametrize("K", [2, 5, 8])
def test_swap_pass_matches_jax(precision, K, parity):
    """Two stacks of K replicas; the uniforms are the JAX package's
    ``uniform(key, (K-1,))`` for each stack's key."""
    dtype, tol = precision
    rng = np.random.default_rng(K + 10 * parity)
    u = rng.normal(scale=3.0, size=(2, K)).astype(dtype)
    betas = np.stack([np.geomspace(1.0, 0.05, K), np.geomspace(1.0, 0.2, K)]).astype(dtype)
    keys = jax.random.split(jax.random.PRNGKey(K), 2)

    @jax.jit
    def reference(uu, b, ks):
        uniform = jax.vmap(lambda k: jax.random.uniform(k, (K - 1,), dtype))(ks)
        return uniform, jax.vmap(lambda a, c, k: jpt._swap_pass(a, c, k, parity))(uu, b, ks)

    uniform, want = reference(jnp.asarray(u), jnp.asarray(betas), keys)
    got = tpt._swap_pass(torch.tensor(u), torch.tensor(betas), torch.tensor(np.asarray(uniform)), parity)
    perm, accept, propose, alpha = got
    np.testing.assert_array_equal(perm.numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(accept.numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(propose.numpy(), np.asarray(want[2])[0])
    _close(alpha, want[3], tol)
    # A permutation of each stack, swapping only proposed neighbours.
    assert all(sorted(row) == list(range(K)) for row in perm.tolist())


@pytest.mark.parametrize("num_leapfrog", [1, 8])
def test_hmc_step_matches_jax(precision, num_leapfrog):
    """Six replicas of a 3-dimensional bimodal target at their own
    temperature, step size and diagonal mass; momentum and acceptance
    draws from the JAX package's per-replica keys."""
    dtype, tol = precision
    R, dim = 6, 3
    rng = np.random.default_rng(num_leapfrog)
    x = rng.normal(size=(R, dim)).astype(dtype)
    beta = np.geomspace(1.0, 0.05, R).astype(dtype)
    step = rng.uniform(0.1, 0.6, size=R).astype(dtype)
    inv_mass = rng.uniform(0.5, 2.0, size=(R, dim)).astype(dtype)
    keys = jax.random.split(jax.random.PRNGKey(3), R)

    @jax.jit
    def draws(ks):
        pairs = jax.vmap(jax.random.split)(ks)
        return (jax.vmap(lambda k: jax.random.normal(k[0], (dim,), dtype))(pairs),
                jax.vmap(lambda k: jax.random.uniform(k[1], dtype=dtype))(pairs))

    z, uniform = draws(keys)

    jlg = jax.value_and_grad(_bimodal_jax)
    ju, jg = jax.jit(jax.vmap(jlg))(jnp.asarray(x))
    step_fn = jax.jit(jax.vmap(jpt._hmc_step, in_axes=(None, 0, 0, 0, 0, 0, 0, 0, None)),
                      static_argnums=(0, 8))
    want = step_fn(jlg, jnp.asarray(x), ju, jg, jnp.asarray(beta), jnp.asarray(step),
                   jnp.asarray(inv_mass), keys, num_leapfrog)

    flat_logp, flat0, unravel, _ = make_flat_logp_and_grad(_bimodal_torch, torch.zeros(dim,
                                                           dtype=torch.tensor(x).dtype))
    tlg = make_batch_logp_and_grad(flat_logp, unravel)
    tu, tg = tlg(torch.tensor(x))
    _close(tu, ju, tol)
    got = tpt._hmc_step(tlg, torch.tensor(x), tu, tg, torch.tensor(beta), torch.tensor(step),
                        torch.tensor(inv_mass), num_leapfrog, torch.tensor(np.asarray(z)),
                        torch.tensor(np.asarray(uniform)))
    for g, w in zip(got, want):
        _close(g, w, tol)
    # Some proposals are taken and some are not, so both branches ran.
    taken = np.asarray(uniform) < np.asarray(want[3])
    assert np.array_equal(np.all(got[0].numpy() != x, axis=-1), taken)


def _short(**kw):
    args = dict(generator=torch.Generator().manual_seed(0), num_chains=2, num_warmup=100,
                num_samples=100, num_temps=4, beta_min=0.1, num_leapfrog=4)
    args.update(kw)
    return tpt.pt_sample(lambda p: _bimodal_torch(p["x"]), {"x": torch.zeros(2)}, **args)


def test_short_run_shapes_keys_and_fixed_ladder():
    res = _short()
    assert tuple(res.samples["x"].shape) == (2, 100, 2)
    assert set(res.stats) == {"accept_prob", "swap_accept"}
    assert all(tuple(v.shape) == (2, 100) for v in res.stats.values())
    assert set(res.extra) == {"swap_rate_per_pair", "betas"}
    assert tuple(res.extra["swap_rate_per_pair"].shape) == (2, 3)
    assert tuple(res.step_size.shape) == (2,) and tuple(res.inv_mass.shape) == (2, 2)
    betas = res.extra["betas"].numpy()
    np.testing.assert_array_equal(betas, np.broadcast_to(
        np.geomspace(1.0, 0.1, 4).astype(np.float32), (2, 4)))
    assert bool(torch.isfinite(res.samples["x"]).all())
    rates = res.extra["swap_rate_per_pair"].numpy()
    assert ((rates >= 0) & (rates <= 1)).all() and rates.max() > 0


def test_adapted_ladder_pins_the_cold_rung_and_stays_monotone():
    res = _short(adapt_ladder=True, generator=torch.Generator().manual_seed(1))
    betas = res.extra["betas"].numpy()
    np.testing.assert_array_equal(betas[:, 0], 1.0)
    assert (np.diff(betas, axis=1) < 0).all()
    assert not np.allclose(betas, np.geomspace(1.0, 0.1, 4))  # it moved


def test_supplied_gradient_drives_the_run():
    """``logp_and_grad_fn`` is the gradient the run uses: it is called
    once per batched evaluation (two at the start, then one per leapfrog
    step of every iteration), and the logp itself never."""
    calls = {"logp": 0, "logp_and_grad": 0}

    def logp(p):
        calls["logp"] += 1
        return _bimodal_torch(p["x"])

    def logp_and_grad(p):
        calls["logp_and_grad"] += 1
        return value_and_grad(lambda q: _bimodal_torch(q["x"]), p)

    res = tpt.pt_sample(logp, {"x": torch.zeros(2)}, generator=torch.Generator().manual_seed(2),
                        num_warmup=30, num_samples=30, num_temps=3, num_leapfrog=4,
                        logp_and_grad_fn=logp_and_grad)
    assert calls == {"logp": 0, "logp_and_grad": 2 + 60 * 4}
    draws = res.samples["x"].numpy()
    assert draws.shape == (1, 30, 2) and np.isfinite(draws).all()


def test_conjugate_normal_moments():
    """The cold chain of N(1.5, 0.5²) (tests/test_tempering.py's
    exactness check): mean within 0.1, sd within 0.1."""
    res = tpt.pt_sample(lambda p: torch.sum(-0.5 * ((p["x"] - 1.5) / 0.5) ** 2), {"x": torch.zeros(1)},
                        generator=torch.Generator().manual_seed(4), num_chains=2, num_warmup=200,
                        num_samples=600, num_temps=4, beta_min=0.2, num_leapfrog=4)
    draws = res.samples["x"].numpy().reshape(-1)
    np.testing.assert_allclose(draws.mean(), 1.5, atol=0.1)
    np.testing.assert_allclose(draws.std(), 0.5, atol=0.1)


@pytest.mark.parametrize("kw,match", [
    (dict(num_temps=1), "2 temperatures"),
    (dict(beta_min=0.0), "beta_min"),
    (dict(beta_min=1.0), "beta_min"),
    (dict(num_chains=0), "num_chains"),
])
def test_rejects_what_jax_rejects(kw, match):
    with pytest.raises(ValueError, match=match) as want:
        jpt.pt_sample(lambda p: _bimodal_jax(p["x"]), {"x": jnp.zeros(1)}, key=jax.random.PRNGKey(0), **kw)
    with pytest.raises(ValueError, match=match) as got:
        _short(**kw)
    assert str(got.value) == str(want.value)

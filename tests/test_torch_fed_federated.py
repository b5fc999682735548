"""The port's ``parallel/federated.py`` (the federated MapReduce API and
FedAvg) and ``fed.FederatedLogpGrad`` on the flagship, against the JAX
package and against the port's own ``FederatedLogp``.

- ``federated_map`` / ``_sum`` / ``_mean`` / ``_broadcast`` against the
  JAX package's (``tests/test_federated_primitives.py`` mirrored); the
  wrong-length weights raise its text.
- ``fedavg``'s final parameters and loss history against the JAX
  package's ``fedavg`` (which binds only ``fed_sum`` and runs under every
  JAX version) within float32 rounding; with an 8-slot CPU mesh, equal
  to the run without one bit for bit (the slots' per-shard work and the
  weighted mean add in the same order).
- ``FederatedLogpGrad`` over the kernel's per-shard form
  (``linreg_shard_logp``; its plain version on the CPU) on a 4-slot CPU
  mesh against ``FederatedLogp(linreg_shard_logp, mesh=)``: gradients
  bit for bit, values to float32 rounding of float64 (``fed_sum`` adds
  the eight per-shard values, ``FederatedLogp`` each slot's first), and
  NUTS through it: its draws equal ``sample()`` through
  ``FederatedLogp(mesh=)`` where every evaluation's bits agree, else its
  posterior means lie within 4 combined Monte Carlo standard errors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytensor_federated_torch as pft
from pytensor_federated_tpu.parallel import make_mesh as jmake_mesh
from pytensor_federated_tpu.parallel.federated import fedavg as jfedavg
from pytensor_federated_torch import fed
from pytensor_federated_torch.ops.linreg_kernel import linreg_shard_logp
from pytensor_federated_torch.parallel import FederatedLogp, make_mesh
from pytensor_federated_torch.parallel.federated import (
    fedavg,
    federated_broadcast,
    federated_map,
    federated_mean,
    federated_sum,
)
from pytensor_federated_torch.utils import value_and_grad

CPU = torch.device("cpu")
F32 = float(np.finfo(np.float32).eps)


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def shard_xy():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(8, 64)).astype(np.float32)
    y = (1.0 + 2.0 * x + 0.2 * rng.normal(size=(8, 64))).astype(np.float32)
    return x, y


def _t(a):
    return torch.as_tensor(np.asarray(a))


class TestPrimitives:
    def test_map_sum_matches_the_jax_package(self, shard_xy):
        x, y = shard_xy
        out = federated_map(lambda d: torch.sum(d[0] * d[1]), (_t(x), _t(y)))
        assert out.shape == (8,)
        want = jax.vmap(lambda a, b: jnp.sum(a * b))(jnp.asarray(x), jnp.asarray(y))
        np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=1e-6)
        np.testing.assert_allclose(float(federated_sum(out)), float(np.sum(x * y)), rtol=1e-5)

    def test_mesh_matches_single_device(self, shard_xy):
        x, y = shard_xy
        mesh = make_mesh({"shards": 8}, devices=[CPU] * 8)
        a = federated_map(lambda d: torch.mean(d[0]), (_t(x), _t(y)), mesh=mesh)
        b = federated_map(lambda d: torch.mean(d[0]), (_t(x), _t(y)))
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=3e-6)

    def test_weighted_mean(self):
        got = federated_mean(_t([[1.0], [3.0]]), _t([3.0, 1.0]))
        np.testing.assert_allclose(got.numpy(), [1.5])

    def test_weighted_mean_rejects_wrong_length_weights(self):
        vals = torch.zeros(4, 2)
        for bad in (torch.ones(1), torch.ones(2), torch.ones(4, 1)):
            with pytest.raises(ValueError, match="one weight per shard"):
                federated_mean(vals, bad)
        np.testing.assert_allclose(federated_mean(vals, torch.ones(4)).numpy(), np.zeros(2))

    def test_broadcast(self):
        out = federated_broadcast({"a": torch.ones(2)}, 4)
        assert out["a"].shape == (4, 2)


def _mse(params, shard):
    x, y = shard
    pred = params["a"] + params["b"] * x
    if isinstance(x, torch.Tensor):
        return torch.mean((y - pred) ** 2)
    return jnp.mean((y - pred) ** 2)


def _fedavg_both(x, y, **kw):
    init = {"a": torch.zeros(()), "b": torch.zeros(())}
    final, history = fedavg(_mse, (_t(x), _t(y)), init, **kw)
    jkw = {k: (jnp.asarray(v) if k == "weights" else v) for k, v in kw.items()}
    jfinal, jhistory = jfedavg(_mse, (jnp.asarray(x), jnp.asarray(y)),
                               {"a": jnp.zeros(()), "b": jnp.zeros(())}, **jkw)
    return (final, history), (jfinal, jhistory)


class TestFedAvg:
    def test_converges_to_pooled_solution_as_the_jax_package(self, shard_xy):
        x, y = shard_xy
        (final, history), (jfinal, jhistory) = _fedavg_both(
            x, y, rounds=150, local_steps=5, learning_rate=0.1)
        b_ols, a_ols = np.polyfit(x.ravel(), y.ravel(), 1)
        assert abs(float(final["a"]) - a_ols) < 0.05
        assert abs(float(final["b"]) - b_ols) < 0.05
        h = history.numpy()
        assert h[-1] < h[0] * 0.1
        # The JAX package's loop, within float32 rounding.
        for k in ("a", "b"):
            np.testing.assert_allclose(float(final[k]), float(jfinal[k]), rtol=1e-5)
        np.testing.assert_allclose(h, np.asarray(jhistory), rtol=1e-4, atol=1e-6)

    def test_mesh_matches_single_device_bit_for_bit(self, shard_xy, devices8):
        x, y = shard_xy
        mesh = make_mesh({"shards": 8}, devices=[CPU] * 8)
        kw = dict(rounds=20, local_steps=3, learning_rate=0.1)
        init = {"a": torch.zeros(()), "b": torch.zeros(())}
        f_mesh, h_mesh = fedavg(_mse, (_t(x), _t(y)), init, mesh=mesh, **kw)
        f_one, h_one = fedavg(_mse, (_t(x), _t(y)), init, **kw)
        assert torch.equal(f_mesh["a"], f_one["a"]) and torch.equal(f_mesh["b"], f_one["b"])
        assert torch.equal(h_mesh, h_one)
        # And the JAX package's mesh run, at its own test's tolerance.
        jf, jh = jfedavg(_mse, (jnp.asarray(x), jnp.asarray(y)),
                         {"a": jnp.zeros(()), "b": jnp.zeros(())},
                         mesh=jmake_mesh({"shards": 8}, devices=devices8), **kw)
        np.testing.assert_allclose(float(f_mesh["a"]), float(jf["a"]), rtol=2e-3)
        np.testing.assert_allclose(h_mesh.numpy(), np.asarray(jh), rtol=2e-3)

    def test_weighted_by_shard_size(self, shard_xy):
        """Weights shift the fixed point toward the heavy shard."""
        x, y = shard_xy
        y_bad = y.copy()
        y_bad[0] += 10.0
        w = np.asarray([1e-6] + [1.0] * 7, np.float32)
        (final, history), (jfinal, jhistory) = _fedavg_both(
            x, y_bad, rounds=100, local_steps=5, learning_rate=0.1, weights=w)
        assert abs(float(final["a"]) - 1.0) < 0.1
        np.testing.assert_allclose(float(final["a"]), float(jfinal["a"]), rtol=1e-5)
        np.testing.assert_allclose(history.numpy(), np.asarray(jhistory), rtol=1e-4, atol=1e-6)


@pytest.fixture(scope="module")
def flagship():
    """The flagship at 8 x 16 in the kernel's per-shard form, a 4-slot
    CPU mesh, the prior, and both evaluators of its data term."""
    data, _ = pft.generate_node_data(8, n_obs=16, seed=123, device="cpu")
    (x, y), mask = data.tree()
    tree = ((x, y), mask, torch.arange(8))
    model = pft.FederatedLinearRegression(data)
    mesh = make_mesh({"shards": 4}, devices=[CPU] * 4)
    fl = FederatedLogp(linreg_shard_logp, tree, mesh=mesh)
    ev = fed.FederatedLogpGrad(linreg_shard_logp, tree, placement=fed.MeshPlacement(mesh),
                               device="cpu")
    return data, tree, model, fl, ev


def _points(model, n=4):
    p0 = model.init_params()
    g = torch.Generator().manual_seed(9)
    return [{k: v + 0.1 * torch.randn(v.shape, generator=g) for k, v in p0.items()}
            for _ in range(n)]


def test_federated_logp_grad_against_federated_logp(flagship):
    """Gradients equal ``FederatedLogp(mesh=)``'s bit for bit (the same
    per-slot maps and cotangents); values within float32 rounding of
    the float64 evaluation (the two add the shards in different
    orders)."""
    data, tree, model, fl, ev = flagship
    tree64 = (tuple(t.double() for t in tree[0]), tree[1].double(), tree[2])
    fl64 = FederatedLogp(linreg_shard_logp, tree64)
    for p in _points(model):
        v, g = value_and_grad(fl.logp, p)
        v_ev, (g_ev,) = ev.logp_and_grad(p)
        assert all(torch.equal(g[k], g_ev[k]) for k in g)
        v64 = fl64.logp({k: t.double() for k, t in p.items()})
        assert abs(float(v_ev) - float(v64)) <= 8 * F32 * abs(float(v64))
        assert abs(float(v) - float(v64)) <= 8 * F32 * abs(float(v64))


def _mcse(draws):
    """Per-parameter means and their Monte Carlo standard errors."""
    out = {}
    for k in ("intercept", "slope", "log_sigma"):
        ess = float(pft.samplers.effective_sample_size({k: draws[k]})[k])
        out[k] = (float(draws[k].mean()), float(draws[k].std()) / max(ess, 1.0) ** 0.5)
    return out


def test_nuts_through_federated_logp_grad(flagship):
    data, tree, model, fl, ev = flagship

    def run(data_logp):
        return pft.samplers.sample(
            lambda p: model.prior_logp(p) + data_logp(p), model.init_params(),
            generator=torch.Generator().manual_seed(3), num_warmup=12, num_samples=12,
            num_chains=2, max_depth=3)

    ref, got = run(fl.logp), run(ev.logp)
    same_bits = all(
        torch.equal(value_and_grad(fl.logp, p)[0], ev.logp_and_grad(p)[0])
        for p in _points(model))
    if same_bits:
        assert all(torch.equal(ref.samples[k], got.samples[k]) for k in ref.samples)
        return
    a, b = _mcse(ref.samples), _mcse(got.samples)
    for k in a:
        assert abs(a[k][0] - b[k][0]) <= 4 * (a[k][1] ** 2 + b[k][1] ** 2) ** 0.5, (k, a[k], b[k])

"""The port's sequence-sharded linear-Gaussian state-space model
(``SeqShardedLGSSM``) and ``FederatedLGSSMPanel(mesh=)`` against the JAX
package's on its 8-device CPU mesh (``tests/conftest.py``'s
``devices8``: a ``{"seq": 4}`` mesh) and against the port's own
single-device filters.

Inputs: ``generate_lgssm_data(T=32, seed=3)`` (d = 2, k = 1), the
parameters moved off the generating point by 0.03, every fifth step
masked and t = 1 masked too; the port's mesh is ``[cpu] * 4``.  Both
packages run in float64 (the JAX side under ``jax.enable_x64``):
rtol 1e-10 (atol 1e-12) on values, gradients, moments, forecasts and
simulation-smoother draws with the JAX noise injected.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytensor_federated_tpu.models.statespace as jss
from pytensor_federated_tpu.parallel import make_mesh as jax_make_mesh
import pytensor_federated_torch.models.statespace as tss
from pytensor_federated_torch.parallel.mesh import make_mesh
from pytensor_federated_torch.utils import value_and_grad

T = 32
F64 = dict(rtol=1e-10, atol=1e-12)
CPU4 = [torch.device("cpu")] * 4
MASK = (np.arange(T) % 5 != 2).astype(np.float64)
MASK[0] = 0.0  # a masked t = 1: the first slot's prior element, unconditioned
DRAWS = 3


@pytest.fixture(scope="module")
def case():
    y, p = jss.generate_lgssm_data(T=T, seed=3)
    params = {k: np.asarray(v, np.float64) + 0.03 for k, v in p.items()}
    return np.asarray(y, np.float64), params


@pytest.fixture(scope="module")
def jax_results(case, devices8):
    """Every JAX output the tests compare with, from one x64 block."""
    y, params = case
    with jax.enable_x64(True):
        mesh = jax_make_mesh({"seq": 4}, devices=devices8[:4])
        jp = {k: jnp.asarray(v) for k, v in params.items()}
        out = {}
        for name, mask in (("mask", MASK), ("full", None)):
            m = jss.SeqShardedLGSSM(jnp.asarray(y), mesh, mask=None if mask is None
                                    else jnp.asarray(mask))
            v, g = m.logp_and_grad(jp)
            out[name] = {
                "vg": (float(v), {k: np.asarray(a) for k, a in g.items()}),
                "smoothed": tuple(np.asarray(a) for a in m.smoothed_moments(jp)),
                "forecast": tuple(np.asarray(a) for a in m.forecast(jp, 6)),
            }
        key = jax.random.PRNGKey(11)
        noise = [jss._draw_noise(jp, k, T) for k in jax.random.split(key, DRAWS)]
        out["noise"] = tuple(np.stack([np.asarray(n[i]) for n in noise]) for i in range(3))
        m = jss.SeqShardedLGSSM(jnp.asarray(y), mesh, mask=jnp.asarray(MASK))
        out["latents"] = np.asarray(m.sample_latents(jp, key, DRAWS))
    return out


@pytest.fixture(scope="module")
def port(case):
    y, params = case
    mesh = make_mesh({"seq": 4}, devices=CPU4)
    models = {"mask": tss.SeqShardedLGSSM(y, mesh, mask=MASK), "full": tss.SeqShardedLGSSM(y, mesh)}
    return models, {k: torch.as_tensor(v) for k, v in params.items()}


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got.detach() if torch.is_tensor(got) else got),
                               np.asarray(want), **F64)


@pytest.mark.parametrize("which", ["mask", "full"])
def test_logp_and_grad_match_jax(port, jax_results, which):
    models, p = port
    want = jax_results[which]
    v, g = models[which].logp_and_grad(p)
    _close(v, want["vg"][0])
    _close(models[which].logp(p), want["vg"][0])
    for k, a in want["vg"][1].items():
        _close(g[k], a)


@pytest.mark.parametrize("which", ["mask", "full"])
def test_smoothed_moments_and_forecast_match_jax(port, jax_results, which):
    models, p = port
    want = jax_results[which]
    for got, w in zip(models[which].smoothed_moments(p), want["smoothed"]):
        assert got.shape == w.shape
        _close(got, w)
    for got, w in zip(models[which].forecast(p, 6), want["forecast"]):
        assert got.shape == w.shape
        _close(got, w)


def test_sample_latents_match_jax_on_its_noise(port, jax_results):
    models, p = port
    noise = tuple(torch.as_tensor(a) for a in jax_results["noise"])
    got = models["mask"].sample_latents(p, noise=noise)
    assert got.shape == (DRAWS, T, 2)
    _close(got, jax_results["latents"])


def test_sharded_equals_the_single_device_filters(case, port):
    """The mesh against the port's own single-device filters: logp and
    gradient, smoothed moments, forecast, and the simulation smoother
    on one generator (its noise is drawn draw by draw in both)."""
    y, _ = case
    models, p = port
    y_t, mask = torch.as_tensor(y), torch.as_tensor(MASK)
    v0, g0 = value_and_grad(lambda q: tss.kalman_logp_parallel(q, y_t, mask), p)
    v, g = models["mask"].logp_and_grad(p)
    _close(v, v0)
    for k in g0:
        _close(g[k], g0[k])
    for a, b in zip(models["mask"].smoothed_moments(p), tss.kalman_smoother_parallel(p, y_t, mask)):
        _close(a, b)
    for a, b in zip(models["mask"].forecast(p, 4), tss.kalman_forecast(p, y_t, 4, mask)):
        _close(a, b)
    got = models["mask"].sample_latents(p, torch.Generator().manual_seed(5), num_draws=2)
    want = tss.sample_latents(p, y_t, torch.Generator().manual_seed(5), num_draws=2, mask=mask)
    _close(got, want)


def test_init_params_and_errors_match_jax(devices8, case):
    y, _ = case
    jmesh = jax_make_mesh({"seq": 4}, devices=devices8[:4])
    tmesh = make_mesh({"seq": 4}, devices=CPU4)
    jm, tm = jss.SeqShardedLGSSM(jnp.asarray(y), jmesh), tss.SeqShardedLGSSM(y, tmesh)
    jinit, tinit = jm.init_params(), tm.init_params()
    assert sorted(jinit) == sorted(tinit)
    for k in jinit:
        np.testing.assert_array_equal(tinit[k].numpy(), np.asarray(jinit[k]))
    msgs = []
    for run in (lambda: jss.SeqShardedLGSSM(jnp.asarray(y[:30]), jmesh),
                lambda: tss.SeqShardedLGSSM(y[:30], tmesh),
                lambda: jss.SeqShardedLGSSM(jnp.asarray(y), jmesh, axis="time"),
                lambda: tss.SeqShardedLGSSM(y, tmesh, axis="time")):
        with pytest.raises(ValueError) as e:
            run()
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] == "sequence length 30 not divisible by 4"
    assert msgs[2] == msgs[3] == "mesh has no axis 'time': ('seq',)"


def test_panel_with_a_mesh_equals_itself_without_one():
    """``FederatedLGSSMPanel(mesh=)``: four series over a 2-slot shards
    mesh against the same panel unsharded, float64."""
    rng = np.random.default_rng(4)
    ys = rng.normal(size=(4, 32))
    masks = (rng.uniform(size=(4, 32)) > 0.2).astype(np.float64)
    mesh = make_mesh({"shards": 2}, devices=CPU4[:2])
    sharded = tss.FederatedLGSSMPanel(ys, masks=masks, mesh=mesh)
    plain = tss.FederatedLGSSMPanel(ys, masks=masks, device="cpu")
    p = {k: v.double() for k, v in plain.init_params().items()}
    v, g = sharded.logp_and_grad(p)
    v0, g0 = plain.logp_and_grad(p)
    _close(v, v0)
    for k in g0:
        _close(g[k], g0[k])
    assert sharded.fed.mesh is mesh and sharded.ys.device == torch.device("cpu")

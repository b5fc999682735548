"""The port's state-space models against the JAX package's.

Inputs are made from a seed with numpy, every value float32-exact, and
go through both packages on the CPU: T = 64, d = 2, k = 1, with every
fifth step masked (and a ragged three-series panel).  The JAX package
runs once, in float64 (``jax.enable_x64``), inside one ``jax.jit``; the
port runs in float64 and in float32 on the same inputs.  Tolerances: in
float64 rtol 1e-10 on every value, gradient and moment (atol 1e-12
where a moment may be zero); in float32 the JAX tests' tolerances
(tests/test_statespace.py): value rtol 1e-4, gradients and smoothed
moments rtol 1e-3 / atol 1e-4, forecasts rtol 1e-4 / atol 1e-6.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytensor_federated_tpu.models.statespace as jss
import pytensor_federated_torch.models.statespace as tss
from pytensor_federated_torch._assoc_scan import associative_scan
from pytensor_federated_torch.samplers.mcmc import make_batch_logp_and_grad, make_flat_logp_and_grad
from pytensor_federated_torch.utils import value_and_grad

T = 64
F64 = dict(rtol=1e-10, atol=1e-12)
F32_VALUE = dict(rtol=1e-4)
F32_MOMENT = dict(rtol=1e-3, atol=1e-4)
F32_FORECAST = dict(rtol=1e-4, atol=1e-6)
MASK = (np.arange(T) % 5 != 2).astype(np.float64)


def _data(dtype):
    y, p = jss.generate_lgssm_data(T=T, seed=3)
    y = np.asarray(y, dtype)
    # Off the generating point, so every gradient component is non-zero;
    # float32-exact, so both dtypes see the same numbers.
    params = {k: (np.asarray(v, np.float64) + 0.03).astype(np.float32).astype(dtype)
              for k, v in p.items()}
    return y, params


def _jax(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()} if isinstance(tree, dict) else jnp.asarray(tree)


def _torch(tree):
    return {k: torch.tensor(v) for k, v in tree.items()} if isinstance(tree, dict) else torch.tensor(tree)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got.detach() if torch.is_tensor(got) else got),
                               np.asarray(want), **tol)


def _ekf_fns():
    def f(params, z):
        return params["F"] @ z

    def h(params, z):
        return params["H"] @ z

    return f, h


def _ekf_mats(p, dtype):
    d = p["F"].shape[0]
    return dict(Q=np.exp(p["log_q"]) * np.eye(d, dtype=dtype), R=np.exp(p["log_r"]) * np.eye(1, dtype=dtype),
                m0=p["m0"], P0=np.eye(d, dtype=dtype))


def _panel(dtype):
    y, p = _data(dtype)
    ys = np.stack([y[:, 0], y[::-1, 0], 0.5 * y[:, 0]])
    masks = np.ones(ys.shape, dtype)
    masks[0] = MASK  # the first series is the masked one the filters see
    masks[1, 50:] = 0.0  # a ragged panel: the second series is shorter
    return ys, masks


def _bundle(lib, p, y, mask, ys, masks, *_):
    """Every state-space output the tests hold, from one library: ``lib``
    is the JAX package's module (inside one ``jax.jit``) or the port's.
    On the JAX side the lag-1 smoother and the forecast are the bodies of
    ``kalman_smoother_with_lag1`` and ``kalman_forecast``, composed from
    the package's own helpers on one shared filter pass (tracing each
    filter costs seconds)."""
    vg = jax.value_and_grad if lib is jss else (lambda fn: lambda q, *a: value_and_grad(
        lambda r: fn(r, *a), q))
    out = {
        "kalman_logp_seq": vg(lib.kalman_logp_seq)(p, y, mask),
        "kalman_smoother_seq": lib.kalman_smoother_seq(p, y, mask),
        "panel_em": lib.panel_em(p, ys, num_iters=3, masks=masks, fit_H=True),
    }
    if lib is tss:
        out["kalman_logp_parallel"] = vg(lib.kalman_logp_parallel)(p, y, mask)
        out["FederatedLGSSMPanel"] = lib.FederatedLGSSMPanel(ys, masks=masks).logp_and_grad(p)
        out["kalman_smoother_parallel"] = lib.kalman_smoother_parallel(p, y, mask)
        out["kalman_smoother_with_lag1"] = lib.kalman_smoother_with_lag1(p, y, mask)
        out["kalman_forecast"] = lib.kalman_forecast(p, y, 6, mask)
    else:
        values, grads = jax.vmap(jax.value_and_grad(jss.kalman_logp_parallel), in_axes=(None, 0, 0))(
            p, ys[..., None], masks)
        out["kalman_logp_parallel"] = (values[0], {k: g[0] for k, g in grads.items()})
        out["FederatedLGSSMPanel"] = (values.sum(), {k: g.sum(0) for k, g in grads.items()})
        F, H, Q, R, _, _ = jss._unpack(p)
        means, covs = jss._filtered_moments(p, y, mask)
        sm, sP = jss._smooth_from_filtered(F, Q, means, covs)
        out["kalman_smoother_parallel"] = (sm, sP)
        out["kalman_smoother_with_lag1"] = (sm, sP, jss._lag1_from_moments(F, Q, covs, sP))
        out["kalman_forecast"] = jss._forecast_from_terminal(F, H, Q, R, means[-1], covs[-1], 6)
    return out


def _ekf(lib, p, y, ekf_mats):
    f, h = _ekf_fns()
    vg = jax.value_and_grad if lib is jss else (lambda fn: lambda q: value_and_grad(fn, q))
    return vg(lambda q: lib.ekf_logp(f, h, q, y, **ekf_mats))({"F": p["F"], "H": p["H"]})


_REFS = {}


def _refs():
    """The JAX package's bundle in float64, one compile, cached for the
    module (its compile dominates this file's time)."""
    if not _REFS:
        y, p = _data(np.float64)
        ys, masks = _panel(np.float64)
        with jax.enable_x64(True):
            args = (_jax(p), _jax(y), _jax(MASK), _jax(ys), _jax(masks), _jax(_ekf_mats(p, np.float64)))
            out = jax.jit(lambda *a: _bundle(jss, *a))(*args)
            out["ekf_logp"] = _ekf(jss, args[0], args[1], args[5])
            _REFS.update(jax.tree_util.tree_map(np.asarray, out))
    return _REFS


def _port(dtype):
    y, p = _data(dtype)
    ys, masks = _panel(dtype)
    out = _bundle(tss, _torch(p), _torch(y), _torch(MASK.astype(dtype)), _torch(ys), _torch(masks))
    out["ekf_logp"] = _ekf(tss, _torch(p), _torch(y), _torch(_ekf_mats(p, dtype)))
    return out


def _assert_tree_close(got, want, tol):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _assert_tree_close(got[k], want[k], tol)
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_tree_close(g, w, tol)
    else:
        assert tuple(got.shape) == tuple(np.shape(want))
        _close(got, want, tol)


_PORT = {}

#: (value or moment tolerance, gradient tolerance) per output in float32.
F32_TOLS = {
    "kalman_logp_seq": (F32_VALUE, F32_MOMENT),
    "kalman_logp_parallel": (F32_VALUE, F32_MOMENT),
    "kalman_smoother_seq": (F32_MOMENT, None),
    "kalman_smoother_parallel": (F32_MOMENT, None),
    "kalman_smoother_with_lag1": (F32_MOMENT, None),
    "kalman_forecast": (F32_FORECAST, None),
    "ekf_logp": (F32_VALUE, F32_MOMENT),
    # Three EM iterations compound three E-steps: the smoothed moments'
    # tolerance on the fitted parameters and the history.
    "panel_em": (F32_MOMENT, None),
    # tests/test_statespace.py:803-812: value rtol 1e-4; gradient 1e-3 / 1e-3.
    "FederatedLGSSMPanel": (F32_VALUE, dict(rtol=1e-3, atol=1e-3)),
}


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["float64", "float32"])
@pytest.mark.parametrize("name", sorted(F32_TOLS))
def test_matches_jax(name, dtype):
    """Each output on the masked series (every fifth step missing; the
    panel ragged) against the JAX package's float64 one, on the same
    inputs."""
    if dtype not in _PORT:
        _PORT[dtype] = _port(dtype)
    got, want = _PORT[dtype][name], _refs()[name]
    first, grad = (F64, F64) if dtype == np.float64 else F32_TOLS[name]
    if grad is None:
        _assert_tree_close(got, want, first)
    else:  # (value, gradient tree)
        _assert_tree_close(got[0], want[0], first)
        _assert_tree_close(got[1], want[1], grad)


def test_full_mask_equals_no_mask():
    y, p = _data(np.float64)
    for form in (tss.kalman_logp_seq, tss.kalman_logp_parallel):
        np.testing.assert_allclose(
            form(_torch(p), _torch(y), torch.ones(T, dtype=torch.float64)).numpy(),
            form(_torch(p), _torch(y)).numpy(), rtol=1e-14)


def test_lgssm_em_is_panel_em_on_one_series():
    y, p = _data(np.float64)
    a = tss.lgssm_em(_torch(p), _torch(y), num_iters=2, mask=_torch(MASK), fit_H=True)
    b = tss.panel_em(_torch(p), _torch(y)[None], num_iters=2, masks=_torch(MASK)[None], fit_H=True)
    _assert_tree_close(a, b, dict(rtol=0, atol=0))


def test_data_are_byte_identical():
    jy, jp = jss.generate_lgssm_data(T=T, d=2, k=1, seed=7)
    ty, tp = tss.generate_lgssm_data(T=T, d=2, k=1, seed=7, device="cpu")
    assert np.asarray(jy).tobytes() == ty.numpy().tobytes()
    for k in jp:
        assert np.asarray(jp[k]).tobytes() == tp[k].numpy().tobytes(), k
    jd, td = jss.default_lgssm_params(3, 2), tss.default_lgssm_params(3, 2, device="cpu")
    for k in jd:
        np.testing.assert_array_equal(td[k].numpy(), np.asarray(jd[k]))
        assert td[k].dtype == torch.float32


def _affine(e1, e2):
    return e2[0] @ e1[0], (e2[0] @ e1[1][..., None])[..., 0] + e2[1]


@pytest.mark.parametrize("n", [1, 2, 7, 16, 33])
@pytest.mark.parametrize("reverse", [False, True])
def test_associative_scan_matches_jax(n, reverse):
    """Random affine elements, float64: rtol 1e-12 (the same pairs are
    combined in the same order)."""
    rng = np.random.default_rng(n)
    A = 0.5 * rng.normal(size=(n, 3, 3))
    b = rng.normal(size=(n, 3))
    with jax.enable_x64(True):
        want = jax.jit(lambda a, c: jax.lax.associative_scan(_affine, (a, c), reverse=reverse))(
            jnp.asarray(A), jnp.asarray(b))
    got = associative_scan(_affine, (torch.tensor(A), torch.tensor(b)), reverse=reverse)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12, atol=1e-14)


def test_associative_scan_under_vmap_and_on_another_axis():
    rng = np.random.default_rng(0)
    A, b = 0.5 * rng.normal(size=(4, 9, 2, 2)), rng.normal(size=(4, 9, 2))
    with jax.enable_x64(True):
        want = jax.jit(jax.vmap(lambda a, c: jax.lax.associative_scan(_affine, (a, c))))(
            jnp.asarray(A), jnp.asarray(b))
    by_vmap = torch.func.vmap(lambda a, c: associative_scan(_affine, (a, c)))(
        torch.tensor(A), torch.tensor(b))
    on_axis = associative_scan(_affine, (torch.tensor(A), torch.tensor(b)), axis=1)
    for got in (by_vmap, on_axis):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12, atol=1e-14)


def test_associative_scan_rejects_ragged_inputs():
    with pytest.raises(ValueError, match="scan axis"):
        associative_scan(_affine, (torch.zeros(3, 2, 2), torch.zeros(4, 2)))


def test_seq_and_parallel_agree_in_float32():
    """The JAX test's own hold (tests/test_statespace.py:87-104) on the
    port's two forms."""
    y, p = _data(np.float32)
    sv, sg = value_and_grad(lambda q: tss.kalman_logp_seq(q, _torch(y)), _torch(p))
    pv, pg = value_and_grad(lambda q: tss.kalman_logp_parallel(q, _torch(y)), _torch(p))
    _close(pv, sv.numpy(), F32_VALUE)
    for k in sg:
        _close(pg[k], sg[k].numpy(), F32_MOMENT)


def test_nan_encoded_missing_rows_are_inert():
    y, p = _data(np.float64)
    y_nan = y.copy()
    y_nan[MASK == 0] = np.nan
    for form in (tss.kalman_logp_seq, tss.kalman_logp_parallel):
        got = form(_torch(p), _torch(y_nan), _torch(MASK))
        want = form(_torch(p), _torch(y), _torch(MASK))
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12)


def test_ekf_equals_the_kalman_filter_on_an_affine_model():
    y, p = _data(np.float64)
    f, h = _ekf_fns()
    mats = _torch(_ekf_mats(p, np.float64))
    np.testing.assert_allclose(
        tss.ekf_logp(f, h, {"F": _torch(p["F"]), "H": _torch(p["H"])}, _torch(y), **mats).numpy(),
        tss.kalman_logp_parallel(_torch(p), _torch(y)).numpy(), rtol=1e-10)


def test_panel_rejects_bad_shapes():
    with pytest.raises(ValueError, match="expected ys"):
        tss.FederatedLGSSMPanel(torch.zeros(4))
    with pytest.raises(ValueError, match="masks shape"):
        tss.FederatedLGSSMPanel(torch.zeros(2, 5), masks=torch.ones(2, 4))


def test_linalg_under_a_chain_batch_has_batching_rules():
    """The panel and the GP-free linalg path under an outer chain vmap,
    with functorch's per-example fallback warning turned into an error:
    every op on the path has a batching rule.  The batch equals per-chain
    calls at rtol 1e-10 (float64).  Series cut to 16 steps."""
    ys, masks = _panel(np.float64)
    ys, masks = ys[:, :16], masks[:, :16]
    _, p = _data(np.float64)
    panel = tss.FederatedLGSSMPanel(_torch(ys), masks=_torch(masks))
    panel.fed.remat = True
    flat_logp, flat0, unravel, lg1 = make_flat_logp_and_grad(panel.logp, _torch(p))
    x = flat0 + 0.01 * torch.randn((3, flat0.shape[0]), generator=torch.Generator().manual_seed(1),
                                   dtype=torch.float64)
    torch._C._functorch._set_vmap_fallback_warning_enabled(True)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            v, g = make_batch_logp_and_grad(flat_logp, unravel)(x)
            v2, g2 = make_batch_logp_and_grad(flat_logp, unravel, panel.logp_and_grad)(x)
    finally:
        torch._C._functorch._set_vmap_fallback_warning_enabled(False)
    for c in range(3):
        v1, g1 = lg1(x[c])
        for vb, gb in ((v, g), (v2, g2)):
            np.testing.assert_allclose(vb[c].numpy(), v1.numpy(), rtol=1e-10)
            np.testing.assert_allclose(gb[c].numpy(), g1.numpy(), rtol=1e-10, atol=1e-12)


def test_simulate_on_injected_noise_matches_jax():
    with jax.enable_x64(True):
        _, p = _data(np.float64)
        key = jax.random.PRNGKey(4)
        noise, (jz, jy) = jax.jit(lambda q: (jss._draw_noise(q, key, T), jss._simulate(q, key, T)))(
            _jax(p))
    tz, ty = tss._simulate(_torch(p), T, noise=tuple(torch.tensor(np.asarray(n)) for n in noise))
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), **F64)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **F64)


def test_sample_latents_is_the_simulation_smoother():
    """Each draw is ``E[z|y] + z* - E[z|y*]`` for the generator's next
    noise, conditioned on the same mask."""
    y, p = _data(np.float64)
    tp, ty, tm = _torch(p), _torch(y), _torch(MASK)
    draws = tss.sample_latents(tp, ty, torch.Generator().manual_seed(5), num_draws=2, mask=tm)
    assert tuple(draws.shape) == (2, T, 2)
    gen = torch.Generator().manual_seed(5)
    sm_y, _ = tss.kalman_smoother_parallel(tp, ty, tm)
    for d in range(2):
        z_star, y_star = tss._simulate(tp, T, generator=gen)
        sm_star, _ = tss.kalman_smoother_parallel(tp, y_star, tm)
        np.testing.assert_allclose(draws[d].numpy(), (sm_y + z_star - sm_star).numpy(), rtol=1e-12)


def test_a_covariance_that_is_not_positive_definite_gives_nan_as_in_jax():
    cov = np.array([[1.0, 2.0], [2.0, 1.0]])
    x = np.array([0.3, -0.2])
    want = jss._mvn_logpdf(jnp.asarray(x, jnp.float32), jnp.zeros(2), jnp.asarray(cov, jnp.float32))
    got = tss._mvn_logpdf(torch.tensor(x, dtype=torch.float32), torch.zeros(2),
                          torch.tensor(cov, dtype=torch.float32))
    assert np.isnan(float(want)) and np.isnan(float(got))

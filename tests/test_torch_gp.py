"""The port's Gaussian processes against the JAX package's.

Inputs are made from a seed with numpy and go through both packages on
the CPU: ``generate_gp_data(2, n_obs=32, seed=9)`` (2 shards x 32
points), every hyperparameter and inducing point float32-exact.
Tolerances: in float64 (the JAX side under ``jax.enable_x64``) rtol
1e-10 on values, gradients, kernels and posterior moments (atol 1e-12
where an entry may be zero); in float32 against the JAX package in
float32, the JAX tests' tolerances (tests/test_gp.py): kernels rtol
1e-4 / atol 1e-5, values rtol 1e-5, gradients rtol 1e-3 / atol 1e-4,
posterior moments rtol 2e-3 / atol 2e-3.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytensor_federated_tpu.models.gp as jgp
import pytensor_federated_torch.models.gp as tgp
from pytensor_federated_tpu.parallel.packing import ShardedData as JaxShardedData
from pytensor_federated_torch.parallel.packing import ShardedData
from pytensor_federated_torch.samplers.mcmc import make_batch_logp_and_grad, make_flat_logp_and_grad
from pytensor_federated_torch.samplers.util import ravel
from pytensor_federated_torch.utils import tree_map, value_and_grad

F64 = dict(rtol=1e-10, atol=1e-12)
F32_KERNEL = dict(rtol=1e-4, atol=1e-5)
F32_VALUE = dict(rtol=1e-5)
F32_GRAD = dict(rtol=1e-3, atol=1e-4)
F32_POSTERIOR = dict(rtol=2e-3, atol=2e-3)
# Multiples of 0.5: the JAX package holds inducing points in float32, and
# their differences are then exact in float32 too.
INDUCING = np.linspace(-2.0, 2.0, 9).astype(np.float32)
X_STAR = np.linspace(-1.5, 1.5, 5).astype(np.float32)
KERNELS = ["sqexp", "matern32", "matern52", "linear", "sqexp+linear", "sqexp*matern32"]


def _params(kernel, dtype, lv=0.1, ll=-0.3, ln=-1.2):
    shape = jgp.kernel_hyper_shape(kernel)
    full = lambda v: np.broadcast_to(np.asarray(v, np.float32), shape).astype(dtype)
    return {"log_variance": full(lv), "log_lengthscale": full(ll),
            "log_noise": np.asarray(ln, np.float32).astype(dtype)}


def _jax(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _torch(tree):
    return {k: torch.tensor(np.array(v)) for k, v in tree.items()}


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got.detach()) if torch.is_tensor(got) else got,
                               np.asarray(want), **tol)


def _data(dtype):
    """Both packages' packed data in ``dtype`` (call the JAX one inside
    ``jax.enable_x64`` for float64)."""
    jd, _ = jgp.generate_gp_data(2, n_obs=32, seed=9)
    td, _ = tgp.generate_gp_data(2, n_obs=32, seed=9, device="cpu")
    jd = JaxShardedData(jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a), dtype), jd.data),
                        jnp.asarray(np.asarray(jd.mask), dtype))
    td = ShardedData(tree_map(lambda t: t.to(torch.float64 if dtype == np.float64 else torch.float32),
                              td.data),
                     td.mask.to(torch.float64 if dtype == np.float64 else torch.float32))
    return jd, td


@pytest.fixture(params=["float64", "float32"])
def precision(request):
    """(numpy dtype, kernel, value, gradient and posterior tolerances)."""
    if request.param == "float64":
        with jax.enable_x64(True):
            yield np.float64, F64, F64, F64, F64
    else:
        yield np.float32, F32_KERNEL, F32_VALUE, F32_GRAD, F32_POSTERIOR


def test_data_are_byte_identical():
    jd, jpool = jgp.generate_gp_data(3, n_obs=20, seed=4)
    td, tpool = tgp.generate_gp_data(3, n_obs=20, seed=4, device="cpu")
    assert jpool.tobytes() == tpool.tobytes()
    assert np.asarray(jd.mask).tobytes() == td.mask.numpy().tobytes()
    for j, t in zip(jax.tree_util.tree_leaves(jd.data), jax.tree_util.tree_leaves(
            tree_map(lambda a: a.numpy(), td.data))):
        assert np.asarray(j).tobytes() == t.tobytes()


# Composites take scalar per-component lengthscales: 1-D inputs only.
KERNEL_CASES = [(k, 1) for k in KERNELS] + [(k, 2) for k in KERNELS if "+" not in k and "*" not in k]


@pytest.mark.parametrize("kernel,ndim", KERNEL_CASES)
def test_kernels_match_jax(precision, kernel, ndim):
    dtype, ktol, _, _, _ = precision
    if ndim == 2 and "+" not in kernel and "*" not in kernel:
        ls = np.array([0.7, 1.6], np.float32).astype(dtype)  # ARD
    else:
        ls = np.asarray(0.8, np.float32).astype(dtype)
    rng = np.random.default_rng(1)
    shape = (7,) if ndim == 1 else (7, 2)
    x1 = rng.uniform(-2, 2, size=shape).astype(np.float32).astype(dtype)
    x2 = rng.uniform(-2, 2, size=(5,) + shape[1:]).astype(np.float32).astype(dtype)
    var = np.asarray(1.3, np.float32).astype(dtype)
    want = jgp.get_kernel(kernel)(jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(var), jnp.asarray(ls))
    got = tgp.get_kernel(kernel)(torch.tensor(x1), torch.tensor(x2), torch.tensor(var), torch.tensor(ls))
    _close(got, want, ktol)


def test_kernel_specs_and_errors_match_jax():
    for spec in ("sqexp", "sqexp+linear", "matern32*matern52"):
        assert tgp.kernel_components(spec) == jgp.kernel_components(spec)
        assert tgp.kernel_hyper_shape(spec) == jgp.kernel_hyper_shape(spec)
    np.testing.assert_allclose(float(tgp.stationary_prior_diag("sqexp*matern32", [2.0, 3.0])),
                               float(jgp.stationary_prior_diag("sqexp*matern32", jnp.array([2.0, 3.0]))))
    cases = [
        (lambda m: m.kernel_components("sqexp+linear*matern32"), "mixes"),
        (lambda m: m.kernel_components("rbf"), "unknown kernel"),
        (lambda m: m.stationary_prior_diag("sqexp+linear", 1.0), "linear"),
    ]
    for call, match in cases:
        with pytest.raises(ValueError, match=match):
            call(jgp)
        with pytest.raises(ValueError, match=match):
            call(tgp)
    for lib, arr in ((jgp, jnp.asarray), (tgp, torch.tensor)):
        with pytest.raises(ValueError, match="matching ndim"):
            lib._sqexp(arr(np.zeros(3)), arr(np.zeros((3, 2))), 1.0, 1.0)
        with pytest.raises(ValueError, match="scalar lengthscale"):
            lib._sqexp(arr(np.zeros(3)), arr(np.zeros(3)), 1.0, arr(np.ones(2)))
        with pytest.raises(ValueError, match="scalar lengthscale"):
            lib._linear(arr(np.zeros(3)), arr(np.zeros(3)), 1.0, arr(np.ones(2)))
    jd, td = _data(np.float32)
    with pytest.raises(ValueError, match="linear"):
        tgp.FederatedSparseGP(td, INDUCING, kernel="sqexp+linear")


@pytest.mark.parametrize("kernel", ["sqexp", "matern52", "sqexp+linear", "sqexp*matern32"])
def test_exact_gp_matches_jax(precision, kernel):
    dtype, _, vtol, gtol, _ = precision
    jd, td = _data(dtype)
    p = _params(kernel, dtype)
    jv, jg = jax.jit(jgp.FederatedExactGP(jd, kernel=kernel).logp_and_grad)(_jax(p))
    tv, tg = tgp.FederatedExactGP(td, kernel=kernel).logp_and_grad(_torch(p))
    _close(tv, jv, vtol)
    for k in jg:
        _close(tg[k], jg[k], gtol)


def test_sparse_gp_and_dense_vfe_match_jax(precision):
    dtype, _, vtol, gtol, _ = precision
    jd, td = _data(dtype)
    p = _params("sqexp", dtype)
    jv, jg = jgp.FederatedSparseGP(jd, INDUCING).logp_and_grad(_jax(p))
    tv, tg = tgp.FederatedSparseGP(td, INDUCING).logp_and_grad(_torch(p))
    _close(tv, jv, vtol)
    for k in jg:
        _close(tg[k], jg[k], gtol)
    _, pool = tgp.generate_gp_data(2, n_obs=32, seed=9, device="cpu")
    x, y = pool.astype(dtype)
    want = jax.jit(lambda q: jgp.dense_vfe_logp(q, x, y, INDUCING))(_jax(p))
    got = tgp.dense_vfe_logp(_torch(p), x, y, INDUCING)
    # JAX's dense golden casts its inputs to float32 whatever the
    # precision: tests/test_gp.py's 2e-4 for the n x n float32 Cholesky.
    _close(got, want, dict(rtol=2e-4))
    if dtype == np.float64:
        # The sparse class is the same bound in whitened algebra.
        _close(tv, got.numpy(), dict(rtol=1e-9))


@pytest.mark.parametrize("return_cov", [False, True], ids=["var", "cov"])
@pytest.mark.parametrize("family", ["exact", "sparse"])
def test_posterior_matches_jax(precision, family, return_cov):
    dtype, _, _, _, ptol = precision
    jd, td = _data(dtype)
    p = _params("sqexp", dtype)
    if family == "exact":
        jm, tm = jgp.FederatedExactGP(jd), tgp.FederatedExactGP(td)
    else:
        jm, tm = jgp.FederatedSparseGP(jd, INDUCING), tgp.FederatedSparseGP(td, INDUCING)
    want = jax.jit(lambda q: jm.posterior(q, jnp.asarray(X_STAR, dtype), return_cov=return_cov))(
        _jax(p))
    got = tm.posterior(_torch(p), X_STAR.astype(dtype), return_cov=return_cov)
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        _close(g, w, ptol)


@pytest.mark.parametrize("family", ["exact", "sparse"])
def test_posterior_sample_is_mean_plus_factor_times_normal(family):
    _, td = _data(np.float64)
    m = tgp.FederatedExactGP(td) if family == "exact" else tgp.FederatedSparseGP(td, INDUCING)
    p = _torch(_params("sqexp", np.float64))
    draws = m.posterior_sample(p, torch.Generator().manual_seed(2), X_STAR, num_draws=3)
    mean, cov = m.posterior(p, X_STAR, return_cov=True)
    assert tuple(draws.shape) == (3,) + tuple(mean.shape)
    chol = tgp._posterior_chol(cov, tgp._JITTER * tgp._jitter_scale(torch.exp(p["log_variance"])))
    eps = torch.randn((3,) + tuple(mean.shape), generator=torch.Generator().manual_seed(2),
                      dtype=torch.float64)
    want = mean[None] + (chol @ eps[..., None])[..., 0]
    np.testing.assert_allclose(draws.numpy(), want.numpy(), rtol=1e-12, atol=1e-12)


def test_padded_model_equals_dense_unpadded_build():
    """Ragged shards padded to 8: the exact GP's logp minus its prior
    equals the sum over shards of the dense Gaussian log-density of the
    real points, float64 (rtol 1e-10)."""
    rng = np.random.default_rng(7)
    shards = []
    for n in (5, 11, 8):
        x = np.sort(rng.uniform(-2, 2, size=n))
        shards.append((x, np.sin(1.3 * x) + 0.1 * rng.normal(size=n)))
    from pytensor_federated_torch.parallel.packing import pack_shards

    packed = pack_shards(shards, pad_to_multiple=8, device="cpu")
    m = tgp.FederatedExactGP(ShardedData(packed.data, packed.mask.double()))
    p = _torch(_params("sqexp", np.float64, lv=0.3, ll=-0.2, ln=-1.5))
    var, ls, noise = (float(torch.exp(p[k])) for k in ("log_variance", "log_lengthscale", "log_noise"))
    dense = 0.0
    for x, y in shards:
        n = x.shape[0]
        k = var * np.exp(-0.5 * (x[:, None] - x[None, :]) ** 2 / ls**2)
        k = k + (noise**2 + tgp._JITTER * var) * np.eye(n)
        _, logdet = np.linalg.slogdet(k)
        dense += -0.5 * (y @ np.linalg.solve(k, y) + logdet + n * np.log(2 * np.pi))
    got = float(m.logp(p) - tgp._prior_logp(p))
    np.testing.assert_allclose(got, dense, rtol=1e-10)


def test_find_map_follows_jax():
    """100 Adam steps of find_map in float32 from the same start end at
    the JAX package's point (tests/test_torch_samplers.py's find_map
    hold: rtol 1e-3, atol 1e-4; the port's Adam follows optax's float32
    bias corrections, so the comparison is in float32)."""
    jd, td = _data(np.float32)
    want = jgp.FederatedExactGP(jd).find_map(num_steps=100)
    got = tgp.FederatedExactGP(td).find_map(num_steps=100)
    for k in want:
        _close(got[k], want[k], dict(rtol=1e-3, atol=1e-4))


def test_covariance_that_is_not_positive_definite_gives_nan_in_both():
    """A float32 variance that overflows (exp(90)) makes the covariance
    non-finite and not positive definite: both packages give a NaN logp
    and do not raise."""
    jd, td = _data(np.float32)
    p = _params("sqexp", np.float32, lv=90.0, ll=0.0, ln=-1.0)
    assert np.isnan(float(jgp.FederatedExactGP(jd).logp(_jax(p))))
    assert np.isnan(float(tgp.FederatedExactGP(td).logp(_torch(p))))
    from pytensor_federated_torch.utils import cholesky_or_nan

    indefinite = np.array([[1.0, 2.0], [2.0, 1.0]], np.float32)
    np.testing.assert_array_equal(cholesky_or_nan(torch.tensor(indefinite)).numpy(),
                                  np.asarray(jnp.linalg.cholesky(indefinite)))


@pytest.mark.parametrize("family", ["exact", "sparse"])
def test_models_under_a_chain_batch_have_batching_rules(family):
    """Each model under an outer chain vmap, with functorch's per-example
    fallback warning turned into an error; the batch equals per-chain
    calls (float64, rtol 1e-10)."""
    _, td = _data(np.float64)
    m = tgp.FederatedExactGP(td) if family == "exact" else tgp.FederatedSparseGP(td, INDUCING)
    flat_logp, flat0, unravel, lg1 = make_flat_logp_and_grad(m.logp, m.init_params())
    x = flat0 + 0.1 * torch.randn((3, flat0.shape[0]), generator=torch.Generator().manual_seed(3),
                                  dtype=torch.float64)
    torch._C._functorch._set_vmap_fallback_warning_enabled(True)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            batches = [make_batch_logp_and_grad(flat_logp, unravel)(x),
                       make_batch_logp_and_grad(flat_logp, unravel, m.logp_and_grad)(x)]
    finally:
        torch._C._functorch._set_vmap_fallback_warning_enabled(False)
    for c in range(3):
        v1, g1 = lg1(x[c])
        for v, g in batches:
            np.testing.assert_allclose(v[c].numpy(), v1.numpy(), rtol=1e-10)
            np.testing.assert_allclose(g[c].numpy(), g1.numpy(), rtol=1e-10, atol=1e-12)


def _saved_bytes_and_grads(remat):
    """Under torch.func.vmap over 4 chains of the exact GP (2 shards x 32
    points, float64): the bytes autograd saves for backward, the values,
    and the gradients of the chains' sum."""
    _, td = _data(np.float64)
    m = tgp.FederatedExactGP(td)
    m.fed.remat = remat
    flat0, unravel = ravel(m.init_params())
    x = (flat0 + 0.1 * torch.arange(1, 5, dtype=torch.float64)[:, None]).requires_grad_(True)
    saved = []

    def pack(t):
        saved.append(t.numel() * t.element_size())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        v = torch.func.vmap(lambda f: m.logp(unravel(f)))(x)
    (g,) = torch.autograd.grad(v.sum(), x)
    return sum(saved), v.detach(), g, m


def test_remat_under_a_chain_vmap_saves_fewer_bytes_with_the_same_gradients():
    """``remat=True`` recomputes the shard map in the backward pass even
    under ``torch.func.vmap``: strictly fewer bytes saved for backward,
    and values and gradients equal to the non-remat path (rtol 1e-12),
    by a later ``autograd.grad`` and by ``logp_and_grad`` under vmap."""
    plain_bytes, v0, g0, plain = _saved_bytes_and_grads(False)
    remat_bytes, v1, g1, remat = _saved_bytes_and_grads(True)
    assert remat_bytes < plain_bytes, (remat_bytes, plain_bytes)
    np.testing.assert_allclose(v1.numpy(), v0.numpy(), rtol=1e-12)
    np.testing.assert_allclose(g1.numpy(), g0.numpy(), rtol=1e-12)
    x = torch.stack([ravel(plain.init_params())[0] + 0.05 * c for c in range(4)])
    for model_a, model_b in ((plain, remat),):
        fl_a, _, un_a, _ = make_flat_logp_and_grad(model_a.logp, model_a.init_params())
        fl_b, _, un_b, _ = make_flat_logp_and_grad(model_b.logp, model_b.init_params())
        va, ga = make_batch_logp_and_grad(fl_a, un_a, model_a.logp_and_grad)(x)
        vb, gb = make_batch_logp_and_grad(fl_b, un_b, model_b.logp_and_grad)(x)
        np.testing.assert_allclose(vb.numpy(), va.numpy(), rtol=1e-12)
        np.testing.assert_allclose(gb.numpy(), ga.numpy(), rtol=1e-12)


def _held_bytes_under_vjp(remat):
    """Under torch.func.vmap over 4 chains of the exact GP (2 shards x 32
    points, float64), each chain's ``torch.func.vjp``: the bytes of the
    tensors made in its forward pass that are still alive when it
    returns (what the graph holds until ``vjp_fn`` runs), the values and
    the gradients.  saved_tensors_hooks do not run under torch.func.vjp,
    so every tensor the forward makes is tracked by a weak reference."""
    import gc
    import weakref

    from torch.utils._python_dispatch import TorchDispatchMode

    class Track(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.refs = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in out if isinstance(out, (tuple, list)) else (out,):
                if isinstance(t, torch.Tensor):
                    self.refs.append(weakref.ref(t))
            return out

    _, td = _data(np.float64)
    m = tgp.FederatedExactGP(td)
    m.fed.remat = remat
    flat0, unravel = ravel(m.init_params())
    x = flat0 + 0.1 * torch.arange(1, 5, dtype=torch.float64)[:, None]
    held = []

    def one(f):
        track = Track()
        with track:
            v, vjp_fn = torch.func.vjp(lambda f: m.logp(unravel(f)), f)
        gc.collect()
        live = {id(t): t for t in (r() for r in track.refs) if t is not None}
        held.append(sum(t.numel() * t.element_size() for t in live.values()))
        (g,) = vjp_fn(torch.ones_like(v))
        return v, g

    v, g = torch.func.vmap(one)(x)
    return held[0], v, g


def test_remat_under_vjp_in_a_chain_vmap_holds_fewer_bytes_with_the_same_gradients():
    """``remat=True`` holds under a grad transform inside vmap too (the
    port's ``value_and_grad`` there, the batched samplers' path): the
    graph between ``torch.func.vjp`` and its ``vjp_fn`` keeps strictly
    fewer bytes, and values and gradients equal the non-remat path's
    (rtol 1e-12)."""
    plain_bytes, v0, g0 = _held_bytes_under_vjp(False)
    remat_bytes, v1, g1 = _held_bytes_under_vjp(True)
    assert 0 < remat_bytes < plain_bytes, (remat_bytes, plain_bytes)
    np.testing.assert_allclose(v1.numpy(), v0.numpy(), rtol=1e-12)
    np.testing.assert_allclose(g1.numpy(), g0.numpy(), rtol=1e-12)


def test_entry_points_place_on_cpu_when_asked():
    td, _ = tgp.generate_gp_data(2, n_obs=4, seed=1, device="cpu")
    p = tgp.FederatedExactGP(td).init_params()
    assert all(v.device.type == "cpu" and v.dtype == torch.float32 for v in p.values())
    sp = tgp.FederatedSparseGP(td, INDUCING).init_params()
    assert sp.keys() == p.keys()
    v, g = value_and_grad(tgp.FederatedExactGP(td).logp, p)
    assert torch.isfinite(v) and all(torch.isfinite(t) for t in g.values())


# Operations that read a device value back to the host (a sync on CUDA).
_HOST_READS = {"aten.nonzero", "aten._local_scalar_dense", "aten.item", "aten._linalg_check_errors",
               "aten.is_nonzero", "aten.equal"}


@pytest.mark.parametrize("family", ["exact", "sparse", "product_kernel", "dense_vfe"])
def test_logp_and_grad_reads_nothing_back_to_the_host(family):
    """Every aten op of a logp+grad, forward and backward, recorded on the
    CPU: none of them reads a value back to the host.  A partial proxy:
    under a dispatch mode some backward formulas take their
    subclass-safe path (``torch.prod``'s skips its ``nonzero``), so the
    card's ``torch.cuda.set_sync_debug_mode`` check (chip_smoke.py's gp
    phase, test_torch_gpu.py) is the full one."""
    from torch.utils._python_dispatch import TorchDispatchMode

    seen = set()

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            seen.add(str(func.overloadpacket))
            return func(*args, **(kwargs or {}))

    _, td = _data(np.float32)
    if family == "exact":
        model = tgp.FederatedExactGP(td)
    elif family in ("sparse", "dense_vfe"):
        model = tgp.FederatedSparseGP(td, INDUCING)
    else:
        model = tgp.FederatedExactGP(td, kernel="sqexp*matern32")
    p = model.init_params()
    if family == "dense_vfe":
        _, pool = tgp.generate_gp_data(2, n_obs=32, seed=9, device="cpu")
        x, y = pool.astype(np.float32)
        logp_and_grad = lambda p: value_and_grad(lambda q: tgp.dense_vfe_logp(q, x, y, INDUCING), p)
    else:
        logp_and_grad = model.logp_and_grad
    with Record():
        logp_and_grad(p)
    assert seen and not (seen & _HOST_READS), seen & _HOST_READS


class TestBlockedPosteriorChol:
    """The posterior draw's Cholesky dispatches concrete covariances of
    order >= ``_BLOCKED_CHOL_MIN`` onto the blocked factorization
    (``linalg.cholesky``), as the JAX package does (tests/test_gp.py's
    ``TestBlockedPosteriorChol``): the two paths agree on the same matrix
    (float64 1e-12; float32 the JAX tests' rtol 1e-4 / atol 1e-5), and
    every traced, batched, recorded or differentiated caller gets the
    dense path."""

    def _spd(self, n, dtype=np.float32, seed=0):
        rng = np.random.default_rng(seed)
        m = rng.normal(size=(n, n))
        return (m @ m.T / n + np.eye(n)).astype(dtype)

    @pytest.fixture
    def blocked_calls(self, monkeypatch):
        """Counts the blocked factorizations ``_posterior_chol`` starts."""
        import pytensor_federated_torch.linalg as tlinalg

        calls = []
        real = tlinalg.cholesky

        def spy(*args, **kwargs):
            calls.append(kwargs)
            return real(*args, **kwargs)

        monkeypatch.setattr(tlinalg, "cholesky", spy)
        return calls

    @pytest.mark.parametrize("dtype,tol", [(np.float64, dict(rtol=1e-12, atol=1e-12)),
                                           (np.float32, dict(rtol=1e-4, atol=1e-5))])
    def test_blocked_path_matches_dense_path(self, monkeypatch, blocked_calls, dtype, tol):
        cov = torch.tensor(self._spd(40, dtype, seed=21))
        dense = tgp._posterior_chol(cov, 1e-4)
        monkeypatch.setattr(tgp, "_BLOCKED_CHOL_MIN", 8)
        blocked = tgp._posterior_chol(cov, 1e-4, block=16)
        assert len(blocked_calls) == 1 and blocked_calls[0]["block"] == 16
        assert blocked.dtype == cov.dtype and blocked.device == cov.device
        np.testing.assert_allclose(blocked.numpy(), dense.numpy(), **tol)

    def test_blocked_path_equals_the_jax_packages(self, monkeypatch):
        """float64 on both sides (the JAX blocked route is numpy LAPACK)."""
        a = self._spd(48, np.float64, seed=23)
        monkeypatch.setattr(tgp, "_BLOCKED_CHOL_MIN", 8)
        monkeypatch.setattr(jgp, "_BLOCKED_CHOL_MIN", 8)
        with jax.enable_x64(True):
            want = np.asarray(jgp._posterior_chol(jnp.asarray(a), 1e-4, block=16))
        got = tgp._posterior_chol(torch.tensor(a), 1e-4, block=16)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)

    def test_sparse_sample_identical_through_dispatch(self, monkeypatch, blocked_calls):
        """The actual consumer: the same draws (same generator) whether
        the covariance factors on the dense or the blocked path."""
        _, td = _data(np.float32)
        sgp = tgp.FederatedSparseGP(td, INDUCING)
        p = _torch(_params("sqexp", np.float32))
        xs = np.linspace(-1.5, 1.5, 9).astype(np.float32)
        monkeypatch.setattr(tgp, "_BLOCKED_CHOL_MIN", 10**9)
        via_dense = sgp.posterior_sample(p, torch.Generator().manual_seed(7), xs, num_draws=3)
        assert not blocked_calls
        monkeypatch.setattr(tgp, "_BLOCKED_CHOL_MIN", 2)
        via_blocked = sgp.posterior_sample(p, torch.Generator().manual_seed(7), xs, num_draws=3)
        assert len(blocked_calls) == 1
        np.testing.assert_allclose(via_blocked.numpy(), via_dense.numpy(), rtol=1e-4, atol=1e-5)

    def test_batched_covariance_takes_dense_path(self, monkeypatch, blocked_calls):
        monkeypatch.setattr(tgp, "_BLOCKED_CHOL_MIN", 2)
        cov = torch.stack([torch.tensor(self._spd(6, seed=s)) for s in (1, 2)])
        out = tgp._posterior_chol(cov, 1e-4)
        assert tuple(out.shape) == (2, 6, 6) and not blocked_calls
        from pytensor_federated_torch.utils import cholesky_or_nan

        np.testing.assert_array_equal(out.numpy(), cholesky_or_nan(cov + 1e-4 * torch.eye(6)).numpy())

    def test_exact_gp_sample_keeps_the_dense_path(self, monkeypatch, blocked_calls):
        """The exact GP's covariances are one per shard, batched."""
        _, td = _data(np.float64)
        m = tgp.FederatedExactGP(td)
        monkeypatch.setattr(tgp, "_BLOCKED_CHOL_MIN", 2)
        draws = m.posterior_sample(_torch(_params("sqexp", np.float64)), torch.Generator().manual_seed(2),
                                   X_STAR, num_draws=2)
        assert tuple(draws.shape) == (2, 2, X_STAR.shape[0]) and not blocked_calls

    def test_a_covariance_requiring_grad_keeps_its_gradient(self, monkeypatch, blocked_calls):
        monkeypatch.setattr(tgp, "_BLOCKED_CHOL_MIN", 2)
        base = torch.tensor(self._spd(12, np.float64, seed=22))
        cov = base.clone().requires_grad_(True)
        out = tgp._posterior_chol(cov, 1e-4)
        assert not blocked_calls and out.grad_fn is not None
        (g,) = torch.autograd.grad(out.sum(), cov)
        ref = base.clone().requires_grad_(True)
        from pytensor_federated_torch.utils import cholesky_or_nan

        (want,) = torch.autograd.grad(
            cholesky_or_nan(ref + 1e-4 * torch.eye(12, dtype=torch.float64)).sum(), ref)
        np.testing.assert_array_equal(g.numpy(), want.numpy())
        # Under no_grad the same tensor is concrete: the blocked path.
        with torch.no_grad():
            blocked = tgp._posterior_chol(cov, 1e-4)
        assert len(blocked_calls) == 1
        np.testing.assert_allclose(blocked.numpy(), out.detach().numpy(), rtol=1e-12, atol=1e-12)

    def test_vmap_and_a_recording_program_take_dense_path(self, monkeypatch, blocked_calls):
        from pytensor_federated_torch import fed
        from pytensor_federated_torch.parallel import make_mesh

        monkeypatch.setattr(tgp, "_BLOCKED_CHOL_MIN", 2)
        covs = torch.stack([torch.tensor(self._spd(6, np.float64, seed=s)) for s in (3, 4)])
        mapped = torch.func.vmap(lambda c: tgp._posterior_chol(c, 1e-4))(covs)
        assert not blocked_calls
        np.testing.assert_array_equal(mapped.numpy(), tgp._posterior_chol(covs, 1e-4).numpy())

        mesh = fed.MeshPlacement(make_mesh({"shards": 2}, devices=[torch.device("cpu")] * 2))

        def model(c, data):
            l = tgp._posterior_chol(c, 1e-4)  # the driver's part of the program
            return fed.fed_sum(fed.fed_map(lambda d: (d * l.sum()).sum(), data))

        data = torch.ones((2, 3), dtype=torch.float64)
        got = fed.program(model, mesh)(covs[0], data)
        assert not blocked_calls
        want = model(covs[0], data)  # eager: concrete, so blocked
        assert len(blocked_calls) == 1
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12)

    def test_not_positive_definite_raises_blocked_and_is_nan_dense_in_both(self, monkeypatch):
        from pytensor_federated_tpu.linalg import BlockError as JBlockError
        from pytensor_federated_torch.linalg import BlockError

        bad = np.array([[1.0, 2.0, 0.0], [2.0, 1.0, 0.0], [0.0, 0.0, 1.0]])
        dense = tgp._posterior_chol(torch.tensor(bad), 0.0)
        with jax.enable_x64(True):
            jdense = np.asarray(jgp._posterior_chol(jnp.asarray(bad), 0.0))
        assert np.isnan(dense.numpy()).any() and np.isnan(jdense).any()
        monkeypatch.setattr(tgp, "_BLOCKED_CHOL_MIN", 2)
        monkeypatch.setattr(jgp, "_BLOCKED_CHOL_MIN", 2)
        with pytest.raises(BlockError, match="positive definite"):
            tgp._posterior_chol(torch.tensor(bad), 0.0, block=2)
        with pytest.raises(JBlockError, match="positive definite"):
            jgp._posterior_chol(jnp.asarray(bad), 0.0, block=2)

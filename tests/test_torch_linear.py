"""The port's packing, flagship model and sharded evaluator against JAX.

Inputs come from numpy with a seed and go through both packages on the
CPU.  Data generation, packing and the sufficient statistics are numpy
in both, so they must agree byte for byte.  logp and its gradient are
float32 in both with different reduction orders: rtol 5e-5 on values
and rtol/atol 5e-4 on gradients (tests/test_pallas.py's tolerances).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from pytensor_federated_tpu.models.linear import (
    FederatedLinearRegression as JaxModel,
    generate_node_data as jax_generate,
    linreg_suffstats as jax_suffstats,
)
from pytensor_federated_tpu.parallel.packing import pack_shards as jax_pack
import pytensor_federated_torch as pft
from pytensor_federated_torch.samplers.util import ravel
from pytensor_federated_torch.utils import tree_leaves, value_and_grad

VALUE_RTOL = 5e-5
GRAD_TOL = dict(rtol=5e-4, atol=5e-4)


def _np(t):
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def _assert_bytes_equal(a, b):
    a, b = _np(a), _np(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize(
    "n_shards,n_obs,seed", [(8, 64, 123), (3, [5, 17, 9], 7), (4, 33, 0)]
)
def test_generate_node_data_is_byte_identical(n_shards, n_obs, seed):
    jdata, joffs = jax_generate(n_shards, n_obs=n_obs, seed=seed)
    tdata, toffs = pft.generate_node_data(n_shards, n_obs=n_obs, seed=seed, device="cpu")
    _assert_bytes_equal(joffs, toffs)
    _assert_bytes_equal(jdata.mask, tdata.mask)
    for j, t in zip(jax.tree_util.tree_leaves(jdata.data), tree_leaves(tdata.data)):
        _assert_bytes_equal(j, t)


def _shards(kind, rng):
    lens = [3, 7, 5]
    if kind == "tuple":
        return [(rng.normal(size=n).astype(np.float32), rng.normal(size=(n, 2))) for n in lens]
    if kind == "dict":
        return [
            {"b": rng.normal(size=n).astype(np.float32),
             "a": (rng.integers(0, 9, size=n), rng.normal(size=(n, 3)).astype(np.float32))}
            for n in lens
        ]
    return [[rng.normal(size=n).astype(np.float32)] for n in lens]


@pytest.mark.parametrize("kind", ["tuple", "dict", "list"])
@pytest.mark.parametrize("pad_to_multiple", [1, 8])
def test_pack_shards_is_byte_identical(kind, pad_to_multiple):
    shards = _shards(kind, np.random.default_rng(3))
    j = jax_pack(shards, pad_to_multiple=pad_to_multiple)
    t = pft.pack_shards(shards, pad_to_multiple=pad_to_multiple, device="cpu")
    assert (t.n_shards, t.max_len) == (j.n_shards, j.max_len)
    _assert_bytes_equal(j.mask, t.mask)
    jl, tl = jax.tree_util.tree_leaves(j.data), tree_leaves(t.data)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        # JAX stores without x64, so 64-bit leaves come back 32-bit there.
        _assert_bytes_equal(a, _np(b).astype(np.asarray(a).dtype))


@pytest.mark.parametrize(
    "shards",
    [
        [],
        [(np.zeros(3), np.zeros(3)), (np.zeros(3),)],
        [(np.zeros(3), np.zeros(4))],
    ],
    ids=["empty", "structure", "leading-axis"],
)
def test_pack_shards_rejects_what_jax_rejects(shards):
    with pytest.raises(ValueError) as je:
        jax_pack(shards)
    with pytest.raises(ValueError) as te:
        pft.pack_shards(shards, device="cpu")
    assert str(je.value).split(",")[0] == str(te.value).split(",")[0]


def test_suffstats_are_byte_identical():
    jdata, _ = jax_generate(5, n_obs=[10, 64, 3, 40, 17], seed=11)
    tdata, _ = pft.generate_node_data(5, n_obs=[10, 64, 3, 40, 17], seed=11, device="cpu")
    (jx, jy), jm = jdata.tree()
    (tx, ty), tm = tdata.tree()
    _assert_bytes_equal(jax_suffstats(jx, jy, jm), pft.linreg_suffstats(tx, ty, tm))


def _models(use_suffstats, n_obs=64):
    jdata, _ = jax_generate(8, n_obs=n_obs, seed=123)
    tdata, _ = pft.generate_node_data(8, n_obs=n_obs, seed=123, device="cpu")
    return (
        JaxModel(jdata, use_suffstats=use_suffstats),
        pft.FederatedLinearRegression(tdata, use_suffstats=use_suffstats),
    )


def _point(jm, tm, where):
    """bench.py's probe points: the origin, and origin + 0.1 * arange."""
    jflat, junravel = ravel_pytree(jm.init_params())
    tflat, tunravel = ravel(tm.init_params())
    if where == "perturbed":
        step = np.float32(0.1) * np.arange(jflat.shape[0], dtype=np.float32)
        jflat, tflat = jflat + step, tflat + torch.from_numpy(step)
    np.testing.assert_array_equal(np.asarray(jflat), tflat.numpy())
    return junravel(jflat), tunravel(tflat)


@pytest.mark.parametrize("use_suffstats", [False, True], ids=["raw", "suffstats"])
@pytest.mark.parametrize("where", ["origin", "perturbed"])
def test_logp_and_grad_match_jax(use_suffstats, where):
    jm, tm = _models(use_suffstats)
    jp, tp = _point(jm, tm, where)
    np.testing.assert_allclose(tm.logp(tp).numpy(), np.asarray(jm.logp(jp)), rtol=VALUE_RTOL)
    jv, jg = jm.logp_and_grad(jp)
    tv, tg = tm.logp_and_grad(tp)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=VALUE_RTOL)
    assert list(tg) == sorted(jg)
    for k in jg:
        np.testing.assert_allclose(tg[k].numpy(), np.asarray(jg[k]), **GRAD_TOL)


@pytest.mark.parametrize("use_suffstats", [False, True], ids=["raw", "suffstats"])
def test_per_shard_and_batched_logps_match_jax(use_suffstats):
    jm, tm = _models(use_suffstats, n_obs=[9, 30, 64, 1, 12, 8, 50, 33])
    _, tunravel = ravel(tm.init_params())
    flats = np.random.default_rng(5).normal(scale=0.3, size=(3, 11)).astype(np.float32)
    _, junravel = ravel_pytree(jm.init_params())
    jbatch = jax.vmap(junravel)(jnp.asarray(flats))
    tbatch = tunravel(torch.from_numpy(flats))
    np.testing.assert_allclose(
        tm.fed.logp_batch(tbatch).numpy(), np.asarray(jm.fed.logp_batch(jbatch)), rtol=VALUE_RTOL
    )
    jp, tp = junravel(jnp.asarray(flats[0])), tunravel(torch.from_numpy(flats[0]))
    np.testing.assert_allclose(
        tm.fed.per_shard_logps(tp).numpy(), np.asarray(jm.fed.per_shard_logps(jp)),
        rtol=VALUE_RTOL, atol=1e-4,
    )
    jv, jg = jm.fed.logp_and_grad(jp)
    tv, tg = tm.fed.logp_and_grad(tp)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=VALUE_RTOL)
    for k in jg:
        np.testing.assert_allclose(tg[k].numpy(), np.asarray(jg[k]), **GRAD_TOL)


def test_model_from_converted_jax_data_matches():
    """``convert`` hands the JAX package's packed data and parameters to
    the port: the resulting model is the port's own, value for value."""
    jdata, _ = jax_generate(8, n_obs=[12, 7, 30, 64, 1, 5, 9, 20], seed=9)
    tdata = pft.sharded_data_from_jax(
        jax.tree_util.tree_map(np.asarray, jdata.data), np.asarray(jdata.mask), device="cpu"
    )
    jm, tm = JaxModel(jdata), pft.FederatedLinearRegression(tdata)
    jp = {k: v + 0.2 for k, v in jm.init_params().items()}
    tp = pft.params_from_jax({k: np.asarray(v) for k, v in jp.items()}, device="cpu")
    jv, jg = jm.logp_and_grad(jp)
    tv, tg = tm.logp_and_grad(tp)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=VALUE_RTOL)
    for k in jg:
        np.testing.assert_allclose(tg[k].numpy(), np.asarray(jg[k]), **GRAD_TOL)


def test_kernel_posterior_matches_model_logp():
    """The flagship's main-path posterior, ``prior + data_logp(kernel)``,
    equals the model's own autograd posterior (on the CPU the kernel's
    plain version runs)."""
    _, tm = _models(False)
    (x, y), mask = tm.data.tree()
    kern = pft.linreg_logp_grad_fn(x, y, mask)
    _, tp = _point(*_models(False), "perturbed")
    kv, kg = value_and_grad(lambda p: tm.prior_logp(p) + kern.data_logp(p), tp)
    mv, mg = tm.logp_and_grad(tp)
    np.testing.assert_allclose(kv.numpy(), mv.numpy(), rtol=VALUE_RTOL)
    for k in mg:
        np.testing.assert_allclose(kg[k].numpy(), mg[k].numpy(), **GRAD_TOL)


@pytest.mark.parametrize("use_suffstats", [False, True], ids=["raw", "suffstats"])
def test_float64_matches_jax_in_float64(use_suffstats):
    """The flagship in float64 against the JAX package under
    ``jax.enable_x64`` on the same data (ragged shards) and points:
    ``logp``, ``logp_and_grad``, ``FederatedLogp.logp_batch`` and
    ``per_shard_logps`` at rtol 1e-12 (atol 1e-12 for a gradient entry
    near zero)."""
    from pytensor_federated_tpu.parallel.packing import ShardedData as JaxShardedData

    n_obs = [9, 30, 64, 1, 12, 8, 50, 33]
    jdata, _ = jax_generate(8, n_obs=n_obs, seed=123)
    tdata, _ = pft.generate_node_data(8, n_obs=n_obs, seed=123, device="cpu")
    flats = np.random.default_rng(6).normal(scale=0.3, size=(3, 11))
    tdata64 = pft.ShardedData(data=tuple(t.double() for t in tdata.data), mask=tdata.mask.double())
    tm = pft.FederatedLinearRegression(tdata64, use_suffstats=use_suffstats)
    _, tunravel = ravel(tm.init_params())
    with jax.enable_x64(True):
        jdata64 = JaxShardedData(
            data=tuple(jnp.asarray(np.asarray(a), jnp.float64) for a in jdata.data),
            mask=jnp.asarray(np.asarray(jdata.mask), jnp.float64),
        )
        jm = JaxModel(jdata64, use_suffstats=use_suffstats)
        _, junravel = ravel_pytree({k: jnp.asarray(np.asarray(v), jnp.float64)
                                    for k, v in jm.init_params().items()})
        jp, tp = junravel(jnp.asarray(flats[0])), tunravel(torch.from_numpy(flats[0]))
        tol = dict(rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(tm.logp(tp).numpy(), np.asarray(jm.logp(jp)), **tol)
        jv, jg = jm.logp_and_grad(jp)
        tv, tg = tm.logp_and_grad(tp)
        assert tv.dtype == torch.float64
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **tol)
        for k in jg:
            np.testing.assert_allclose(tg[k].numpy(), np.asarray(jg[k]), **tol)
        jbatch = jax.vmap(junravel)(jnp.asarray(flats))
        tbatch = tunravel(torch.from_numpy(flats))
        np.testing.assert_allclose(tm.fed.logp_batch(tbatch).numpy(),
                                   np.asarray(jm.fed.logp_batch(jbatch)), **tol)
        np.testing.assert_allclose(tm.fed.per_shard_logps(tp).numpy(),
                                   np.asarray(jm.fed.per_shard_logps(jp)), **tol)
        jfv, jfg = jm.fed.logp_and_grad(jp)
        tfv, tfg = tm.fed.logp_and_grad(tp)
        np.testing.assert_allclose(tfv.numpy(), np.asarray(jfv), **tol)
        for k in jfg:
            np.testing.assert_allclose(tfg[k].numpy(), np.asarray(jfg[k]), **tol)

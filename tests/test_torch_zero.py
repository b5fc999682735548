"""The port's ZeRO-style scattered gradient (``parallel/zero.py``)
against the JAX package's on the same numpy inputs.

The port runs on an 8-slot CPU mesh (``[cpu] * 8``), the JAX package on
its own 8-device CPU mesh (``tests/conftest.py``'s ``mesh8``).  Float64
(JAX under x64): rtol 1e-12 on values, gradient slices and SGD
trajectories.  Float32: the JAX tests' own tolerances
(``tests/test_zero.py``: value rtol 1e-5, gradient rtol 1e-4).  Adam's
update is float32 arithmetic in both packages at either dtype: it is
held bit for bit against optax's ``scale_by_adam`` and its trajectory
at float32 rounding (see ``test_adam_steps_match_jax``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytensor_federated_tpu.models import linear as jlinear
from pytensor_federated_tpu.parallel import ZeroShardedLogpGrad as JZero
import pytensor_federated_torch as pft
from pytensor_federated_torch.ops.linreg_kernel import linreg_shard_logp
from pytensor_federated_torch.parallel import FederatedLogp, ZeroShardedLogpGrad, make_mesh
from pytensor_federated_torch.ppl.elbo import adam_updates
from pytensor_federated_torch.utils import value_and_grad

D = 37  # not divisible by 8: the flat vector (D + 1) pads to 40
RTOL64 = 1e-12
CPU8 = [torch.device("cpu")] * 8


def _jax_shard(params, shard):
    Xs, ys = shard
    return -0.5 * jnp.sum((ys - (Xs @ params["w"] + params["b"])) ** 2)


def _torch_shard(params, shard):
    Xs, ys = shard
    return -0.5 * torch.sum((ys - (Xs @ params["w"] + params["b"])) ** 2)


def _data(n_shards, seed=0, dtype=np.float64):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n_shards, 16, D)).astype(dtype),
            rng.normal(size=(n_shards, 16)).astype(dtype))


def _point(seed=3, dtype=np.float64):
    rng = np.random.default_rng(seed)
    return {"w": (0.1 * rng.normal(size=D)).astype(dtype), "b": dtype(0.2)}


def _jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _torch(tree):
    return jax.tree_util.tree_map(lambda a: torch.as_tensor(np.asarray(a)), tree)


def _close(got, want, rtol):
    got = np.asarray(got.detach().cpu() if torch.is_tensor(got) else got)
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * float(np.abs(want).max()))


@pytest.fixture(scope="module")
def mesh():
    return make_mesh({"shards": 8}, devices=CPU8)


@pytest.mark.parametrize("n_shards", [8, 16], ids=["one_shard_per_slot", "two_per_slot"])
def test_scattered_grad_matches_jax(mesh8, mesh, n_shards):
    """Logp, every slot's gradient slice and the gathered gradient equal
    the JAX package's (device i's slice against slot i's) in float64."""
    X, y = _data(n_shards, seed=n_shards)
    p = _point()
    z = ZeroShardedLogpGrad(_torch_shard, _torch((X, y)), _torch(p), mesh=mesh)
    sg = z.logp_and_scattered_grad(_torch(p))
    with jax.enable_x64(True):
        jz = JZero(_jax_shard, _jax((X, y)), _jax(p), mesh=mesh8)
        jsg = jz.logp_and_scattered_grad(_jax(p))
        want_slices = np.asarray(jsg.grad_slices).reshape(8, -1)
        want_full = jax.tree_util.tree_map(np.asarray, jz.gather_grad(jsg))
        want_logp = float(jsg.logp)
    assert (z.dim, z.padded_dim, z.slice_len) == (jz.dim, jz.padded_dim, 5) == (38, 40, 5)
    _close(sg.logp, want_logp, RTOL64)
    assert len(sg.grad_slices) == 8
    for i, s in enumerate(sg.grad_slices):
        assert s.shape == (5,) and s.dtype == torch.float64
        _close(s, want_slices[i], RTOL64)
    full = z.gather_grad(sg)
    for k in ("w", "b"):
        _close(full[k], want_full[k], RTOL64)


def test_padding_is_inert(mesh):
    """D = 37 (+ b) pads to 40: the last slot's slice ends in two zeros
    of padding, and the padding never reaches the parameters."""
    X, y = _data(8)
    p = _torch(_point())
    z = ZeroShardedLogpGrad(_torch_shard, _torch((X, y)), p, mesh=mesh)
    vec = z.flatten(p)
    assert vec.shape == (40,) and torch.equal(vec[38:], torch.zeros(2, dtype=vec.dtype))
    sg = z.logp_and_scattered_grad(p)
    assert torch.equal(sg.grad_slices[-1][3:], torch.zeros(2, dtype=torch.float64))
    final, _ = z.sgd_steps(p, learning_rate=1e-3, num_steps=3)
    assert final["w"].shape == (D,) and final["b"].shape == ()


def test_scattered_grad_matches_federated_logp(mesh):
    """Against the port's ``FederatedLogp(mesh=same)``: the same value and
    gradient (float64, the replicated path's summation order)."""
    X, y = _data(16, seed=5)
    p = _torch(_point(4))
    data = _torch((X, y))
    z = ZeroShardedLogpGrad(_torch_shard, data, p, mesh=mesh)
    sg = z.logp_and_scattered_grad(p)
    v, g = value_and_grad(FederatedLogp(_torch_shard, data, mesh=mesh).logp, p)
    _close(sg.logp, float(v), RTOL64)
    full = z.gather_grad(sg)
    for k in g:
        _close(full[k], g[k].numpy(), RTOL64)


def test_sgd_steps_match_jax(mesh8, mesh):
    X, y = _data(8, seed=1)
    p = _point(5)
    z = ZeroShardedLogpGrad(_torch_shard, _torch((X, y)), _torch(p), mesh=mesh)
    final, logps = z.sgd_steps(_torch(p), learning_rate=1e-3, num_steps=20)
    with jax.enable_x64(True):
        jz = JZero(_jax_shard, _jax((X, y)), _jax(p), mesh=mesh8)
        jfinal, jlogps = jz.sgd_steps(_jax(p), learning_rate=1e-3, num_steps=20)
        jfinal = jax.tree_util.tree_map(np.asarray, jfinal)
        jlogps = np.asarray(jlogps)
    assert float(logps[-1]) > float(logps[0])
    _close(logps, jlogps, RTOL64)
    for k in ("w", "b"):
        _close(final[k], jfinal[k], RTOL64)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_adam_steps_match_jax(mesh8, mesh, dtype):
    """Adam with sharded moments against the JAX loop (optax's
    ``scale_by_adam(mu_dtype=float32)``).  The update is float32
    arithmetic in both packages whatever the parameters' dtype (the
    moments are float32 and the gradient is cast to float32), and XLA's
    fused float32 arithmetic in the jitted JAX loop rounds ``u`` 1 ulp
    apart from optax run eagerly, which the port matches bit for bit
    (``test_adam_update_is_optax_scale_by_adam``).  So float64
    parameters are held at float32 rounding accumulated over 15 steps
    (rtol 1e-5, atol 1e-6; logps rtol 1e-6), float32 at the JAX test's
    tolerances (rtol 1e-3, atol 1e-4; logps rtol 1e-5)."""
    dt = np.float64 if dtype == "float64" else np.float32
    X, y = _data(8, dtype=dt)
    p = _point(6, dtype=dt)
    z = ZeroShardedLogpGrad(_torch_shard, _torch((X, y)), _torch(p), mesh=mesh)
    final, logps = z.adam_steps(_torch(p), learning_rate=0.05, num_steps=15)
    with jax.enable_x64(dtype == "float64"):
        jz = JZero(_jax_shard, _jax((X, y)), _jax(p), mesh=mesh8)
        jfinal, jlogps = jz.adam_steps(_jax(p), learning_rate=0.05, num_steps=15)
        jfinal = jax.tree_util.tree_map(np.asarray, jfinal)
        jlogps = np.asarray(jlogps)
    assert float(logps[-1]) > float(logps[0])
    assert final["w"].dtype == (torch.float64 if dtype == "float64" else torch.float32)
    rtol, atol = (1e-5, 1e-6) if dtype == "float64" else (1e-3, 1e-4)
    for k in ("w", "b"):
        np.testing.assert_allclose(final[k].numpy(), jfinal[k], rtol=rtol, atol=atol)
    np.testing.assert_allclose(logps.numpy(), jlogps, rtol=1e-6 if dtype == "float64" else 1e-5)


def test_adam_update_is_optax_scale_by_adam():
    """The slice update is ``optax.scale_by_adam(mu_dtype=float32)``'s
    ``u`` (``adam_updates`` with learning rate -1), step for step, on a
    float32 gradient sequence: same bits."""
    optax = pytest.importorskip("optax")
    rng = np.random.default_rng(11)
    grads = rng.normal(size=(12, 5)).astype(np.float32)
    tx = optax.scale_by_adam(b1=0.8, b2=0.99, eps=1e-7, mu_dtype=jnp.float32)
    state = tx.init(jnp.zeros((5,), jnp.float32))
    mu = nu = torch.zeros(5)
    for t, g in enumerate(grads, start=1):
        u_want, state = tx.update(jnp.asarray(g), state)
        (u,), (mu,), (nu,) = adam_updates([torch.from_numpy(g)], [mu], [nu], t, -1.0,
                                          b1=0.8, b2=0.99, eps=1e-7)
        np.testing.assert_array_equal(u.numpy(), np.asarray(u_want))
        np.testing.assert_array_equal(mu.numpy(), np.asarray(state.mu))
        np.testing.assert_array_equal(nu.numpy(), np.asarray(state.nu))


def test_flagship_through_the_kernel_wrapper(mesh8, mesh):
    """The flagship's per-shard logp through the kernel's wrapper
    (``linreg_shard_logp``: on CPU tensors its plain version, under the
    shard vmap rule that makes a slot's block one launch on CUDA) in
    ZeRO, against the JAX package's ZeRO over its own flagship per-shard
    logp, float32 at the JAX test's tolerances."""
    jdata, _ = jlinear.generate_node_data(16, n_obs=24, seed=9)
    (jx, jy), jm = jdata.tree()
    jmodel = jlinear.FederatedLinearRegression(jdata)
    jtree = ((jx, jy), jm, jnp.arange(16))
    p = {"intercept": np.float32(1.2), "slope": np.float32(1.7),
         "log_sigma": np.float32(-0.4), "offsets": np.linspace(-0.3, 0.3, 16).astype(np.float32)}
    jz = JZero(jmodel.fed.per_shard_logp, jtree, _jax(p), mesh=mesh8)
    jsg = jz.logp_and_scattered_grad(_jax(p))
    want = jax.tree_util.tree_map(np.asarray, jz.gather_grad(jsg))
    tree = _torch(((jx, jy), jm, jnp.arange(16)))
    z = ZeroShardedLogpGrad(linreg_shard_logp, tree, _torch(p), mesh=mesh)
    sg = z.logp_and_scattered_grad(_torch(p))
    np.testing.assert_allclose(float(sg.logp), float(jsg.logp), rtol=1e-5)
    got = z.gather_grad(sg)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-4,
                                   atol=1e-4 * float(np.abs(want[k]).max()))
    # The same as the port's plain per-shard model on the mesh.
    data, _ = pft.generate_node_data(16, n_obs=24, seed=9, device="cpu")
    v, g = value_and_grad(pft.FederatedLinearRegression(data, mesh=mesh).fed.logp, _torch(p))
    np.testing.assert_allclose(float(sg.logp), float(v), rtol=1e-5)


def test_shard_count_error_matches_jax(mesh8, mesh):
    X, y = _data(6)  # 6 shards do not divide over 8 slots
    p = _point()
    with pytest.raises(ValueError) as got:
        ZeroShardedLogpGrad(_torch_shard, _torch((X, y)), _torch(p), mesh=mesh)
    with pytest.raises(ValueError) as want:
        JZero(_jax_shard, _jax((X, y)), _jax(p), mesh=mesh8)
    assert str(got.value) == str(want.value)
    assert "not divisible" in str(got.value)

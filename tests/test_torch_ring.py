"""The port's ring collectives (``parallel/ring.py``) and the
sequence-sharded AR(1) (``models/timeseries.py``) against the JAX
package's on its 8-device CPU mesh (``tests/conftest.py``'s
``devices8``: a ``{"seq": 4}`` mesh) and against dense computations.

The port's mesh is ``[cpu] * 4``.  Inputs come from numpy with a seed.
Tolerances: float32 outputs rtol 1e-5 (atol 1e-6), float32 gradients
rtol 1e-4 (atol 1e-5): the two packages sum blocks in other orders;
float64 rtol 1e-12.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytensor_federated_tpu.models.timeseries import SeqShardedAR1 as JAR1
from pytensor_federated_tpu.models.timeseries import generate_ar1_data as jax_ar1_data
from pytensor_federated_tpu.parallel import make_mesh as jax_make_mesh
from pytensor_federated_tpu.parallel import ring as jring
import pytensor_federated_torch as pft
from pytensor_federated_torch.models.timeseries import SeqShardedAR1, generate_ar1_data
from pytensor_federated_torch.parallel import ring
from pytensor_federated_torch.parallel.mesh import make_mesh
from pytensor_federated_torch.utils import value_and_grad

F32 = dict(rtol=1e-5, atol=1e-6)
F32_GRAD = dict(rtol=1e-4, atol=1e-5)
F64 = dict(rtol=1e-12, atol=1e-12)
CPU4 = [torch.device("cpu")] * 4


@pytest.fixture(scope="module")
def meshes(devices8):
    return jax_make_mesh({"seq": 4}, devices=devices8[:4]), make_mesh({"seq": 4}, devices=CPU4)


def _qkv(seed, t=32, d=8, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=(t, d)).astype(dtype) for _ in range(3))


def _dense_attention(q, k, v, causal):
    s = (q @ k.T) / np.sqrt(q.shape[-1])
    if causal:
        s = s.masked_fill(~torch.tril(torch.ones(s.shape, dtype=torch.bool)), -torch.inf)
    return torch.softmax(s, dim=-1) @ v


@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_matches_dense_and_jax(meshes, causal):
    jmesh, tmesh = meshes
    q, k, v = _qkv(1 + causal)
    got = ring.ring_attention(*map(torch.as_tensor, (q, k, v)), mesh=tmesh, causal=causal)
    want = jring.ring_attention(*map(jnp.asarray, (q, k, v)), mesh=jmesh, causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    q64, k64, v64 = (torch.as_tensor(a, dtype=torch.float64) for a in (q, k, v))
    np.testing.assert_allclose(
        ring.ring_attention(q64, k64, v64, mesh=tmesh, causal=causal).numpy(),
        _dense_attention(q64, k64, v64, causal).numpy(), **F64)


@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_gradient_matches_jax(meshes, causal):
    """The gradient of ``sum(w * out)`` in q, k and v."""
    jmesh, tmesh = meshes
    q, k, v = _qkv(3 + causal)
    w = np.random.default_rng(9).normal(size=q.shape).astype(np.float32)
    jloss = lambda q, k, v: jnp.sum(jnp.asarray(w) * jring.ring_attention(
        q, k, v, mesh=jmesh, causal=causal))
    jg = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out = ring.ring_attention(tq, tk, tv, mesh=tmesh, causal=causal)
    tg = torch.autograd.grad(torch.sum(torch.as_tensor(w) * out), (tq, tk, tv))
    for a, b in zip(tg, jg):
        assert torch.isfinite(a).all()
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **F32_GRAD)


def _pair_jax(a, b):
    return jnp.sum(jnp.exp(-jnp.sum((a[:, None, :] - b[None, :, :]) ** 2, axis=-1)))


def _pair_torch(a, b):
    return torch.sum(torch.exp(-torch.sum((a[:, None, :] - b[None, :, :]) ** 2, dim=-1)))


@pytest.mark.parametrize("include_self", [True, False])
def test_ring_all_pairs_sum_matches_dense_and_jax(meshes, include_self):
    jmesh, tmesh = meshes
    x = np.random.default_rng(5).normal(size=(16, 3)).astype(np.float32)
    got = ring.ring_all_pairs_sum(_pair_torch, torch.as_tensor(x), mesh=tmesh,
                                  include_self=include_self)
    want = jring.ring_all_pairs_sum(_pair_jax, jnp.asarray(x), mesh=jmesh,
                                    include_self=include_self)
    np.testing.assert_allclose(float(got), float(want), **F32)
    x64 = torch.as_tensor(x, dtype=torch.float64)
    dense = _pair_torch(x64, x64)
    if not include_self:  # the four diagonal blocks
        dense = dense - sum(_pair_torch(b, b) for b in x64.split(4))
    np.testing.assert_allclose(
        float(ring.ring_all_pairs_sum(_pair_torch, x64, mesh=tmesh, include_self=include_self)),
        float(dense), **F64)


def test_ring_all_pairs_sum_is_differentiable(meshes):
    _, tmesh = meshes
    x = torch.tensor(np.random.default_rng(6).normal(size=(8, 2)), requires_grad=True)
    (g,) = torch.autograd.grad(ring.ring_all_pairs_sum(_pair_torch, x, mesh=tmesh), x)
    x2 = x.detach().clone().requires_grad_(True)
    (g_dense,) = torch.autograd.grad(_pair_torch(x2, x2), x2)
    np.testing.assert_allclose(g.numpy(), g_dense.numpy(), **F64)


def test_ring_shift_and_shift_right_move_blocks_as_ppermute(meshes):
    """Slot i holds slot i-1's block after a ring step (i+1's in reverse);
    the right shift is the global sequence shifted by one, zero first."""
    _, tmesh = meshes
    devices = tmesh.slot_devices("seq")
    blocks = [torch.full((2,), float(i)) for i in range(4)]
    assert [float(b[0]) for b in ring.ring_shift(blocks, devices)] == [3.0, 0.0, 1.0, 2.0]
    assert [float(b[0]) for b in ring.ring_shift(blocks, devices, reverse=True)] == [
        1.0, 2.0, 3.0, 0.0]
    x = torch.arange(1.0, 9.0)
    shifted = torch.cat(ring.shift_right_across_shards(list(x.split(2)), devices))
    assert shifted.tolist() == [0.0] + x[:-1].tolist()


def test_indivisible_length_errors_match_jax(meshes):
    jmesh, tmesh = meshes
    q = np.zeros((30, 4), np.float32)
    msgs = []
    for run in (lambda: jring.ring_attention(*(jnp.asarray(q),) * 3, mesh=jmesh),
                lambda: ring.ring_attention(*(torch.as_tensor(q),) * 3, mesh=tmesh),
                lambda: jring.seq_sharded_markov_logp(None, None, jnp.asarray(q), mesh=jmesh),
                lambda: ring.seq_sharded_markov_logp(None, None, torch.as_tensor(q),
                                                     mesh=tmesh)):
        with pytest.raises(ValueError) as e:
            run()
        msgs.append(str(e.value))
    assert set(msgs) == {"sequence length 30 not divisible by 4"}
    with pytest.raises(ValueError, match=r"mesh has no axis 'time'"):
        ring.seq_sharded_markov_logp(None, None, torch.as_tensor(q), mesh=tmesh, axis="time")


def _ar1_params(dtype):
    return {"mu": np.asarray(0.4, dtype), "arctanh_phi": np.asarray(0.9, dtype),
            "log_sigma": np.asarray(-1.1, dtype)}


def test_generate_ar1_data_is_the_jax_packages():
    np.testing.assert_array_equal(generate_ar1_data(256, seed=3), jax_ar1_data(256, seed=3))


@pytest.mark.parametrize("sharded", [True, False])
def test_seq_sharded_ar1_matches_jax(meshes, sharded):
    jmesh, tmesh = meshes
    y = generate_ar1_data(64, seed=2)
    p = _ar1_params(np.float32)
    jm = JAR1(y, mesh=jmesh if sharded else None)
    tm = SeqShardedAR1(y, mesh=tmesh if sharded else None, device="cpu")
    jv, jg = jm.logp_and_grad({k: jnp.asarray(v) for k, v in p.items()})
    tv, tg = tm.logp_and_grad({k: torch.as_tensor(v) for k, v in p.items()})
    np.testing.assert_allclose(float(tv), float(jv), **F32)
    np.testing.assert_allclose(float(tm.logp({k: torch.as_tensor(v) for k, v in p.items()})),
                               float(jv), **F32)
    for k in jg:
        np.testing.assert_allclose(float(tg[k]), float(jg[k]), **F32_GRAD)
    assert sorted(tm.init_params()) == sorted(jm.init_params())


def test_seq_sharded_ar1_mesh_equals_no_mesh_in_float64(meshes):
    _, tmesh = meshes
    y = generate_ar1_data(128, seed=4).astype(np.float64)
    p = {k: torch.as_tensor(v) for k, v in _ar1_params(np.float64).items()}
    v, g = SeqShardedAR1(y, mesh=tmesh).logp_and_grad(p)
    v0, g0 = SeqShardedAR1(y, device="cpu").logp_and_grad(p)
    np.testing.assert_allclose(float(v), float(v0), **F64)
    for k in g0:
        np.testing.assert_allclose(float(g[k]), float(g0[k]), **F64)


def test_seq_sharded_markov_logp_with_features_matches_jax(meshes):
    """A user-defined Markov model on ``(T, 2)`` observations."""
    jmesh, tmesh = meshes
    y = np.random.default_rng(8).normal(size=(32, 2)).astype(np.float32)

    def trans(lib):
        return lambda p, a, b: -0.5 * lib.sum((b - p["rho"] * a) ** 2, axis=-1)

    def init(lib):
        return lambda p, y0: -0.5 * lib.sum(y0**2)

    jf = jring.seq_sharded_markov_logp(trans(jnp), init(jnp), jnp.asarray(y), mesh=jmesh)
    tf = ring.seq_sharded_markov_logp(
        lambda p, a, b: -0.5 * torch.sum((b - p["rho"] * a) ** 2, dim=-1),
        lambda p, y0: -0.5 * torch.sum(y0**2), torch.as_tensor(y), mesh=tmesh)
    jv, jg = jax.value_and_grad(jf)({"rho": jnp.asarray(0.3)})
    tv, tg = value_and_grad(tf, {"rho": torch.tensor(0.3)})
    np.testing.assert_allclose(float(tv), float(jv), **F32)
    np.testing.assert_allclose(float(tg["rho"]), float(jg["rho"]), **F32_GRAD)
    assert pft.parallel.seq_sharded_markov_logp is ring.seq_sharded_markov_logp

"""The port's Ulysses all-to-all sequence parallelism
(``parallel/ulysses.py``) against the JAX package's on the same numpy
inputs, against dense multi-head attention, and against the port's
``ring_attention`` head by head.

The port runs on a 4-slot CPU mesh (``[cpu] * 4``), the JAX package on
its 4-device CPU mesh over ``tests/conftest.py``'s ``devices8``.
Float64 (JAX under x64): rtol 1e-12 on outputs and gradients.  Float32:
``tests/test_ulysses.py``'s tolerances (atol 1e-5 on outputs, 1e-4 on
gradients, 2e-5 at the shape corners).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytensor_federated_tpu.parallel import make_mesh as jmake_mesh
from pytensor_federated_tpu.parallel import ulysses as julysses
from pytensor_federated_torch.parallel import (
    heads_to_seq,
    make_mesh,
    ring_attention,
    seq_to_heads,
    ulysses_attention,
)

RTOL64 = 1e-12
CPU4 = [torch.device("cpu")] * 4


@pytest.fixture(scope="module")
def mesh():
    return make_mesh({"seq": 4}, devices=CPU4)


@pytest.fixture(scope="module")
def jmesh(devices8):
    return jmake_mesh({"seq": 4}, devices=devices8[:4])


def _qkv(seed, t=32, h=8, d=16, dtype=np.float64):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=(t, h, d)).astype(dtype) for _ in range(3))


def dense_mha(q, k, v, *, causal=False):
    """(T, H, d) dense multi-head attention, head at a time."""
    outs = []
    for j in range(q.shape[1]):
        s = (q[:, j] @ k[:, j].T) / math.sqrt(q.shape[-1])
        if causal:
            t = q.shape[0]
            s = torch.where(torch.tril(torch.ones((t, t), dtype=torch.bool)), s, -math.inf)
        outs.append(torch.softmax(s, dim=-1) @ v[:, j])
    return torch.stack(outs, dim=1)


def _jax_out(qkv, jmesh, causal, x64):
    with jax.enable_x64(x64):
        return np.asarray(julysses.ulysses_attention(
            *(jnp.asarray(a) for a in qkv), mesh=jmesh, axis="seq", causal=causal))


def _check64(got, want):
    got = got.detach().numpy() if torch.is_tensor(got) else got
    np.testing.assert_allclose(got, want, rtol=RTOL64, atol=RTOL64 * float(np.abs(want).max()))


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_matches_jax_dense_and_ring_float64(mesh, jmesh, causal):
    qkv = _qkv(1 + causal)
    q, k, v = (torch.as_tensor(a) for a in qkv)
    out = ulysses_attention(q, k, v, mesh=mesh, axis="seq", causal=causal)
    assert out.shape == q.shape and out.dtype == torch.float64
    _check64(out, _jax_out(qkv, jmesh, causal, True))
    _check64(out, dense_mha(q, k, v, causal=causal).numpy())
    ring = torch.stack([ring_attention(q[:, j], k[:, j], v[:, j], mesh=mesh, axis="seq",
                                       causal=causal) for j in range(q.shape[1])], dim=1)
    _check64(out, ring.numpy())


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_matches_jax_float32(mesh, jmesh, causal):
    qkv = _qkv(3 + causal, dtype=np.float32)
    q, k, v = (torch.as_tensor(a) for a in qkv)
    out = ulysses_attention(q, k, v, mesh=mesh, axis="seq", causal=causal)
    np.testing.assert_allclose(out.numpy(), _jax_out(qkv, jmesh, causal, False), atol=1e-5)
    np.testing.assert_allclose(out.numpy(), dense_mha(q, k, v, causal=causal).numpy(), atol=1e-5)


def test_all_to_all_layout(mesh):
    """seq_to_heads gives slot j the whole sequence of head chunk j
    (source blocks in slot order); heads_to_seq undoes it exactly."""
    x = torch.arange(16 * 8 * 2, dtype=torch.float64).reshape(16, 8, 2)
    devices = mesh.slot_devices("seq")
    blocks = [x[i * 4:(i + 1) * 4] for i in range(4)]
    heads = seq_to_heads(blocks, devices)
    for j, hb in enumerate(heads):
        assert torch.equal(hb, x[:, 2 * j:2 * j + 2])
    back = heads_to_seq(heads, devices)
    for i, b in enumerate(back):
        assert torch.equal(b, blocks[i])


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_gradients_match_jax(mesh, jmesh, causal):
    """d sum(out^2) / d (q, k, v) through the all-to-alls' copies,
    against the JAX package's gradient and the dense one (float64)."""
    qkv = _qkv(5 + causal, t=16, h=4, d=8)
    ts = [torch.as_tensor(a).requires_grad_(True) for a in qkv]
    loss = torch.sum(ulysses_attention(*ts, mesh=mesh, axis="seq", causal=causal) ** 2)
    got = torch.autograd.grad(loss, ts)
    dense = [torch.as_tensor(a).requires_grad_(True) for a in qkv]
    want_dense = torch.autograd.grad(torch.sum(dense_mha(*dense, causal=causal) ** 2), dense)
    with jax.enable_x64(True):
        jfn = lambda q, k, v: jnp.sum(julysses.ulysses_attention(
            q, k, v, mesh=jmesh, axis="seq", causal=causal) ** 2)
        want = jax.grad(jfn, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in qkv))
    for g, w, wd in zip(got, want, want_dense):
        _check64(g, np.asarray(w))
        _check64(g, wd.numpy())


@pytest.mark.parametrize(
    "t,h,d,causal",
    [(4, 4, 1, True), (8, 8, 2, True), (64, 4, 4, True), (16, 12, 3, False)],
)
def test_dimension_corners(mesh, t, h, d, causal):
    """The JAX test's shape corners, against dense MHA (float32, atol 2e-5)."""
    q, k, v = (torch.as_tensor(a) for a in _qkv(t * h + d, t=t, h=h, d=d, dtype=np.float32))
    out = ulysses_attention(q, k, v, mesh=mesh, axis="seq", causal=causal)
    np.testing.assert_allclose(out.numpy(), dense_mha(q, k, v, causal=causal).numpy(), atol=2e-5)


def _errors(pkg, mesh):
    """The five validation errors' messages."""
    cases = [(30, 4, 8, "seq", None), (16, 6, 8, "seq", None), (16, 4, 8, "nope", None),
             (16, 4, 8, "seq", "k_heads"), (16, 4, 8, "seq", "ndim")]
    out = []
    for t, h, d, axis, bad in cases:
        q, k, v = _qkv(7, t=t, h=h, d=d, dtype=np.float32)
        if bad == "k_heads":
            k = k[:, :2]
        if bad == "ndim":
            q, k, v = q[:, 0], k[:, 0], v[:, 0]
        try:
            if pkg == "torch":
                ulysses_attention(*(torch.as_tensor(a) for a in (q, k, v)), mesh=mesh, axis=axis)
            else:
                julysses.ulysses_attention(*(jnp.asarray(a) for a in (q, k, v)), mesh=mesh,
                                           axis=axis)
            out.append(None)
        except ValueError as e:
            out.append(str(e))
    return out


def test_errors_match_jax(mesh, jmesh):
    got = _errors("torch", mesh)
    want = _errors("jax", jmesh)
    assert None not in got
    assert got[0].startswith("sequence length 30 not divisible")
    assert got[1].startswith("head count 6") and "no axis" in got[2]
    assert "shapes differ" in got[3] and "expected (T, H, d)" in got[4]
    # The mesh's repr differs between the packages; the rest is the same.
    assert got[:2] + got[3:] == want[:2] + want[3:]
    assert got[2].split(":")[0] == want[2].split(":")[0]

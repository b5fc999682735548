"""The Hopper kernel on the card, against its plain PyTorch version.

Marked ``gpu``: each test decides inside itself whether a CUDA device is
present and skips without one, so on the CPU these count as skips.  The
GPU host has no JAX, and ``tests/conftest.py`` imports it, so this file
imports neither and runs there as

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Tolerances against the float64 plain version on the same float32
inputs: rtol 2e-5 on ll (every term has the same sign); on the gradient
reductions, which may cancel, 2e-5 times the sum of the terms'
magnitudes (the kernel sums float32 terms at most ~50 deep, worst case
~3e-6 of that sum).  The totals over shards against the float64 sum of
the kernel's own per-shard outputs: 4e-6 times the sum of their
magnitudes (at most 24 float32 additions deep, ~1.4e-6).
"""

import numpy as np
import pytest
import torch

from pytensor_federated_torch.ops import linreg_kernel
from pytensor_federated_torch.ops.linreg_kernel import (
    linreg_logp_grad_fn,
    linreg_reductions,
    linreg_reductions_and_totals,
    linreg_reductions_ref,
)
from pytensor_federated_torch.utils import value_and_grad

SHAPES = [
    (1, 8), (5, 70), (8, 512), (12, 700), (8, 64), (5, 4099), (3, 20000),
    # The persistent schedule: fewer tiles than blocks, one very long row
    # (a ragged tail after 488 tiles), many short rows, and a tile count
    # (7 x 53 = 371 tiles) that the grid does not divide.
    (2, 4100), (1, 2_000_003), (4096, 37), (7, 53 * 4096),
]
UNEVEN = (7, 53 * 4096)


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc; runs on the GPU host")
    return torch.device("cuda")


def _case(S, N, dev, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(S, N)).astype(np.float32)
    y = (1.0 + 2.0 * x + 0.3 * rng.normal(size=(S, N))).astype(np.float32)
    mask = (rng.uniform(size=(S, N)) > 0.25).astype(np.float32)
    scalars = np.array([0.7, 1.8, -0.2], np.float32)
    offsets = rng.normal(size=S).astype(np.float32)
    return [torch.tensor(a, device=dev) for a in (scalars, offsets, x, y, mask)]


@pytest.mark.gpu
@pytest.mark.parametrize("S,N", SHAPES)
def test_kernel_matches_plain_version(S, N):
    args = _case(S, N, _cuda())
    before = linreg_reductions.launches
    got = linreg_reductions(*args)
    again = linreg_reductions(*args)
    assert linreg_reductions.launches == before + 2
    for g, a in zip(got, again):
        assert torch.equal(g, a)  # no float atomics: reruns are bitwise equal
    scal, offs, x, y, m = (a.double().cpu() for a in args)
    ref = linreg_reductions_ref(scal, offs, x, y, m)
    np.testing.assert_allclose(got[0].cpu().double(), ref[0], rtol=2e-5)
    inv_s2 = torch.exp(-2.0 * scal[2])
    r = y - ((scal[0] + offs[:, None]) + scal[1] * x)
    sum_abs = [
        (m * r.abs()).sum(1) * inv_s2,
        (m * (r * x).abs()).sum(1) * inv_s2,
        (m * (r * r * inv_s2 - 1.0).abs()).sum(1),
    ]
    for g, want, scale in zip(got[1:], ref[1:], sum_abs):
        assert torch.all((g.cpu().double() - want).abs() <= 2e-5 * scale)


@pytest.mark.gpu
def test_data_logp_gradient_matches_cpu_path():
    """value and gradient through the autograd Function on the card equal
    the CPU path (the plain version) at rtol 5e-5 / 5e-4."""
    dev = _cuda()
    _, offs, x, y, m = _case(6, 3000, dev, seed=3)
    params = {"intercept": 0.4, "slope": 1.7, "log_sigma": -0.3}
    p_gpu = {k: torch.tensor(v, device=dev) for k, v in params.items()}
    p_gpu["offsets"] = offs * 0.1
    p_cpu = {k: v.cpu() for k, v in p_gpu.items()}
    gv, gg = linreg_logp_grad_fn(x, y, m)(p_gpu)
    cv, cg = linreg_logp_grad_fn(x.cpu(), y.cpu(), m.cpu())(p_cpu)
    np.testing.assert_allclose(gv.cpu(), cv, rtol=5e-5)
    for k in cg:
        np.testing.assert_allclose(gg[k].cpu(), cg[k], rtol=5e-4, atol=5e-4)
    p = {k: v.detach().requires_grad_(True) for k, v in p_gpu.items()}
    fn = linreg_logp_grad_fn(x, y, m)
    with pytest.raises(RuntimeError, match="second-order"):
        torch.autograd.grad(fn.data_logp(p), list(p.values()), create_graph=True)
    value_and_grad(fn.data_logp, p_gpu)  # the plain call still works after


@pytest.mark.gpu
@pytest.mark.parametrize("bad", ["float64", "non-contiguous"])
def test_kernel_wrapper_rejects_what_the_kernel_cannot_take(bad):
    args = _case(4, 64, _cuda())
    if bad == "float64":
        args[2] = args[2].double()
        with pytest.raises(TypeError):
            linreg_reductions(*args)
    else:
        args[2] = torch.empty((64, 4), device=args[2].device).T
        with pytest.raises(ValueError):
            linreg_reductions(*args)


@pytest.mark.gpu
def test_uneven_shape_leaves_a_partial_round():
    """The UNEVEN shape's tile count is not a multiple of the grid."""
    _cuda()
    lib = linreg_kernel._kernel_lib()
    S, N = UNEVEN
    n_tiles = S * -(-N // lib.linreg_tile())
    blocks = lib.linreg_persistent_blocks()
    assert blocks > 0 and n_tiles > blocks and n_tiles % blocks != 0


@pytest.mark.gpu
@pytest.mark.parametrize("S,N", [(8, 64), (5, 4099), (4096, 37), UNEVEN, (8, 131_072)])
def test_bits_do_not_depend_on_grid(S, N):
    """Partials are kept per tile and summed in tile order, so a grid
    capped to a few blocks gives the persistent grid's bits."""
    scal, *rest = _case(S, N, _cuda(), seed=5)
    full = linreg_kernel._launch(scal.unbind(), *rest)
    for cap in (1, 3, 7):
        assert torch.equal(linreg_kernel._launch(scal.unbind(), *rest, max_blocks=cap), full)


@pytest.mark.gpu
def test_two_streams_keep_their_tickets():
    """Back-to-back calls on two streams, overlapping on the card, each
    give the result of a call alone: each stream has its own ticket."""
    dev = _cuda()
    a = _case(8, 1 << 20, dev, seed=6)
    b = _case(8, 1 << 20, dev, seed=7)
    want_a, want_b = linreg_reductions(*a), linreg_reductions(*b)
    streams = torch.cuda.Stream(dev), torch.cuda.Stream(dev)
    for st in streams:
        st.wait_stream(torch.cuda.current_stream(dev))
    got = {0: [], 1: []}
    for _ in range(10):
        for k, (st, args) in enumerate(zip(streams, (a, b))):
            with torch.cuda.stream(st):
                got[k].append(linreg_reductions(*args))
    torch.cuda.synchronize(dev)
    for k, want in ((0, want_a), (1, want_b)):
        for res in got[k]:
            assert all(torch.equal(g, w) for g, w in zip(res, want))


@pytest.mark.gpu
@pytest.mark.parametrize("S,N", [(8, 64), (8, 131_072), (64, 65_536), (4096, 37)])
def test_totals_equal_float64_sum_of_shards(S, N):
    args = _case(S, N, _cuda(), seed=8)
    red, totals = linreg_reductions_and_totals(*args)
    per_shard = torch.stack(red, dim=1).double()
    want = per_shard.sum(0)
    scale = per_shard.abs().sum(0)
    assert torch.all((totals.double() - want).abs() <= 4e-6 * scale)


@pytest.mark.gpu
def test_node_on_the_card_serves_the_kernel_over_tcp():
    """A node owning two shards on the card answers TCP requests with one
    kernel launch each, and its replies equal a CPU node's (the plain
    version) at rtol 5e-5 / 5e-4."""
    import threading

    from pytensor_federated_torch.service import TcpArraysClient, device_compute_fn, serve_tcp_once
    from pytensor_federated_torch.wrappers import wrap_logp_grad_fn

    dev = _cuda()
    _, _, x, y, m = _case(2, 5000, dev, seed=9)
    keys = ("intercept", "slope", "log_sigma", "offsets")

    def node(device):
        kern = linreg_logp_grad_fn(x.to(device), y.to(device), m.to(device))

        def logp_grad(*params):
            logp, g = kern(dict(zip(keys, params)))
            return logp, tuple(g[k] for k in keys)

        return device_compute_fn(wrap_logp_grad_fn(logp_grad), device=device)

    ports = []
    for device in ("cuda", "cpu"):
        ready = threading.Event()
        threading.Thread(target=serve_tcp_once, args=(node(device),), daemon=True,
                         kwargs={"max_connections": 1, "concurrent": True,
                                 "ready_callback": lambda p, r=ready: (ports.append(p), r.set())}).start()
        assert ready.wait(30)
    clients = [TcpArraysClient("127.0.0.1", p, timeout_s=60) for p in ports]
    try:
        before = linreg_reductions.launches
        for i in range(5):
            req = [np.float32(0.1 * i), np.float32(1.9), np.float32(-0.2),
                   np.array([0.1, -0.2], np.float32)]
            on_card, plain = (c.evaluate(*req) for c in clients)
            np.testing.assert_allclose(on_card[0], plain[0], rtol=5e-5)
            for g, w in zip(on_card[1:], plain[1:]):
                assert g.shape == w.shape and g.dtype == np.float32
                np.testing.assert_allclose(g, w, rtol=5e-4, atol=5e-4)
        assert linreg_reductions.launches == before + 5
    finally:
        for c in clients:
            c.close()

"""The Hopper kernel and the models on the card, against their plain
PyTorch versions.

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

The radon, logistic and Lotka-Volterra models in float32 on the card
against the same models in float64 on the CPU: value within rtol 1e-5,
gradient within 1e-4 |g| + 1e-5 max|g of the leaf| (float32 on the CPU
lands ~25x inside both).  The three logistic forms on the card agree
behind bench.py's equality gate (value rtol 2e-4, gradient rtol 2e-3 /
atol 1e-3).
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
from pytensor_federated_torch.utils import tree_map, value_and_grad

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


def _f64_cpu(data):
    import pytensor_federated_torch as pft

    if torch.is_tensor(data):
        return data.cpu().double()
    return pft.ShardedData(data=tree_map(lambda t: t.cpu().double(), data.data),
                           mask=data.mask.cpu().double())


def _model_pair(name, dev):
    """(model on ``dev``, the same model in float64 on the CPU)."""
    import pytensor_federated_torch as pft

    if name == "radon":
        data, _ = pft.generate_radon_data(16, seed=12, device=dev)
        return pft.HierarchicalRadonGLM(data), pft.HierarchicalRadonGLM(_f64_cpu(data))
    if name.startswith("logistic"):
        data, _ = pft.generate_logistic_data(n_shards=64, n_obs=64, n_features=8, device=dev)
        kw = {"logistic": {}, "logistic_suffstats": {"use_suffstats": True},
              "logistic_flat": {"flatten": True}}[name]
        return (pft.FederatedLogisticRegression(data, **kw),
                pft.FederatedLogisticRegression(_f64_cpu(data), **kw))
    if name == "hier_logistic":
        data, _ = pft.generate_hier_logistic_data(16, n_obs=64, n_features=4, device=dev)
        return pft.HierarchicalLogisticRegression(data), pft.HierarchicalLogisticRegression(_f64_cpu(data))
    model, meta = pft.make_lv_model(8, device=dev)
    return model, pft.LotkaVolterraModel(_f64_cpu(model.observations), meta["y0"], meta["dt"],
                                         meta["n_steps"], meta["obs_idx"])


def _points(init, seed=5):
    from pytensor_federated_torch.samplers.util import ravel

    flat, unravel = ravel(init)
    noise = 0.3 * torch.randn(flat.shape, generator=torch.Generator().manual_seed(seed))
    return [init, unravel(flat + 0.05), unravel(flat + noise.to(flat.device))]


@pytest.mark.gpu
@pytest.mark.parametrize(
    "name", ["radon", "logistic", "logistic_suffstats", "logistic_flat", "hier_logistic", "lv"]
)
def test_model_on_the_card_matches_float64_on_the_cpu(name):
    model, model64 = _model_pair(name, _cuda())
    for p in _points(model.init_params()):
        assert all(t.device.type == "cuda" for t in p.values())
        v, g = model.logp_and_grad(p)
        v64, g64 = model64.logp_and_grad({k: t.cpu().double() for k, t in p.items()})
        assert v.device.type == "cuda"
        np.testing.assert_allclose(float(v), float(v64), rtol=1e-5)
        for k in g64:
            err = (g[k].cpu().double() - g64[k]).abs()
            assert torch.all(err <= 1e-4 * g64[k].abs() + 1e-5 * g64[k].abs().max()), k


@pytest.mark.gpu
def test_logistic_forms_agree_on_the_card():
    import pytensor_federated_torch as pft

    data, _ = pft.generate_logistic_data(n_shards=64, n_obs=64, n_features=8, device=_cuda())
    forms = [pft.FederatedLogisticRegression(data, **kw)
             for kw in ({}, {"use_suffstats": True}, {"flatten": True})]
    for p in _points(forms[0].init_params()):
        va, ga = forms[0].logp_and_grad(p)
        for other in forms[1:]:
            vb, gb = other.logp_and_grad(p)
            np.testing.assert_allclose(float(vb), float(va), rtol=2e-4)
            for k in ga:
                np.testing.assert_allclose(gb[k].cpu(), ga[k].cpu(), rtol=2e-3, atol=1e-3)


# ---- the chain axis and lockstep chains ----


def _chain_case(S, N, chains, dev, seed=0):
    scalars, offsets, x, y, m = _case(S, N, dev, seed)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    scalars = scalars + 0.1 * torch.randn((chains, 3), generator=g, device=dev)
    offsets = offsets + torch.randn((chains, S), generator=g, device=dev)
    return scalars, offsets, x, y, m


@pytest.mark.gpu
@pytest.mark.parametrize("chains", [1, 3, 16])
@pytest.mark.parametrize("S,N", [(8, 64), (5, 4099), (4096, 37), (8, 131_072)])
def test_chain_batched_kernel_matches_chains_alone_and_plain_version(S, N, chains):
    """One launch for C parameter sets: each chain's bits equal the chain
    called alone (for C = 1, the unbatched call), and each chain is
    within the tolerances above of the float64 plain version."""
    scal, offs, x, y, m = _chain_case(S, N, chains, _cuda(), seed=10)
    before = linreg_reductions.launches
    red, tot = linreg_reductions_and_totals(scal, offs, x, y, m)
    assert linreg_reductions.launches == before + 1
    assert red[0].shape == (chains, S) and tot.shape == (chains, 4)
    ref = linreg_reductions_ref(scal.double().cpu(), offs.double().cpu(),
                                *(t.double().cpu() for t in (x, y, m)))
    for c in range(chains):
        one, one_tot = linreg_reductions_and_totals(scal[c], offs[c], x, y, m)
        assert all(torch.equal(a, b[c]) for a, b in zip(one, red))
        assert torch.equal(one_tot, tot[c])
        np.testing.assert_allclose(red[0][c].cpu().double(), ref[0][c], rtol=2e-5)
    capped = linreg_kernel._launch(scal.unbind(-1), offs, x, y, m, max_blocks=3)
    assert all(torch.equal(capped[..., :S, k], red[k]) for k in range(4))


@pytest.mark.gpu
def test_kernel_under_vmap_is_one_launch_for_all_chains():
    """``torch.func.vmap`` of prior + data_logp over chains, then one
    backward pass: one kernel launch, each chain's value and gradient
    those of its own call."""
    dev = _cuda()
    scal, offs, x, y, m = _chain_case(8, 64, 4, dev, seed=11)
    fn = linreg_logp_grad_fn(x, y, m)
    p = {"intercept": scal[:, 0], "slope": scal[:, 1], "log_sigma": scal[:, 2], "offsets": offs}
    p = {k: v.detach().clone().requires_grad_(True) for k, v in p.items()}

    def post(q):
        return -0.5 * q["slope"] ** 2 + fn.data_logp(q)

    before = linreg_reductions.launches
    values = torch.func.vmap(post)(p)
    assert linreg_reductions.launches == before + 1
    grads = torch.autograd.grad(values.sum(), list(p.values()))
    for c in range(4):
        v, g = value_and_grad(post, {k: t[c].detach() for k, t in p.items()})
        assert torch.equal(v, values[c].detach())
        for gb, k in zip(grads, p):
            np.testing.assert_allclose(gb[c].cpu(), g[k].cpu(), rtol=1e-6, atol=1e-6)


@pytest.mark.gpu
def test_lockstep_nuts_transition_on_the_card_matches_the_cpu():
    """One NUTS transition of four chains in lockstep on the flagship
    posterior: through the kernel on the card and through its plain
    version on the CPU, on the same draws.  Float32 in both; the trees
    must make the same choices and land on the same positions within
    rtol 1e-4 / atol 1e-5."""
    import pytensor_federated_torch as pft
    from pytensor_federated_torch.samplers import hmc, nuts
    from pytensor_federated_torch.samplers.mcmc import make_batch_logp_and_grad, make_flat_logp_and_grad

    dev = _cuda()
    out = {}
    draws = None
    for device in ("cuda", "cpu"):
        data, _ = pft.generate_node_data(8, n_obs=64, seed=123, device=device)
        model = pft.FederatedLinearRegression(data)
        (xx, yy), mask = data.tree()
        kern = linreg_logp_grad_fn(xx, yy, mask)
        flat_logp, flat0, unravel, _ = make_flat_logp_and_grad(
            lambda q: model.prior_logp(q) + kern.data_logp(q), model.init_params())
        lg = make_batch_logp_and_grad(flat_logp, unravel)
        x = flat0 + 0.1 * torch.arange(4 * flat0.shape[0], dtype=flat0.dtype,
                                       device=flat0.device).reshape(4, -1) / 44.0
        if draws is None:
            draws = nuts.draw_nuts(torch.Generator(device="cpu").manual_seed(12), x.cpu(), 6)
        state = hmc.hmc_init(lg, x)
        before = linreg_reductions.launches
        new, info = nuts.nuts_step(lg, state, None, step_size=0.02, inv_mass=torch.ones_like(x),
                                   max_depth=6, draws=nuts.NUTSDraws(*(t.to(device) for t in draws)))
        out[device] = (new, info, linreg_reductions.launches - before)
    (gn, gi, launches), (cn, ci, cpu_launches) = out["cuda"], out["cpu"]
    assert cpu_launches == 0 and launches > 0
    assert gi.depth.tolist() == ci.depth.tolist()
    assert gi.diverging.tolist() == ci.diverging.tolist()
    np.testing.assert_allclose(gn.x.cpu(), cn.x, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(gn.logp.cpu(), cn.logp, rtol=1e-5)


# ---- the state-space models, the Gaussian processes and tempering ----


def _vg_close(got, want, value_rtol, grad_rtol, grad_atol):
    (v, g), (v64, g64) = got, want
    np.testing.assert_allclose(float(v), float(v64), rtol=value_rtol)
    for k in g64:
        np.testing.assert_allclose(g[k].cpu().double(), g64[k], rtol=grad_rtol, atol=grad_atol)


@pytest.mark.gpu
@pytest.mark.parametrize("form", ["kalman_logp_seq", "kalman_logp_parallel"])
def test_kalman_filter_on_the_card_matches_float64_on_the_cpu(form):
    """Config 6's data at T = 512 (seed 7): each filter's logp+grad on the
    card, float32 with TF32 off, against itself in float64 on the CPU at
    the JAX tests' tolerances (value rtol 1e-4; gradient rtol 1e-3, atol
    1e-4); the smoothers on the card against each other at 1e-3 / 1e-4."""
    import pytensor_federated_torch as pft
    from pytensor_federated_torch.models import statespace as ss

    dev = _cuda()
    y, p = pft.generate_lgssm_data(T=512, seed=7, device=dev)
    fn = getattr(ss, form)
    with pft.precision.matmul_precision_ctx("highest"):
        got = value_and_grad(lambda q: fn(q, y), p)
        sm_seq = ss.kalman_smoother_seq(p, y)
        sm_par = ss.kalman_smoother_parallel(p, y)
    want = value_and_grad(lambda q: fn(q, y.cpu().double()), {k: v.cpu().double() for k, v in p.items()})
    assert got[0].device.type == "cuda"
    _vg_close(got, want, 1e-4, 1e-3, 1e-4)
    for a, b in zip(sm_par, sm_seq):
        np.testing.assert_allclose(a.cpu(), b.cpu(), rtol=1e-3, atol=1e-4)


@pytest.mark.gpu
def test_gp_on_the_card_matches_float64_and_does_not_sync():
    """Config 10 (8 shards x 256 points): the exact GP's logp+grad on the
    card against float64 on the CPU (value rtol 1e-4; gradient within
    1e-3 |g| + 1e-4 max|g|), one warm evaluation with the sync debug mode
    set to error; the sparse GP (32 inducing points) the same way, its
    value within 1e-4 |logp| + 1e-5 n."""
    import pytensor_federated_torch as pft

    dev = _cuda()
    data, _ = pft.generate_gp_data(8, n_obs=256, seed=9, device=dev)
    z = torch.linspace(-2.0, 2.0, 32)
    n_obs = float(data.mask.sum())
    # The sparse bound is a sum of O(n) terms that crosses zero: its value
    # within 1e-4 |logp| + 1e-5 n (chip_smoke.py's gp phase).
    for model, model64, atol in (
            (pft.FederatedExactGP(data), pft.FederatedExactGP(_f64_cpu(data)), 0.0),
            (pft.FederatedSparseGP(data, z), pft.FederatedSparseGP(_f64_cpu(data), z.double()),
             1e-5 * n_obs)):
        for p in _points(model.init_params()):
            v, g = model.logp_and_grad(p)
            v64, g64 = model64.logp_and_grad({k: t.cpu().double() for k, t in p.items()})
            np.testing.assert_allclose(float(v), float(v64), rtol=1e-4, atol=atol)
            for k in g64:
                err = (g[k].cpu().double() - g64[k]).abs()
                assert torch.all(err <= 1e-3 * g64[k].abs() + 1e-4 * g64[k].abs().max()), k
        p = model.init_params()
        model.logp_and_grad(p)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            model.logp_and_grad(p)
        finally:
            torch.cuda.set_sync_debug_mode(0)


@pytest.mark.gpu
def test_tempering_on_the_card_matches_float64_on_the_cpu():
    """Eight leapfrog steps of 16 replicas of config 12's bimodal on the
    card against the same step in float64 on the CPU with the same draws
    (rtol 1e-4, atol 1e-4: float32 rounding of the trajectory and of the
    energies behind the acceptance probability), then a short pt_sample
    run on the card."""
    import pytensor_federated_torch as pft
    from pytensor_federated_torch.samplers import tempering as tpt
    from pytensor_federated_torch.samplers.mcmc import make_batch_logp_and_grad, make_flat_logp_and_grad

    dev = _cuda()

    def logp(p):
        x = p["x"]
        return torch.logaddexp(-0.5 * torch.sum(((x + 4.0) / 0.5) ** 2),
                               -0.5 * torch.sum(((x - 4.0) / 0.5) ** 2))

    g = torch.Generator().manual_seed(0)
    R, dim = 16, 8
    x = 4.0 * torch.sign(torch.randn(R, 1, generator=g)) + 0.3 * torch.randn(R, dim, generator=g)
    beta = torch.tensor(np.geomspace(1.0, 0.01, R))
    step = 0.05 + 0.1 * torch.rand(R, generator=g, dtype=torch.float64)
    inv_mass = torch.ones(R, dim, dtype=torch.float64)
    z = torch.randn(R, dim, generator=g, dtype=torch.float64)
    uniform = torch.rand(R, generator=g, dtype=torch.float64)
    out = {}
    for device, dtype in (("cuda", torch.float32), ("cpu", torch.float64)):
        cast = lambda t: t.to(device=device, dtype=dtype)
        flat_logp, _, unravel, _ = make_flat_logp_and_grad(logp, {"x": torch.zeros(dim, device=device,
                                                                                    dtype=dtype)})
        lg = make_batch_logp_and_grad(flat_logp, unravel)
        u0, g0 = lg(cast(x))
        out[device] = tpt._hmc_step(lg, cast(x), u0, g0, cast(beta), cast(step), cast(inv_mass), 8,
                                    cast(z), cast(uniform))
    for a, b in zip(out["cuda"], out["cpu"]):
        np.testing.assert_allclose(a.cpu().double(), b, rtol=1e-4, atol=1e-4)
    res = pft.samplers.pt_sample(logp, {"x": torch.zeros(dim, device=dev)},
                                 generator=torch.Generator(device=dev).manual_seed(1), num_chains=2,
                                 num_warmup=20, num_samples=20, num_temps=8, beta_min=0.01)
    assert res.samples["x"].device.type == "cuda" and tuple(res.samples["x"].shape) == (2, 20, dim)
    assert bool(torch.isfinite(res.samples["x"]).all())


# ---- the GLM families and the Gaussian mixture ----

FAMILIES = ["poisson", "negbin", "zip", "zinb", "robust", "gamma", "ordinal", "softmax",
            "softmax_suffstats", "hier_softmax", "weibull", "mixture"]


def _family_data(name, dev):
    """(data, model kwargs) of a family at 8 shards x 64 obs x 4 features."""
    from pytensor_federated_torch import models as M

    L = dict(n_shards=8, n_obs=64, n_features=4, device=dev)
    if name in ("poisson", "negbin"):
        return M.generate_count_data(**L, dispersion=4.0 if name == "negbin" else None)[0], {}
    if name in ("zip", "zinb"):
        return M.generate_zi_count_data(**L, dispersion=4.0 if name == "zinb" else None)[0], {}
    if name == "robust":
        return M.generate_robust_data(**L)[0], {}
    if name == "gamma":
        return M.generate_gamma_data(**L)[0], {}
    if name == "ordinal":
        return M.generate_ordinal_data(**L, n_categories=5)[0], {"n_categories": 5}
    if name.startswith("softmax"):
        kw = {"n_classes": 4, "use_suffstats": name == "softmax_suffstats"}
        return M.generate_multinomial_data(**L, n_classes=4)[0], kw
    if name == "hier_softmax":
        return M.generate_hier_multinomial_data(**L, n_classes=4)[0], {"n_classes": 4}
    if name == "weibull":
        return M.generate_survival_data(**L)[0], {}
    return M.generate_mixture_data(8, n_obs=128, device=dev)[0], {"n_components": 3}


def _family_class(name):
    from pytensor_federated_torch import models as M

    return {"poisson": M.FederatedPoissonGLM, "negbin": M.FederatedNegBinGLM,
            "zip": M.FederatedZeroInflPoissonGLM, "zinb": M.FederatedZeroInflNegBinGLM,
            "robust": M.FederatedRobustRegression, "gamma": M.FederatedGammaGLM,
            "ordinal": M.FederatedOrdinalRegression, "softmax": M.FederatedSoftmaxRegression,
            "softmax_suffstats": M.FederatedSoftmaxRegression,
            "hier_softmax": M.HierarchicalSoftmaxRegression, "weibull": M.FederatedWeibullAFT,
            "mixture": M.FederatedGaussianMixture}[name]


@pytest.mark.gpu
@pytest.mark.parametrize("name", FAMILIES)
def test_family_on_the_card_matches_float64_on_the_cpu(name):
    """Value within rtol 1e-5, gradient within 1e-4 |g| + 1e-5 max|g of
    the leaf|, pointwise log-likelihoods within rtol 1e-5 + 1e-5
    max|ll| (the models' tolerances above); predictive draws on the card
    are finite, shaped like the data and zero on padding."""
    dev = _cuda()
    data, kw = _family_data(name, dev)
    cls = _family_class(name)
    model, model64 = cls(data, **kw), cls(_f64_cpu(data), **kw)
    for p in _points(model.init_params()):
        v, g = model.logp_and_grad(p)
        p64 = {k: t.cpu().double() for k, t in p.items()}
        v64, g64 = model64.logp_and_grad(p64)
        assert v.device.type == "cuda"
        np.testing.assert_allclose(float(v), float(v64), rtol=1e-5)
        for k in g64:
            err = (g[k].cpu().double() - g64[k]).abs()
            assert torch.all(err <= 1e-4 * g64[k].abs() + 1e-5 * g64[k].abs().max()), k
        pw, pw64 = model.pointwise_loglik(p).cpu().double(), model64.pointwise_loglik(p64)
        assert torch.all((pw - pw64).abs() <= 1e-5 * pw64.abs() + 1e-5 * pw64.abs().max())
    sims = model.predictive(model.init_params(), torch.Generator(device=dev).manual_seed(0))
    assert sims.device.type == "cuda" and sims.shape == data.mask.shape
    assert bool(torch.isfinite(sims).all())
    if not name.startswith("softmax"):  # the flat softmax labels every row
        assert bool((sims[data.mask == 0] == 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("name", FAMILIES)
def test_family_without_cuda_and_without_cpu_raises(name, monkeypatch):
    """No entry point carries on quietly on the CPU: without CUDA, data
    for a family are made only when the caller passes ``device="cpu"``."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _family_data(name, None)
    data, kw = _family_data(name, "cpu")
    assert _family_class(name)(data, **kw).logp(
        _family_class(name)(data, **kw).init_params()).device.type == "cpu"


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["zinb", "ordinal", "hier_softmax", "mixture", "radon"])
def test_cuda_graph_evaluation_equals_eager(name):
    """The chain batch's value+grad replayed from a CUDA graph gives the
    eager evaluation's bits at new inputs, and a NUTS run with
    ``cuda_graph=True`` gives the eager run's draws (radon: one chain,
    the path that skips vmap)."""
    from pytensor_federated_torch.samplers.mcmc import (
        graph_batch_logp_and_grad,
        make_batch_logp_and_grad,
        make_flat_logp_and_grad,
        sample,
    )

    import pytensor_federated_torch as pft

    dev = _cuda()
    if name == "radon":
        model, chains = pft.HierarchicalRadonGLM(pft.generate_radon_data(16, seed=12, device=dev)[0]), 1
    else:
        data, kw = _family_data(name, dev)
        model, chains = _family_class(name)(data, **kw), 4
    flat_logp, flat_init, unravel, _ = make_flat_logp_and_grad(model.logp, model.init_params())
    lg = make_batch_logp_and_grad(flat_logp, unravel)
    graphed = graph_batch_logp_and_grad(lg, flat_init.expand(chains, -1))
    gen = torch.Generator(device=dev).manual_seed(0)
    for _ in range(3):
        x = flat_init + 0.3 * torch.randn((chains,) + tuple(flat_init.shape), generator=gen,
                                          device=dev)
        (v, g), (gv, gg) = lg(x), graphed(x)
        assert torch.equal(v, gv) and torch.equal(g, gg)
    assert graphed.calls == 3
    runs = [sample(model.logp, model.init_params(), generator=torch.Generator(device=dev).manual_seed(3),
                   num_warmup=20, num_samples=10, num_chains=chains, cuda_graph=flag)
            for flag in (False, True)]
    assert runs[0].extra is None and runs[1].extra["graph_replays"] > 0
    for k in runs[0].samples:
        assert torch.equal(runs[0].samples[k], runs[1].samples[k]), k


def _window_node(dev, S=2, N=131_072, seed=11):
    """A node's compute over the kernel on ``dev``, batched, and W
    seeded parameter sets for it."""
    from pytensor_federated_torch.service import device_compute_fn
    from pytensor_federated_torch.wrappers import wrap_logp_grad_fn

    _, _, x, y, m = _case(S, N, dev, seed=seed)
    kern = linreg_logp_grad_fn(x, y, m)
    keys = ("intercept", "slope", "log_sigma", "offsets")

    def logp_grad(*params):
        logp, g = kern(dict(zip(keys, params)))
        return logp, tuple(g[k] for k in keys)

    compute = device_compute_fn(wrap_logp_grad_fn(logp_grad), device=dev, batched=True,
                                max_batch=64)
    rng = np.random.default_rng(seed)

    def requests(w):
        return [(np.float32(1.0 + 0.1 * rng.normal()), np.float32(2.0 + 0.1 * rng.normal()),
                 np.float32(-1.2 + 0.05 * rng.normal()), rng.normal(size=S).astype(np.float32))
                for _ in range(w)]

    return compute, requests


@pytest.mark.gpu
@pytest.mark.parametrize("w", [3, 16, 64])
def test_shm_window_on_the_card_is_one_launch(w):
    """A window of W requests through an in-process shm node on the card
    is one kernel launch (C = W padded to the next power of two), and
    each reply equals that request alone, bit for bit."""
    import threading

    from pytensor_federated_torch.service import ShmArraysClient, batching, serve_shm

    dev = _cuda()
    compute, requests = _window_node(dev)
    ready, ports = threading.Event(), []
    threading.Thread(target=serve_shm, args=(compute,), daemon=True,
                     kwargs={"max_connections": 1,
                             "ready_callback": lambda p: (ports.append(p), ready.set())}).start()
    assert ready.wait(30)
    client = ShmArraysClient("127.0.0.1", ports[0], timeout_s=60)
    vmapped = batching._BATCHES.labels(kind="vmapped")
    fallback = batching._BATCHES.labels(kind="fallback")
    try:
        reqs = requests(w)
        client.evaluate_many(reqs, window=w)  # the first vmapped call of this shape
        torch.cuda.synchronize()
        launches, windows, fallbacks = linreg_reductions.launches, vmapped.value, fallback.value
        many = client.evaluate_many(reqs, window=w)
        n_frames = -(-w // 32)  # a batch frame carries at most 32 requests
        assert linreg_reductions.launches - launches == vmapped.value - windows == n_frames
        assert fallback.value == fallbacks
        singles = [client.evaluate(*r) for r in reqs]
        for got, want in zip(many, singles):
            assert len(got) == len(want) == 5
            for g, s in zip(got, want):
                assert np.asarray(g).tobytes() == np.asarray(s).tobytes()
    finally:
        client.close()


@pytest.mark.gpu
def test_micro_batcher_over_the_kernel_on_the_card():
    """64 requests submitted at once to a MicroBatcher in front of the
    kernel: one window, one launch, no fallback, each reply equal to the
    request alone, bit for bit."""
    import asyncio

    from pytensor_federated_torch.service import MicroBatcher

    dev = _cuda()
    compute, requests = _window_node(dev, S=8, N=4099)
    reqs = requests(64)
    asyncio.run(MicroBatcher(compute, compute.batch, max_batch=64).submit_many(reqs[::-1]))
    batcher = MicroBatcher(compute, compute.batch, max_batch=64)
    torch.cuda.synchronize()
    before = linreg_reductions.launches
    out = asyncio.run(batcher.submit_many(reqs))
    stats = batcher.stats()
    assert linreg_reductions.launches - before == stats["batches_total"] == 1
    assert stats["fallbacks_total"] == 0 and stats["dispatched_total"] == 64
    for got, r in zip(out, reqs):
        assert not isinstance(got, Exception)
        for g, s in zip(got, compute(*r)):
            assert np.asarray(g).tobytes() == np.asarray(s).tobytes()


@pytest.mark.gpu
@pytest.mark.parametrize("w", [5, 32])
def test_gateway_window_on_the_card_is_one_launch(w):
    """W requests pipelined through a ``GatewayThread`` in front of an
    in-process TCP node on the card: the gateway coalesces them into
    upstream windows (the window histogram's count), the node runs each
    window as one kernel launch, and each reply equals that request sent
    alone to the node, bit for bit."""
    import socket
    import struct
    import threading

    from pytensor_federated_torch.gateway import GatewayThread
    from pytensor_federated_torch.routing import NodePool
    from pytensor_federated_torch.service import TcpArraysClient, npwire, serve_tcp_once
    from pytensor_federated_torch.telemetry import metrics, spans

    dev = _cuda()
    compute, requests = _window_node(dev)
    ready, ports = threading.Event(), []
    threading.Thread(target=serve_tcp_once, args=(compute,), daemon=True,
                     kwargs={"max_connections": 4, "concurrent": True,
                             "ready_callback": lambda p: (ports.append(p), ready.set())}).start()
    assert ready.wait(30)
    node = TcpArraysClient("127.0.0.1", ports[0], timeout_s=60)
    pool = NodePool([("127.0.0.1", ports[0])], transport="tcp")
    reqs = requests(w)
    frames = [npwire.encode_arrays(list(r), uuid=i.to_bytes(16, "little"), tenant="t")
              for i, r in enumerate(reqs)]
    window_reqs = metrics.REGISTRY.get("pftpu_gateway_window_requests")

    def exchange(port):
        with socket.create_connection(("127.0.0.1", port), timeout=60) as s:
            s.settimeout(60)
            s.sendall(b"".join(struct.pack("<I", len(f)) + f for f in frames))
            out = []
            for _ in frames:
                (n,) = struct.unpack("<I", s.recv(4, socket.MSG_WAITALL))
                out.append(npwire.decode_arrays_all(s.recv(n, socket.MSG_WAITALL)))
            return out

    telemetry_was = spans.enabled()
    spans.set_enabled(True)  # the gateway's window histogram counts with telemetry on
    gw = GatewayThread(pool, frame_items=32)
    try:
        gw.start()
        exchange(gw.port)  # the node's first vmapped call of this shape
        torch.cuda.synchronize()
        launches, windows = linreg_reductions.launches, window_reqs.count
        replies = exchange(gw.port)
        sent = window_reqs.count - windows
        assert sent >= 1 and linreg_reductions.launches - launches == sent
        singles = [node.evaluate(*r) for r in reqs]
        for (arrays, uuid, error, _tid, _sp), single, i in zip(replies, singles, range(w)):
            assert error is None and uuid == i.to_bytes(16, "little")
            for g, s in zip(arrays, single):
                assert np.asarray(g).tobytes() == np.asarray(s).tobytes()
    finally:
        spans.set_enabled(telemetry_was)
        gw.stop()
        pool.close()
        node.close()


@pytest.mark.gpu
def test_grpc_node_on_the_card_is_one_launch_per_batch_frame():
    """A gRPC ``ArraysToArraysService`` over the kernel on the card: a
    batched ``evaluate_many`` of 16 requests is one batch frame and one
    kernel launch, each reply equal to the request alone, bit for bit.
    The GPU host has no grpcio; there this skips and says so."""
    import asyncio
    import threading

    dev = _cuda()
    pytest.importorskip("grpc", reason="grpcio is absent on the GPU host; the gRPC lane is held "
                                       "on the CPU")
    from pytensor_federated_torch.service import ArraysToArraysServiceClient, serve

    compute, requests = _window_node(dev)
    loop = asyncio.new_event_loop()
    thread = threading.Thread(target=loop.run_forever, daemon=True)
    thread.start()
    server = asyncio.run_coroutine_threadsafe(serve(compute, port=0), loop).result(30)
    try:
        client = ArraysToArraysServiceClient("127.0.0.1", server.port)
        reqs = requests(16)
        client.evaluate_many(reqs, window=16)  # the first vmapped call of this shape
        torch.cuda.synchronize()
        before = linreg_reductions.launches
        many = client.evaluate_many(reqs, window=16, batch=True)
        assert linreg_reductions.launches - before == 1
        for got, r in zip(many, reqs):
            for g, s in zip(got, client.evaluate(*r)):
                assert np.asarray(g).tobytes() == np.asarray(s).tobytes()
    finally:
        asyncio.run_coroutine_threadsafe(server.stop(0), loop).result(30)
        loop.call_soon_threadsafe(loop.stop)
        thread.join(30)


def _flagship_kernel_posterior(dev, n_obs=64):
    from pytensor_federated_torch.models.linear import (
        FederatedLinearRegression,
        generate_node_data,
    )

    data, _ = generate_node_data(8, n_obs=n_obs, seed=123, device=dev)
    model = FederatedLinearRegression(data)
    (x, y), mask = data.tree()
    kern = linreg_logp_grad_fn(x, y, mask)
    return model, kern, (lambda p: model.prior_logp(p) + kern.data_logp(p))


@pytest.mark.gpu
def test_smc_batch_on_the_card_is_one_launch_with_each_chains_bits():
    """SMC's particle batch through the kernel: one launch per batched
    evaluation, each particle's data term bit for bit the particle
    evaluated alone."""
    from pytensor_federated_torch.samplers import smc_sample
    from pytensor_federated_torch.samplers.util import ravel

    dev = _cuda()
    model, kern, post = _flagship_kernel_posterior(dev)
    flat0, unravel = ravel(model.init_params())
    gen = torch.Generator(device=dev).manual_seed(0)
    x = flat0 + 0.1 * torch.randn((64, flat0.shape[0]), generator=gen, device=dev)
    with torch.no_grad():
        linreg_reductions.launches = 0
        batched = torch.func.vmap(lambda v: kern.data_logp(unravel(v)))(x)
        assert linreg_reductions.launches == 1
        alone = torch.stack([kern.data_logp(unravel(v)) for v in x])
    assert torch.equal(batched, alone)
    evals = {"n": 0}

    def counted(p):
        evals["n"] += 1
        return post(p)

    linreg_reductions.launches = 0
    res = smc_sample(counted, model.init_params(), generator=gen, n_particles=256,
                     n_mutations=2, max_stages=3)
    torch.cuda.synchronize()
    assert linreg_reductions.launches == evals["n"] == 1 + 2 * int(res.n_stages)
    assert bool(torch.isfinite(res.samples["slope"]).all())


@pytest.mark.gpu
def test_sample_checkpointed_resumes_bit_identically_on_the_card(tmp_path):
    from pytensor_federated_torch import sample_checkpointed

    dev = _cuda()
    model, _, post = _flagship_kernel_posterior(dev)
    kw = dict(num_warmup=20, num_samples=20, num_chains=1, checkpoint_every=5, max_depth=3)
    full = sample_checkpointed(post, model.init_params(),
                               generator=torch.Generator(device=dev).manual_seed(4),
                               checkpoint_path=str(tmp_path / "full.npz"), **kw)

    class Stop(Exception):
        pass

    def stop(i):
        if i == 1:
            raise Stop

    path = str(tmp_path / "cut.npz")
    with pytest.raises(Stop):
        sample_checkpointed(post, model.init_params(),
                            generator=torch.Generator(device=dev).manual_seed(4),
                            checkpoint_path=path, on_chunk=stop, **kw)
    ran = []
    res = sample_checkpointed(post, model.init_params(),
                              generator=torch.Generator(device=dev).manual_seed(4),
                              checkpoint_path=path, on_chunk=ran.append, **kw)
    assert ran == [2, 3]
    assert res.samples["slope"].device.type == "cuda"
    for k in full.samples:
        assert torch.equal(res.samples[k], full.samples[k])


@pytest.mark.gpu
def test_demo_grpc_node_on_the_card_answers_and_is_gone_after_sigterm():
    """A demo node pool of one gRPC node on the card answers with the
    CPU node's values (rtol 1e-5) and its process is gone within 10 s of
    the SIGTERM to its manager."""
    import asyncio
    import functools
    import multiprocessing as mp
    import os
    import socket
    import time

    from pytensor_federated_torch.demos import demo_node
    from pytensor_federated_torch.service import LogpGradServiceClient

    _cuda()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    manager = mp.get_context("spawn").Process(
        target=functools.partial(demo_node.run_node_pool, device="cuda"),
        args=("127.0.0.1", [port]))
    manager.start()
    try:
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            with socket.socket() as s:
                if s.connect_ex(("127.0.0.1", port)) == 0:
                    break
            time.sleep(0.2)

        async def call():
            client = LogpGradServiceClient("127.0.0.1", port)
            return await asyncio.wait_for(
                client.evaluate_async(np.float32(1.5), np.float32(2.0)), 60)

        logp, grads = asyncio.run(call())
        want = demo_node.make_node_compute(port, device="cpu")(np.float32(1.5), np.float32(2.0))
        np.testing.assert_allclose(np.array([logp, *grads], np.float64),
                                   np.array(want, np.float64), rtol=1e-5, atol=1e-4)
        nodes = []
        for entry in os.listdir("/proc"):
            if entry.isdigit():
                try:
                    with open(f"/proc/{entry}/stat") as f:
                        fields = f.read().rsplit(")", 1)[1].split()
                except OSError:
                    continue
                if int(fields[1]) == manager.pid:
                    nodes.append(int(entry))
        assert len(nodes) == 1
    finally:
        manager.terminate()
        manager.join(timeout=10)
    assert manager.exitcode == 128 + 15
    end = time.monotonic() + 10
    while time.monotonic() < end and os.path.exists(f"/proc/{nodes[0]}"):
        with open(f"/proc/{nodes[0]}/stat") as f:
            if f.read().rsplit(")", 1)[1].split()[0] == "Z":
                break
        time.sleep(0.1)
    assert not os.path.exists(f"/proc/{nodes[0]}") or open(
        f"/proc/{nodes[0]}/stat").read().rsplit(")", 1)[1].split()[0] == "Z"


@pytest.mark.gpu
def test_sharded_optimizer_on_the_card_is_bit_identical_to_driver_centric_adam(tmp_path):
    """Owners over tcp, each computing the flagship's full gradient on
    the card through the kernel (one launch per update request), take
    Adam steps on 4 shards of the 11 parameters; the result equals Adam
    on the whole gradient, bit for bit, and each shard's Adam count
    equals its accepted steps."""
    import threading

    import pytensor_federated_torch as pft
    from pytensor_federated_torch.optim import ShardStore, ShardedOptimizer, make_update_compute
    from pytensor_federated_torch.optim._adam import adam
    from pytensor_federated_torch.samplers.util import ravel
    from pytensor_federated_torch.service import TcpArraysClient, serve_tcp_once

    dev = _cuda()
    data, _ = pft.generate_node_data(8, n_obs=4096, seed=123, device=dev)
    model = pft.FederatedLinearRegression(data)
    (x, y), mask = data.tree()
    kern = linreg_logp_grad_fn(x, y, mask)
    flat0, unravel = ravel(model.init_params())
    flat0 = flat0.cpu().numpy()

    def grad_fn(params, *_):
        flat = torch.as_tensor(np.array(params, np.float32), device=dev).requires_grad_(True)
        p = unravel(flat)
        loss = -(model.prior_logp(p) + kern.data_logp(p))
        (g,) = torch.autograd.grad(loss, flat)
        return loss.detach().cpu().numpy(), g.cpu().numpy()

    store = ShardStore(str(tmp_path))
    clients = []
    for _ in range(2):
        ready, port = threading.Event(), []
        compute = make_update_compute(grad_fn, adam(0.05), store,
                                      params_of=lambda a: np.asarray(a[0]).ravel())
        threading.Thread(target=serve_tcp_once, args=(compute,), daemon=True,
                         kwargs={"port": 0, "concurrent": True,
                                 "ready_callback": lambda p, r=ready, o=port: (o.append(p),
                                                                               r.set())}).start()
        assert ready.wait(30)
        clients.append(TcpArraysClient("127.0.0.1", port[0], timeout_s=60.0))
    try:
        opt = ShardedOptimizer(flat0.size, clients=clients + clients)  # two shards per node
        params, steps = flat0.copy(), 20
        before = linreg_reductions.launches
        for _ in range(steps):
            params, accepted = opt.apply(params, opt.step([params]))
            assert accepted == [0, 1, 2, 3]
        assert linreg_reductions.launches - before == 4 * steps
        ref, state = flat0.copy(), adam(0.05).init(torch.from_numpy(flat0))
        for _ in range(steps):
            upd, state = adam(0.05).update(torch.from_numpy(grad_fn(ref)[1]), state)
            ref = ref + upd.numpy()
        np.testing.assert_array_equal(params, ref)
        assert opt.versions == [steps] * 4 and opt.max_reply_elems == 3
        for part in opt.parts:
            assert int(store.load(part).opt_leaves[0]) == steps
    finally:
        for c in clients:
            c.close()


@pytest.mark.gpu
def test_mesh_on_the_card_matches_float64_on_the_cpu():
    """The flagship over a 4-slot mesh of one card ([cuda:0] * 4), on the
    plain per-shard path: value rtol 1e-5 and gradient within 1e-4 |g| +
    1e-5 max|g| of the float64 model on the CPU; a rerun gives the same
    bits."""
    import pytensor_federated_torch as pft

    dev = _cuda()
    data, _ = pft.generate_node_data(8, n_obs=131_072, seed=123, device=dev)
    mesh = pft.make_mesh({"shards": 4}, devices=[torch.device("cuda", 0)] * 4)
    model = pft.FederatedLinearRegression(data, mesh=mesh)
    data64 = pft.ShardedData(data=tree_map(lambda t: t.cpu().double(), data.data),
                             mask=data.mask.cpu().double())
    model64 = pft.FederatedLinearRegression(data64)
    p = {k: v + 0.1 for k, v in model.init_params().items()}
    v, g = model.logp_and_grad(p)
    v2, g2 = model.logp_and_grad(p)
    assert torch.equal(v, v2) and all(torch.equal(g[k], g2[k]) for k in g)
    v64, g64 = model64.logp_and_grad({k: t.cpu().double() for k, t in p.items()})
    assert abs(float(v) - float(v64)) <= 1e-5 * abs(float(v64))
    for k in g64:
        err = (g[k].cpu().double() - g64[k]).abs()
        assert bool((err <= 1e-4 * g64[k].abs() + 1e-5 * g64[k].abs().max()).all()), k
    assert torch.device("cuda", 0) in pft.healthy_devices()


@pytest.mark.gpu
def test_seq_sharded_lgssm_on_the_card_matches_float64_on_the_cpu():
    """SeqShardedLGSSM at T = 4,096 over a 4-slot seq mesh of one card,
    float32 with TF32 off, every fifth step and t = 1 masked: logp rtol
    1e-4, gradient rtol 1e-3 / atol 1e-4 (the JAX tests' float32
    tolerances) and smoothed moments rtol 1e-3 / atol 1e-4 against the
    single-device filters in float64 on the CPU."""
    import pytensor_federated_torch as pft
    from pytensor_federated_torch.models import statespace as ss

    dev = _cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    y, params = pft.generate_lgssm_data(T=4096, seed=7, device=dev)
    mask = (np.arange(4096) % 5 != 2).astype(np.float32)
    mask[0] = 0.0
    mesh = pft.make_mesh({"seq": 4}, devices=[torch.device("cuda", 0)] * 4)
    model = ss.SeqShardedLGSSM(y, mesh, mask=mask)
    v, g = model.logp_and_grad(params)
    y64, mask64 = y.cpu().double(), torch.as_tensor(mask, dtype=torch.float64)
    p64 = {k: t.cpu().double() for k, t in params.items()}
    v64, g64 = value_and_grad(lambda q: ss.kalman_logp_parallel(q, y64, mask64), p64)
    assert abs(float(v) - float(v64)) <= 1e-4 * abs(float(v64))
    for k in g64:
        np.testing.assert_allclose(g[k].cpu().double().numpy(), g64[k].numpy(), rtol=1e-3,
                                   atol=1e-4)
    for a, b in zip(model.smoothed_moments(params), ss.kalman_smoother_parallel(p64, y64, mask64)):
        np.testing.assert_allclose(a.cpu().double().numpy(), b.numpy(), rtol=1e-3, atol=1e-4)


@pytest.mark.gpu
def test_multichain_on_the_card_matches_float64_on_the_cpu():
    """The flagship's per-chain logp+grad on a {"chains": 2, "shards": 2}
    mesh of one card against the same function on a CPU mesh in
    float64 (value rtol 1e-5, gradient within 1e-4 |g| + 1e-5 max|g|),
    and a short NUTS run, its evaluation replayed from a CUDA graph,
    giving the same bits twice on one generator."""
    import pytensor_federated_torch as pft
    from pytensor_federated_torch.parallel.multichain import (
        multichain_logp_and_grad,
        multichain_sample,
    )
    from pytensor_federated_torch.samplers.util import ravel

    dev = _cuda()
    data, _ = pft.generate_node_data(8, n_obs=4096, seed=123, device=dev)
    model = pft.FederatedLinearRegression(data)
    cuda0 = torch.device("cuda", 0)
    mesh = pft.make_mesh({"chains": 2, "shards": 2}, devices=[cuda0] * 4)
    cpu_mesh = pft.make_mesh({"chains": 2, "shards": 2}, devices=["cpu"] * 4)
    flat0, unravel = ravel(model.init_params())
    lg = multichain_logp_and_grad(model.fed.per_shard_logp, model.fed.data, unravel,
                                  mesh=mesh, prior_logp=model.prior_logp)
    lg64 = multichain_logp_and_grad(
        model.fed.per_shard_logp,
        tree_map(lambda t: t.cpu().double() if t.is_floating_point() else t.cpu(), model.fed.data),
        lambda x: unravel(x), mesh=cpu_mesh, prior_logp=model.prior_logp)
    X = flat0 + 0.05 * torch.randn((2, flat0.shape[0]), generator=torch.Generator(dev).manual_seed(1),
                                   device=dev)
    (v, g), (v64, g64) = lg(X), lg64(X.cpu().double())
    np.testing.assert_allclose(v.cpu().double().numpy(), v64.numpy(), rtol=1e-5)
    err = (g.cpu().double() - g64).abs()
    assert bool((err <= 1e-4 * g64.abs() + 1e-5 * g64.abs().max(dim=1, keepdim=True).values).all())
    runs = [multichain_sample(model.fed.per_shard_logp, model.fed.data, model.init_params(),
                              mesh=mesh, generator=torch.Generator(dev).manual_seed(3),
                              num_samples=10, num_warmup=10, prior_logp=model.prior_logp,
                              dense_mass=True, cuda_graph=True, return_extra=True)
            for _ in range(2)]
    assert torch.equal(runs[0][0], runs[1][0]) and bool(torch.isfinite(runs[0][0]).all())
    assert runs[0][3]["graph_replays"] == runs[1][3]["graph_replays"] > 0


@pytest.mark.gpu
def test_pt_sample_from_a_cuda_graph_gives_the_eager_draws():
    """``pt_sample(cuda_graph=True)`` on a bimodal target: the eager run's
    draws and swap rates, bit for bit, and one replay per evaluation."""
    import pytensor_federated_torch as pft

    dev = _cuda()

    def bimodal(params):
        x = params["x"]
        return torch.logaddexp(-0.5 * torch.sum(((x + 3.0) / 0.5) ** 2),
                               -0.5 * torch.sum(((x - 3.0) / 0.5) ** 2))

    init = {"x": torch.zeros(4, device=dev)}
    kw = dict(num_chains=2, num_temps=8, num_warmup=40, num_samples=40, num_leapfrog=4)
    eager = pft.samplers.pt_sample(bimodal, init, generator=torch.Generator(dev).manual_seed(1),
                                   **kw)
    graphed = pft.samplers.pt_sample(bimodal, init, generator=torch.Generator(dev).manual_seed(1),
                                     cuda_graph=True, **kw)
    assert torch.equal(eager.samples["x"], graphed.samples["x"])
    assert torch.equal(eager.extra["swap_rate_per_pair"], graphed.extra["swap_rate_per_pair"])
    assert graphed.extra["graph_replays"] == 2 + kw["num_leapfrog"] * (kw["num_warmup"]
                                                                       + kw["num_samples"])


@pytest.mark.gpu
def test_sharded_samplers_run_on_the_mesh_when_the_init_lives_elsewhere():
    """``sample``/``chees_sample(chain_sharding=)`` and
    ``pt_sample(temp_sharding=)`` with ``init_params`` on the CPU and the
    mesh on the card: the state, the ladder and every draw live on the
    mesh's first device (where the generator is), and the draws equal
    those of the same run with the init on the card."""
    import pytensor_federated_torch as pft
    from pytensor_federated_torch.parallel.mesh import NamedSharding
    from pytensor_federated_torch.samplers.chees import chees_sample
    from pytensor_federated_torch.samplers.tempering import pt_sample

    dev = _cuda()
    chains = NamedSharding(pft.make_mesh({"chains": 2}, devices=[dev] * 2), "chains")
    temps = NamedSharding(pft.make_mesh({"temps": 4}, devices=[dev] * 4), "temps")

    def target(params):
        x = params["x"]
        return torch.logaddexp(-0.5 * torch.sum(((x + 2.0) / 0.5) ** 2),
                               -0.5 * torch.sum(((x - 2.0) / 0.5) ** 2))

    runs = {
        "sample": lambda init: pft.samplers.sample(
            target, init, generator=torch.Generator(dev).manual_seed(1), num_chains=4,
            num_warmup=10, num_samples=10, chain_sharding=chains),
        "chees": lambda init: chees_sample(
            target, init, generator=torch.Generator(dev).manual_seed(2), num_chains=4,
            num_warmup=5, num_samples=5, max_leapfrogs=8, chain_sharding=chains),
        "pt": lambda init: pt_sample(
            target, init, generator=torch.Generator(dev).manual_seed(3), num_temps=8,
            num_warmup=10, num_samples=10, num_leapfrog=4, temp_sharding=temps),
    }
    for name, run in runs.items():
        on_cpu, on_card = run({"x": torch.zeros(3)}), run({"x": torch.zeros(3, device=dev)})
        assert on_cpu.samples["x"].device.type == "cuda", name
        assert on_cpu.step_size.device.type == "cuda", name
        assert torch.equal(on_cpu.samples["x"], on_card.samples["x"]), name


@pytest.mark.gpu
def test_shard_vmap_rule_launches_once_per_slot_block():
    """The kernel's per-shard form (``linreg_shard_logp``) mapped over
    each slot's block of shards by ``FederatedLogp`` and by
    ``ZeroShardedLogpGrad`` on a 4-slot mesh of the card: one launch per
    slot and evaluation; the value and gradient against the plain
    per-shard model in float64 on the CPU (value rtol 1e-5, gradient
    within 1e-4 |g| + 1e-5 max|g|); ZeRO's value equals
    ``FederatedLogp``'s bit for bit."""
    import pytensor_federated_torch as pft
    from pytensor_federated_torch.ops.linreg_kernel import linreg_shard_logp

    dev = _cuda()
    data, _ = pft.generate_node_data(8, n_obs=131_072, seed=123, device=dev)
    (x, y), mask = data.tree()
    tree = ((x, y), mask, torch.arange(8, device=dev))
    mesh = pft.make_mesh({"shards": 4}, devices=[torch.device("cuda", 0)] * 4)
    fed = pft.FederatedLogp(linreg_shard_logp, tree, mesh=mesh)
    model64 = pft.FederatedLinearRegression(pft.ShardedData(
        data=tree_map(lambda t: t.cpu().double(), data.data), mask=data.mask.cpu().double()))
    p = {k: v + 0.1 for k, v in model64.init_params().items()}
    p32 = {k: v.float().to(dev) for k, v in p.items()}
    linreg_reductions.launches = 0
    v, g = value_and_grad(fed.logp, p32)
    torch.cuda.synchronize()
    assert linreg_reductions.launches == 4
    v64, g64 = value_and_grad(model64.fed.logp, p)
    assert abs(float(v) - float(v64)) <= 1e-5 * abs(float(v64))
    for k in g64:
        err = (g[k].cpu().double() - g64[k]).abs()
        assert bool((err <= 1e-4 * g64[k].abs() + 1e-5 * g64[k].abs().max()).all()), k
    z = pft.parallel.ZeroShardedLogpGrad(linreg_shard_logp, tree, p32, mesh=mesh)
    linreg_reductions.launches = 0
    sg = z.logp_and_scattered_grad(p32)
    torch.cuda.synchronize()
    assert linreg_reductions.launches == 4 and torch.equal(sg.logp, v)
    assert [s.device for s in sg.grad_slices] == [torch.device("cuda", 0)] * 4

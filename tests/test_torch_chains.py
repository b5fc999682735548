"""Lockstep chains: the port's chain batch against chains run alone and
against ``jax.vmap`` of the JAX package's functions.

- A lockstep step of C = 3 chains on injected draws equals each chain
  stepped alone (a batch of one) at rtol 1e-12, in float64: leapfrog,
  HMC, NUTS (with a chain that diverges and one whose tree stops
  shallower than the others'), Metropolis and the step-size search.
  The chains are independent and each is frozen with ``torch.where``
  once its own loop ends, so only summation order in the batched
  value+grad may differ.
- Dual averaging and Welford (diagonal and dense) with a chain axis
  against ``jax.vmap`` of the JAX ones, float64 (``jax.enable_x64``),
  rtol 1e-12; one batched HMC step against ``jax.vmap(hmc_step)`` on the
  JAX step's own draws, at tests/test_torch_samplers.py's float32
  tolerances.
- The kernel's plain version with a chain axis against ``jax.vmap`` of
  the Pallas kernel (``interpret=True``) at tests/test_torch_linreg_kernel.py's
  tolerances; ``torch.func.vmap`` through the kernel's autograd
  Function; second order refused under vmap; padding inert per chain.
- A host-callback op under a chain batch: one request per chain, the
  per-chain values and gradients.
- The models of configs 3-5 and config 7's three forms under a chain
  batch, against per-chain evaluation and against ``jax.vmap`` of the
  JAX flat value+grad.
- The sampler's telemetry with spans on.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from pytensor_federated_tpu.models import logistic as jlog
from pytensor_federated_tpu.models.linear import (
    FederatedLinearRegression as JaxModel,
    generate_node_data as jax_generate,
)
from pytensor_federated_tpu.ops.pallas_kernels import linreg_reductions as jax_reductions
from pytensor_federated_tpu.samplers import hmc as jhmc
from pytensor_federated_tpu.samplers import util as jutil
import pytensor_federated_torch as pft
from pytensor_federated_torch.ops.linreg_kernel import _DataLogp, linreg_logp_grad_fn, linreg_reductions
from pytensor_federated_torch.samplers import hmc as thmc
from pytensor_federated_torch.samplers import metropolis as tmet
from pytensor_federated_torch.samplers import nuts as tnuts
from pytensor_federated_torch.samplers import util as tutil
from pytensor_federated_torch.samplers.mcmc import make_batch_logp_and_grad, make_flat_logp_and_grad
from pytensor_federated_torch.utils import tree_map

LOCKSTEP_RTOL = 1e-12
C = 3


def _f64(data):
    return pft.ShardedData(data=tree_map(lambda t: t.double(), data.data), mask=data.mask.double())


@pytest.fixture(scope="module")
def target64():
    """The flagship posterior in float64 on the CPU, as a batched and a
    one-chain value+grad over flat vectors."""
    data, _ = pft.generate_node_data(8, n_obs=16, seed=123, device="cpu")
    model = pft.FederatedLinearRegression(_f64(data))
    init = {k: v.double() for k, v in model.init_params().items()}
    flat_logp, flat0, unravel, _ = make_flat_logp_and_grad(model.logp, init)
    lg = make_batch_logp_and_grad(flat_logp, unravel)
    return flat_logp, flat0, unravel, lg


def _chains(flat0, seed=0, scale=0.3):
    g = torch.Generator().manual_seed(seed)
    return flat0 + scale * torch.randn((C, flat0.shape[0]), generator=g, dtype=flat0.dtype)


def _inv_mass(kind, d, seed=1):
    rng = np.random.default_rng(seed)
    if kind == "diag":
        return torch.tensor(rng.uniform(0.5, 1.5, size=(C, d)))
    a = rng.normal(size=(C, d, d)) * 0.1
    return torch.tensor(a @ np.swapaxes(a, 1, 2) + np.eye(d))


def _close(a, b, rtol=LOCKSTEP_RTOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=0)


def _alone(t, c):
    """Chain c's slice of a batched tensor, as a batch of one."""
    return t[c : c + 1]


# ---- lockstep against each chain alone, on injected draws ----


@pytest.mark.parametrize("kind", ["diag", "dense"])
def test_leapfrog_and_hmc_step_lockstep_equal_chains_alone(target64, kind):
    _, flat0, _, lg = target64
    x = _chains(flat0)
    d = x.shape[1]
    inv_mass = _inv_mass(kind, d)
    step = torch.tensor([0.01, 0.02, 0.005], dtype=x.dtype)
    g = torch.Generator().manual_seed(3)
    z = torch.randn((C, d), generator=g, dtype=x.dtype)
    u = torch.rand((C,), generator=g, dtype=x.dtype)
    state = thmc.hmc_init(lg, x)
    lf = thmc.IntegratorState(x, thmc.sample_momentum(z, inv_mass), state.logp, state.grad)
    for _ in range(3):
        lf = thmc.leapfrog(lg, lf, step, inv_mass)
    new, info = thmc.hmc_step(lg, state, None, step_size=step, inv_mass=inv_mass,
                              num_steps=6, z=z, u=u)
    for c in range(C):
        one = thmc.IntegratorState(*(_alone(t, c) for t in (x, thmc.sample_momentum(z, inv_mass),
                                                             state.logp, state.grad)))
        for _ in range(3):
            one = thmc.leapfrog(lg, one, _alone(step, c), _alone(inv_mass, c))
        for a, b in zip(one, lf):
            _close(a[0], b[c])
        s1 = thmc.HMCState(*(_alone(t, c) for t in state))
        n1, i1 = thmc.hmc_step(lg, s1, None, step_size=_alone(step, c), inv_mass=_alone(inv_mass, c),
                               num_steps=6, z=_alone(z, c), u=_alone(u, c))
        for a, b in zip(n1, new):
            _close(a[0], b[c])
        assert bool(i1.accepted[0]) == bool(info.accepted[c])
        _close(i1.accept_prob[0], info.accept_prob[c])
        _close(i1.energy[0], info.energy[c])


@pytest.mark.parametrize("kind", ["diag", "dense"])
def test_nuts_step_lockstep_equals_chains_alone(target64, kind):
    """Chain 0 takes a step size that diverges at once; chains 1 and 2
    build trees of different depths.  Each chain's transition equals the
    one it takes alone on the same draws."""
    _, flat0, _, lg = target64
    x = _chains(flat0, seed=4, scale=0.05)
    inv_mass = _inv_mass(kind, x.shape[1])
    step = torch.tensor([1.0, 0.002, 0.02], dtype=x.dtype)
    max_depth = 6
    state = thmc.hmc_init(lg, x)
    draws = tnuts.draw_nuts(torch.Generator().manual_seed(5), x, max_depth)
    new, info = tnuts.nuts_step(lg, state, None, step_size=step, inv_mass=inv_mass,
                                max_depth=max_depth, draws=draws)
    assert info.diverging.tolist() == [True, False, False]
    assert info.depth[1] != info.depth[2] and int(info.depth.min()) < int(info.depth.max())
    for c in range(C):
        s1 = thmc.HMCState(*(_alone(t, c) for t in state))
        d1 = tnuts.NUTSDraws(*(_alone(t, c) for t in draws))
        n1, i1 = tnuts.nuts_step(lg, s1, None, step_size=_alone(step, c),
                                 inv_mass=_alone(inv_mass, c), max_depth=max_depth, draws=d1)
        for a, b in zip(n1, new):
            _close(a[0], b[c])
        for a, b in zip(i1, info):
            _close(a[0], b[c])


def test_nuts_step_shares_a_diagonal_mass_and_step(target64):
    """A shared (d,) inverse mass and a scalar step size broadcast to
    every chain: the same transition as their per-chain copies."""
    _, flat0, _, lg = target64
    x = _chains(flat0, seed=6, scale=0.05)
    state = thmc.hmc_init(lg, x)
    draws = tnuts.draw_nuts(torch.Generator().manual_seed(7), x, 5)
    m = torch.linspace(0.5, 1.5, x.shape[1], dtype=x.dtype)
    shared = tnuts.nuts_step(lg, state, None, step_size=0.05, inv_mass=m, max_depth=5, draws=draws)
    per = tnuts.nuts_step(lg, state, None, step_size=torch.full((C,), 0.05, dtype=x.dtype),
                          inv_mass=m.expand(C, -1), max_depth=5, draws=draws)
    for a, b in zip(shared[0] + shared[1], per[0] + per[1]):
        assert torch.equal(a, b)


def test_find_reasonable_step_size_lockstep_equals_chains_alone(target64):
    """Each chain doubles or halves until its own acceptance crosses the
    target; the batch ends when the last chain has crossed."""
    _, flat0, _, lg = target64
    x = _chains(flat0, seed=8, scale=0.5)
    z = torch.randn(x.shape, generator=torch.Generator().manual_seed(9), dtype=x.dtype)
    inv_mass = torch.ones_like(x)
    got = thmc.find_reasonable_step_size(lg, x, None, inv_mass, z=z)
    want = [thmc.find_reasonable_step_size(lg, _alone(x, c), None, _alone(inv_mass, c),
                                           z=_alone(z, c))[0] for c in range(C)]
    _close(got, torch.stack(want))
    assert len(set(got.tolist())) > 1  # the chains stopped at different sizes


def test_metropolis_step_lockstep_equals_chains_alone(target64):
    flat_logp, flat0, _, _ = target64
    logp = torch.func.vmap(flat_logp)
    x = _chains(flat0, seed=10)
    g = torch.Generator().manual_seed(11)
    step = torch.tensor([0.01, 0.3, 3.0], dtype=x.dtype)
    accepted = set()
    with torch.no_grad():
        state = tmet.metropolis_init(logp, x)
        for _ in range(4):
            z = torch.randn(x.shape, generator=g, dtype=x.dtype)
            u = torch.rand((C,), generator=g, dtype=x.dtype)
            new = tmet.metropolis_step(logp, state, None, step_size=step, draws=(z, u))
            for c in range(C):
                s1 = tmet.MetropolisState(*(_alone(t, c) for t in state))
                n1 = tmet.metropolis_step(logp, s1, None, step_size=_alone(step, c),
                                          draws=(_alone(z, c), _alone(u, c)))
                for a, b in zip(n1, new):
                    _close(a[0], b[c])
            accepted |= set((new.n_accept - state.n_accept).tolist())
            state = new
    assert accepted == {0.0, 1.0}


# ---- against jax.vmap of the JAX functions ----


def test_dual_averaging_with_a_chain_axis_matches_jax_vmap():
    rng = np.random.default_rng(12)
    step0 = rng.uniform(0.05, 1.0, size=C)
    accept = rng.uniform(size=(40, C))
    with jax.enable_x64(True):
        jd = jax.vmap(jutil.da_init)(jnp.asarray(step0))
        jupdate = jax.vmap(lambda s, a: jutil.da_update(s, a, target=0.8))
        for a in accept:
            jd = jupdate(jd, jnp.asarray(a))
        td = tutil.da_init(torch.tensor(step0))
        for a in accept:
            td = tutil.da_update(td, torch.tensor(a), target=0.8)
        for name in jd._fields:
            _close(getattr(td, name), getattr(jd, name))


@pytest.mark.parametrize("dense", [False, True])
def test_welford_with_a_chain_axis_matches_jax_vmap(dense):
    xs = np.random.default_rng(13).normal(size=(30, C, 4)) * [1.0, 2.0, 3.0, 4.0]
    with jax.enable_x64(True):
        js = jax.vmap(lambda _: jutil.welford_init(4, jnp.float64, dense=dense))(jnp.arange(C))
        jupdate = jax.vmap(jutil.welford_update)
        ts = tutil.welford_init(4, torch.float64, dense=dense, batch=(C,))
        for x in xs:
            js = jupdate(js, jnp.asarray(x))
            ts = tutil.welford_update(ts, torch.tensor(x))
        for name in ("mean", "m2", "count"):
            _close(getattr(ts, name), getattr(js, name))
        if dense:
            assert ts.m2.shape == (C, 4, 4)
            _close(tutil.welford_covariance(ts), jax.vmap(jutil.welford_covariance)(js))
        else:
            _close(tutil.welford_variance(ts), jax.vmap(jutil.welford_variance)(js))


@pytest.mark.parametrize("kind", ["diag", "dense"])
def test_batched_hmc_step_matches_jax_vmap_on_the_same_draws(kind):
    """``jax.vmap(hmc_step)`` over C chains with their own keys, and the
    port's batched step with those keys' draws."""
    jm = JaxModel(jax_generate(8, n_obs=64, seed=123)[0])
    tm = pft.FederatedLinearRegression(pft.generate_node_data(8, n_obs=64, seed=123, device="cpu")[0])
    jflat, junravel = ravel_pytree(jm.init_params())
    jlg = jax.value_and_grad(lambda x: jm.logp(junravel(x)))
    flat_logp, flat0, unravel, _ = make_flat_logp_and_grad(tm.logp, tm.init_params())
    tlg = make_batch_logp_and_grad(flat_logp, unravel)
    d = flat0.shape[0]
    rng = np.random.default_rng(14)
    x0 = (rng.normal(size=(C, d)) * 0.2).astype(np.float32)
    if kind == "diag":
        inv_mass = rng.uniform(0.5, 1.5, size=(C, d)).astype(np.float32)
    else:
        a = rng.normal(size=(C, d, d)) * 0.1
        inv_mass = (a @ np.swapaxes(a, 1, 2) + np.eye(d)).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(15), C)
    z, u = [], []
    for k in keys:
        k_mom, k_acc = jax.random.split(k)
        z.append(np.asarray(jax.random.normal(k_mom, (d,), jnp.float32)))
        u.append(np.asarray(jax.random.uniform(k_acc, dtype=jnp.float32)))
    step = np.array([0.01, 0.02, 0.005], np.float32)

    def jstep(x, key, s, m):
        return jhmc.hmc_step(jlg, jhmc.hmc_init(jlg, x), key, step_size=s, inv_mass=m, num_steps=8)

    jnew, jinfo = jax.vmap(jstep)(jnp.asarray(x0), keys, jnp.asarray(step), jnp.asarray(inv_mass))
    tnew, tinfo = thmc.hmc_step(
        tlg, thmc.hmc_init(tlg, torch.tensor(x0)), None, step_size=torch.tensor(step),
        inv_mass=torch.tensor(inv_mass), num_steps=8, z=torch.tensor(np.stack(z)),
        u=torch.tensor(np.stack(u)),
    )
    assert tinfo.accepted.tolist() == np.asarray(jinfo.accepted).tolist()
    np.testing.assert_allclose(tinfo.accept_prob.numpy(), np.asarray(jinfo.accept_prob), rtol=5e-4, atol=5e-4)
    np.testing.assert_allclose(tnew.x.numpy(), np.asarray(jnew.x), rtol=5e-4, atol=5e-4)
    np.testing.assert_allclose(tnew.logp.numpy(), np.asarray(jnew.logp), rtol=5e-5)


# ---- the kernel with a chain axis ----

KERNEL_SHAPES = [(1, 8), (5, 70), (8, 512)]


def _kernel_case(S, N, chains, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(S, N)).astype(np.float32)
    y = (1.0 + 2.0 * x + 0.3 * rng.normal(size=(S, N))).astype(np.float32)
    mask = (rng.uniform(size=(S, N)) > 0.25).astype(np.float32)
    scalars = (np.array([0.7, 1.8, -0.2]) + 0.1 * rng.normal(size=(chains, 3))).astype(np.float32)
    offsets = rng.normal(size=(chains, S)).astype(np.float32)
    return scalars, offsets, x, y, mask


@pytest.mark.parametrize("chains", [1, 3])
@pytest.mark.parametrize("S,N", KERNEL_SHAPES)
def test_reductions_with_a_chain_axis_match_jax_vmap(S, N, chains):
    scalars, offsets, x, y, mask = _kernel_case(S, N, chains)
    want = jax.vmap(lambda s, o: jax_reductions(s, o, x, y, mask, interpret=True))(
        jnp.asarray(scalars), jnp.asarray(offsets)
    )
    got = linreg_reductions(torch.tensor(scalars), torch.tensor(offsets),
                            *map(torch.tensor, (x, y, mask)))
    assert got[0].shape == (chains, S)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=5e-5)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=5e-4, atol=5e-4)
    # Each chain's row is that chain's own call.
    for c in range(chains):
        one = linreg_reductions(torch.tensor(scalars[c]), torch.tensor(offsets[c]),
                                *map(torch.tensor, (x, y, mask)))
        for a, b in zip(one, got):
            np.testing.assert_allclose(a.numpy(), b[c].numpy(), rtol=1e-6, atol=1e-6)


def _chain_params(scalars, offsets, requires_grad=False):
    p = {"intercept": scalars[:, 0], "slope": scalars[:, 1], "log_sigma": scalars[:, 2],
         "offsets": offsets}
    return {k: torch.tensor(v).requires_grad_(requires_grad) for k, v in p.items()}


def _prior(p):
    return -0.5 * p["slope"] ** 2 - 0.5 * torch.sum(p["offsets"] ** 2)


def test_vmap_through_the_kernel_function_under_autograd():
    """``torch.func.vmap`` of prior + data_logp over chains, then one
    backward pass: one kernel call for the batch, each chain's value and
    gradient equal to the chain's own call."""
    scalars, offsets, x, y, mask = _kernel_case(5, 70, C, seed=1)
    fn = linreg_logp_grad_fn(*map(torch.tensor, (x, y, mask)))
    p = _chain_params(scalars, offsets, requires_grad=True)
    values = torch.func.vmap(lambda q: _prior(q) + fn.data_logp(q))(p)
    grads = dict(zip(p, torch.autograd.grad(values.sum(), list(p.values()))))
    for c in range(C):
        q = {k: v[c].detach().requires_grad_(True) for k, v in p.items()}
        v = _prior(q) + fn.data_logp(q)
        g = dict(zip(q, torch.autograd.grad(v, list(q.values()))))
        np.testing.assert_allclose(values[c].detach().numpy(), v.detach().numpy(), rtol=1e-6)
        for k in g:
            np.testing.assert_allclose(grads[k][c].numpy(), g[k].numpy(), rtol=1e-5, atol=1e-5)
    # A batched logp_and_grad of the kernel alone (a torch.func reverse
    # pass inside vmap) gives the same.
    vb, gb = torch.func.vmap(fn)({k: v.detach() for k, v in p.items()})
    v0, g0 = fn({k: v[0].detach() for k, v in p.items()})
    np.testing.assert_allclose(vb[0].numpy(), v0.numpy(), rtol=1e-6)
    for k in g0:
        np.testing.assert_allclose(gb[k][0].numpy(), g0[k].numpy(), rtol=1e-5, atol=1e-5)


def test_second_order_refused_under_vmap():
    scalars, offsets, x, y, mask = _kernel_case(2, 16, C, seed=2)
    fn = linreg_logp_grad_fn(*map(torch.tensor, (x, y, mask)))
    p = _chain_params(scalars, offsets, requires_grad=True)
    values = torch.func.vmap(lambda q: _prior(q) + fn.data_logp(q))(p)
    with pytest.raises(RuntimeError, match="second-order"):
        torch.autograd.grad(values.sum(), list(p.values()), create_graph=True)
    q0 = {k: v[0].detach() for k, v in p.items()}
    with pytest.raises(RuntimeError, match="second-order"):
        torch.func.grad(lambda s: torch.func.grad(
            lambda s2: fn.data_logp({**q0, "slope": s2}))(s))(q0["slope"])


def test_kernel_function_refuses_batched_data():
    scalars, offsets, x, y, mask = _kernel_case(2, 16, C, seed=3)
    xs = torch.tensor(np.stack([x] * C))
    p = _chain_params(scalars, offsets)
    with pytest.raises(ValueError, match="shares x, y and mask"):
        torch.func.vmap(lambda q, xx: _DataLogp.apply(
            q["intercept"], q["slope"], q["log_sigma"], q["offsets"], xx,
            torch.tensor(y), torch.tensor(mask)))(p, xs)


@pytest.mark.parametrize("pad_shards,pad_obs", [(0, 40), (3, 0), (3, 40)])
def test_padding_is_inert_for_every_chain(pad_shards, pad_obs):
    scalars, offsets, x, y, mask = _kernel_case(3, 17, C, seed=4)
    base = linreg_reductions(torch.tensor(scalars), torch.tensor(offsets),
                             *map(torch.tensor, (x, y, mask)))
    pad = lambda a: torch.tensor(np.pad(a, ((0, pad_shards), (0, pad_obs))))
    padded = linreg_reductions(
        torch.tensor(scalars), torch.nn.functional.pad(torch.tensor(offsets), (0, pad_shards)),
        pad(x), pad(y), pad(mask),
    )
    for b, p in zip(base, padded):
        assert p.shape == (C, 3 + pad_shards)
        np.testing.assert_allclose(p[:, :3].numpy(), b.numpy(), rtol=1e-6, atol=1e-6)
        assert torch.all(p[:, 3:] == 0)


# ---- a host callback under a chain batch ----


def _serve_quad_node(center):
    """An in-process TCP node serving -sum((x - c)^2) and its gradient."""
    from pytensor_federated_torch.service import device_compute_fn, serve_tcp_once

    def node(x):
        return -torch.sum((x - center) ** 2), (-2.0 * (x - center),)

    compute = device_compute_fn(pft.wrap_logp_grad_fn(node), device="cpu")
    ports, ready = [], threading.Event()

    def on_ready(port):
        ports.append(port)
        ready.set()

    threading.Thread(target=serve_tcp_once, args=(compute,), daemon=True,
                     kwargs={"ready_callback": on_ready, "max_connections": 50,
                             "concurrent": True}).start()
    assert ready.wait(30)
    return ports[0]


@pytest.fixture(scope="module")
def quad_nodes():
    return [_serve_quad_node(c) for c in (1.0, -0.5)]


def _as_logp_grad(client):
    def call(*arrays):
        out = client.evaluate(*arrays)
        return out[0], out[1:]

    return call


@pytest.mark.parametrize("fan", ["blackbox", "parallel"])
def test_host_callback_under_a_chain_batch(quad_nodes, fan):
    """A batched value+grad calls each node once per chain, in turn, and
    gives every chain's own value and gradient."""
    from pytensor_federated_torch.service import TcpArraysClient, _node_metrics

    clients = [TcpArraysClient("127.0.0.1", port, timeout_s=30.0) for port in quad_nodes]
    spec = pft.spec_of(torch.zeros(3, dtype=torch.float32))
    try:
        if fan == "blackbox":
            ops = [pft.blackbox_logp_grad(_as_logp_grad(c), spec) for c in clients]

            def total(x):
                return sum(op.logp(x) for op in ops)
        else:
            par = pft.ParallelLogpGrad([_as_logp_grad(c) for c in clients], [spec] * 2)

            def total(x):
                return par.total_logp([(x,), (x,)])

        def logp(p):
            return -0.5 * torch.sum(p["x"] ** 2) + total(p["x"])

        flat_logp, flat0, unravel, lg1 = make_flat_logp_and_grad(logp, {"x": torch.zeros(3)})
        lg = make_batch_logp_and_grad(flat_logp, unravel)
        x = torch.tensor(np.random.default_rng(16).normal(size=(C, 3)), dtype=torch.float32)
        requests = _node_metrics.REQUESTS.labels(method="evaluate")
        before = requests.value
        v, g = lg(x)
        assert requests.value - before == C * len(clients)  # one request per chain per node
        for c in range(C):
            v1, g1 = lg1(x[c])
            np.testing.assert_allclose(v[c].numpy(), v1.numpy(), rtol=1e-6)
            np.testing.assert_allclose(g[c].numpy(), g1.numpy(), rtol=1e-6)
            want = -0.5 * x[c] - sum(2.0 * (x[c] - cc) for cc in (1.0, -0.5)) - 0.5 * x[c]
            np.testing.assert_allclose(g[c].numpy(), want.numpy(), rtol=1e-5, atol=1e-6)
        if fan == "parallel":
            par.close()
    finally:
        for cl in clients:
            cl.close()


# ---- the models under a chain batch ----


def _models():
    radon, _ = pft.generate_radon_data(4, mean_obs=8, seed=3, device="cpu")
    logi, _ = pft.generate_logistic_data(n_shards=6, n_obs=16, n_features=3, device="cpu")
    hier, _ = pft.generate_hier_logistic_data(6, n_obs=16, n_features=3, device="cpu")
    return {
        "radon": lambda: pft.HierarchicalRadonGLM(radon),
        "radon_remat": lambda: pft.HierarchicalRadonGLM(radon),
        "logistic": lambda: pft.FederatedLogisticRegression(logi),
        "logistic_suffstats": lambda: pft.FederatedLogisticRegression(logi, use_suffstats=True),
        "logistic_flat": lambda: pft.FederatedLogisticRegression(logi, flatten=True),
        "logistic_strict": lambda: pft.FederatedLogisticRegression(logi, compute_dtype="float32_strict"),
        "logistic_bf16": lambda: pft.FederatedLogisticRegression(logi, compute_dtype=torch.bfloat16),
        "hier_logistic": lambda: pft.HierarchicalLogisticRegression(hier),
        "lv_ode": lambda: pft.make_lv_model(2, n_obs=4, device="cpu")[0],
    }


@pytest.mark.parametrize("name", list(_models()))
def test_models_under_a_chain_batch_equal_per_chain_calls(name):
    """Each model's batched value+grad (its logp under an outer chain
    vmap, and its logp_and_grad under vmap) against the chain's own."""
    model = _models()[name]()
    if name == "radon_remat":
        model.fed.remat = True
    flat_logp, flat0, unravel, lg1 = make_flat_logp_and_grad(model.logp, model.init_params())
    x = _chains(flat0, seed=17, scale=0.1)
    v, g = make_batch_logp_and_grad(flat_logp, unravel)(x)
    v2, g2 = make_batch_logp_and_grad(flat_logp, unravel, model.logp_and_grad)(x)
    for c in range(C):
        v1, g1 = lg1(x[c])
        for vb, gb in ((v, g), (v2, g2)):
            np.testing.assert_allclose(vb[c].numpy(), v1.numpy(), rtol=1e-5)
            np.testing.assert_allclose(gb[c].numpy(), g1.numpy(), rtol=1e-4, atol=1e-5)
    if hasattr(model, "fed") and model.fed:
        batch = unravel(x)
        per_shard = torch.func.vmap(model.fed.logp_batch)(
            tree_map(lambda t: t[None].expand(2, *t.shape), batch))
        np.testing.assert_allclose(per_shard[1].numpy(), model.fed.logp_batch(batch).numpy(),
                                   rtol=1e-6)


# Config 7's forms, cut from 8 x 4096 x 512 with 64 chains to 8 x 64 x 16
# with 8 chains; tolerances per form against the same form in JAX: f32
# and f32-strict at the models' (value rtol 1e-5, gradient rtol 1e-4 /
# atol 1e-5 of max|g|), bf16 at the bf16 band (2e-2 / 5e-2).
WIDE_FORMS = {
    "f32": (None, None, 1e-5, 1e-4),
    "f32_strict": ("float32_strict", "float32_strict", 1e-5, 1e-4),
    "bf16": (torch.bfloat16, jnp.bfloat16, 2e-2, 5e-2),
}


@pytest.mark.parametrize("form", list(WIDE_FORMS))
def test_wide_logistic_batched_value_and_grad_match_jax_vmap(form):
    tdtype, jdtype, value_rtol, grad_tol = WIDE_FORMS[form]
    kw = dict(n_shards=8, n_obs=64, n_features=16, seed=77)
    jdata, _ = jlog.generate_logistic_data(**kw)
    tdata, _ = pft.generate_logistic_data(**kw, device="cpu")
    jm = jlog.FederatedLogisticRegression(jdata, compute_dtype=jdtype)
    tm = pft.FederatedLogisticRegression(tdata, compute_dtype=tdtype)
    jflat, junravel = ravel_pytree(jm.init_params())
    jlg = jax.vmap(jax.value_and_grad(lambda v: jm.logp(junravel(v))))
    flat_logp, flat0, unravel, _ = make_flat_logp_and_grad(tm.logp, tm.init_params())
    lg = make_batch_logp_and_grad(flat_logp, unravel)
    x = (np.asarray(jflat)[None] + 0.01 * np.random.default_rng(18).normal(size=(8, jflat.shape[0])))
    x = x.astype(np.float32)
    jv, jg = jlg(jnp.asarray(x))
    tv, tg = lg(torch.tensor(x))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=value_rtol)
    scale = float(np.abs(np.asarray(jg)).max())
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=grad_tol, atol=grad_tol * scale)


# ---- telemetry ----


def test_sample_records_its_span_metrics_and_flight_record():
    """``sample()`` with spans on: the ``mcmc.sample`` span with the JAX
    package's attributes, the run and step histograms, the draws counter
    and the ``sampler.run`` flight record, labelled by kernel."""
    from pytensor_federated_torch.telemetry import flightrec, metrics, spans

    run = metrics.REGISTRY.get("pftpu_sampler_run_seconds").labels(kernel="hmc")
    step = metrics.REGISTRY.get("pftpu_sampler_step_seconds").labels(kernel="hmc")
    draws = metrics.REGISTRY.get("pftpu_sampler_draws_total").labels(kernel="hmc")
    before = (run.count, step.count, draws.value)
    prev = spans.set_enabled(True)
    prev_fr = flightrec.set_enabled(True)
    try:
        spans.clear_traces()
        flightrec.clear()
        pft.samplers.sample(
            lambda p: -0.5 * torch.sum(p["x"] ** 2), {"x": torch.zeros(2)},
            generator=torch.Generator().manual_seed(0), kernel="hmc",
            num_warmup=5, num_samples=7, num_chains=3, num_hmc_steps=2,
        )
        traces = [t for t in spans.recent_traces() if t["name"] == "mcmc.sample"]
        events = [e for e in flightrec.events() if e["kind"] == "sampler.run"]
    finally:
        spans.set_enabled(prev)
        flightrec.set_enabled(prev_fr)
    assert len(traces) == 1
    assert traces[0]["attrs"] == {"kernel": "hmc", "chains": 3, "warmup": 5, "draws": 7}
    assert (run.count, step.count, draws.value) == (before[0] + 1, before[1] + 1, before[2] + 21)
    assert len(events) == 1
    ev = events[0]
    assert {k: ev[k] for k in ("kernel", "chains", "warmup", "draws")} == {
        "kernel": "hmc", "chains": 3, "warmup": 5, "draws": 7}
    assert ev["wall_s"] > 0

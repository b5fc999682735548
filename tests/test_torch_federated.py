"""The federation slice as a whole, on the CPU: a mixed fleet of torch
and JAX nodes behind one torch driver.

Eight shards of the flagship model, two per node.  Nodes 0 and 1 are
the port's (``device_compute_fn(wrap_logp_grad_fn(...))`` over
``linreg_logp_grad_fn``, on the CPU, so the kernel's plain version
runs); nodes 2 and 3 are the JAX package's, computing their data term
with ``pallas_kernels.linreg_logp_grad_fn(..., interpret=True)`` as the
JAX package runs it on the CPU.  A torch ``ParallelLogpGrad`` fans out
to all four over TCP; the driver adds the prior.

Tolerance: rtol 2e-5 on logp, rtol 1e-4 / atol 1e-4 on the gradient.
Every term is float32 and the four node partials are summed on the
driver in another order than either in-process sum, so the value can
differ by a few float32 ulps of the total's magnitude.
"""

import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytensor_federated_tpu.models.linear import (
    FederatedLinearRegression as JaxModel,
    generate_node_data as jax_generate,
)
from pytensor_federated_tpu.ops.pallas_kernels import linreg_logp_grad_fn as jax_kernel_fn
from pytensor_federated_tpu.service import tcp as jtcp
from pytensor_federated_tpu.service.server import device_compute_fn as jax_device_compute_fn
from pytensor_federated_tpu.wrappers import wrap_logp_grad_fn as jax_wrap
import pytensor_federated_torch as pft
from pytensor_federated_torch.samplers import hmc_step, make_flat_logp_and_grad
from pytensor_federated_torch.samplers.hmc import HMCState
from pytensor_federated_torch.service import TcpArraysClient, device_compute_fn, serve_tcp_once
from pytensor_federated_torch.utils import value_and_grad

N_SHARDS, N_OBS, SEED = 8, 24, 123
LOGP_RTOL = 2e-5
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
TIMEOUT_S = 60.0
KEYS = ("intercept", "slope", "log_sigma", "offsets")


def _serve(compute, serve):
    ports, ready = [], threading.Event()

    def on_ready(port):
        ports.append(port)
        ready.set()

    threading.Thread(
        target=serve, args=(compute,), daemon=True,
        kwargs={"ready_callback": on_ready, "max_connections": 8, "concurrent": True},
    ).start()
    assert ready.wait(TIMEOUT_S)
    return ports[0]


def _torch_node(x, y, mask):
    kern = pft.linreg_logp_grad_fn(x, y, mask)

    def node_logp_grad(*params):
        logp, g = kern(dict(zip(KEYS, params)))
        return logp, tuple(g[k] for k in KEYS)

    return device_compute_fn(pft.wrap_logp_grad_fn(node_logp_grad), device="cpu")


def _jax_node(x, y, mask):
    kern = jax_kernel_fn(x, y, mask, interpret=True)

    def node_logp_grad(*params):
        logp, g = kern(dict(zip(KEYS, params)))
        return logp, tuple(g[k] for k in KEYS)

    return jax_device_compute_fn(jax_wrap(node_logp_grad))


@pytest.fixture(scope="module")
def fleet():
    """Four nodes (torch, torch, JAX, JAX) and the torch driver's
    posterior over them."""
    data, _ = pft.generate_node_data(N_SHARDS, n_obs=N_OBS, seed=SEED, device="cpu")
    (x, y), mask = data.tree()
    ports = []
    for i in range(4):
        own = slice(2 * i, 2 * i + 2)
        if i < 2:
            ports.append(_serve(_torch_node(x[own], y[own], mask[own]), serve_tcp_once))
        else:
            arrs = [t[own].numpy() for t in (x, y, mask)]
            ports.append(_serve(_jax_node(*arrs), jtcp.serve_tcp_once))
    clients = [TcpArraysClient("127.0.0.1", p, timeout_s=TIMEOUT_S) for p in ports]

    def as_logp_grad(client):
        def call(*arrays):
            out = client.evaluate(*arrays)
            return out[0], out[1:]

        return call

    spec = pft.spec_of(*(torch.zeros(()),) * 3, torch.zeros(2))
    fan = pft.ParallelLogpGrad([as_logp_grad(c) for c in clients], [spec] * 4)

    def posterior(p):
        per_node = [(p["intercept"], p["slope"], p["log_sigma"], p["offsets"][2 * i:2 * i + 2])
                    for i in range(4)]
        return pft.linreg_prior_logp(p) + fan.total_logp(per_node)

    yield posterior, pft.FederatedLinearRegression(data)
    fan.close()
    for c in clients:
        c.close()


def _params(seed):
    rng = np.random.default_rng(seed)
    flat = rng.normal(scale=0.3, size=11).astype(np.float32)
    return {"intercept": flat[0] + 1.5, "slope": flat[1] + 2.0, "log_sigma": flat[2] - 0.7,
            "offsets": flat[3:]}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mixed_fleet_matches_both_packages_in_process(fleet, seed):
    posterior, model = fleet
    p = _params(seed)
    tp = {k: torch.tensor(np.float32(v)) for k, v in p.items()}
    rv, rg = value_and_grad(posterior, tp)
    tv, tg = model.logp_and_grad(tp)

    jdata, _ = jax_generate(N_SHARDS, n_obs=N_OBS, seed=SEED)
    jv, jg = JaxModel(jdata).logp_and_grad({k: jnp.asarray(v, jnp.float32) for k, v in p.items()})

    np.testing.assert_allclose(rv.numpy(), tv.numpy(), rtol=LOGP_RTOL)
    np.testing.assert_allclose(rv.numpy(), np.asarray(jv), rtol=LOGP_RTOL)
    for k in KEYS:
        np.testing.assert_allclose(rg[k].numpy(), tg[k].numpy(), **GRAD_TOL)
        np.testing.assert_allclose(rg[k].numpy(), np.asarray(jg[k]), **GRAD_TOL)


def test_hmc_step_over_the_wire_matches_in_process(fleet):
    posterior, model = fleet
    init = {k: torch.tensor(np.float32(v)) for k, v in _params(5).items()}
    _, x0, _, remote_lg = make_flat_logp_and_grad(posterior, init)
    _, _, _, local_lg = make_flat_logp_and_grad(model.logp, init)
    g = torch.Generator().manual_seed(3)
    z = torch.randn(x0.shape, generator=g)
    u = torch.rand((), generator=g)
    inv_mass = torch.full_like(x0, 0.05)
    states = []
    for lg in (remote_lg, local_lg):
        state = HMCState(x0, *lg(x0))
        new, info = hmc_step(lg, state, None, step_size=0.05, inv_mass=inv_mass,
                             num_steps=5, z=z, u=u)
        states.append((new, info))
    (rs, ri), (ls, li) = states
    assert bool(ri.accepted) == bool(li.accepted)
    assert bool(ri.accepted)  # the step moved, so the compared states differ from x0
    np.testing.assert_allclose(ri.accept_prob.numpy(), li.accept_prob.numpy(), **GRAD_TOL)
    np.testing.assert_allclose(rs.x.numpy(), ls.x.numpy(), **GRAD_TOL)
    np.testing.assert_allclose(rs.logp.numpy(), ls.logp.numpy(), rtol=LOGP_RTOL)
    np.testing.assert_allclose(rs.grad.numpy(), ls.grad.numpy(), **GRAD_TOL)

"""The port's driver-side ops against the JAX package's.

The same numpy host functions go behind the JAX package's
``LogpGradOp`` / ``blackbox_logp_grad`` / ``ParallelLogpGrad``
(``jax.custom_vjp`` + ``pure_callback``) and the port's
(``torch.autograd.Function``): values and gradients must agree, second
order must raise, and a fan-out's wall time must be about the max of
its nodes' delays, not the sum (``tests/test_fanout.py``'s margin).
The wrappers raise the JAX package's error messages
(``tests/test_wrappers.py``), and ``device_compute_fn(batched=True)``
batches as the JAX ``batched_compute_fn`` does.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytensor_federated_tpu as jpft
from pytensor_federated_tpu.service.batching import batched_compute_fn as jax_batched
import pytensor_federated_torch as tpft
from pytensor_federated_torch.ops import LogpGradOp, parallel_host_call
from pytensor_federated_torch.service import device_compute_fn

RTOL = 1e-6


def _quad_node(center):
    """A numpy logp+grad node: -sum((x - c)^2) and -log-cosh of y."""

    def host(x, y):
        x, y = np.asarray(x, np.float32), np.asarray(y, np.float32)
        logp = -np.sum((x - center) ** 2) - np.log(np.cosh(y))
        return np.float32(logp), [(-2.0 * (x - center)).astype(np.float32), np.float32(-np.tanh(y))]

    return host


X = np.array([0.0, 2.0, -0.5], np.float32)
Y = np.float32(0.3)


def _torch_args():
    return torch.tensor(X, requires_grad=True), torch.tensor(Y, requires_grad=True)


def test_blackbox_logp_grad_matches_jax():
    host = _quad_node(1.0)
    jspec = jpft.spec_of(X, Y)
    tspec = tpft.spec_of(X, Y)
    assert [tuple(s.shape) for s in tspec] == [tuple(s.shape) for s in jspec]
    jop, top = jpft.blackbox_logp_grad(host, jspec), tpft.blackbox_logp_grad(host, tspec)

    jl, jg = jop(X, Y)
    x, y = _torch_args()
    tl, tg = top(x, y)
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl), rtol=RTOL)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=RTOL)

    # Gradient of 3 * logp through the forward-supplied grads.
    jgrad = jax.grad(lambda a, b: 3.0 * jop.logp(a, b), argnums=(0, 1))(jnp.asarray(X), jnp.asarray(Y))
    (3.0 * top.logp(x, y)).backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jgrad[0]), rtol=RTOL)
    np.testing.assert_allclose(y.grad.numpy(), np.asarray(jgrad[1]), rtol=RTOL)


def test_logp_grad_op_and_from_logp_match_jax():
    def t_fn(x, y):
        return torch.sum(x**3) * y, (3 * x**2 * y, torch.sum(x**3))

    def j_fn(x, y):
        return jnp.sum(x**3) * y, (3 * x**2 * y, jnp.sum(x**3))

    x, y = _torch_args()
    tl, _ = LogpGradOp(t_fn)(x, y)
    jl, _ = jpft.LogpGradOp(j_fn)(X, Y)
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl), rtol=RTOL)
    tl.backward()
    jg = jax.grad(lambda a, b: jpft.LogpGradOp(j_fn).logp(a, b), argnums=(0, 1))(
        jnp.asarray(X), jnp.asarray(Y)
    )
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jg[0]), rtol=RTOL)
    np.testing.assert_allclose(y.grad.numpy(), np.asarray(jg[1]), rtol=RTOL)

    derived = tpft.ops.from_logp_fn(lambda a, b: torch.sum(a**3) * b)
    dl, (dgx, dgy) = derived(torch.tensor(X), torch.tensor(Y))
    np.testing.assert_allclose(dl.numpy(), np.asarray(jl), rtol=RTOL)
    np.testing.assert_allclose(dgx.numpy(), np.asarray(jg[0]), rtol=RTOL)


def test_parallel_logp_grad_matches_jax():
    hosts = [_quad_node(1.0), _quad_node(-1.0), _quad_node(0.25)]
    jspec, tspec = jpft.spec_of(X, Y), tpft.spec_of(X, Y)
    jop = jpft.ParallelLogpGrad(hosts, [jspec] * 3)
    top = tpft.ParallelLogpGrad(hosts, [tspec] * 3)
    try:
        jres = jop([(X, Y)] * 3)
        x, y = _torch_args()
        tres = top([(x, y)] * 3)
        for (tl, tg), (jl, jg) in zip(tres, jres):
            np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl), rtol=RTOL)
            for a, b in zip(tg, jg):
                np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=RTOL)
        jgrad = jax.grad(lambda a, b: jop.total_logp([(a, b)] * 3), argnums=(0, 1))(
            jnp.asarray(X), jnp.asarray(Y)
        )
        top.total_logp([(x, y)] * 3).backward()
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(jgrad[0]), rtol=RTOL)
        np.testing.assert_allclose(y.grad.numpy(), np.asarray(jgrad[1]), rtol=RTOL)
    finally:
        jop.close()
        top.close()


def test_parallel_host_call_values():
    fn = parallel_host_call(
        [lambda x: [2.0 * x], lambda x: [3.0 * x]], [tpft.spec_of(X)] * 2
    )
    try:
        (a,), (b,) = fn((torch.tensor(X),), (torch.tensor(X),))
        np.testing.assert_allclose(a.numpy(), 2.0 * X)
        np.testing.assert_allclose(b.numpy(), 3.0 * X)
        assert a.dtype == torch.float32
    finally:
        fn.close()


def _second_order(op_call, x, y):
    logp = op_call(x, y)
    (g,) = torch.autograd.grad(logp, x, create_graph=True)
    return g


@pytest.mark.parametrize("kind", ["blackbox", "parallel"])
def test_second_order_raises(kind):
    host = _quad_node(1.0)
    spec = tpft.spec_of(X, Y)
    if kind == "blackbox":
        op = tpft.blackbox_logp_grad(host, spec)
        call, close = op.logp, lambda: None
    else:
        op = tpft.ParallelLogpGrad([host], [spec])
        call, close = (lambda a, b: op.total_logp([(a, b)])), op.close
    try:
        x, y = _torch_args()
        with pytest.raises(NotImplementedError, match="first-order only"):
            _second_order(call, x, y)
        # A gradient flowing into the grads outputs raises as well.
        x, y = _torch_args()
        if kind == "blackbox":
            _, (gx, _) = op(x, y)
        else:
            ((_, (gx, _)),) = op([(x, y)])
        with pytest.raises(NotImplementedError, match="first-order only"):
            torch.sum(gx).backward()
    finally:
        close()


def test_parallel_logp_grad_overlaps():
    """Wall time ~= max(delays), not sum (tests/test_fanout.py)."""
    delay, n = 0.4, 3

    def slow_node(i):
        def host(x):
            time.sleep(delay)
            return -float(i) * np.asarray(x) ** 2, [-2 * float(i) * np.asarray(x)]

        return host

    spec = tpft.spec_of(np.float32(1.0))
    op = tpft.ParallelLogpGrad([slow_node(i) for i in range(n)], [spec] * n)
    try:
        args = [(torch.tensor(1.0),) for _ in range(n)]
        op(args)  # warm up: the member threads start
        t0 = time.perf_counter()
        op(args)
        wall = time.perf_counter() - t0
        assert wall < n * delay * 0.75, f"no overlap: {wall:.2f}s"
    finally:
        op.close()


@pytest.mark.parametrize(
    "fn,args",
    [
        ("arity", (np.ones(2, np.float32), np.ones(2, np.float32))),
        ("shape", (np.ones(2, np.float32),)),
        ("nonscalar", (np.ones(2, np.float32),)),
    ],
)
def test_wrappers_raise_the_jax_messages(fn, args):
    if fn == "arity":
        jw = jpft.wrap_logp_grad_fn(lambda x, y: (-jnp.sum(x**2), (-2 * x,)))
        tw = tpft.wrap_logp_grad_fn(lambda x, y: (-torch.sum(x**2), (-2 * x,)))
    elif fn == "shape":
        jw = jpft.wrap_logp_grad_fn(lambda x: (-jnp.sum(x**2), (jnp.zeros((3,)),)))
        tw = tpft.wrap_logp_grad_fn(lambda x: (-torch.sum(x**2), (torch.zeros((3,)),)))
    else:
        jw = jpft.wrap_logp_fn(lambda x: x)
        tw = tpft.wrap_logp_fn(lambda x: x)
    with pytest.raises(ValueError) as je:
        jw(*(jnp.asarray(a) for a in args))
    with pytest.raises(ValueError) as te:
        tw(*(torch.from_numpy(a) for a in args))
    assert str(te.value) == str(je.value)


def test_wrap_logp_grad_fn_values_match():
    def jfn(x, y):
        return -jnp.sum(x**2) - y**2, (-2 * x, -2 * y)

    tfn = tpft.logp_grad_from_logp(lambda x, y: -torch.sum(x**2) - y**2)
    jout = jpft.wrap_logp_grad_fn(jfn)(jnp.asarray(X), jnp.asarray(Y))
    tout = tpft.wrap_logp_grad_fn(tfn)(torch.tensor(X), torch.tensor(Y))
    for a, b in zip(tout, jout):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL)


def test_device_compute_fn_batch_matches_jax_batched_compute_fn():
    def tfn(x, s):
        return [torch.tanh(x) * s, torch.sum(x**2) + s]

    def jfn(x, s):
        return [jnp.tanh(x) * s, jnp.sum(x**2) + s]

    rng = np.random.default_rng(0)
    reqs = [(rng.normal(size=4).astype(np.float32), np.float32(i)) for i in range(5)]
    compute = device_compute_fn(tfn, device="cpu", batched=True, max_batch=4)
    tout = compute.batch(reqs)
    jout = jax_batched(jfn, max_batch=4)(reqs)
    assert len(tout) == len(jout) == 5
    for treq, jreq, req in zip(tout, jout, reqs):
        scalar = compute(*req)
        for a, b, c in zip(treq, jreq, scalar):
            assert a.shape == np.asarray(b).shape and a.dtype == np.asarray(b).dtype
            np.testing.assert_allclose(a, b, rtol=RTOL)
            np.testing.assert_allclose(a, c, rtol=RTOL)


def test_device_compute_fn_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        device_compute_fn(lambda x: [x])

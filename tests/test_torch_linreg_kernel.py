"""The port's fused logp+grad reductions against the JAX package's.

The same inputs, made with numpy from a seed, go through the JAX
package's Pallas kernel (``interpret=True``, as tests/test_pallas.py
runs it on the CPU) and through the port's ``linreg_reductions``, whose
CPU path is the plain PyTorch version that the Hopper kernel is held
against on the card (tests/test_torch_gpu.py holds the two together
there).  Tolerances are test_pallas.py's: rtol 5e-5 on values, rtol/atol
5e-4 on gradients (float32, different summation orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytensor_federated_tpu.ops.pallas_kernels import (
    linreg_logp_grad_fn as jax_logp_grad_fn,
    linreg_reductions as jax_reductions,
)
from pytensor_federated_torch.ops import _build
from pytensor_federated_torch.ops.linreg_kernel import (
    _DataLogp,
    linreg_logp_grad_fn,
    linreg_reductions,
    linreg_reductions_and_totals,
)

SHAPES = [(1, 8), (5, 70), (8, 512), (12, 700)]  # test_pallas.py's cases
VALUE_RTOL = 5e-5
GRAD_TOL = dict(rtol=5e-4, atol=5e-4)


def _make_case(S, N, seed=0, mask_p=0.25):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(S, N)).astype(np.float32)
    y = (1.0 + 2.0 * x + 0.3 * rng.normal(size=(S, N))).astype(np.float32)
    mask = (rng.uniform(size=(S, N)) > mask_p).astype(np.float32)
    params = {
        "intercept": np.float32(0.7),
        "slope": np.float32(1.8),
        "log_sigma": np.float32(-0.2),
        "offsets": rng.normal(size=S).astype(np.float32),
    }
    return x, y, mask, params


def _jax_params(params):
    return {k: jnp.asarray(v) for k, v in params.items()}


def _torch_params(params, requires_grad=False):
    return {
        k: torch.tensor(np.asarray(v)).requires_grad_(requires_grad)
        for k, v in params.items()
    }


def _scalars(params):
    return np.array(
        [params["intercept"], params["slope"], params["log_sigma"]], np.float32
    )


@pytest.mark.parametrize("S,N", SHAPES)
def test_reductions_match_jax(S, N):
    x, y, mask, params = _make_case(S, N)
    want = jax_reductions(
        jnp.asarray(_scalars(params)), jnp.asarray(params["offsets"]),
        x, y, mask, interpret=True,
    )
    got = linreg_reductions(
        torch.tensor(_scalars(params)), torch.tensor(params["offsets"]),
        torch.tensor(x), torch.tensor(y), torch.tensor(mask),
    )
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=VALUE_RTOL)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **GRAD_TOL)


@pytest.mark.parametrize("S,N", SHAPES)
def test_totals_match_jax(S, N):
    """The four totals over shards (what the kernel writes beside the
    per-shard rows) equal the sums of the JAX package's reductions."""
    x, y, mask, params = _make_case(S, N, seed=1)
    want = jax_reductions(
        jnp.asarray(_scalars(params)), jnp.asarray(params["offsets"]),
        x, y, mask, interpret=True,
    )
    red, totals = linreg_reductions_and_totals(
        torch.tensor(_scalars(params)), torch.tensor(params["offsets"]),
        torch.tensor(x), torch.tensor(y), torch.tensor(mask),
    )
    assert totals.shape == (4,)
    for g, w in zip(red, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **GRAD_TOL)
    np.testing.assert_allclose(totals[0].numpy(), np.sum(want[0]), rtol=VALUE_RTOL)
    for g, w in zip(totals[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), np.sum(w), **GRAD_TOL)


@pytest.mark.parametrize("S,N", SHAPES)
def test_data_logp_totals_path_matches_jax(S, N):
    """``_DataLogp`` takes the three scalars as 0-d tensors and returns
    the ll total; its gradient is the totals and the per-shard gmu."""
    x, y, mask, params = _make_case(S, N, seed=2)
    jfn = jax_logp_grad_fn(x, y, mask, interpret=True)
    jv, jg = jax.value_and_grad(jfn.data_logp)(_jax_params(params))
    p = _torch_params(params, requires_grad=True)
    tv = _DataLogp.apply(
        p["intercept"], p["slope"], p["log_sigma"], p["offsets"],
        *map(torch.tensor, (x, y, mask)),
    )
    tg = dict(zip(p, torch.autograd.grad(tv, list(p.values()))))
    np.testing.assert_allclose(tv.detach().numpy(), np.asarray(jv), rtol=VALUE_RTOL)
    for k in jg:
        np.testing.assert_allclose(tg[k].numpy(), np.asarray(jg[k]), **GRAD_TOL)


def test_scalars_as_three_0d_tensors():
    """Three 0-d tensors give the bits of one (3,) tensor."""
    x, y, mask, params = _make_case(4, 33)
    data = [torch.tensor(params["offsets"]), *map(torch.tensor, (x, y, mask))]
    one = linreg_reductions(torch.tensor(_scalars(params)), *data)
    three = linreg_reductions(tuple(torch.tensor(v) for v in _scalars(params)), *data)
    for a, b in zip(one, three):
        assert torch.equal(a, b)


@pytest.mark.parametrize(
    "bad,error",
    [("dtype", TypeError), ("device", ValueError), ("count", ValueError), ("ndim", ValueError)],
)
def test_wrapper_rejects_malformed_scalars(bad, error):
    x, y, mask, params = _make_case(3, 10)
    scal = [torch.tensor(v) for v in _scalars(params)]
    if bad == "dtype":
        scal[1] = scal[1].double()
    elif bad == "device":
        scal[2] = scal[2].to("meta")
    elif bad == "count":
        scal = scal[:2]
    else:
        scal[0] = scal[0].reshape(1)
    with pytest.raises(error):
        linreg_reductions_and_totals(
            scal, torch.tensor(params["offsets"]), *map(torch.tensor, (x, y, mask))
        )


@pytest.mark.parametrize("S,N", SHAPES)
def test_logp_grad_fn_matches_jax(S, N):
    x, y, mask, params = _make_case(S, N)
    jv, jg = jax_logp_grad_fn(x, y, mask, interpret=True)(_jax_params(params))
    fn = linreg_logp_grad_fn(torch.tensor(x), torch.tensor(y), torch.tensor(mask))
    tv, tg = fn(_torch_params(params))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=VALUE_RTOL)
    assert sorted(tg) == sorted(jg)
    for k in jg:
        np.testing.assert_allclose(tg[k].numpy(), np.asarray(jg[k]), **GRAD_TOL)


@pytest.mark.parametrize("pad_shards,pad_obs", [(0, 40), (3, 0), (3, 40)])
def test_padding_is_inert(pad_shards, pad_obs):
    """Padded rows/cols (mask == 0) contribute nothing."""
    x, y, mask, params = _make_case(3, 17)
    scal = torch.tensor(_scalars(params))
    offs = torch.tensor(params["offsets"])
    base = linreg_reductions(scal, offs, *map(torch.tensor, (x, y, mask)))
    pad = lambda a: torch.tensor(np.pad(a, ((0, pad_shards), (0, pad_obs))))
    padded = linreg_reductions(
        scal, torch.nn.functional.pad(offs, (0, pad_shards)), pad(x), pad(y), pad(mask)
    )
    for b, p in zip(base, padded):
        np.testing.assert_allclose(p[:3].numpy(), b.numpy(), rtol=1e-6, atol=1e-6)
        assert torch.all(p[3:] == 0)


def test_kernel_composes_with_prior_under_autograd():
    """The kernel's value feeds a larger differentiable expression
    (prior + likelihood), the way NUTS consumes it; same composition
    through the JAX kernel."""
    x, y, mask, params = _make_case(4, 33)
    jfn = jax_logp_grad_fn(x, y, mask, interpret=True)
    tfn = linreg_logp_grad_fn(torch.tensor(x), torch.tensor(y), torch.tensor(mask))

    def jpost(p):
        return -0.5 * (p["slope"] ** 2) - 0.5 * jnp.sum(p["offsets"] ** 2) + jfn.data_logp(p)

    jv, jg = jax.value_and_grad(jpost)(_jax_params(params))
    p = _torch_params(params, requires_grad=True)
    tv = -0.5 * (p["slope"] ** 2) - 0.5 * torch.sum(p["offsets"] ** 2) + tfn.data_logp(p)
    tg = dict(zip(p, torch.autograd.grad(tv, list(p.values()))))
    np.testing.assert_allclose(tv.detach().numpy(), np.asarray(jv), rtol=VALUE_RTOL)
    for k in jg:
        np.testing.assert_allclose(tg[k].numpy(), np.asarray(jg[k]), **GRAD_TOL)


def test_second_order_unsupported():
    """No second-order autodiff through the kernel boundary, even when
    the kernel term is summed with a differentiable prior (whose second
    derivative alone would otherwise be returned)."""
    x, y, mask, params = _make_case(2, 16)
    fn = linreg_logp_grad_fn(torch.tensor(x), torch.tensor(y), torch.tensor(mask))
    p = _torch_params(params, requires_grad=True)
    total = -0.5 * p["slope"] ** 2 + fn.data_logp(p)
    with pytest.raises(RuntimeError, match="second-order"):
        torch.autograd.grad(total, list(p.values()), create_graph=True)


def test_cpu_path_counts_no_launch():
    x, y, mask, params = _make_case(2, 16)
    before = linreg_reductions.launches
    linreg_reductions(
        torch.tensor(_scalars(params)), torch.tensor(params["offsets"]),
        *map(torch.tensor, (x, y, mask)),
    )
    assert linreg_reductions.launches == before


@pytest.mark.parametrize(
    "bad",
    ["scalars", "offsets", "mask", "device"],
)
def test_wrapper_rejects_malformed_inputs(bad):
    x, y, mask, params = _make_case(3, 10)
    args = [
        torch.tensor(_scalars(params)), torch.tensor(params["offsets"]),
        *map(torch.tensor, (x, y, mask)),
    ]
    if bad == "scalars":
        args[0] = args[0][:2]
    elif bad == "offsets":
        args[1] = args[1][:2]
    elif bad == "mask":
        args[4] = args[4][:, :5]
    else:
        args = [a.to("meta") for a in args]
    with pytest.raises(ValueError):
        linreg_reductions(*args)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """A missing toolkit is a loud error, never a silent fallback."""
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "CUDA_HOMES", ())
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_all(["linreg_reductions"])

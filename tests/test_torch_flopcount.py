"""The port's FLOP accounting against closed forms and the JAX package.

On functions made of matrix products alone, ``flops_per_eval`` equals
the JAX package's ``xla_flops_per_eval`` on the same shapes (exactly:
both count a multiply-add as 2 FLOPs).  Each registered linalg formula
is held against its closed form on a batch, forward only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytensor_federated_tpu.flopcount import xla_flops_per_eval
from pytensor_federated_torch import flopcount
from pytensor_federated_torch.flopcount import flops_per_eval, measured_matmul_peak, mfu, peak_flops


@pytest.mark.parametrize(
    "name,jfn,tfn,shapes",
    [
        ("matmul", lambda a: a @ a, lambda a: a @ a, [(128, 128)]),
        ("rectangular", lambda a, b: a @ b, lambda a, b: a @ b, [(64, 96), (96, 40)]),
        ("chain", lambda a, b, c: a @ b @ c, lambda a, b, c: a @ b @ c, [(32, 48), (48, 16), (16, 8)]),
        ("batched", lambda a, b: a @ b, lambda a, b: a @ b, [(4, 16, 24), (4, 24, 8)]),
        ("matvec", lambda a, x: a @ x, lambda a, x: a @ x, [(256, 64), (64,)]),
        ("vmapped_matvec", jax.vmap(lambda w: jnp.ones((256, 64)) @ w),
         torch.func.vmap(lambda w: torch.ones((256, 64)) @ w), [(8, 64)]),
    ],
)
def test_matrix_products_equal_xla_count(name, jfn, tfn, shapes):
    want = xla_flops_per_eval(jfn, *(jnp.ones(s) for s in shapes))
    got = flops_per_eval(tfn, *(torch.ones(s) for s in shapes))
    assert want is not None and got == want, (name, got, want)


def test_value_and_grad_adds_one_cotangent_product():
    """loss(w) = sum((A @ w)²): the gradient adds exactly the transposed
    product, so value+grad counts twice the forward (4 n³)."""
    n = 64
    A = torch.randn(n, n)

    def loss(w):
        return torch.sum((A @ w) ** 2)

    def value_and_grad(w):
        w = w.detach().requires_grad_(True)
        v = loss(w)
        return v, torch.autograd.grad(v, w)[0]

    w = torch.randn(n, n)
    assert flops_per_eval(loss, w) == 2 * n**3
    assert flops_per_eval(value_and_grad, w) == 4 * n**3


def _spd(batch, n):
    a = torch.randn(batch, n, n, dtype=torch.float64, generator=torch.Generator().manual_seed(n))
    return a @ a.mT + n * torch.eye(n, dtype=torch.float64)


B, N, K = 3, 24, 5


@pytest.mark.parametrize(
    "op,fn,want",
    [
        ("linalg_cholesky_ex", lambda a, b: torch.linalg.cholesky_ex(a), B * N**3 // 3),
        ("linalg_solve_triangular",
         lambda a, b: torch.linalg.solve_triangular(torch.linalg.cholesky(a), b, upper=False),
         B * N**3 // 3 + B * N * N * K),
        ("cholesky_solve", lambda a, b: torch.cholesky_solve(b, torch.linalg.cholesky(a)),
         B * N**3 // 3 + B * 2 * N * N * K),
        ("linalg_lu_factor_ex", lambda a, b: torch.linalg.lu_factor_ex(a), B * 2 * N**3 // 3),
        ("linalg_lu_solve", lambda a, b: torch.linalg.lu_solve(*torch.linalg.lu_factor(a), b),
         B * 2 * N**3 // 3 + B * 2 * N * N * K),
        ("solve_matrix", lambda a, b: torch.linalg.solve(a, b), B * (2 * N**3 // 3 + 2 * N * N * K)),
        ("solve_vector", lambda a, b: torch.linalg.solve(a, b[..., 0]), B * (2 * N**3 // 3 + 2 * N * N)),
        ("mv", lambda a, b: a[0] @ b[0, :, 0], 2 * N * N),
        ("dot", lambda a, b: b[0, :, 0] @ b[1, :, 0], 2 * N),
    ],
)
def test_linalg_formulas(op, fn, want):
    a = _spd(B, N)
    b = torch.randn(B, N, K, dtype=torch.float64, generator=torch.Generator().manual_seed(1))
    assert flops_per_eval(fn, a, b) == want


def test_formulas_cover_the_gp_backward():
    """The exact GP's linalg ops and their backward all carry a formula:
    a logp+grad counts more than the Cholesky alone."""
    from pytensor_federated_torch.models.gp import FederatedExactGP, generate_gp_data

    data, _ = generate_gp_data(2, n_obs=32, seed=9, device="cpu")
    model = FederatedExactGP(data)
    p = model.init_params()
    fwd = flops_per_eval(model.logp, p)
    both = flops_per_eval(model.logp_and_grad, p)
    assert fwd >= 2 * 32**3 // 3  # two shards' Cholesky
    assert both > 2 * fwd


def test_counting_failure_returns_none():
    def broken(x):
        raise RuntimeError("no")

    assert flops_per_eval(broken, torch.ones(2)) is None


def test_mfu_fields_complete_and_unavailable_path():
    fields = mfu(1e6, 1000.0, device="cpu")
    assert fields["flops_per_sec"] == 1e9
    assert fields["mfu"] > 0
    assert "FLOP/s" in fields["mfu_basis"]
    none_fields = mfu(None, 1000.0)
    assert none_fields["mfu"] is None and none_fields["flops_per_eval"] is None
    assert "unavailable" in none_fields["mfu_basis"]


def test_measured_peak_caches_and_is_positive():
    p1 = measured_matmul_peak("cpu", n=256)
    p2 = measured_matmul_peak("cpu", n=256)
    assert p1 == p2 > 1e9
    flopcount._MEASURED_PEAK_CACHE[("cpu", 4096)] = p1  # no 4096² product on the CPU here
    peak, basis = peak_flops("cpu")
    assert peak == p1 and "measured" in basis


@pytest.mark.parametrize("name,want", [("NVIDIA H100 80GB HBM3", 67e12), ("NVIDIA H100 PCIe", 51e12)])
def test_cuda_peak_is_the_data_sheet_rate_with_the_measured_one_beside_it(monkeypatch, name, want):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: name)
    monkeypatch.setattr(flopcount, "measured_matmul_peak", lambda *a, **k: 4.2e13)
    peak, basis = peak_flops("cuda")
    assert peak == want
    assert "data sheet" in basis and "measured float32 matmul rate 4.2e+13" in basis


def test_peak_on_cuda_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        peak_flops()

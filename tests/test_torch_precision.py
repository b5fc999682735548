"""The port's float32 contraction policy (precision.py) and the bf16
``compute_dtype`` of the GLMs, mirroring tests/test_precision.py and
tests/test_mixed_precision.py.

A simulated bf16-multiply contraction (operands rounded to bf16, products
summed in float32) stands in for degraded hardware: it must really be
broken (norm-relative error > 1e-4 on the 2048x512 dot), and the 6-pass
split over that same contraction must recover true float32 (<= 1e-5).
A bf16 ``compute_dtype`` keeps the logistic logp within rtol 2e-2 of
float32 and of the JAX package's bf16 value.
"""

from contextlib import nullcontext

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytensor_federated_tpu.models import logistic as jlog
import pytensor_federated_torch as pft
from pytensor_federated_torch.models.hierbase import linear_predictor
from pytensor_federated_torch.precision import (
    POLICIES,
    matmul_precision_ctx,
    pdot,
    resolve_policy,
    split_dot,
    wrap_policy,
)

BF16_RTOL = 2e-2


def _sim_bf16_dot(a, b):
    return torch.matmul(a.to(torch.bfloat16).float(), b.to(torch.bfloat16).float())


def _relerr(x, ref):
    """Norm-relative error (single outputs of a random dot may nearly
    cancel, so the elementwise maximum is the wrong gate)."""
    x = x.detach().numpy().astype(np.float64)
    return float(np.linalg.norm(x - ref) / np.linalg.norm(ref))


@pytest.fixture(scope="module")
def mat_vec():
    rng = np.random.default_rng(0)
    A = rng.normal(size=(2048, 512)).astype(np.float32)
    w = rng.normal(size=(512,)).astype(np.float32)
    ref = A.astype(np.float64) @ w.astype(np.float64)
    return torch.from_numpy(A), torch.from_numpy(w), ref


class TestSplitDot:
    def test_simulated_chip_reproduces_the_trap(self, mat_vec):
        A, w, ref = mat_vec
        assert _relerr(_sim_bf16_dot(A, w), ref) > 1e-4

    def test_split_recovers_true_f32_on_simulated_chip(self, mat_vec):
        A, w, ref = mat_vec
        assert _relerr(split_dot(A, w, base_dot=_sim_bf16_dot), ref) <= 1e-5

    def test_split_matches_plain_f32_on_cpu(self, mat_vec):
        A, w, ref = mat_vec
        assert _relerr(split_dot(A, w), ref) <= 1e-5

    def test_split_matmul_shapes(self):
        rng = np.random.default_rng(1)
        a = rng.normal(size=(8, 16, 32)).astype(np.float32)
        b = rng.normal(size=(8, 32, 4)).astype(np.float32)
        out = split_dot(torch.from_numpy(a), torch.from_numpy(b))
        assert out.shape == (8, 16, 4)
        assert _relerr(out, a.astype(np.float64) @ b.astype(np.float64)) <= 1e-5

    def test_gradients_flow(self, mat_vec):
        A, w, _ = mat_vec
        w1 = w.clone().requires_grad_(True)
        (g,) = torch.autograd.grad(torch.sum(split_dot(A, w1) ** 2), w1)
        w2 = w.clone().requires_grad_(True)
        (g_ref,) = torch.autograd.grad(torch.sum((A @ w2) ** 2), w2)
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(g.numpy(), g_ref.numpy(), rtol=1e-4, atol=1e-2)


class TestPolicyRouting:
    def test_resolve_rejects_unknown(self):
        with pytest.raises(ValueError, match="unknown f32 policy"):
            resolve_policy("fastest")

    def test_env_override(self, monkeypatch):
        monkeypatch.setenv("PFTPU_F32_POLICY", "split")
        assert resolve_policy(None) == "split"
        monkeypatch.setenv("PFTPU_F32_POLICY", "bogus")
        with pytest.raises(ValueError):
            resolve_policy(None)
        monkeypatch.delenv("PFTPU_F32_POLICY")
        assert resolve_policy(None) == "default"

    @pytest.mark.parametrize("policy", POLICIES)
    def test_all_policies_accurate_on_cpu(self, policy, mat_vec):
        A, w, ref = mat_vec
        assert _relerr(pdot(A, w, policy), ref) <= 1e-5

    def test_wrap_policy_identity_for_default(self):
        fn = lambda x: x  # noqa: E731
        assert wrap_policy(fn, "default") is fn
        assert wrap_policy(fn, "split") is fn
        assert wrap_policy(fn, "strict") is not fn

    def test_ctx_types(self):
        assert isinstance(matmul_precision_ctx("default"), nullcontext)
        assert isinstance(matmul_precision_ctx("split"), nullcontext)
        assert not isinstance(matmul_precision_ctx("strict"), nullcontext)

    @pytest.mark.parametrize("policy", ["highest", "strict"])
    def test_ctx_turns_tf32_off_and_restores(self, policy):
        flags = torch.backends.cuda.matmul, torch.backends.cudnn
        before = [f.allow_tf32 for f in flags]
        try:
            for f in flags:
                f.allow_tf32 = True
            seen = []
            wrap_policy(lambda: seen.extend(f.allow_tf32 for f in flags), policy)()
            assert seen == [False, False]
            assert [f.allow_tf32 for f in flags] == [True, True]
        finally:
            for f, v in zip(flags, before):
                f.allow_tf32 = v


class TestModelWiring:
    def test_linear_predictor_strict(self):
        rng = np.random.default_rng(6)
        X = torch.from_numpy(rng.normal(size=(128, 16)).astype(np.float32))
        w = torch.from_numpy(rng.normal(size=16).astype(np.float32))
        out0 = linear_predictor(X, w, 0.5)
        out1 = linear_predictor(X, w, 0.5, compute_dtype="float32_strict")
        np.testing.assert_allclose(out0.numpy(), out1.numpy(), rtol=1e-5, atol=1e-6)

    def test_bf16_predictor_multiplies_in_float32(self):
        """bf16-rounded operands, float32 products and sums — not a bf16
        matmul, whose result is itself rounded to bf16."""
        rng = np.random.default_rng(7)
        X = torch.from_numpy(rng.normal(size=(64, 8)).astype(np.float32))
        w = torch.from_numpy(rng.normal(size=8).astype(np.float32))
        out = linear_predictor(X, w, 0.0, compute_dtype=torch.bfloat16)
        assert out.dtype == torch.float32
        want = X.to(torch.bfloat16).double() @ w.to(torch.bfloat16).double()
        np.testing.assert_allclose(out.double().numpy(), want.numpy(), rtol=1e-6, atol=1e-6)

    def test_logistic_model_strict_dtype(self):
        data, _ = pft.generate_logistic_data(n_shards=4, n_obs=32, n_features=8, device="cpu")
        base = pft.FederatedLogisticRegression(data)
        strict = pft.FederatedLogisticRegression(data, compute_dtype="float32_strict")
        p = base.init_params()
        np.testing.assert_allclose(float(base.logp(p)), float(strict.logp(p)), rtol=1e-5)

    @pytest.mark.parametrize("hier", [False, True], ids=["flat", "hier"])
    def test_bf16_logistic_close_to_f32_and_to_jax(self, hier):
        if hier:
            gen_j = lambda: jlog.generate_hier_logistic_data(8, n_obs=64, n_features=16)
            gen_t = lambda: pft.generate_hier_logistic_data(8, n_obs=64, n_features=16, device="cpu")
            jcls, tcls = jlog.HierarchicalLogisticRegression, pft.HierarchicalLogisticRegression
        else:
            gen_j = lambda: jlog.generate_logistic_data(n_shards=8, n_obs=64, n_features=16)
            gen_t = lambda: pft.generate_logistic_data(n_shards=8, n_obs=64, n_features=16, device="cpu")
            jcls, tcls = jlog.FederatedLogisticRegression, pft.FederatedLogisticRegression
        (jd, _), (td, _) = gen_j(), gen_t()
        rng = np.random.default_rng(3)
        m32 = tcls(td)
        p = {k: v.numpy() + (0.3 * rng.normal(size=v.shape)).astype(np.float32)
             for k, v in m32.init_params().items()}
        tp = pft.params_from_jax(p, device="cpu")
        v32 = float(m32.logp(tp))
        v16 = float(tcls(td, compute_dtype=torch.bfloat16).logp(tp))
        j16 = float(jcls(jd, compute_dtype=jnp.bfloat16).logp({k: jnp.asarray(v) for k, v in p.items()}))
        np.testing.assert_allclose(v16, v32, rtol=BF16_RTOL)
        np.testing.assert_allclose(v16, j16, rtol=BF16_RTOL)
        assert v16 != v32  # the bf16 path really rounds

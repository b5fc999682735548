"""The port's ``demos/demo_pymc.py`` under the port's fake pytensor and
pymc (``tests/torch_pymc_shim.py``), on the CPU, where its data term runs
the kernel's plain version: every case of ``tests/test_demo_pymc_shim.py``
at its gates, the demo's potential held against the JAX package's under
the JAX package's fakes on the same data (carried across with
``convert.py``), and the torch lane's own contracts (one reduction pass
for value and gradient, the kernel's graph kept for a sampler's
backward, chains under ``torch.func.vmap``).

Fake caveat: this proves our-side logic, not real-pymc compatibility.
"""

import sys

import numpy as np
import pytest
import torch

from torch_pymc_shim import demo_pymc_under_torch_shims
import torch_pytensor_shim as tps

from pytensor_federated_torch.convert import sharded_data_from_jax
from pytensor_federated_torch.ops.linreg_kernel import linreg_reductions_ref
from pytensor_federated_torch.utils import LOG_2PI


@pytest.fixture(scope="class")
def shims():
    with demo_pymc_under_torch_shims("cpu") as ns:
        yield ns


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _unconstrained(model, *, intercept, offsets, slope, log_sigma):
    u = {
        "intercept": torch.tensor(np.float32(intercept)),
        "offsets": torch.as_tensor(np.asarray(offsets, np.float32)),
        "slope": torch.tensor(np.float32(slope)),
        "sigma": torch.tensor(np.float32(log_sigma)),  # unconstrained = log sigma
    }
    assert {rv.name for rv in model.free_rvs} == set(u)
    return u


def _potential_parts(model, point, lane):
    """[logp, dA, dslope, dsigma] of the model's federated op at a
    constrained ``point``, through the PyTorch linker stand-in or the
    perform lane."""
    outputs = model.potentials[0].owner.outputs
    values = [point[rv.name] for rv in model.free_rvs]
    if lane == "torch":
        fn = tps.compile_graph_to_torch(
            outputs, [rv.var for rv in model.free_rvs],
            sys.modules["pytensor.link.pytorch.dispatch"].pytorch_funcify)
        return [np.asarray(t.detach().double()) for t in fn(*map(torch.as_tensor, values))]
    return [np.asarray(v, np.float64) for v in tps.eval_graph(
        outputs, {rv.var: np.asarray(v) for rv, v in zip(model.free_rvs, values)})]


class TestModelParity:
    def test_federated_matches_native_logp(self, shims):
        """The federated Potential model and the natively built model are
        the SAME posterior."""
        demo = shims.demo
        data, _ = demo.generate_node_data(4, n_obs=32, seed=7, device="cpu")
        fed_logp = demo.build_model(data).logp_fn()
        native = demo.build_native_model(data)
        native_logp = native.logp_fn()
        rng = np.random.default_rng(0)
        for _ in range(3):
            point = _unconstrained(
                native,
                intercept=rng.normal(1.5, 0.3),
                offsets=rng.normal(0.0, 0.2, size=4),
                slope=rng.normal(2.0, 0.3),
                log_sigma=rng.normal(-0.5, 0.2),
            )
            a = float(fed_logp(point))
            b = float(native_logp(point))
            assert np.isfinite(a) and np.isfinite(b)
            # float32 evaluation over ~128 observations: 1e-4 relative
            # (both sides float32; the gap is summation order).
            assert abs(a - b) <= 1e-4 * max(1.0, abs(a)), (a, b)

    def test_perform_path_matches_torch_path(self, shims):
        """build_model(use_torch_fn=False) routes the same likelihood
        through the host callable and op.perform (the C/py-linker path);
        both lanes agree, gradients included."""
        demo = shims.demo
        data, _ = demo.generate_node_data(4, n_obs=32, seed=7, device="cpu")
        host_model = demo.build_model(data, use_torch_fn=False)
        torch_model = demo.build_model(data, use_torch_fn=True)
        point = dict(intercept=np.float32(1.4), offsets=np.zeros(4, np.float32),
                     slope=np.float32(2.1), sigma=np.float32(0.6))
        for h, t in zip(_potential_parts(host_model, point, "perform"),
                        _potential_parts(torch_model, point, "torch")):
            np.testing.assert_allclose(h, t, rtol=1e-5)
        with pytest.raises(NotImplementedError, match="torch_fn"):
            _potential_parts(host_model, point, "torch")
        logp = torch_model.logp_fn()(_unconstrained(
            torch_model, intercept=1.4, offsets=np.zeros(4), slope=2.1, log_sigma=np.log(0.6)))
        assert np.isfinite(float(logp))


class TestDriver:
    def test_main_end_to_end(self, shims):
        """The full driver: generate data, build the federated model,
        find_MAP, NUTS — the posterior recovers the generating truth
        (slope 2.0, intercept 1.5)."""
        idata = shims.demo.main(
            ["--n-shards", "4", "--n-obs", "48", "--draws", "200", "--tune", "200",
             "--chains", "2", "--device", "cpu"]
        )
        post = idata.posterior
        slope = float(post["slope"].median())
        intercept = float(post["intercept"].median())
        sigma = float(post["sigma"].median())
        assert abs(slope - 2.0) < 0.15, slope
        assert abs(intercept - 1.5) < 0.4, intercept
        assert 0.3 < sigma < 0.8, sigma

    def test_find_map_recovers_truth(self, shims):
        demo = shims.demo
        data, _ = demo.generate_node_data(6, n_obs=64, seed=3, device="cpu")
        model = demo.build_model(data)
        with model:
            map_est = shims.pymc.find_MAP(progressbar=False)
        assert abs(map_est["slope"] - 2.0) < 0.1, map_est
        assert abs(map_est["intercept"] - 1.5) < 0.4, map_est
        assert 0.3 < map_est["sigma"] < 0.8, map_est

    def test_main_defaults_to_the_card(self, shims, monkeypatch):
        """Without ``--device`` the demo asks for CUDA and raises where
        there is none, instead of carrying on on the CPU."""
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            shims.demo.main(["--n-shards", "2", "--n-obs", "8", "--draws", "1", "--tune", "1"])


def _jax_potential_parts(points):
    """The JAX package's demo under the JAX package's fakes: its data and
    its potential's [logp, dA, dslope, dsigma] through the JAX linker's
    stand-in at constrained ``points`` (float32, as its jax_fn runs)."""
    import jax.numpy as jnp
    from pymc_shim import demo_pymc_under_shims
    import pytensor_shim as pts

    with demo_pymc_under_shims() as ns:
        data, _ = ns.demo.generate_node_data(4, n_obs=32, seed=7)
        model = ns.demo.build_model(data)
        outputs = model.potentials[0].owner.outputs
        fn = pts.compile_graph_to_jax(outputs, [rv.var for rv in model.free_rvs],
                                      sys.modules["pytensor.link.jax.dispatch"].jax_funcify)
        (x, y), mask = data.tree()
        host = [np.asarray(a) for a in (x, y, mask)]
        parts = [[np.asarray(v, np.float64) for v in fn(
            *[jnp.asarray(p[rv.name]) for rv in model.free_rvs])] for p in points]
    return host, parts


def test_the_ports_potential_equals_the_jax_packages():
    """The same data (the JAX package's, carried across with
    ``convert.sharded_data_from_jax``) through each package's demo under
    its own fakes, one after the other: the potential and its three
    gradients agree within 1e-5 relative at 3 points."""
    rng = np.random.default_rng(11)
    points = [dict(intercept=np.float32(rng.normal(1.5, 0.3)),
                   offsets=rng.normal(0.0, 0.2, size=4).astype(np.float32),
                   slope=np.float32(rng.normal(2.0, 0.3)),
                   sigma=np.float32(np.exp(rng.normal(-0.5, 0.2))))
              for _ in range(3)]
    (x, y, mask), jax_parts = _jax_potential_parts(points)
    with demo_pymc_under_torch_shims("cpu") as ns:
        data = sharded_data_from_jax((x, y), mask, device="cpu")
        model = ns.demo.build_model(data)
        for point, jparts in zip(points, jax_parts):
            parts = _potential_parts(model, point, "torch")
            for got, want in zip(parts, jparts):
                np.testing.assert_allclose(got, want, rtol=1e-5)


class TestTorchLane:
    @pytest.fixture(scope="class")
    def term(self, shims):
        data, _ = shims.demo.generate_node_data(5, n_obs=40, seed=4, device="cpu")
        (x, y), mask = data.tree()
        torch_fn, host_fn = shims.demo.make_federated_data_logp(data)
        return torch_fn, host_fn, (x, y, mask)

    def test_value_and_grads_match_float64_plain_autograd(self, term):
        torch_fn, _, (x, y, mask) = term
        A = torch.tensor([1.2, 1.4, 1.6, 1.5, 1.3])
        slope, sigma = torch.tensor(1.9), torch.tensor(0.55)
        logp, grads = torch_fn(A, slope, sigma)
        ref_in = [t.double().requires_grad_(True) for t in (A, slope, sigma)]
        a64, s64, sig64 = ref_in
        z = (y.double() - (a64[:, None] + s64 * x.double())) / sig64
        ref = torch.sum(mask.double() * (-0.5 * z * z - torch.log(sig64) - 0.5 * LOG_2PI))
        ref_grads = torch.autograd.grad(ref, ref_in)
        np.testing.assert_allclose(float(logp.detach()), float(ref.detach()), rtol=1e-6)
        for g, r in zip(grads, ref_grads):
            assert not g.requires_grad
            np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=1e-5, atol=1e-4)

    def test_logp_keeps_the_kernels_graph(self, term):
        """A sampler's backward through ``logp`` gives the returned
        gradients; second order through the kernel's Function raises."""
        torch_fn, _, _ = term
        ins = [torch.tensor([1.2, 1.4, 1.6, 1.5, 1.3], requires_grad=True),
               torch.tensor(1.9, requires_grad=True), torch.tensor(0.55, requires_grad=True)]
        logp, grads = torch_fn(*ins)
        back = torch.autograd.grad(logp, ins, retain_graph=True)
        for b, g in zip(back, grads):
            torch.testing.assert_close(b, g, rtol=1e-6, atol=1e-6)
        with pytest.raises(RuntimeError, match="second-order"):
            torch.autograd.grad(logp, ins, create_graph=True)

    def test_one_reduction_pass_through_the_kernel_wrapper(self, term, monkeypatch):
        """Value and gradients come from ONE call of the kernel's
        reductions (on the CPU its plain version ``linreg_reductions_ref``)
        with intercept 0, offsets A and log sigma."""
        from pytensor_federated_torch.ops import linreg_kernel

        torch_fn, _, (x, y, mask) = term
        calls = []

        def spy(scalars, offsets, *rest):
            calls.append((torch.stack(list(scalars)), offsets))
            return linreg_reductions_ref(scalars, offsets, *rest)

        monkeypatch.setattr(linreg_kernel, "linreg_reductions_ref", spy)
        A, slope, sigma = torch.full((5,), 1.5), torch.tensor(2.0), torch.tensor(0.5)
        torch_fn(A, slope, sigma)
        assert len(calls) == 1
        scal, offs = calls[0]
        torch.testing.assert_close(scal, torch.stack([torch.tensor(0.0), slope, torch.log(sigma)]))
        torch.testing.assert_close(offs, A)

    def test_host_fn_crosses_as_float32_and_casts_back(self, term):
        torch_fn, host_fn, _ = term
        A = np.array([1.2, 1.4, 1.6, 1.5, 1.3])  # float64, as PyMC passes
        logp, grads = host_fn(A, 1.9, 0.55)
        assert logp.dtype == np.float32 and all(g.dtype == np.float32 for g in grads)
        t_logp, t_grads = torch_fn(torch.as_tensor(A, dtype=torch.float32),
                                   torch.tensor(1.9), torch.tensor(0.55))
        assert float(logp) == float(t_logp.detach())
        for g, t in zip(grads, t_grads):
            np.testing.assert_array_equal(g, t.numpy())
        # float64 inputs in the torch lane come back float64
        lp64, g64 = torch_fn(torch.as_tensor(A), torch.tensor(1.9, dtype=torch.float64),
                             torch.tensor(0.55, dtype=torch.float64))
        assert lp64.dtype == torch.float64 and all(g.dtype == torch.float64 for g in g64)

    def test_chains_under_vmap_equal_the_per_chain_calls(self, term):
        """Two chains under ``torch.func.vmap`` (as the lockstep sampler
        batches them) give each chain's own call, value and gradients."""
        torch_fn, _, _ = term
        A = torch.tensor([[1.2, 1.4, 1.6, 1.5, 1.3], [1.0, 1.1, 1.2, 1.3, 1.4]])
        slope, sigma = torch.tensor([1.9, 2.1]), torch.tensor([0.55, 0.45])
        lp, grads = torch.func.vmap(torch_fn)(A, slope, sigma)
        for c in range(2):
            lp_c, grads_c = torch_fn(A[c], slope[c], sigma[c])
            torch.testing.assert_close(lp[c], lp_c.detach())
            for g, gc in zip(grads, grads_c):
                torch.testing.assert_close(g[c], gc)

"""The port's SVI lanes against the JAX package's (``tests/test_ppl_svi.py``
of the JAX package, mirrored: one port test for each of its tests, under
the same class and test names), on the same numpy inputs.

- The shared ELBO core: entropy, draws and the Adam loop against the JAX
  package's ``ppl/elbo.py``.
- Batch SVI: ``svi_fit`` with the JAX package's Monte Carlo draws
  injected, against JAX ``scan_vi`` + ``meanfield_neg_elbo`` over JAX
  ``log_density`` of the same radon model, at float32 rounding
  (ELBO trace rtol 1e-5; parameters rtol 1e-4, atol 1e-5).
- ``_classify_skip`` on the same exceptions and in-band strings as the
  JAX function, each package's own exception classes included.
- ``StreamingSVI``'s accounting locally, through the port's gateway with
  deadline sheds, with an overload shed, and in sharded mode over
  owner nodes (width 2, TCP threads): per-shard Adam counts equal the
  accepted steps, replies hold at most ``ceil(total / width)`` elements,
  the trajectory equals the driver-centric lane's bit for bit, and the
  driver-side reply bytes per step fall by the width's factor.
"""

import math
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytensor_federated_tpu import ppl as jppl
from pytensor_federated_tpu.ppl import elbo as jelbo
from pytensor_federated_tpu.ppl.radon import make_radon_example as jmake_radon
from pytensor_federated_tpu.ppl.svi import _classify_skip as jclassify
from pytensor_federated_torch import fed, ppl
from pytensor_federated_torch.ppl import PPLError
from pytensor_federated_torch.ppl.elbo import gaussian_entropy, meanfield_draws, scan_vi
from pytensor_federated_torch.ppl.svi import _classify_skip

optax = pytest.importorskip("optax")

TIMEOUT_S = 60.0


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


@pytest.fixture(scope="module")
def radon_small():
    model, args, true = ppl.make_radon_example(8, mean_obs=8, seed=3, device="cpu")
    return ppl.compile(model, args), true


def _serve_thread(compute):
    from pytensor_federated_torch.service import serve_tcp_once

    box, ready = {}, threading.Event()
    threading.Thread(
        target=serve_tcp_once, args=(compute,), daemon=True,
        kwargs=dict(ready_callback=lambda p: (box.update(p=p), ready.set()), concurrent=True),
    ).start()
    assert ready.wait(TIMEOUT_S)
    return box["p"]


# ---------------------------------------------------------------------------
# the shared core
# ---------------------------------------------------------------------------


class TestElboCore:
    def test_gaussian_entropy_value(self):
        dim = 3
        want = dim / 2 * (1 + math.log(2 * math.pi))
        assert float(gaussian_entropy(dim)) == pytest.approx(want)
        assert float(gaussian_entropy(dim, 1.5)) == pytest.approx(want + 1.5)
        assert float(gaussian_entropy(dim, 1.5)) == pytest.approx(
            float(jelbo.gaussian_entropy(dim, 1.5)), rel=1e-7)

    def test_meanfield_draws_shape_and_reparam(self):
        mu = torch.tensor([1.0, -1.0])
        log_sd = torch.tensor([0.0, math.log(2.0)])
        x = meanfield_draws(mu, log_sd, _gen(0), 5000)
        assert x.shape == (5000, 2)
        np.testing.assert_allclose(x.mean(0).numpy(), [1.0, -1.0], atol=0.1)
        np.testing.assert_allclose(x.std(0).numpy(), [1.0, 2.0], atol=0.1)
        # with the JAX package's standard normals injected: its draws
        key = jax.random.PRNGKey(0)
        eps = np.array(jax.random.normal(key, (7, 2), jnp.float32))
        jx = jelbo.meanfield_draws(jnp.asarray(mu.numpy()), jnp.asarray(log_sd.numpy()), key, 7)
        np.testing.assert_allclose(meanfield_draws(mu, log_sd, torch.as_tensor(eps), 7).numpy(),
                                   np.asarray(jx), rtol=1e-6)

    def test_scan_vi_matches_hand_rolled_loop(self):
        """scan_vi is the loop the VI samplers run — the JAX package's
        ``scan_vi`` with optax's Adam, step for step."""

        def neg_elbo(var, _noise):
            return torch.sum((var - 3.0) ** 2)

        got_var, got_trace = scan_vi(neg_elbo, torch.zeros(2), generator=_gen(0), num_steps=25,
                                     learning_rate=0.1)
        jvar, jtrace = jelbo.scan_vi(lambda v, k: jnp.sum((v - 3.0) ** 2) + 0.0 * k[0],
                                     jnp.zeros((2,)), key=jax.random.PRNGKey(0), num_steps=25,
                                     optimizer=optax.adam(0.1))
        np.testing.assert_allclose(got_var.numpy(), np.asarray(jvar), rtol=1e-5)
        np.testing.assert_allclose(got_trace.numpy(), np.asarray(jtrace), rtol=1e-5)
        # and a hand-rolled loop of the same update
        var, trace = torch.zeros(2), []
        mu, nu = [torch.zeros(2)], [torch.zeros(2)]
        from pytensor_federated_torch.ppl.elbo import adam_step

        for count in range(1, 26):
            v = var.clone().requires_grad_(True)
            loss = neg_elbo(v, None)
            (g,) = torch.autograd.grad(loss, v)
            (var,), mu, nu = adam_step([var], [g], mu, nu, count, 0.1)
            trace.append(-loss.detach())
        assert torch.equal(got_var, var) and torch.equal(got_trace, torch.stack(trace))

    def test_advi_reuses_core(self):
        """samplers/advi.py and samplers/flows.py optimize through the
        shared core (no second hand-rolled loop), as the JAX package's
        do."""
        import inspect

        from pytensor_federated_torch.samplers import advi, flows

        for mod in (advi, flows):
            src = inspect.getsource(mod)
            assert "scan_vi" in src and "gaussian_entropy" in src
            assert "adam_step(" not in src and "adam_updates(" not in src


# ---------------------------------------------------------------------------
# batch SVI
# ---------------------------------------------------------------------------


class TestBatchSVI:
    def test_svi_fit_improves_and_recovers(self, radon_small):
        compiled, true = radon_small
        res, unravel = ppl.svi_fit(compiled, generator=_gen(0), num_steps=400, n_mc=4,
                                   learning_rate=5e-2)
        assert float(res.elbo_trace[-1]) > float(res.elbo_trace[0])
        assert abs(float(res.mean["mu_alpha"]) - true["mu_alpha"]) < 0.8
        draws = res.sample(_gen(1), 16, unravel)
        assert draws["alpha_raw"].shape == (16, 8)

    def test_minibatch_svi_runs_and_improves(self, radon_small):
        compiled, _ = radon_small
        res, _ = ppl.svi_fit(compiled, generator=_gen(0), num_steps=300, n_mc=2, minibatch=True,
                             batch_size=4, learning_rate=5e-2)
        # minibatch ELBO estimates are noisy; compare smoothed ends
        first = float(res.elbo_trace[:50].mean())
        last = float(res.elbo_trace[-50:].mean())
        assert last > first


def test_svi_fit_with_jax_draws_matches_the_jax_elbo_loop(radon_small):
    """``svi_fit`` with the JAX package's draws injected follows JAX
    ``scan_vi`` + ``meanfield_neg_elbo`` over JAX ``log_density`` of the
    same radon model (the JAX ``svi_fit``'s loop, written out over the
    direct density) at float32 rounding."""
    compiled, _ = radon_small
    steps, n_mc, lr = 30, 4, 5e-2
    jmodel, jargs, _ = jmake_radon(8, mean_obs=8, seed=3)
    init = {k: jnp.zeros(tuple(t.shape), jnp.float32) for k, t in compiled.init_params().items()}
    flat0, unravel = jax.flatten_util.ravel_pytree(init)
    dim = int(flat0.shape[0])
    batch = jax.vmap(lambda xi: jppl.log_density(jmodel, jargs, unravel(xi)))
    neg = jelbo.meanfield_neg_elbo(lambda x, k: jnp.mean(batch(x)), dim, n_mc=n_mc,
                                   split_keys=False)
    key = jax.random.PRNGKey(2)
    (jmu, jls), jtrace = jelbo.scan_vi(neg, (flat0, jnp.full((dim,), -2.0)), key=key,
                                       num_steps=steps, optimizer=optax.adam(lr))
    eps = [torch.as_tensor(np.array(jax.random.normal(k, (n_mc, dim), jnp.float32)))
           for k in jax.random.split(key, steps)]
    res, _ = ppl.svi_fit(compiled, generator=_gen(0), num_steps=steps, n_mc=n_mc,
                         learning_rate=lr, noise=eps)
    np.testing.assert_allclose(res.elbo_trace.numpy(), np.asarray(jtrace), rtol=1e-5)
    np.testing.assert_allclose(res.flat_mean.numpy(), np.asarray(jmu), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(res.flat_log_sd.numpy(), np.asarray(jls), rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# streaming SVI
# ---------------------------------------------------------------------------


def _both(exc_of):
    """Each package's ``_classify_skip`` on the exception ``exc_of``
    builds from that package's modules."""
    import pytensor_federated_tpu as jpkg
    import pytensor_federated_torch as tpkg

    return _classify_skip(exc_of(tpkg)), jclassify(exc_of(jpkg))


class TestClassifySkip:
    def test_deadline(self):
        from pytensor_federated_torch.service.deadline import DeadlineExceeded

        assert _classify_skip(DeadlineExceeded("x")) == "shed_deadline"
        # relayed in-band: the TYPE is lost, the string survives
        assert _classify_skip(RuntimeError("... deadline exceeded: budget spent ...")) \
            == "shed_deadline"
        assert _both(lambda pkg: pkg.service.deadline.DeadlineExceeded("x")) \
            == ("shed_deadline",) * 2
        assert _both(lambda pkg: RuntimeError(pkg.service.deadline.deadline_error("spent"))) \
            == ("shed_deadline",) * 2

    def test_overload(self):
        from pytensor_federated_torch.gateway.fairness import overload_error

        exc = RuntimeError(overload_error("svi", "quota"))
        assert _classify_skip(exc) == "shed_overload"
        assert _both(lambda pkg: RuntimeError(
            __import__(pkg.__name__ + ".gateway.fairness", fromlist=["x"]).overload_error(
                "svi", "quota"))) == ("shed_overload",) * 2

    def test_transient_vs_programming_error(self):
        assert _classify_skip(ConnectionError("boom")) == "failed"
        assert _classify_skip(RuntimeError("node died")) == "failed"
        assert _classify_skip(PPLError("bad model")) is None
        assert _classify_skip(TypeError("bug")) is None
        # the type erased, the text still names the deterministic model
        # bug -> must propagate
        assert _classify_skip(RuntimeError("...PPLError: duplicate site name 'w'...")) is None
        for exc in (ConnectionError("boom"), RuntimeError("node died"), TypeError("bug"),
                    OSError("reset"), ValueError("shape"), KeyError("k"),
                    RuntimeError("...PPLError: duplicate site name 'w'...")):
            assert _classify_skip(exc) == jclassify(exc), exc
        assert _both(lambda pkg: pkg.ppl.PPLError("bad model")) == (None, None)
        from pytensor_federated_torch.service.tcp import RemoteComputeError

        assert _classify_skip(RemoteComputeError("node: PPLError: plate")) is None
        assert _classify_skip(RemoteComputeError("node: ZeroDivisionError")) == "failed"


class TestStreamingSVI:
    def test_local_accounting(self, radon_small):
        compiled, _ = radon_small
        svi = ppl.StreamingSVI(compiled, generator=_gen(0), n_mc=2, learning_rate=5e-2)
        rng = np.random.default_rng(0)
        tally = svi.consume(rng.choice(8, size=4, replace=False) for _ in range(15))
        assert tally == {"accepted": 15}
        assert svi.offered == svi.accepted == 15
        assert svi.opt_steps == 15  # the optimizer's own counter
        assert len(svi.elbo_trace) == 15
        res, _ = svi.result()
        assert res.flat_mean.shape == svi.mu.shape
        # an int seed is a CPU generator seeded with it: the same run
        again = ppl.StreamingSVI(compiled, generator=0, n_mc=2, learning_rate=5e-2)
        rng = np.random.default_rng(0)
        again.consume(rng.choice(8, size=4, replace=False) for _ in range(15))
        assert torch.equal(again.mu, svi.mu) and torch.equal(again.log_sd, svi.log_sd)

    def test_streaming_through_gateway_with_sheds(self, radon_small):
        """The full streaming loop: windows ride the gateway; a
        deadline-starved batch is SHED and provably skipped (the
        optimizer's step counter never moves), then service resumes."""
        from pytensor_federated_torch.gateway import GatewayThread, TenantFairness
        from pytensor_federated_torch.routing import NodePool
        from pytensor_federated_torch.service import TcpArraysClient

        compiled, _ = radon_small
        ports = [_serve_thread(compiled.node_compute()) for _ in range(2)]
        pool = NodePool([("127.0.0.1", p) for p in ports], transport="tcp")
        pool.start()
        gw = GatewayThread(pool, fairness=TenantFairness(), frame_items=16)
        gw.start()
        cli = TcpArraysClient("127.0.0.1", gw.port, tenant="svi")
        try:
            pc = ppl.compile(compiled.model, compiled.model_args,
                             placement=fed.PoolPlacement(cli, window=8, tag="svi"))
            svi = ppl.StreamingSVI(pc, generator=_gen(0), n_mc=2, learning_rate=5e-2,
                                   deadline_s=60.0)
            local = ppl.StreamingSVI(compiled, generator=_gen(0), n_mc=2, learning_rate=5e-2)
            rng = np.random.default_rng(1)

            def batch():
                return rng.choice(8, size=4, replace=False)

            for _ in range(6):
                b = batch()
                assert svi.step(b) == "accepted"
                local.step(b)
            # the pool lane follows the local lane at float32 rounding
            np.testing.assert_allclose(svi.mu.numpy(), local.mu.numpy(), rtol=1e-4, atol=1e-5)
            # starve one batch
            svi.deadline_s = 1e-4
            assert svi.step(batch()) == "shed_deadline"
            assert svi.opt_steps == svi.accepted == 6
            # recovery: the shed batch did not poison the lane
            svi.deadline_s = 60.0
            assert svi.step(batch()) == "accepted"
            assert svi.opt_steps == svi.accepted == 7
            assert svi.offered == 8
            assert svi.skipped == {"shed_deadline": 1}
        finally:
            cli.close()
            gw.stop()
            pool.close()

    def test_unclassified_errors_propagate(self, radon_small):
        compiled, _ = radon_small
        svi = ppl.StreamingSVI(compiled, generator=_gen(0))
        with pytest.raises(PPLError):
            svi.step(np.zeros((2, 2)))  # 2-D batch: a caller bug
        assert svi.accepted == 0 and svi.opt_steps == 0


def test_overload_shed_moves_no_optimizer_step(radon_small):
    """A window denied by the gateway's quota (its in-band overload text)
    sheds the batch as ``shed_overload`` with the optimizer untouched;
    the next batch is accepted; the outcome counter and the flight
    record name the shed."""
    from pytensor_federated_torch.gateway.fairness import overload_error
    from pytensor_federated_torch.service import TcpArraysClient
    from pytensor_federated_torch.telemetry import flightrec, spans

    compiled, _ = radon_small
    port = _serve_thread(compiled.node_compute())

    class Flaky:
        def __init__(self, inner):
            self.inner, self.deny = inner, False

        def evaluate_many(self, requests, window=8):
            if self.deny:
                self.deny = False
                raise RuntimeError(overload_error("svi", "quota exhausted"))
            return self.inner.evaluate_many(requests, window=window)

    cli = TcpArraysClient("127.0.0.1", port)
    was = spans.set_enabled(True), flightrec.set_enabled(True)
    try:
        flaky = Flaky(cli)
        pc = ppl.compile(compiled.model, compiled.model_args,
                         placement=fed.PoolPlacement(flaky, window=8, tag="svi"))
        svi = ppl.StreamingSVI(pc, generator=_gen(0), n_mc=2)
        assert svi.step([0, 1, 2, 3]) == "accepted"
        before = svi.mu.clone()
        counter = ppl.svi.SVI_BATCHES.labels(outcome="shed_overload")
        sheds = counter.value
        flightrec.clear()
        flaky.deny = True
        assert svi.step([4, 5, 6, 7]) == "shed_overload"
        assert torch.equal(svi.mu, before) and svi.opt_steps == svi.accepted == 1
        assert counter.value == sheds + 1
        assert [e["outcome"] for e in flightrec.events() if e["kind"] == "svi.shed"] == [
            "shed_overload"]
        assert svi.step([4, 5, 6, 7]) == "accepted" and svi.opt_steps == 2
        assert svi.offered == svi.accepted + sum(svi.skipped.values()) == 3
    finally:
        spans.set_enabled(was[0])
        flightrec.set_enabled(was[1])
        cli.close()


def test_sharded_mode_matches_driver_centric(radon_small, tmp_path):
    """ZeRO-sharded streaming SVI at width 2 over owner nodes on TCP
    threads: the trajectory equals the driver-centric lane's bit for bit
    (the same estimator, noise and Adam on one device); per shard the
    Adam count (the version) equals the accepted steps; no reply holds
    more than ``ceil(total / 2)`` elements; the driver-side reply bytes
    of a step (the npwire ``decode_copy`` counter) are at least 2x below
    the driver-centric pool lane's; the split mode runs and keeps the
    per-shard invariant."""
    from pytensor_federated_torch.optim import ShardedOptimizer, ShardStore
    from pytensor_federated_torch.ppl.svi import make_sharded_update_compute
    from pytensor_federated_torch.service import TcpArraysClient
    from pytensor_federated_torch.service.npwire import WIRE_BYTES_COPIED
    from pytensor_federated_torch.telemetry import spans

    compiled, _ = radon_small
    dim = sum(t.numel() for t in compiled.init_params().values())
    total, width = 2 * dim, 2
    compute = make_sharded_update_compute(compiled, ShardStore(str(tmp_path / "a")),
                                          learning_rate=5e-2, n_mc=2)
    clients = [TcpArraysClient("127.0.0.1", _serve_thread(compute)) for _ in range(width)]
    plain_port = _serve_thread(compiled.node_compute())
    plain_cli = TcpArraysClient("127.0.0.1", plain_port)
    decode = WIRE_BYTES_COPIED.labels(lane="npwire", stage="decode_copy")

    def one_step_bytes(svi, b):
        was = spans.set_enabled(True)
        try:
            b0 = decode.value
            assert svi.step(b) == "accepted"
            return decode.value - b0
        finally:
            spans.set_enabled(was)

    opt = ShardedOptimizer(total, clients=clients)
    try:
        ref = ppl.StreamingSVI(compiled, generator=_gen(5), n_mc=2, learning_rate=5e-2)
        svi = ppl.StreamingSVI(compiled, generator=_gen(5), n_mc=2, learning_rate=5e-2,
                               sharded=opt)
        assert svi._opt is None
        rng = np.random.default_rng(16)
        for _ in range(6):
            b = rng.choice(8, size=4, replace=False)
            assert ref.step(b) == "accepted"
            assert svi.step(b) == "accepted"
            assert torch.equal(ref.mu, svi.mu) and torch.equal(ref.log_sd, svi.log_sd)
        assert svi.shard_opt_steps == svi.shard_accepted == [6, 6]
        assert svi.opt_steps == svi.accepted == 6
        assert opt.max_reply_elems <= -(-total // width)
        for k, part in enumerate(opt.parts):
            state = ShardStore(str(tmp_path / "a")).load(part)
            assert state.version == int(state.opt_leaves[0]) == 6
        sharded_bytes = one_step_bytes(svi, rng.choice(8, size=4, replace=False))
        control = ppl.StreamingSVI(
            ppl.compile(compiled.model, compiled.model_args,
                        placement=fed.PoolPlacement(plain_cli, window=8, tag="svi")),
            generator=_gen(5), n_mc=2, learning_rate=5e-2)
        control.step(rng.choice(8, size=4, replace=False))
        control_bytes = one_step_bytes(control, rng.choice(8, size=4, replace=False))
        assert control_bytes >= width * sharded_bytes > 0
    finally:
        for c in clients:
            c.close()
        plain_cli.close()
        if opt._executor is not None:
            opt._executor.shutdown()
    split_store = ShardStore(str(tmp_path / "b"))
    compute = make_sharded_update_compute(compiled, split_store, learning_rate=5e-2, n_mc=2)
    clients = [TcpArraysClient("127.0.0.1", _serve_thread(compute)) for _ in range(width)]
    opt = ShardedOptimizer(total, clients=clients)
    try:
        svi = ppl.StreamingSVI(compiled, generator=_gen(6), n_mc=2, sharded=opt,
                               minibatch_mode="split")
        rng = np.random.default_rng(3)
        tally = svi.consume(rng.choice(8, size=4, replace=False) for _ in range(4))
        assert tally == {"accepted": 4} and svi.shard_opt_steps == svi.shard_accepted == [4, 4]
    finally:
        for c in clients:
            c.close()
        if opt._executor is not None:
            opt._executor.shutdown()

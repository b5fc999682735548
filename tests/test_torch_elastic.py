"""The port's elastic sampling (``samplers/elastic.py``): the four cases
of the JAX package's ``tests/test_elastic.py``, and the flight record of
a failed run against the JAX package's.

- A failure after chunk 0 is recovered in-process and the draws equal
  an uninterrupted run's bit for bit (the same evaluation path: the
  bomb logp never armed is the oracle).
- The heartbeat verdict and the recovery policy reach ``build_logp``;
  the replica-pool tier runs first; the three ``sampler.*`` flight
  events are recorded in order.
- The process-restart tier: a child process dies (``os._exit``) after
  chunk 0; a fresh child resumes from the checkpoint, bit-identical to
  a clean child.  The children's code is this file's ``__main__``.
- An exhausted failure budget re-raises, with the JAX package's flight
  record (the same event kinds and attempts).
"""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIM = 3
SAMPLE_KW = dict(num_warmup=100, num_samples=90, num_chains=2, checkpoint_every=30, jitter=0.5)


def _bomb_logp(torch, fail_state, chunk0_path):
    """-0.5 |x - 2|^2, raising ONCE as soon as chunk 0's file exists:
    after at least one completed checkpoint chunk, wherever the
    evaluation count lands."""

    def logp(params):
        if fail_state["armed"] and os.path.exists(chunk0_path):
            fail_state["armed"] = False
            fail_state["fired"] = True
            raise RuntimeError("injected node death")
        return -0.5 * torch.sum((params["x"] - 2.0) ** 2)

    return logp


def _child_main(ckpt, out_npz, mode):
    """The restart tier's process: the flagship-like regression over an
    8-slot CPU mesh, ``os._exit(42)`` once chunk 0 exists in ``crash``
    mode; ``run`` samples to the end and saves the draws."""
    sys.path.insert(0, REPO)
    import numpy as np
    import torch

    from pytensor_federated_torch import pack_shards
    from pytensor_federated_torch.parallel import FederatedLogp, make_mesh
    from pytensor_federated_torch.samplers import elastic_sample

    rng = np.random.default_rng(0)
    shards = []
    for _ in range(8):
        x = rng.normal(size=(32,)).astype(np.float32)
        shards.append((x, (1.5 * x + 0.1).astype(np.float32)))
    data = pack_shards(shards, device="cpu")

    def build_logp(mesh):
        fed = FederatedLogp(
            lambda p, shard: -0.5 * torch.sum((shard[0][1] - p["w"] * shard[0][0]) ** 2
                                              * shard[1]),
            data.tree(), mesh=mesh)

        def logp(params):
            if mode == "crash" and os.path.exists(ckpt + ".chunk0000.npz"):
                os._exit(42)  # the process dies; nothing graceful runs
            return fed.logp(params)

        return logp

    res = elastic_sample(build_logp, {"w": torch.tensor(0.0)},
                         generator=torch.Generator().manual_seed(3), checkpoint_path=ckpt,
                         mesh=make_mesh({"shards": 8}, devices=["cpu"] * 8), num_warmup=100,
                         num_samples=90, num_chains=2, checkpoint_every=30)
    np.savez(out_npz, w=res.samples["w"].numpy())
    sys.stdout.flush()
    os._exit(0)


if __name__ == "__main__":
    _child_main(*sys.argv[1:4])


import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from pytensor_federated_tpu.samplers import elastic_sample as jelastic_sample  # noqa: E402
from pytensor_federated_tpu.telemetry import flightrec as jflightrec  # noqa: E402
from pytensor_federated_tpu.telemetry import spans as jspans  # noqa: E402
from pytensor_federated_torch.checkpoint import sample_checkpointed  # noqa: E402
from pytensor_federated_torch.parallel import make_mesh  # noqa: E402
from pytensor_federated_torch.samplers import elastic_sample  # noqa: E402
from pytensor_federated_torch.telemetry import flightrec, spans  # noqa: E402


@pytest.fixture
def recording():
    """Both packages' flight recorders on (they record with spans on)."""
    prev = [m.set_enabled(True) for m in (spans, flightrec, jspans, jflightrec)]
    flightrec.clear()
    jflightrec.clear()
    yield
    for m, p in zip((spans, flightrec, jspans, jflightrec), prev):
        m.set_enabled(p)
    flightrec.clear()
    jflightrec.clear()


def _sampler_events(rec):
    return [e for e in rec.events() if e["kind"].startswith("sampler.")]


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def test_failure_recovery_bit_identical(tmp_path):
    init = {"x": torch.zeros(DIM)}
    clean = sample_checkpointed(_bomb_logp(torch, {"armed": False}, "/nonexistent"), init,
                                generator=_gen(7), checkpoint_path=str(tmp_path / "clean.ckpt"),
                                **SAMPLE_KW)
    path = str(tmp_path / "elastic.ckpt")
    fail_state = {"armed": True, "fired": False}
    meshes_seen = []

    def build_logp(mesh):
        meshes_seen.append(mesh)
        return _bomb_logp(torch, fail_state, path + ".chunk0000.npz")

    res = elastic_sample(build_logp, init, generator=_gen(7), checkpoint_path=path, **SAMPLE_KW)
    assert fail_state["fired"], "the injected failure never fired"
    assert meshes_seen == [None, None]  # the first build and one recovery
    assert torch.equal(res.samples["x"], clean.samples["x"])


class _Pool:
    """A replica pool's recovery surface: ``recover()`` and ``replicas``."""

    def __init__(self, calls):
        self.calls, self.replicas = calls, ["a", "b", "c"]

    def recover(self):
        self.calls.append("pool")
        return 2


def test_policy_detection_and_pool_feed_recovery(tmp_path, recording):
    """The heartbeat verdict (port 1: nothing listens) reaches the
    policy after the pool tier ran; the policy's mesh reaches
    ``build_logp``; the three flight events are recorded in order."""
    mesh8 = make_mesh({"shards": 8}, devices=["cpu"] * 8)
    mesh4 = make_mesh({"shards": 4}, devices=["cpu"] * 4)
    path = str(tmp_path / "mesh.ckpt")
    fail_state = {"armed": True, "fired": False}
    meshes_seen, calls = [], []

    def build_logp(mesh):
        meshes_seen.append(mesh)
        return _bomb_logp(torch, fail_state, path + ".chunk0000.npz")

    def on_failure(mesh, dead):
        calls.append(("policy", mesh, tuple(dead)))
        return mesh4

    res = elastic_sample(build_logp, {"x": torch.zeros(DIM)}, generator=_gen(1),
                         checkpoint_path=path, mesh=mesh8, peers={7: ("127.0.0.1", 1)},
                         node_pool=_Pool(calls), on_failure=on_failure, **SAMPLE_KW)
    assert fail_state["fired"]
    assert calls == ["pool", ("policy", mesh8, (7,))]
    assert meshes_seen == [mesh8, mesh4]
    assert res.samples["x"].shape == (2, 90, DIM)
    events = _sampler_events(flightrec)
    assert [e["kind"] for e in events] == [
        "sampler.segment_failed", "sampler.pool_recovered", "sampler.recovered"]
    assert events[1]["healthy_replicas"] == 2 and events[1]["total_replicas"] == 3
    assert events[2]["dead_process_ids"] == [7]


def test_process_restart_resumes_bit_identical(tmp_path):
    """Child 1 dies after chunk 0 persisted; child 2 resumes from the
    checkpoint; its draws equal a clean third child's bit for bit."""
    env = {k: v for k, v in os.environ.items() if k not in ("RANK", "WORLD_SIZE")}

    def start(ckpt, out, mode):
        return subprocess.Popen([sys.executable, os.path.abspath(__file__), ckpt, out, mode],
                                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True)

    def finish(proc, mode, expect):
        try:
            text, _ = proc.communicate(timeout=120)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        assert proc.returncode == expect, (mode, proc.returncode, text)

    ckpt, out = str(tmp_path / "restart.ckpt"), str(tmp_path / "restart.npz")
    clean_out = str(tmp_path / "clean.npz")
    # The clean child runs beside the crashing one: they share nothing.
    clean = start(str(tmp_path / "clean.ckpt"), clean_out, "run")
    finish(start(ckpt, out, "crash"), "crash", 42)
    assert os.path.exists(ckpt + ".chunk0000.npz") and not os.path.exists(out)
    finish(start(ckpt, out, "run"), "resume", 0)
    finish(clean, "clean", 0)
    w, w_clean = np.load(out)["w"], np.load(clean_out)["w"]
    assert w.shape == (2, 90)
    np.testing.assert_array_equal(w, w_clean)
    assert abs(float(np.mean(w_clean)) - 1.5) < 0.05


def test_failure_budget_exhausted_reraises(tmp_path, recording):
    """``max_failures=2``: the third failure re-raises, after the same
    flight record as the JAX package's on the same failing build."""

    def broken(mesh):
        def logp(params):
            raise RuntimeError("always broken")

        return logp

    with pytest.raises(RuntimeError, match="always broken"):
        elastic_sample(broken, {"x": torch.zeros(DIM)}, generator=_gen(0),
                       checkpoint_path=str(tmp_path / "x.ckpt"), max_failures=2, **SAMPLE_KW)
    with pytest.raises(RuntimeError, match="always broken"):
        jelastic_sample(broken, {"x": jnp.zeros(DIM)}, key=jax.random.PRNGKey(0),
                        checkpoint_path=str(tmp_path / "j.ckpt"), max_failures=2, **SAMPLE_KW)
    drop = ("seq", "ts", "trace_id")
    got = [{k: v for k, v in e.items() if k not in drop} for e in _sampler_events(flightrec)]
    want = [{k: v for k, v in e.items() if k not in drop} for e in _sampler_events(jflightrec)]
    assert [e["kind"] for e in got].count("sampler.segment_failed") == 3
    assert got == want

"""The port's ``MicroBatcher`` against the JAX package's.

The same submit sequence goes through both batchers: the torch one in
front of the port's ``device_compute_fn(..., batched=True)`` on the
CPU, the JAX one in front of the JAX package's.  Both must form the
same windows (the batch function's call sizes), give the same replies
(float32, rtol 1e-5), shed the same expired entries, isolate a
poisoned item to its own reply, and report the same ``stats()``.
"""

import asyncio
import time
import warnings

import numpy as np
import pytest
import torch

from test_torch_tcp import SIGMA_ERROR, _reference, _request, guarded, jax_compute, torch_compute
from pytensor_federated_tpu.service import batching as jbatching
from pytensor_federated_tpu.service import deadline as jdl
from pytensor_federated_tpu.service.server import device_compute_fn as jax_device_compute_fn
from pytensor_federated_torch.service import batching as tbatching
from pytensor_federated_torch.service import deadline as tdl
from pytensor_federated_torch.service.server import device_compute_fn as torch_device_compute_fn

PKG = {"torch": (tbatching, tdl), "jax": (jbatching, jdl)}
STATS_COUNTS = ("max_batch", "max_wait_us", "queue_depth", "dispatched_total", "batches_total",
                "fallbacks_total", "shed_total", "max_queue_seen")


def _compute(pkg):
    if pkg == "torch":
        return guarded(torch_device_compute_fn(torch_compute, device="cpu", batched=True))
    return guarded(jax_device_compute_fn(jax_compute, batched=True))


class _Recorded:
    """The node's batch function, recording each window's size."""

    def __init__(self, fn):
        self.fn, self.sizes = fn, []

    def __call__(self, requests):
        self.sizes.append(len(requests))
        return self.fn.batch(requests)


def _batcher(pkg, **kw):
    fn = _compute(pkg)
    rec = _Recorded(fn)
    return PKG[pkg][0].MicroBatcher(fn, rec, **kw), rec


def _both(scenario, **kw):
    """Run ``scenario(batcher, deadline_module)`` on both packages."""
    out = {}
    for pkg in PKG:
        mb, rec = _batcher(pkg, **kw)
        res = asyncio.run(scenario(mb, PKG[pkg][1]))
        out[pkg] = (mb, rec, res)
    return out


def _assert_same_replies(got, want, reqs):
    assert len(got) == len(want) == len(reqs)
    for g, w, r in zip(got, want, reqs):
        if isinstance(w, Exception):
            assert type(g).__name__ == type(w).__name__ and str(g) == str(w)
            continue
        assert len(g) == len(w) == 3
        for a, b in zip(g, w):
            assert np.asarray(a).dtype == np.asarray(b).dtype == np.float32
            np.testing.assert_allclose(a, b, rtol=1e-5)
        for a, ref in zip(g, _reference(*r)):
            np.testing.assert_allclose(float(a), ref, rtol=2e-5, atol=1e-4)


@pytest.mark.parametrize("max_batch", [4, 8, 32])
@pytest.mark.parametrize("n", [1, 3, 10])
def test_submit_many_forms_the_same_windows(n, max_batch):
    reqs = [_request(i) for i in range(n)]

    async def scenario(mb, _dl):
        return await mb.submit_many(reqs)

    out = _both(scenario, max_batch=max_batch, max_wait_us=0.0, inline=True)
    (tmb, trec, tres), (jmb, jrec, jres) = out["torch"], out["jax"]
    assert trec.sizes == jrec.sizes
    assert all(s <= max_batch for s in trec.sizes)
    _assert_same_replies(tres, jres, reqs)
    assert {k: tmb.stats()[k] for k in STATS_COUNTS} == {k: jmb.stats()[k] for k in STATS_COUNTS}


def test_concurrent_submits_coalesce_the_same_way():
    """Submits issued in one turn of the loop all queue before the
    drain task first runs, and dispatch as one window."""
    reqs = [_request(i) for i in range(9)]

    async def scenario(mb, _dl):
        return await asyncio.gather(*(mb.submit(r) for r in reqs))

    out = _both(scenario, max_batch=32, max_wait_us=0.0, inline=True)
    assert out["torch"][1].sizes == out["jax"][1].sizes == [9]
    assert out["torch"][0].n_batches == out["jax"][0].n_batches == 1
    _assert_same_replies(out["torch"][2], out["jax"][2], reqs)


def test_poisoned_item_fails_only_its_own_reply():
    reqs = [_request(0), _request(1), _request(2, sigma=-1.0), _request(3)]

    async def scenario(mb, _dl):
        return await mb.submit_many(reqs)

    out = _both(scenario, max_batch=32, inline=True)
    for pkg in PKG:
        mb, rec, res = out[pkg]
        assert isinstance(res[2], ValueError) and str(res[2]) == SIGMA_ERROR
        assert mb.n_fallbacks == 1 and rec.sizes == [4]
    _assert_same_replies(out["torch"][2], out["jax"][2], reqs)


def test_expired_entries_are_shed_not_computed():
    """Entries whose deadline is spent when their window dispatches are
    failed with the deadline classification and never reach compute;
    live siblings in the same window still run."""
    live = [_request(i) for i in range(3)]
    dead = [_request(10 + i) for i in range(2)]

    async def scenario(mb, dl):
        tasks = [asyncio.ensure_future(mb.submit(r)) for r in live[:1]]
        with dl.deadline_scope(1e-6):
            tasks += [asyncio.ensure_future(mb.submit(r)) for r in dead]
        tasks += [asyncio.ensure_future(mb.submit(r)) for r in live[1:]]
        time.sleep(0.01)  # the deadlines pass before the loop runs
        return await asyncio.gather(*tasks, return_exceptions=True)

    out = _both(scenario, max_batch=32, max_wait_us=0.0, inline=True)
    for pkg in PKG:
        mb, rec, res = out[pkg]
        assert all(isinstance(r, PKG[pkg][1].DeadlineExceeded) for r in res[1:3])
        assert PKG[pkg][1].is_deadline_error(str(res[1]))
        assert mb.n_shed == 2 and mb.n_dispatched == 3
    assert out["torch"][1].sizes == out["jax"][1].sizes == [3]  # the live ones only
    t, j = out["torch"][2], out["jax"][2]
    assert [str(e) for e in t[1:3]] == [str(e) for e in j[1:3]]
    _assert_same_replies([t[0], *t[3:]], [j[0], *j[3:]], [live[0], *live[1:]])


def test_shed_expired_drops_queued_entries():
    async def scenario(mb, dl):
        loop = asyncio.get_running_loop()
        with dl.deadline_scope(1e-6):
            futs = [mb._enqueue(list(_request(i)), start=False) for i in range(3)]
        keep = mb._enqueue(list(_request(5)), start=False)
        time.sleep(0.01)
        shed = mb.shed_expired()
        mb._start()
        await asyncio.wait_for(keep, 30)
        await loop.run_in_executor(None, time.sleep, 0)
        return shed, [type(f.exception()).__name__ for f in futs], keep.result()

    out = _both(scenario, max_batch=32, inline=True)
    assert out["torch"][2][:2] == out["jax"][2][:2] == (3, ["DeadlineExceeded"] * 3)
    _assert_same_replies([out["torch"][2][2]], [out["jax"][2][2]], [_request(5)])


def test_executor_mode_gives_the_same_replies():
    reqs = [_request(i) for i in range(6)]

    async def scenario(mb, _dl):
        return await mb.submit_many(reqs)

    out = _both(scenario, max_batch=32, inline=False)
    assert out["torch"][1].sizes == out["jax"][1].sizes == [6]
    _assert_same_replies(out["torch"][2], out["jax"][2], reqs)


def test_stats_keys_match():
    async def scenario(mb, _dl):
        await mb.submit_many([_request(i) for i in range(4)])
        return mb.stats()

    out = _both(scenario, max_batch=16, inline=True)
    assert set(out["torch"][2]) == set(out["jax"][2])
    assert {k: out["torch"][2][k] for k in STATS_COUNTS} == {k: out["jax"][2][k] for k in STATS_COUNTS}


def test_max_batch_below_one_is_refused_alike():
    for pkg in PKG:
        with pytest.raises(ValueError, match="max_batch must be >= 1, got 0"):
            PKG[pkg][0].MicroBatcher(lambda *a: a, max_batch=0)


@pytest.mark.parametrize("k", [1, 3, 4])
def test_batched_compute_fn_takes_read_only_views(k):
    """The shm lane hands a compute READ-ONLY views of the shared pages:
    the batched path stacks them into fresh arrays, so torch never sees
    a non-writeable buffer (and warns about none)."""
    fn = torch_device_compute_fn(torch_compute, device="cpu", batched=True)
    reqs = []
    for i in range(k):
        arrays = [np.array(a) for a in _request(i)]
        for a in arrays:
            a.flags.writeable = False
        reqs.append(arrays)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        outs = fn.batch(reqs)
        single = [fn(*r) for r in reqs]
    for got, want in zip(outs, single):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=1e-6)
    assert all(not a.flags.writeable for r in reqs for a in r)  # inputs untouched


@pytest.mark.parametrize("k", [3, 5, 7])
def test_padding_never_reaches_a_reply(k):
    """A ragged window runs at the next power-of-two bucket (the first
    row repeated, as in the JAX package), and only its own k replies
    come back, each equal to its request alone."""
    assert tbatching._bucket(k, 32) == jbatching._bucket(k, 32) > k
    fn = torch_device_compute_fn(torch_compute, device="cpu", batched=True)
    reqs = [_request(i) for i in range(k)]
    outs = fn.batch(reqs)
    assert len(outs) == k
    for got, r in zip(outs, reqs):
        for g, w in zip(got, fn(*r)):
            np.testing.assert_allclose(g, w, rtol=1e-6)

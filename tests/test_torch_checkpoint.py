"""The port's checkpoint snapshots and resumable sampling.

``save_pytree``/``load_pytree`` write the JAX package's files: each
package reads the other's, with the same metadata, and raises the same
structure-mismatch error.  ``sample_checkpointed`` resumes bit for bit
inside the port: a run interrupted after a chunk (an exception raised
in ``on_chunk``) and called again gives the draws of an uninterrupted
run exactly; a changed config restarts.
"""

import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytensor_federated_tpu import checkpoint as jck
from pytensor_federated_torch import checkpoint as tck
from pytensor_federated_torch import load_pytree, sample_checkpointed, save_pytree


def _tree():
    return {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": (torch.zeros(()), torch.ones(4, dtype=torch.int32))}


def test_roundtrip_and_interchange_with_the_jax_package(tmp_path):
    p = str(tmp_path / "t.npz")
    save_pytree(p, _tree(), {"step": 7})
    got, meta = load_pytree(p, _tree())
    assert meta == {"step": 7}
    for a, b in zip(jax.tree_util.tree_leaves({k: v for k, v in _tree().items()}),
                    jax.tree_util.tree_leaves(got)):
        assert torch.equal(a, b) and a.dtype == b.dtype
    # The JAX package reads the port's file, and the port the JAX one's.
    jlike = {"a": jnp.zeros((2, 3)), "b": (jnp.zeros(()), jnp.zeros(4, jnp.int32))}
    jgot, jmeta = jck.load_pytree(p, jlike)
    assert jmeta == meta
    np.testing.assert_array_equal(np.asarray(jgot["a"]), _tree()["a"].numpy())
    q = str(tmp_path / "j.npz")
    jck.save_pytree(q, jlike, {"from": "jax"})
    tgot, tmeta = load_pytree(q, _tree())
    assert tmeta == {"from": "jax"} and tgot["b"][1].dtype == torch.int32
    with open(p, "rb") as f, open(q, "rb") as g:  # the same layout: leaves then metadata
        assert np.load(f).files == np.load(g).files


def test_structure_mismatch_and_atomic_overwrite(tmp_path):
    p = str(tmp_path / "ck.npz")
    save_pytree(p, {"a": torch.zeros(2), "b": torch.zeros(3)})
    with pytest.raises(ValueError, match="structure mismatch") as t_err:
        load_pytree(p, {"a": torch.zeros(2)})
    with pytest.raises(ValueError, match="structure mismatch") as j_err:
        jck.load_pytree(p, {"a": jnp.zeros(2)})
    assert str(t_err.value) == str(j_err.value)
    save_pytree(p, {"a": torch.ones(2)}, {"v": 2})
    got, meta = load_pytree(p, {"a": torch.zeros(2)})
    assert meta["v"] == 2 and torch.equal(got["a"], torch.ones(2))
    assert os.listdir(tmp_path) == ["ck.npz"]


def _logp(params):
    return -0.5 * torch.sum(params["x"] ** 2)


KW = dict(num_warmup=30, num_samples=40, num_chains=2, checkpoint_every=10, max_depth=4)


class _Stop(Exception):
    pass


def _interrupt_after(n):
    def on_chunk(i):
        if i + 1 == n:
            raise _Stop

    return on_chunk


@pytest.mark.parametrize("kernel", ["nuts", "hmc"])
def test_resume_is_bit_identical(tmp_path, kernel):
    init = {"x": torch.zeros(3)}
    full = sample_checkpointed(_logp, init, generator=torch.Generator().manual_seed(3),
                               checkpoint_path=str(tmp_path / "full.npz"), kernel=kernel, **KW)
    path = str(tmp_path / "cut.npz")
    with pytest.raises(_Stop):
        sample_checkpointed(_logp, init, generator=torch.Generator().manual_seed(3),
                            checkpoint_path=path, kernel=kernel, on_chunk=_interrupt_after(2),
                            **KW)
    assert sorted(os.listdir(tmp_path)) == ["cut.npz", "cut.npz.chunk0000.npz",
                                            "cut.npz.chunk0001.npz", "full.npz"] + [
        f"full.npz.chunk000{i}.npz" for i in range(4)]
    resumed_chunks = []
    res = sample_checkpointed(_logp, init, generator=torch.Generator().manual_seed(3),
                              checkpoint_path=path, kernel=kernel,
                              on_chunk=resumed_chunks.append, **KW)
    assert resumed_chunks == [2, 3]  # chunks 0-1 came from disk
    assert torch.equal(res.samples["x"], full.samples["x"])
    assert torch.equal(res.stats["accept_prob"], full.stats["accept_prob"])
    assert torch.equal(res.stats["diverging"], full.stats["diverging"])
    assert res.samples["x"].shape == (2, 40, 3)
    assert bool(torch.isfinite(res.samples["x"]).all())


def test_changed_config_restarts(tmp_path, caplog):
    path = str(tmp_path / "ck.npz")
    init = {"x": torch.zeros(2)}
    with pytest.raises(_Stop):
        sample_checkpointed(_logp, init, generator=torch.Generator().manual_seed(1),
                            checkpoint_path=path, on_chunk=_interrupt_after(1), **KW)
    ran = []
    with caplog.at_level(logging.WARNING):
        sample_checkpointed(_logp, init, generator=torch.Generator().manual_seed(2),
                            checkpoint_path=path, on_chunk=ran.append, **KW)
    assert ran == [0, 1, 2, 3]  # another seed: every chunk ran again
    assert "does not match the current run" in caplog.text
    _, meta = load_pytree(path, {k: torch.zeros(1) for k in
                                 ("x", "logp", "grad", "step_size", "inv_mass")})
    assert meta["config"]["seed"] == 2 and meta["chunks_done"] == 4


def test_chunk_streams_depend_on_seed_and_index_only():
    a = tck._stream(torch.Generator().manual_seed(5), "chunk3")
    b = tck._stream(torch.Generator().manual_seed(5), "chunk3")
    c = tck._stream(torch.Generator().manual_seed(5), "chunk4")
    assert torch.equal(torch.rand(4, generator=a), torch.rand(4, generator=b))
    assert not torch.equal(torch.rand(4, generator=b), torch.rand(4, generator=c))

"""Checkpoint / resume for long-running sampling jobs.

Port of the JAX package's ``checkpoint.py``:

- :func:`save_pytree` / :func:`load_pytree` — atomic on-disk snapshots of
  a tree of tensors or arrays (``.npz`` + JSON metadata; write-to-temp +
  ``os.replace``, so a crash mid-write never corrupts the previous
  checkpoint).  The files are the JAX package's: either package reads
  the other's.
- :func:`sample_checkpointed` — the chunked, resumable front door: warmup
  runs once, then sampling proceeds in chunks of ``checkpoint_every``
  draws.  After every chunk the small kernel state is re-persisted and
  that chunk's draws are written to their own file
  (``<path>.chunk0000.npz``, ...).  Killing the process at any point and
  calling the same function again resumes after the last completed chunk
  and produces bit-identical draws to an uninterrupted run.

The JAX package derives each chunk's key from the base key and the chunk
index (``fold_in``).  Here each chunk's ``torch.Generator`` is seeded
from the base generator's seed and the chunk index, never carried over
from the chunk before, so the stream does not depend on where the run
was interrupted.  A checkpoint whose recorded config (the seed and the
kernel settings among it) does not match the call is ignored and
sampling restarts fresh.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import tempfile
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

from .utils import tree_leaves, tree_map

_META_KEY = "__pft_metadata__"


def save_pytree(path: str, tree: Any, metadata: Optional[dict] = None) -> None:
    """Atomically snapshot a tree of tensors or arrays (+ JSON metadata)
    to ``path``.

    Leaves are stored positionally (``leaf_0..leaf_N``, sorted dict keys
    first); restore with :func:`load_pytree` and a structurally identical
    ``like`` tree.
    """
    leaves = tree_leaves(tree)
    payload = {
        f"leaf_{i}": leaf.detach().cpu().numpy() if isinstance(leaf, torch.Tensor)
        else np.asarray(leaf)
        for i, leaf in enumerate(leaves)
    }
    payload[_META_KEY] = np.frombuffer(json.dumps(metadata or {}).encode(), dtype=np.uint8)
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **payload)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_pytree(path: str, like: Any) -> Tuple[Any, dict]:
    """Load a :func:`save_pytree` snapshot into the structure of ``like``.

    Returns ``(tree, metadata)``, the leaves as CPU tensors.  Raises
    ``ValueError`` on leaf-count mismatch in either direction (structure
    mismatch); dtypes/shapes come from the file.
    """
    with np.load(path) as data:
        metadata = json.loads(bytes(data[_META_KEY].tobytes()).decode())
        n = len(tree_leaves(like))
        n_stored = sum(1 for f in data.files if f.startswith("leaf_"))
        if n_stored != n:
            raise ValueError(
                f"checkpoint {path} has {n_stored} leaves, `like` has {n} "
                f"(structure mismatch)"
            )
        stored = iter([torch.from_numpy(np.array(data[f"leaf_{i}"])) for i in range(n)])
    return tree_map(lambda _: next(stored), like), metadata


def _chunk_path(checkpoint_path: str, i: int) -> str:
    return f"{checkpoint_path}.chunk{i:04d}.npz"


def derived_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for the stream ``tag`` of base seed ``seed``: the
    stream depends on nothing else (the analog of ``fold_in``)."""
    digest = hashlib.sha256(f"{seed}/{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & (2**63 - 1)


def _stream(generator: torch.Generator, tag: str) -> torch.Generator:
    return torch.Generator(device=generator.device).manual_seed(
        derived_seed(generator.initial_seed(), tag))


def sample_checkpointed(
    logp_fn: Callable[[Any], torch.Tensor],
    init_params: Any,
    *,
    generator: torch.Generator,
    checkpoint_path: str,
    num_warmup: int = 500,
    num_samples: int = 500,
    num_chains: int = 4,
    checkpoint_every: int = 100,
    kernel: str = "nuts",
    max_depth: int = 8,
    num_hmc_steps: int = 16,
    target_accept: float = 0.8,
    jitter: float = 1.0,
    logp_and_grad_fn: Optional[Callable] = None,
    dense_mass: bool = False,
    on_chunk: Optional[Callable[[int], None]] = None,
):
    """Resumable NUTS/HMC sampling with periodic on-disk checkpoints.

    Same posterior contract as :func:`.samplers.sample` (gradient kernels
    only: "nuts"/"hmc"; every chain in lockstep) but the draw loop is
    chunked: after every ``checkpoint_every`` draws the kernel state is
    persisted to ``checkpoint_path`` and the chunk's draws to a
    per-chunk file.  If a matching checkpoint exists, sampling resumes
    after the last completed chunk; the result is bit-identical to an
    uninterrupted run.  The run's streams (the jitter, the warmup, each
    chunk) are seeded from ``generator.initial_seed()``; the generator
    itself is not advanced.  ``on_chunk(i)`` runs after chunk ``i`` is
    persisted (an exception raised there interrupts the run with chunk
    ``i`` saved).

    Returns a :class:`.samplers.mcmc.SampleResult`.
    """
    from .samplers.hmc import HMCState
    from .samplers.mcmc import (
        SampleResult,
        _warmup,
        make_batch_logp_and_grad,
        make_flat_logp_and_grad,
        make_kernel_step,
    )

    flat_logp, flat_init, unravel, _ = make_flat_logp_and_grad(logp_fn, init_params)
    dtype, device = flat_init.dtype, flat_init.device
    dim = flat_init.shape[0]
    lg = make_batch_logp_and_grad(flat_logp, unravel, logp_and_grad_fn)
    kernel_step = make_kernel_step(lg, kernel, max_depth=max_depth, num_hmc_steps=num_hmc_steps)

    n_chunks = -(-num_samples // checkpoint_every)  # ceil
    config = {
        "seed": generator.initial_seed(),
        "num_warmup": num_warmup,
        "num_samples": num_samples,
        "num_chains": num_chains,
        "checkpoint_every": checkpoint_every,
        "kernel": kernel,
        "max_depth": max_depth,
        "num_hmc_steps": num_hmc_steps,
        "target_accept": target_accept,
        "jitter": jitter,
        "dim": dim,
        # Part of the resume identity: a diagonal-mass checkpoint must
        # not be stitched into a dense-mass run.
        "dense_mass": dense_mass,
    }
    # Config keys added after a release, with the default value older
    # checkpoints implicitly ran with.
    _added_config_defaults = {"dense_mass": False}

    def _config_compatible(stored) -> bool:
        if stored == config:
            return True
        if not isinstance(stored, dict):
            return False
        for k, cur in config.items():
            if k in stored:
                if stored[k] != cur:
                    return False
            elif k not in _added_config_defaults or cur != _added_config_defaults[k]:
                return False
        return all(k in config for k in stored)

    def zeros(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt)

    state_template = {
        "x": zeros(num_chains, dim), "logp": zeros(num_chains), "grad": zeros(num_chains, dim),
        "step_size": zeros(num_chains),
        "inv_mass": zeros(num_chains, dim, dim) if dense_mass else zeros(num_chains, dim),
    }
    chunk_template = {
        "draws": zeros(num_chains, checkpoint_every, dim),
        "accept_prob": zeros(num_chains, checkpoint_every),
        "diverging": zeros(num_chains, checkpoint_every, dt=torch.bool),
    }
    to_dev = lambda tree: tree_map(lambda t: t.to(device), tree)

    # ---- resume or fresh start ----
    resumed = None
    if os.path.exists(checkpoint_path):
        try:
            state, meta = load_pytree(checkpoint_path, state_template)
            if _config_compatible(meta.get("config")):
                chunks_done = int(meta["chunks_done"])
                chunks = [load_pytree(_chunk_path(checkpoint_path, i), chunk_template)[0]
                          for i in range(chunks_done)]
                resumed = (to_dev(state), chunks_done, chunks)
            else:
                logging.getLogger(__name__).warning(
                    "discarding checkpoint %s: stored sampling config does "
                    "not match the current run; restarting from scratch",
                    checkpoint_path,
                )
        except (ValueError, KeyError, OSError):
            # Stale/foreign/partial checkpoint: restart fresh.
            resumed = None

    if resumed is None:
        init_flat = flat_init.expand(num_chains, dim)
        if jitter:
            init_flat = init_flat + jitter * torch.randn(
                init_flat.shape, generator=_stream(generator, "jitter"), dtype=dtype,
                device=device)
        warm = _warmup(lg, init_flat, _stream(generator, "warmup"), num_warmup=num_warmup,
                       kernel_step=kernel_step, target_accept=target_accept,
                       dense_mass=dense_mass)
        state = {"x": warm.state.x, "logp": warm.state.logp, "grad": warm.state.grad,
                 "step_size": warm.step_size, "inv_mass": warm.inv_mass.contiguous()}
        chunks_done, chunks = 0, []
        save_pytree(checkpoint_path, state, {"config": config, "chunks_done": 0})
    else:
        state, chunks_done, chunks = resumed

    for i in range(chunks_done, n_chunks):
        chunk_gen = _stream(generator, f"chunk{i}")
        hmc = HMCState(state["x"], state["logp"], state["grad"])
        xs, aps, divs = [], [], []
        for _ in range(checkpoint_every):
            hmc, info = kernel_step(hmc, chunk_gen, step_size=state["step_size"],
                                    inv_mass=state["inv_mass"])
            xs.append(hmc.x)
            aps.append(info.accept_prob)
            divs.append(info.diverging)
        state = dict(state, x=hmc.x, logp=hmc.logp, grad=hmc.grad)
        chunk = {"draws": torch.stack(xs, dim=1).cpu(), "accept_prob": torch.stack(aps, dim=1).cpu(),
                 "diverging": torch.stack(divs, dim=1).cpu()}
        save_pytree(_chunk_path(checkpoint_path, i), chunk)
        save_pytree(checkpoint_path, state, {"config": config, "chunks_done": i + 1})
        chunks.append(chunk)
        if on_chunk is not None:
            on_chunk(i)

    cat = lambda name: torch.cat([c[name] for c in chunks], dim=1)[:, :num_samples].to(device)
    return SampleResult(
        samples=unravel(cat("draws")),
        stats={"accept_prob": cat("accept_prob"), "diverging": cat("diverging")},
        step_size=state["step_size"],
        inv_mass=state["inv_mass"],
    )

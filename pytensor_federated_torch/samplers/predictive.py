"""Posterior and prior predictive sampling over the samplers' draws.

Port of the JAX package's ``samplers/predictive.py``.  A modeller ends a
PyMC-style workflow with ``pm.sample_posterior_predictive`` over the
trace; this is the counterpart on :class:`..mcmc.SampleResult` trees
(leading ``(chains, draws)`` axes).

The JAX package vmaps a one-draw simulator over one split PRNG key per
draw.  ``torch.func.vmap`` does not thread an explicit generator through
random operations, so here the simulator takes the draws as a batch: it
receives the parameter tree with one leading draws axis and a single
``torch.Generator``, and simulates every draw at once (the families'
``predictive`` methods do, since their observation samplers are
elementwise).
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import numpy as np
import torch

from ..utils import tree_leaves, tree_map

__all__ = ["posterior_predictive", "prior_predictive"]


def _flatten_chain_draws(samples: Any) -> Any:
    """(chains, draws, *event) -> (chains*draws, *event) per leaf."""
    return tree_map(lambda leaf: leaf.reshape((-1,) + tuple(leaf.shape[2:])), samples)


def _subsample_indices(total: int, num_draws: int) -> torch.Tensor:
    """``num_draws`` evenly spaced indices into ``total`` draws (the
    truncated ``linspace(0, total - 1, num_draws)``)."""
    return torch.from_numpy(np.linspace(0, total - 1, num_draws).astype(np.int64))


def posterior_predictive(
    predictive_fn: Callable[[Any, torch.Generator], Any],
    samples: Any,
    generator: torch.Generator,
    *,
    num_draws: Optional[int] = None,
) -> Any:
    """Simulate data from every (or ``num_draws`` subsampled) posterior
    draw.

    ``predictive_fn(params, generator)`` receives the parameter tree with
    ONE leading draws axis on every leaf (e.g. a family's
    ``model.predictive``) and returns simulated data with that leading
    axis; ``samples`` has leading ``(chains, draws)`` axes
    (``SampleResult.samples``).  Subsampling (``num_draws``) picks evenly
    spaced draws — cheaper than the full sweep and unbiased for
    stationary chains.
    """
    flat = _flatten_chain_draws(samples)
    total = tree_leaves(flat)[0].shape[0]
    if num_draws is not None and num_draws < total:
        idx = _subsample_indices(total, num_draws)
        flat = tree_map(lambda leaf: leaf[idx.to(leaf.device)], flat)
    return predictive_fn(flat, generator)


def prior_predictive(
    sample_prior_fn: Callable[[torch.Generator], Any],
    predictive_fn: Callable[[Any, torch.Generator], Any],
    generator: torch.Generator,
    *,
    num_draws: int = 500,
) -> Any:
    """Simulate data from the prior: draw ``num_draws`` parameter sets
    with ``sample_prior_fn(generator) -> params``, stack them on a
    leading draws axis and push the batch through ``predictive_fn``."""
    draws = [sample_prior_fn(generator) for _ in range(num_draws)]
    batch = tree_map(lambda *leaves: torch.stack(leaves), draws[0], *draws[1:])
    return predictive_fn(batch, generator)

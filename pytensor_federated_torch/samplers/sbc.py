"""Simulation-based calibration (Talts et al. 2018, arXiv:1804.06788).

Port of the JAX package's ``samplers/sbc.py``: draw ``theta* ~ prior``,
simulate ``data | theta*``, sample the posterior, and record the rank of
``theta*`` among the posterior draws.  If (and only if) the sampler
targets the right posterior, ranks are uniform on ``{0..L}``.

The JAX package maps one warmup + NUTS chain per simulation over the
simulated datasets with ``vmap``.  Here every simulation is one chain of
one lockstep batch (``samplers/mcmc.py:_warmup`` and
:func:`.mcmc.make_kernel_step`): a batched evaluation maps ``logp`` over
the parameter sets and their datasets together, so a NUTS leaf is one
evaluation of every simulation.  The data differ per chain, so the
target must be plain torch (the linreg kernel shares its data among
chains and refuses a batched dataset).  Where the JAX package takes a
PRNG key this takes a ``torch.Generator``.

Caveat (as in the paper): ranks computed from autocorrelated draws
over-disperse slightly; use ``thin`` to decorrelate.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from ..utils import tree_map
from .mcmc import _warmup, make_kernel_step
from .util import ravel

__all__ = ["SBCResult", "sbc_ranks", "sbc_uniformity"]


class SBCResult(NamedTuple):
    ranks: torch.Tensor  # (n_sims, dim) int32 in {0..L}
    n_levels: int  # L + 1 possible rank values
    param_names: Any  # flat-coordinate labels (best effort)


def _names(tree, prefix=""):
    """Flat-coordinate labels in ``ravel`` order, keyed like
    ``jax.tree_util.keystr`` (``['a']``, ``[0]``)."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in _names(tree[k], f"{prefix}[{k!r}]")]
    if isinstance(tree, (tuple, list)):
        return [n for i, t in enumerate(tree) for n in _names(t, f"{prefix}[{i}]")]
    size = int(np.prod(tuple(tree.shape))) if tree.dim() else 1
    return [prefix] if tree.dim() == 0 or size == 1 else [f"{prefix}[{i}]" for i in range(size)]


def batch_logp_and_grad_over_data(logp, unravel, datas):
    """``lg(X: (n, d)) -> ((n,), (n, d))`` of ``logp(unravel(x_i),
    data_i)`` for every row: one ``vmap`` over parameters and data
    together, one ``torch.autograd`` pass."""
    batched = torch.func.vmap(lambda x, data: logp(unravel(x), data))

    def lg(x):
        x = x.detach().requires_grad_(True)
        v = batched(x, datas)
        (g,) = torch.autograd.grad(v.sum(), x)
        return v.detach(), g

    return lg


def sbc_ranks(
    prior_sample: Callable[[torch.Generator], Any],
    simulate: Callable[[torch.Generator, Any], Any],
    logp: Callable[[Any, Any], torch.Tensor],
    *,
    generator: torch.Generator,
    n_sims: int = 64,
    num_warmup: int = 200,
    num_samples: int = 128,
    thin: int = 4,
    max_depth: int = 6,
    target_accept: float = 0.8,
    counter: dict | None = None,
) -> SBCResult:
    """Rank statistics for ``n_sims`` prior-predictive replications.

    ``prior_sample(generator) -> params``; ``simulate(generator, params)
    -> data`` (any tree of tensors, fixed shapes across draws); ``logp(
    params, data) -> scalar`` in torch ops that ``vmap`` can map over
    the data.  The draws are taken one simulation at a time: every
    prior draw, then every dataset.  The kept draws are thinned by
    ``thin``; ranks take values in ``{0, ..., num_samples // thin}``.
    ``counter``, if given, gains the batched evaluations (``evals``).
    """
    if num_samples < thin:
        raise ValueError(
            f"num_samples={num_samples} < thin={thin}: no draws would "
            "be kept and every rank would be 0"
        )
    thetas = [prior_sample(generator) for _ in range(n_sims)]
    datas = [simulate(generator, t) for t in thetas]
    stack = lambda trees: tree_map(lambda *leaves: torch.stack(leaves), *trees)
    theta0 = thetas[0]
    _, unravel = ravel(theta0)
    flat_thetas = torch.stack([ravel(t)[0] for t in thetas]).detach()
    lg = batch_logp_and_grad_over_data(logp, unravel, stack(datas))
    if counter is not None:
        counter.setdefault("evals", 0)
        inner = lg

        def lg(x):
            counter["evals"] += 1
            return inner(x)

    kernel_step = make_kernel_step(lg, "nuts", max_depth=max_depth)
    # Initialize AT the true draw: it is a perfect posterior sample (that
    # is the whole point of SBC), so no burn-in bias.
    warm = _warmup(lg, flat_thetas, generator, num_warmup=num_warmup,
                   kernel_step=kernel_step, target_accept=target_accept)
    state, draws = warm.state, []
    for _ in range(num_samples):
        state, _ = kernel_step(state, generator, step_size=warm.step_size,
                               inv_mass=warm.inv_mass)
        draws.append(state.x)
    kept = torch.stack(draws[thin - 1 :: thin], dim=1)  # (n_sims, kept, dim)
    ranks = torch.sum((kept < flat_thetas[:, None, :]).to(torch.int32), dim=1)
    return SBCResult(ranks=ranks, n_levels=num_samples // thin + 1, param_names=_names(theta0))


def sbc_uniformity(result: SBCResult, *, n_bins: int = 8):
    """Per-coordinate chi-square statistic against uniform ranks.

    Returns ``(stat, dof)``; under calibration each ``stat`` is
    ~chi2(dof).  A quick screen, not a substitute for looking at the
    histograms: use e.g. ``stat < dof + 4*sqrt(2*dof)`` as a loose gate.
    """
    ranks = np.asarray(result.ranks.cpu() if isinstance(result.ranks, torch.Tensor)
                       else result.ranks)
    n_sims, dim = ranks.shape
    edges = np.linspace(0, result.n_levels, n_bins + 1)
    # Ranks are integers in [0, n_levels); when n_bins does not divide
    # n_levels the bins cover unequal numbers of integer levels, so the
    # expected count is proportional to each bin's level coverage.
    levels = np.arange(result.n_levels)
    levels_per_bin, _ = np.histogram(levels, bins=edges)
    # Bins covering no integer level contribute 0 observed and 0
    # expected: drop them and shrink the dof to the bins that remain.
    keep = levels_per_bin > 0
    expected = n_sims * levels_per_bin[keep] / result.n_levels
    stats = np.empty((dim,))
    for j in range(dim):
        hist, _ = np.histogram(ranks[:, j], bins=edges)
        stats[j] = np.sum((hist[keep] - expected) ** 2 / expected)
    return stats, int(keep.sum()) - 1

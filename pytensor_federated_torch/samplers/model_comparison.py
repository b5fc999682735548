"""Model comparison: WAIC and PSIS-LOO from the samplers' draws.

Port of the JAX package's ``samplers/model_comparison.py``.  A
modeller's workflow ends in arviz (``az.waic`` / ``az.loo`` over an
InferenceData with pointwise log-likelihoods); this module gives the
same estimators directly on ``SampleResult`` draws, with the pointwise
log-likelihood evaluated for every kept draw in one
``torch.func.vmap``.

Estimators (Vehtari, Gelman & Gabry, 2017, "Practical Bayesian model
evaluation using leave-one-out cross-validation and WAIC"):

- :func:`waic` — elpd_waic = Σ_i lppd_i − p_waic, p_waic = Σ_i
  Var_s(ll_is); fast, no importance sampling.
- :func:`psis_loo` — importance-sampled exact LOO with Pareto-smoothed
  tails: the raw ratios 1/p(y_i|θ_s) have heavy tails, so the top-M
  ratios are replaced by expected order statistics of a generalized
  Pareto fitted by the Zhang–Stephens (2009) posterior-mean method.
  Per-point shape diagnostics ``k`` are returned: k > 0.7 flags an
  unreliable point (same rule as arviz).
- :func:`compare` — rank models by elpd with paired-difference SEs.

The smoothing runs on the host in numpy, a copy of the JAX package's
code line for line, so both packages give equal results on the same
matrix; the log-likelihood sweep is torch.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import numpy as np
import torch

from ..utils import tree_leaves, tree_map

__all__ = [
    "pointwise_loglik_matrix",
    "waic",
    "psis_loo",
    "compare",
]


def pointwise_loglik_matrix(
    pointwise_fn: Callable[[Any], torch.Tensor],
    samples: Any,
    mask: Any = None,
) -> np.ndarray:
    """``(n_draws_total, n_points)`` pointwise log-likelihoods.

    ``pointwise_fn(params)`` maps ONE parameter tree (no chain/draw
    axes) to per-observation log-likelihoods of any shape; it is mapped
    over the flattened draws with ``torch.func.vmap``.  ``samples`` has
    leading ``(chains, draws)`` axes.  ``mask`` (same shape as the fn
    output) drops padded slots — a padded point would otherwise enter
    the sums as a real observation with ll=0.
    """
    leaves = tree_leaves(samples)
    c, d = leaves[0].shape[:2]
    flat = tree_map(lambda a: a.reshape((c * d,) + tuple(a.shape[2:])), samples)
    with torch.no_grad():
        ll = torch.func.vmap(pointwise_fn)(flat)  # (S_total, ...)
    ll = ll.reshape(c * d, -1).cpu().numpy()
    if mask is not None:
        mask = mask.detach().cpu().numpy() if torch.is_tensor(mask) else np.asarray(mask)
        ll = ll[:, mask.reshape(-1) > 0]
    return ll


def _logmeanexp(a: np.ndarray, axis: int = 0) -> np.ndarray:
    m = a.max(axis=axis)
    return m + np.log(np.mean(np.exp(a - m), axis=axis))


def _logsumexp(a: np.ndarray) -> float:
    m = a.max()
    return float(m + np.log(np.sum(np.exp(a - m))))


def waic(ll: np.ndarray) -> Dict[str, Any]:
    """WAIC from an ``(n_draws, n_points)`` log-likelihood matrix."""
    lppd_i = _logmeanexp(ll, axis=0)
    p_i = ll.var(axis=0, ddof=1)
    elpd_i = lppd_i - p_i
    n = ll.shape[1]
    return {
        "elpd_waic": float(elpd_i.sum()),
        "p_waic": float(p_i.sum()),
        "se": float(np.sqrt(n * elpd_i.var(ddof=1))),
        "elpd_i": elpd_i,
    }


def _gpd_fit(x: np.ndarray) -> tuple[float, float]:
    """Zhang & Stephens (2009) posterior-mean fit of a generalized
    Pareto to exceedances ``x`` (sorted ascending).

    Returns ``(xi, sigma)`` in the ξ convention (cdf
    ``1 - (1 + ξx/σ)^{-1/ξ}``; heavy tail = ξ > 0) — the convention
    the quantile formula in :func:`_psis_smooth_tail` and the
    ``k > 0.7`` reliability threshold use.  Zhang–Stephens derive with
    ``k = -ξ``; the sign flip happens at the return."""
    n = x.size
    prior_bs = 3.0
    q25 = float(np.quantile(x, 0.25))
    if not np.isfinite(q25) or q25 <= 1e-20:
        # Tie-heavy exceedances (routine with duplicated Metropolis draws):
        # >=25% of the tail sits at the cutoff, the quartile collapses to
        # the clamp, bs explodes and log1p(-bs*x) goes NaN — and a NaN k
        # silently PASSES the k > 0.7 bad-point check (NaN > 0.7 is
        # False).  Flag the point unreliable instead.
        return np.inf, np.nan
    m = 30 + int(np.sqrt(n))
    bs = 1.0 - np.sqrt(m / (np.arange(1, m + 1) - 0.5))
    bs = bs / (prior_bs * q25) + 1.0 / x[-1]
    ks = -np.mean(np.log1p(-bs[:, None] * x[None, :]), axis=1)
    L = n * (np.log(bs / ks) + ks - 1.0)
    if not np.all(np.isfinite(ks)) or not np.all(np.isfinite(L)):
        return np.inf, np.nan
    # posterior weights w_j ∝ exp(L_j), computed as a stable softmax
    e = np.exp(L - L.max())
    w = e / e.sum()
    b_post = float(np.sum(bs * w))
    xi = float(np.mean(np.log1p(-b_post * x)))
    sigma = -xi / b_post
    return xi, sigma


def _psis_smooth_tail(log_ratios_i: np.ndarray) -> tuple[np.ndarray, float]:
    """Smooth one point's log importance ratios in place; returns the
    smoothed log-ratios and the fitted Pareto k."""
    s = log_ratios_i.size
    # tail size from Vehtari et al. (2017): min(S/5, 3*sqrt(S))
    m = min(int(np.ceil(0.2 * s)), int(np.ceil(3.0 * np.sqrt(s))), s - 1)
    if m < 5:
        return log_ratios_i, -np.inf  # too few draws to smooth
    order = np.argsort(log_ratios_i)
    tail_idx = order[-m:]
    cutoff = log_ratios_i[order[-m - 1]]
    exceed = np.exp(log_ratios_i[tail_idx]) - np.exp(cutoff)
    exceed = np.sort(exceed)
    if not np.all(np.isfinite(exceed)) or exceed[-1] <= 0:
        return log_ratios_i, np.inf
    k, sigma = _gpd_fit(np.maximum(exceed, 1e-30))
    if not (np.isfinite(k) and np.isfinite(sigma)):
        # degenerate fit (see _gpd_fit guards): leave the ratios raw and
        # report k = inf so psis_loo flags the point, never NaN-cascades
        return log_ratios_i, np.inf
    # expected order statistics of the fitted gPd
    p = (np.arange(1, m + 1) - 0.5) / m
    if abs(k) < 1e-8:
        q = -sigma * np.log1p(-p)
    else:
        q = sigma / k * (np.power(1.0 - p, -k) - 1.0)
    smoothed = log_ratios_i.copy()
    smoothed[tail_idx[np.argsort(log_ratios_i[tail_idx])]] = np.log(
        q + np.exp(cutoff)
    )
    # cap at the max raw ratio (arviz does the same)
    smoothed = np.minimum(smoothed, log_ratios_i.max())
    return smoothed, k


def psis_loo(ll: np.ndarray) -> Dict[str, Any]:
    """PSIS-LOO from an ``(n_draws, n_points)`` log-likelihood matrix."""
    n_s, n = ll.shape
    elpd_i = np.empty(n)
    ks = np.empty(n)
    for i in range(n):
        lr = -ll[:, i]
        lr = lr - lr.max()
        sm, k = _psis_smooth_tail(lr)
        ks[i] = k
        # elpd_i = log Σ_s w̃_s p(y_i|θ_s) with self-normalized weights
        lw = sm - _logsumexp(sm)
        elpd_i[i] = _logsumexp(lw + ll[:, i])
    lppd_i = _logmeanexp(ll, axis=0)
    return {
        "elpd_loo": float(elpd_i.sum()),
        "p_loo": float((lppd_i - elpd_i).sum()),
        "se": float(np.sqrt(n * elpd_i.var(ddof=1))),
        "pareto_k": ks,
        "n_bad_k": int(np.sum(ks > 0.7)),
        "elpd_i": elpd_i,
    }


def compare(models: Dict[str, np.ndarray]) -> list:
    """Rank models by PSIS-LOO elpd.

    ``models`` maps name -> ``(n_draws, n_points)`` ll matrix (all over
    the SAME observations).  Returns rows sorted best-first with
    paired-difference SEs vs the best model (the honest comparison SE:
    pointwise differences are correlated across models).
    """
    loos = {name: psis_loo(ll) for name, ll in models.items()}
    ranked = sorted(loos, key=lambda k: -loos[k]["elpd_loo"])
    best = ranked[0]
    rows = []
    for name in ranked:
        d_i = loos[name]["elpd_i"] - loos[best]["elpd_i"]
        n = d_i.size
        rows.append(
            {
                "model": name,
                "elpd_loo": loos[name]["elpd_loo"],
                "p_loo": loos[name]["p_loo"],
                "d_elpd": float(d_i.sum()),
                "d_se": float(np.sqrt(n * d_i.var(ddof=1))),
                "n_bad_k": loos[name]["n_bad_k"],
            }
        )
    return rows

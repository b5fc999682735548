"""Convergence diagnostics: split-R̂, effective sample size, summaries.

Port of the JAX package's ``samplers/convergence.py``.  Definitions
follow Vehtari, Gelman, Simpson, Carpenter, Bürkner (2021)
"Rank-normalization, folding, and localization: An improved R̂":
split-chain R̂ and the Geyer initial-monotone-sequence ESS (the same
estimators Stan and arviz report), with optional rank-normalization
(the paper's "bulk" variants).  Computation promotes to at least
float32 and keeps float64 inputs in float64.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import torch

from ..utils import tree_map

__all__ = [
    "split_rhat",
    "effective_sample_size",
    "hdi",
    "summary",
    "tail_ess",
]


def _split_chains(draws: torch.Tensor) -> torch.Tensor:
    """(chains, n, ...) -> (2*chains, n//2, ...), dropping an odd tail."""
    half = draws.shape[1] // 2
    return torch.cat([draws[:, :half], draws[:, half : 2 * half]], dim=0)


def _compute_dtype(d: torch.Tensor) -> torch.dtype:
    return torch.promote_types(d.dtype, torch.float32)


def _rhat_scalar(draws: torch.Tensor) -> torch.Tensor:
    """Split-R̂ for one scalar parameter; ``draws``: (chains, n)."""
    x = _split_chains(draws.to(_compute_dtype(draws)))
    n = x.shape[1]
    chain_means = torch.mean(x, dim=1)
    w = torch.mean(torch.var(x, dim=1, correction=1))
    b = n * torch.var(chain_means, correction=1)
    var_plus = (n - 1) / n * w + b / n
    return torch.sqrt(var_plus / w)


def _autocov(x: torch.Tensor) -> torch.Tensor:
    """Per-chain autocovariance via FFT; ``x``: (chains, n) -> (chains, n)."""
    n = x.shape[1]
    xc = x - torch.mean(x, dim=1, keepdim=True)
    size = 2 * n  # zero-pad to avoid circular wrap
    f = torch.fft.rfft(xc, n=size, dim=1)
    acov = torch.fft.irfft(f * torch.conj(f), n=size, dim=1)[:, :n]
    return acov / n


def _ess_scalar(draws: torch.Tensor) -> torch.Tensor:
    """Geyer initial-monotone-sequence ESS; ``draws``: (chains, n)."""
    x = _split_chains(draws.to(_compute_dtype(draws)))
    m, n = x.shape
    acov = _autocov(x)
    chain_var = acov[:, 0] * n / (n - 1.0)
    w = torch.mean(chain_var)
    chain_means = torch.mean(x, dim=1)
    var_plus = (n - 1) / n * w + torch.var(chain_means, correction=1)

    rho = 1.0 - (w - torch.mean(acov, dim=0)) / var_plus  # (n,)
    # Geyer: sum consecutive-lag pairs while the pair sums stay positive
    # (initial positive sequence), with a running minimum so the used
    # sequence is also non-increasing (initial monotone sequence).
    n_pairs = n // 2
    pair = rho[: 2 * n_pairs].reshape(n_pairs, 2).sum(dim=1)
    positive = torch.cumprod((pair > 0.0).to(pair.dtype), dim=0)
    pair_mono = torch.cummin(pair, dim=0).values
    # rho_0 = 1 is part of pair[0]; subtract it back out of tau below.
    tau = -1.0 + 2.0 * torch.sum(pair_mono * positive)
    tau = torch.clamp(tau, min=1.0 / math.log10(float(m * n)))
    return m * n / tau


def _rank_normalize(x: torch.Tensor) -> torch.Tensor:
    """Replace (chains, n) draws by normal quantiles of their pooled
    Blom-adjusted AVERAGE ranks (Vehtari et al. 2021, eq. 14); NaN draws
    stay NaN."""
    c, n = x.shape
    flat = x.reshape(-1).contiguous()
    s = torch.sort(flat).values
    lo = torch.searchsorted(s, flat, side="left")
    hi = torch.searchsorted(s, flat, side="right")
    ranks = 0.5 * (lo + hi + 1).to(x.dtype)  # 1-based average rank
    z = torch.special.ndtri((ranks - 0.375) / (flat.numel() + 0.25))
    z = torch.where(torch.isnan(flat), math.nan, z)
    return z.reshape(c, n)


def _per_component(fn, d: torch.Tensor) -> torch.Tensor:
    """Apply a (chains, n) -> scalar function to every scalar component
    of a (chains, draws, *event) leaf."""
    c, n = d.shape[0], d.shape[1]
    flat = d.reshape(c, n, -1)
    out = torch.stack([fn(flat[:, :, j]) for j in range(flat.shape[2])])
    return out.reshape(d.shape[2:])


def _rank_normalize_tree(samples: Any) -> Any:
    """Rank-normalize every scalar component of every leaf once."""

    def leaf(d):
        c, n = d.shape[0], d.shape[1]
        flat = d.reshape(c, n, -1).to(_compute_dtype(d))
        z = torch.stack(
            [_rank_normalize(flat[:, :, j]) for j in range(flat.shape[2])], dim=2
        )
        return z.reshape(d.shape)

    return tree_map(leaf, samples)


def _per_param(fn, samples: Any, *, rank_normalized: bool = False) -> Any:
    def scalar_fn(d2):
        if rank_normalized:
            d2 = _rank_normalize(d2.to(_compute_dtype(d2)))
        return fn(d2)

    return tree_map(lambda d: _per_component(scalar_fn, d), samples)


def split_rhat(samples: Any, *, rank_normalized: bool = False) -> Any:
    """Split-chain potential-scale-reduction R̂ per scalar component.

    ``samples``: tree of tensors shaped (chains, draws, *event) — e.g.
    ``SampleResult.samples``.  ``rank_normalized=True`` gives the 2021
    bulk-R̂.
    """
    return _per_param(_rhat_scalar, samples, rank_normalized=rank_normalized)


def effective_sample_size(samples: Any, *, rank_normalized: bool = False) -> Any:
    """Bulk effective sample size per scalar component (Geyer/Stan
    estimator on split chains); ``rank_normalized=True`` gives the 2021
    bulk-ESS."""
    return _per_param(_ess_scalar, samples, rank_normalized=rank_normalized)


def _tail_ess_scalar(draws: torch.Tensor) -> torch.Tensor:
    x = draws.to(_compute_dtype(draws))
    q05 = torch.nanquantile(x, 0.05)
    q95 = torch.nanquantile(x, 0.95)
    e05 = _ess_scalar((x <= q05).to(x.dtype))
    e95 = _ess_scalar((x <= q95).to(x.dtype))
    # (nan <= q) is False, which would launder diverged draws into
    # healthy-looking indicator chains — propagate the alarm instead.
    return torch.where(torch.any(torch.isnan(x)), math.nan, torch.minimum(e05, e95))


def tail_ess(samples: Any) -> Any:
    """Tail effective sample size (Vehtari et al. 2021): the minimum ESS
    of the 5% / 95% quantile-exceedance indicators."""
    return _per_param(_tail_ess_scalar, samples)


def hdi(samples: Any, prob: float = 0.94) -> Any:
    """Highest-density interval per scalar component: the narrowest
    window holding ``prob`` of the pooled sorted draws, as a trailing
    axis of 2 ``[lower, upper]``."""
    if not 0.0 < prob < 1.0:
        raise ValueError(f"prob must be in (0, 1), got {prob}")

    def leaf(d):
        s = torch.sort(d.reshape((-1,) + d.shape[2:]), dim=0).values
        n = s.shape[0]
        k = max(int(math.floor(prob * n)), 1)
        i = torch.argmin(s[k:] - s[: n - k], dim=0)
        lower = torch.take_along_dim(s, i[None], dim=0)[0]
        upper = torch.take_along_dim(s, (i + k)[None], dim=0)[0]
        return torch.stack([lower, upper], dim=-1)

    return tree_map(leaf, samples)


def summary(
    samples: Any, *, hdi_prob: float = 0.94, rank_normalized: bool = False
) -> Dict[str, Any]:
    """Posterior summary: mean, sd, HDI, split-R̂, ESS per component."""
    diag_samples = _rank_normalize_tree(samples) if rank_normalized else samples
    return {
        "mean": tree_map(lambda d: torch.mean(d, dim=(0, 1)), samples),
        "sd": tree_map(lambda d: torch.std(d, dim=(0, 1), correction=0), samples),
        "hdi": hdi(samples, hdi_prob),
        "rhat": split_rhat(diag_samples),
        "ess": effective_sample_size(diag_samples),
        "ess_tail": tail_ess(samples),
    }

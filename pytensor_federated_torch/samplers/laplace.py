"""Laplace approximation: Gaussian posterior from MAP + Hessian.

Port of the JAX package's ``samplers/laplace.py``.  Find the MAP, take
the Hessian of the log-posterior there (``torch.func.hessian``, forward
over reverse mode, through the whole sharded evaluator) and return
``N(map, (-H)^{-1})`` with draws in the original parameter structure.

A cheap posterior when the target is near-Gaussian, an initializer or
mass-matrix source for NUTS, and a sanity oracle in tests (exact for
Gaussian posteriors).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from ..utils import cholesky_or_nan
from .mcmc import find_map
from .util import flatten_logp

__all__ = ["LaplaceResult", "laplace_approximation"]


@dataclasses.dataclass
class LaplaceResult:
    """MAP point, flat Gaussian moments, and draw machinery."""

    mode: Any  # params tree, the MAP point
    mean_flat: torch.Tensor  # (dim,)
    cov_flat: torch.Tensor  # (dim, dim)
    scale_flat: torch.Tensor  # (dim, dim), scale_flat' @ scale_flat == cov
    unravel: Callable[[torch.Tensor], Any]
    logp_at_mode: float

    def sample(self, generator: torch.Generator, num_draws: int = 1000) -> Any:
        """Draws from the Gaussian approximation, as a params tree with a
        leading ``(num_draws,)`` axis.  Uses the covariance factor
        computed at fit time — no re-factorization (which could go NaN
        on a precision->covariance round trip of a barely-identified
        posterior)."""
        m = self.mean_flat
        eps = torch.randn((num_draws,) + tuple(m.shape), generator=generator,
                          dtype=m.dtype, device=m.device)
        return self.unravel(m + eps @ self.scale_flat)

    def stddev(self) -> Any:
        """Marginal posterior standard deviations, as a params tree."""
        return self.unravel(torch.sqrt(torch.diagonal(self.cov_flat)))


def laplace_approximation(
    logp_fn: Callable[[Any], torch.Tensor],
    init_params: Any,
    *,
    jitter: float = 0.0,
    mode: Optional[Any] = None,
    **map_kwargs,
) -> LaplaceResult:
    """Fit ``N(theta_MAP, (-Hessian)^{-1})`` to the posterior.

    ``mode``: optionally skip the MAP search and expand around a given
    point.  ``jitter`` adds ``jitter * I`` to ``-H`` before inversion
    for barely-identified directions.  Extra keyword arguments
    (``num_steps``, ``learning_rate``, ...) go to :func:`..mcmc.find_map`.
    Raises ``ValueError`` if the Hessian is non-finite (diverged MAP
    search / NaN logp) or ``-H`` is not positive definite at the
    expansion point (not a local maximum): the Cholesky factor is NaN
    there, as ``jnp.linalg.cholesky``'s is, and no draw is made from a
    non-PD covariance.
    """
    if mode is None:
        mode = find_map(logp_fn, init_params, **map_kwargs)
    flat_logp, flat_mode, unravel = flatten_logp(logp_fn, mode)
    flat_mode = flat_mode.detach()
    H = torch.func.hessian(flat_logp)(flat_mode)
    if not bool(torch.isfinite(H).all()):
        raise ValueError(
            "non-finite Hessian at the expansion point — the MAP search "
            "diverged or logp is NaN there (try a smaller learning_rate "
            "or pass a finite mode=)"
        )
    eye = torch.eye(H.shape[0], dtype=H.dtype, device=H.device)
    prec = -H + jitter * eye
    # Cholesky doubles as the PD check and the inversion workhorse.
    chol = cholesky_or_nan(prec)
    if bool(torch.isnan(chol).any()):
        raise ValueError(
            "-Hessian at the expansion point is not positive definite; "
            "the point is not a local maximum (try more MAP steps or a "
            "jitter > 0)"
        )
    inv_chol = torch.linalg.solve_triangular(chol, eye, upper=False)
    cov = inv_chol.T @ inv_chol
    with torch.no_grad():
        logp_at_mode = float(flat_logp(flat_mode))
    return LaplaceResult(
        mode=mode,
        mean_flat=flat_mode,
        cov_flat=cov,
        scale_flat=inv_chol,
        unravel=unravel,
        logp_at_mode=logp_at_mode,
    )

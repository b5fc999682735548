"""ADVI — stochastic variational inference on the federated logp.

Port of the JAX package's ``samplers/advi.py``.  Each optimization step
draws ``n_mc`` reparameterized samples and evaluates the logp of all of
them as one ``torch.func.vmap`` batch: through the linreg kernel, one
launch with a chain axis of ``n_mc``.  The gradient of the ELBO is one
first-order ``torch.autograd`` pass (:func:`..ppl.elbo.scan_vi`).

Two approximation families:

- :func:`advi_fit` — fully factorized (mean-field) Gaussian
  ``q(x) = N(mu, diag(exp(log_sd)^2))``;
- :func:`fullrank_advi_fit` — full-rank Gaussian ``q(x) = N(mu, LLᵀ)``
  with a learned Cholesky factor (Stan's ``fullrank`` method).

Where the JAX functions take a PRNG ``key`` these take a
``torch.Generator`` on the device of the parameters.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch

from ..ppl.elbo import gaussian_entropy, meanfield_neg_elbo, normal, scan_vi
from .util import flatten_logp


class ADVIResult(NamedTuple):
    mean: Any  # user pytree — posterior mean of q
    sd: Any  # user pytree — posterior sd of q
    elbo_trace: torch.Tensor  # (num_steps,)
    flat_mean: torch.Tensor
    flat_log_sd: torch.Tensor

    def sample(self, generator: torch.Generator, n: int, unravel) -> Any:
        eps = normal(generator, (n, self.flat_mean.shape[0]), self.flat_mean)
        return unravel(self.flat_mean[None, :] + torch.exp(self.flat_log_sd)[None, :] * eps)


def _stochastic_mean(stochastic_logp_fn, unravel):
    """The doubly stochastic lane's ``E[logp]``: each draw's own
    minibatch estimate, drawn from the generator in turn (a generator
    cannot be threaded through ``vmap``), then their mean."""

    def e_logp_fn(x, generator):
        return torch.stack([stochastic_logp_fn(unravel(xi), generator) for xi in x]).mean()

    return e_logp_fn


def advi_fit(
    logp_fn: Callable[[Any], torch.Tensor],
    init_params: Any,
    *,
    generator: torch.Generator,
    num_steps: int = 2000,
    n_mc: int = 8,
    learning_rate: float = 1e-2,
    init_log_sd: float = -2.0,
    stochastic_logp_fn: Optional[Callable[[Any, torch.Generator], torch.Tensor]] = None,
) -> tuple[ADVIResult, Callable]:
    """Fit mean-field ADVI to ``logp_fn``; returns ``(result, unravel)``.

    ``result.sample(generator, n, unravel)`` draws from the fitted
    approximation in user pytree structure.

    ``stochastic_logp_fn(params, generator) -> scalar`` switches to
    doubly stochastic VI: the MC expectation over q and an unbiased
    minibatch estimate of the logp itself, e.g. ``lambda p, g:
    fed.logp_minibatch(p, g, num_shards=m)``.  ``logp_fn`` still fixes
    the parameter tree.
    """
    flat_logp, flat_init, unravel = flatten_logp(logp_fn, init_params)
    flat_init = flat_init.detach()
    dim = flat_init.shape[0]
    if stochastic_logp_fn is None:
        batch_logp = torch.func.vmap(flat_logp)

        def e_logp_fn(x, _noise):
            return torch.mean(batch_logp(x))

    else:
        e_logp_fn = _stochastic_mean(stochastic_logp_fn, unravel)

    neg_elbo = meanfield_neg_elbo(
        e_logp_fn, dim, n_mc=n_mc, split_keys=stochastic_logp_fn is not None
    )
    var0 = (flat_init, torch.full((dim,), init_log_sd, dtype=flat_init.dtype,
                                  device=flat_init.device))
    (mu, log_sd), elbos = scan_vi(
        neg_elbo, var0, generator=generator, num_steps=num_steps, learning_rate=learning_rate
    )
    result = ADVIResult(
        mean=unravel(mu),
        sd=unravel(torch.exp(log_sd)),
        elbo_trace=elbos,
        flat_mean=mu,
        flat_log_sd=log_sd,
    )
    return result, unravel


class FullRankADVIResult(NamedTuple):
    mean: Any  # user pytree — posterior mean of q
    sd: Any  # user pytree — posterior marginal sds of q
    elbo_trace: torch.Tensor  # (num_steps,)
    flat_mean: torch.Tensor
    flat_chol: torch.Tensor  # (d, d) lower-triangular factor of cov(q)

    @property
    def covariance(self) -> torch.Tensor:
        """(d, d) covariance of the fitted approximation."""
        return self.flat_chol @ self.flat_chol.T

    def sample(self, generator: torch.Generator, n: int, unravel) -> Any:
        eps = normal(generator, (n, self.flat_mean.shape[0]), self.flat_mean)
        return unravel(self.flat_mean[None, :] + eps @ self.flat_chol.T)


def _chol_from_theta(theta, dim, tril_idx):
    """Lower-triangular L from the unconstrained packed vector; the
    diagonal is exp'd for positivity (the standard bijection)."""
    L = torch.zeros((dim, dim), dtype=theta.dtype, device=theta.device).index_put(
        tril_idx, theta
    )
    diag = torch.exp(torch.diagonal(L))
    return L - torch.diag(torch.diagonal(L)) + torch.diag(diag)


def fullrank_neg_elbo(batch_logp, dim, n_mc, tril_idx):
    """The full-rank estimator: ``-(E_q[logp] + H[q])`` at ``(mu,
    theta)`` from ``n_mc`` draws ``mu + L eps``."""

    def neg_elbo(var_params, noise):
        mu, theta = var_params
        L = _chol_from_theta(theta, dim, tril_idx)
        eps = normal(noise, (n_mc, dim), mu)
        x = mu[None, :] + eps @ L.T
        e_logp = torch.mean(batch_logp(x))
        # Σ log L_ii is the full-rank log_sd_sum (shared kernel).
        entropy = gaussian_entropy(dim, torch.sum(torch.log(torch.diagonal(L))))
        return -(e_logp + entropy)

    return neg_elbo


def fullrank_advi_fit(
    logp_fn: Callable[[Any], torch.Tensor],
    init_params: Any,
    *,
    generator: torch.Generator,
    num_steps: int = 3000,
    n_mc: int = 8,
    learning_rate: float = 5e-3,
    init_log_sd: float = -2.0,
) -> tuple[FullRankADVIResult, Callable]:
    """Fit a full-rank Gaussian ``q(x) = N(mu, LLᵀ)`` to ``logp_fn``.

    Same contract as :func:`advi_fit`; the extra d(d-1)/2 off-diagonal
    parameters let q match correlated posteriors exactly (for a Gaussian
    target the optimum is the target).
    """
    flat_logp, flat_init, unravel = flatten_logp(logp_fn, init_params)
    flat_init = flat_init.detach()
    dim = flat_init.shape[0]
    dtype, device = flat_init.dtype, flat_init.device
    tril_idx = tuple(torch.tril_indices(dim, dim, device=device))
    # diag positions within the packed theta vector: entry (i, i) is
    # the last element of packed row i -> index i(i+3)/2.
    rows = torch.arange(dim, device=device)
    diag_pos = (rows * (rows + 3)) // 2

    neg_elbo = fullrank_neg_elbo(torch.func.vmap(flat_logp), dim, n_mc, tril_idx)
    theta0 = torch.zeros((dim * (dim + 1) // 2,), dtype=dtype, device=device)
    theta0[diag_pos] = init_log_sd
    (mu, theta), elbos = scan_vi(
        neg_elbo, (flat_init, theta0), generator=generator, num_steps=num_steps,
        learning_rate=learning_rate,
    )
    L = _chol_from_theta(theta, dim, tril_idx)
    sd = torch.sqrt(torch.sum(L**2, dim=1))
    result = FullRankADVIResult(
        mean=unravel(mu),
        sd=unravel(sd),
        elbo_trace=elbos,
        flat_mean=mu,
        flat_chol=L,
    )
    return result, unravel

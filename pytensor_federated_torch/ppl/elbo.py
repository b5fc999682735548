"""The shared ELBO core every VI lane optimizes through.

Port of the JAX package's ``ppl/elbo.py``: the Gaussian entropy and the
Adam loop (:func:`scan_vi`) that mean-field ADVI, full-rank ADVI and the
RealNVP flow all run.  The JAX loop is one jitted ``lax.scan``; here it
is an eager loop on the device of the variational parameters, one
``torch.autograd`` pass per step.  Adam is written out in optax's update
order, as :func:`..samplers.mcmc.find_map` does, so a run with the same
noise follows the JAX package's to float32 rounding.

Where the JAX estimators take a PRNG key, these take a *noise source*: a
``torch.Generator`` to draw from, or the already-drawn tensor itself (the
JAX draws, in the tests).  Gradients never go through a ``torch.func``
grad transform: the linreg kernel refuses second order, and such a
transform always asks for it.  The estimators evaluate the draws with a
``vmap``-ed forward pass and :func:`scan_vi` takes one first-order
``torch.autograd.grad`` of the loss.
"""

from __future__ import annotations

from typing import Any, Callable, Tuple, Union

import numpy as np
import torch

from ..utils import LOG_2PI, tree_leaves, tree_map

__all__ = [
    "gaussian_entropy",
    "meanfield_draws",
    "meanfield_neg_elbo",
    "scan_vi",
]

Noise = Union[torch.Generator, torch.Tensor]

# optax.adam's defaults: b1, b2, eps (added after the square root of the
# bias-corrected second moment), eps_root 0.
_B1, _B2, _EPS = 0.9, 0.999, 1e-8


def normal(noise: Noise, shape: tuple, like: torch.Tensor) -> torch.Tensor:
    """Standard normal draws of ``shape``: from ``noise`` if it is a
    generator, else ``noise`` itself (which must have that shape)."""
    if isinstance(noise, torch.Tensor):
        if tuple(noise.shape) != tuple(shape):
            raise ValueError(f"injected noise has shape {tuple(noise.shape)}, expected {shape}")
        return noise.to(dtype=like.dtype, device=like.device)
    return torch.randn(shape, generator=noise, dtype=like.dtype, device=like.device)


def gaussian_entropy(dim: int, log_sd_sum: Any = 0.0) -> Any:
    """Closed-form entropy of a ``dim``-dimensional Gaussian with
    ``Σ log σ_i = log_sd_sum``: ``log_sd_sum + dim/2 (1 + log 2π)``.
    With ``log_sd_sum=0`` this is the standard-normal base entropy
    (the flow lane's constant)."""
    return log_sd_sum + 0.5 * dim * (1.0 + LOG_2PI)


def adam_updates(grads, mu, nu, count: int, learning_rate: float, *, b1: float = _B1,
                 b2: float = _B2, eps: float = _EPS, correction_dtype=None):
    """optax Adam's update for step ``count`` over lists of tensors:
    ``(updates, mu, nu)``; the step adds ``updates`` to the parameters.

    optax's order: moments ``(1-b) g + b m``, bias corrections ``1 -
    b**count`` in the gradients' precision (float32, or float64 as
    optax computes them under ``jax_enable_x64``; ``correction_dtype``
    overrides it), ``(m̂ / (sqrt(v̂) + eps))`` scaled by
    ``-learning_rate`` (``-1.0`` gives ``scale_by_adam``'s update)."""
    real = np.float64 if (correction_dtype or grads[0].dtype) == torch.float64 else np.float32
    bc1 = float(1 - real(b1) ** count)
    bc2 = float(1 - real(b2) ** count)
    mu = [(1 - b1) * g + b1 * m for g, m in zip(grads, mu)]
    nu = [(1 - b2) * (g**2) + b2 * v for g, v in zip(grads, nu)]
    updates = [(-learning_rate) * ((m / bc1) / (torch.sqrt(v / bc2) + eps)) for m, v in zip(mu, nu)]
    return updates, mu, nu


def adam_step(params, grads, mu, nu, count: int, learning_rate: float):
    """One optax Adam step over lists of tensors: ``(params, mu, nu)``,
    the :func:`adam_updates` added to ``params``."""
    updates, mu, nu = adam_updates(grads, mu, nu, count, learning_rate)
    return [p + u for p, u in zip(params, updates)], mu, nu


def scan_vi(
    neg_elbo: Callable[[Any, Noise], torch.Tensor],
    var0: Any,
    *,
    generator: torch.Generator,
    num_steps: int,
    learning_rate: float,
) -> Tuple[Any, torch.Tensor]:
    """The whole VI optimization: ``(final_var_params, elbo_trace)``.

    ``neg_elbo(var, generator)`` is any estimator (mean-field, full-rank,
    flow); one step is the loss and its first-order gradient by one
    ``torch.autograd`` pass, then optax's Adam update (the JAX package
    passes ``optax.adam(learning_rate)``; no other optimizer is ported).
    The trace is ``-loss`` per step, kept on the device: no host sync."""
    leaves = [t.detach() for t in tree_leaves(var0)]

    def rebuild(values):
        it = iter(values)
        return tree_map(lambda _: next(it), var0)

    mu = [torch.zeros_like(t) for t in leaves]
    nu = [torch.zeros_like(t) for t in leaves]
    trace = []
    for count in range(1, num_steps + 1):
        live = [t.requires_grad_(True) for t in leaves]
        loss = neg_elbo(rebuild(live), generator)
        grads = torch.autograd.grad(loss, live)
        with torch.no_grad():
            leaves, mu, nu = adam_step(live, grads, mu, nu, count, learning_rate)
        trace.append(-loss.detach())
    return rebuild(leaves), torch.stack(trace)


def meanfield_draws(
    mu: torch.Tensor, log_sd: torch.Tensor, noise: Noise, n_mc: int
) -> torch.Tensor:
    """``n_mc`` reparameterized draws from ``N(mu, diag(exp(log_sd)²))``
    — shape ``(n_mc, dim)``."""
    eps = normal(noise, (n_mc,) + tuple(mu.shape), mu)
    return mu[None, :] + torch.exp(log_sd)[None, :] * eps


def meanfield_neg_elbo(
    e_logp_fn: Callable[[torch.Tensor, Any], torch.Tensor],
    dim: int,
    *,
    n_mc: int,
    split_keys: bool,
) -> Callable[[Tuple[torch.Tensor, torch.Tensor], Noise], torch.Tensor]:
    """Build the mean-field negative-ELBO estimator over a flat
    parameter vector: MC expectation of ``e_logp_fn(x_draws, noise)``
    plus the closed-form Gaussian entropy.

    ``split_keys=False`` gives ``e_logp_fn`` no noise of its own (the
    deterministic-logp lane); ``split_keys=True`` hands it the same
    generator, after the draws (the doubly stochastic, minibatch lane).
    """

    def neg_elbo(var: Tuple[torch.Tensor, torch.Tensor], noise: Noise) -> torch.Tensor:
        mu, log_sd = var
        x = meanfield_draws(mu, log_sd, noise, n_mc)
        return -(e_logp_fn(x, noise if split_keys else None)
                 + gaussian_entropy(dim, torch.sum(log_sd)))

    return neg_elbo

"""Stochastic-gradient Langevin dynamics (Welling & Teh 2011).

Port of the JAX package's ``samplers/sgld.py``: each step consumes an
unbiased stochastic gradient — typically
``FederatedLogp.logp_and_grad_minibatch`` over a random subset of
shards — plus injected Gaussian noise matched to the step size, so the
iterates sample (approximately) from the posterior.  Also preconditioned
SGLD and SGHMC.  No Metropolis correction.

The JAX chain is one ``lax.scan``; here it is an eager loop on the device
of the initial parameters with no host sync.  Where the JAX package
takes a PRNG key these take a ``torch.Generator``; the oracle
``logp_and_grad_fn(params, generator)`` draws its minibatch from the
same generator, before each step's noise.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from .util import ravel


@dataclasses.dataclass
class SGLDResult:
    samples: Any  # pytree, leading axis num_samples
    logps: torch.Tensor  # (num_samples,) stochastic logp estimates
    unravel: Callable[[torch.Tensor], Any]


def polynomial_decay(
    a: float = 1e-3, b: float = 1.0, gamma: float = 0.55
) -> Callable[[Any], Any]:
    """Welling-Teh step schedule ``eps_t = a (b + t)^{-gamma}``
    (gamma in (0.5, 1] satisfies the SGLD convergence conditions)."""

    def schedule(t):
        return a * (b + t) ** (-gamma)

    return schedule


def _as_schedule(step_size):
    """Float-or-callable step size -> ``t -> eps_t`` callable (shared
    contract for every sampler here)."""
    return step_size if callable(step_size) else (lambda t: step_size)


def _step_sizes(step_size, total, like):
    """``eps_t`` for t = 0 .. total-1 as a device tensor; a schedule is
    evaluated on an int32 step counter, as the JAX scan's ``t``."""
    t = torch.arange(total, dtype=torch.int32, device=like.device)
    return torch.as_tensor(_as_schedule(step_size)(t), dtype=like.dtype,
                           device=like.device).expand(total)


def _run_chain(step, carry, oracle, generator, *, num_samples, num_burnin, thin, step_size,
               unravel):
    """Run a Langevin chain and slice out the kept draws.

    ``step(carry, g, eps, z) -> carry`` is the update from the oracle's
    gradient ``g`` at ``carry[0]``, the step size and the noise ``z``; the
    recorded pair is the pre-update iterate with its logp estimate."""
    total = num_burnin + num_samples * thin
    x0 = carry[0]
    eps = _step_sizes(step_size, total, x0)
    xs, lps = [], []
    for t in range(total):
        lp, g = oracle(carry[0], generator)
        z = torch.randn(x0.shape, generator=generator, dtype=x0.dtype, device=x0.device)
        xs.append(carry[0])
        lps.append(lp)
        carry = step(carry, g, eps[t], z)
    keep = torch.stack(xs[num_burnin::thin][:num_samples])
    return SGLDResult(samples=unravel(keep), logps=torch.stack(lps[num_burnin::thin][:num_samples]),
                      unravel=unravel)


def _flat_oracle(logp_and_grad_fn, unravel):
    def oracle(x, generator):
        lp, g = logp_and_grad_fn(unravel(x), generator)
        return torch.as_tensor(lp).detach(), ravel(g)[0].detach()

    return oracle


def sgld_step(carry, g, eps, z):
    """``theta += eps/2 * grad + sqrt(eps) z``."""
    (x,) = carry
    return (x + 0.5 * eps * g + torch.sqrt(eps) * z,)


def psgld_step(carry, g, eps, z, *, beta=0.99, eps_rms=1e-5):
    """RMSProp-preconditioned step: ``V = beta V + (1-beta) g²``, ``G = 1
    / (eps_rms + sqrt(V))``, ``theta += eps/2 G g + sqrt(eps G) z``."""
    x, V = carry
    V = beta * V + (1.0 - beta) * g**2
    G = 1.0 / (eps_rms + torch.sqrt(V))
    return (x + 0.5 * eps * G * g + torch.sqrt(eps * G) * z, V)


def sghmc_step(carry, g, eps, z, *, friction=1.0):
    """``v <- (1 - eps C) v + eps g + sqrt(2 C eps) z``, ``theta += eps v``."""
    x, v = carry
    v = (1.0 - eps * friction) * v + eps * g + torch.sqrt(2.0 * friction * eps) * z
    return (x + eps * v, v)


def sgld_sample(
    logp_and_grad_fn: Callable[[Any, torch.Generator], tuple],
    init_params: Any,
    generator: torch.Generator,
    *,
    num_samples: int = 1000,
    num_burnin: int = 500,
    step_size: Any = 1e-3,
    thin: int = 1,
) -> SGLDResult:
    """Run one SGLD chain.

    ``logp_and_grad_fn(params, generator) -> (logp_estimate,
    grad_estimate)`` is any unbiased stochastic oracle, e.g. ``lambda p,
    g: fed.logp_and_grad_minibatch(p, g, num_shards=8)``, or a
    deterministic value+grad that ignores the generator.  ``step_size``
    is a float or a ``t -> eps_t`` schedule (:func:`polynomial_decay`).
    """
    flat_init, unravel = ravel(init_params)
    return _run_chain(sgld_step, (flat_init.detach(),), _flat_oracle(logp_and_grad_fn, unravel),
                      generator, num_samples=num_samples, num_burnin=num_burnin, thin=thin,
                      step_size=step_size, unravel=unravel)


def psgld_sample(
    logp_and_grad_fn: Callable[[Any, torch.Generator], tuple],
    init_params: Any,
    generator: torch.Generator,
    *,
    num_samples: int = 1000,
    num_burnin: int = 500,
    step_size: Any = 1e-3,
    beta: float = 0.99,
    eps_rms: float = 1e-5,
    thin: int = 1,
) -> SGLDResult:
    """Preconditioned SGLD (Li et al., AAAI 2016): RMSProp-style diagonal
    preconditioning of the Langevin dynamics (the Gamma curvature-drift
    term dropped, as is standard).

    The EMA is warm-started from the init point's squared gradient (one
    extra oracle call, the first draw from ``generator``)."""
    flat_init, unravel = ravel(init_params)
    oracle = _flat_oracle(logp_and_grad_fn, unravel)
    _, g0 = oracle(flat_init.detach(), generator)

    def step(carry, g, eps, z):
        return psgld_step(carry, g, eps, z, beta=beta, eps_rms=eps_rms)

    return _run_chain(step, (flat_init.detach(), g0**2), oracle, generator,
                      num_samples=num_samples, num_burnin=num_burnin, thin=thin,
                      step_size=step_size, unravel=unravel)


def sghmc_sample(
    logp_and_grad_fn: Callable[[Any, torch.Generator], tuple],
    init_params: Any,
    generator: torch.Generator,
    *,
    num_samples: int = 1000,
    num_burnin: int = 500,
    step_size: Any = 1e-3,
    friction: float = 1.0,
    thin: int = 1,
) -> SGLDResult:
    """Stochastic-gradient Hamiltonian Monte Carlo (Chen et al. 2014):
    underdamped Langevin with friction ``C`` and identity mass, the same
    oracle and ``step_size`` contract as :func:`sgld_sample`."""
    flat_init, unravel = ravel(init_params)

    def step(carry, g, eps, z):
        return sghmc_step(carry, g, eps, z, friction=friction)

    x0 = flat_init.detach()
    return _run_chain(step, (x0, torch.zeros_like(x0)), _flat_oracle(logp_and_grad_fn, unravel),
                      generator, num_samples=num_samples, num_burnin=num_burnin, thin=thin,
                      step_size=step_size, unravel=unravel)

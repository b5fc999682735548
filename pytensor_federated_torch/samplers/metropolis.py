"""Gaussian random-walk Metropolis — the reference's CI sampler.

Port of the JAX package's ``samplers/metropolis.py``.  The accept
decision is a ``torch.where`` on the device, so a step needs no host
sync.  The proposal's standard-normal draw and the accept uniform come
from ``generator`` unless given as ``draws=(z, u)``, so that a step can
be held against the JAX one on the same draws.

A leading chain axis steps every chain at once, as ``jax.vmap`` of the
JAX step does: positions ``(C, d)``, a log density ``flat_logp`` that
takes ``(C, d)`` and returns ``(C,)``, and a ``(C,)`` or shared step
size.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from .hmc import _col, normal_like, uniform_like


class MetropolisState(NamedTuple):
    x: torch.Tensor
    logp: torch.Tensor
    n_accept: torch.Tensor


def metropolis_init(flat_logp: Callable, x0: torch.Tensor) -> MetropolisState:
    n_accept = torch.zeros(x0.shape[:-1], dtype=x0.dtype, device=x0.device)
    return MetropolisState(x=x0, logp=flat_logp(x0), n_accept=n_accept)


def metropolis_step(
    flat_logp: Callable,
    state: MetropolisState,
    generator: Optional[torch.Generator],
    *,
    step_size,
    draws: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> MetropolisState:
    if draws is None:
        draws = normal_like(generator, state.x), uniform_like(generator, state.logp)
    z, u = draws
    prop = state.x + _col(step_size, state.x) * z
    logp_prop = flat_logp(prop)
    accept = torch.log(u) < (logp_prop - state.logp)
    return MetropolisState(
        x=torch.where(accept[..., None], prop, state.x),
        logp=torch.where(accept, logp_prop, state.logp),
        n_accept=state.n_accept + accept.to(state.x.dtype),
    )

"""Gaussian random-walk Metropolis — the reference's CI sampler.

Port of the JAX package's ``samplers/metropolis.py``.  The accept
decision is a ``torch.where`` on the device, so a step needs no host
sync.  The proposal's standard-normal draw and the accept uniform come
from ``generator`` unless given as ``draws=(z, u)``, so that a step can
be held against the JAX one on the same draws.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from .hmc import normal_like, uniform_like


class MetropolisState(NamedTuple):
    x: torch.Tensor
    logp: torch.Tensor
    n_accept: torch.Tensor


def metropolis_init(flat_logp: Callable, x0: torch.Tensor) -> MetropolisState:
    return MetropolisState(
        x=x0, logp=flat_logp(x0), n_accept=torch.zeros((), dtype=x0.dtype, device=x0.device)
    )


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
    prop = state.x + step_size * z
    logp_prop = flat_logp(prop)
    accept = torch.log(u) < (logp_prop - state.logp)
    return MetropolisState(
        x=torch.where(accept, prop, state.x),
        logp=torch.where(accept, logp_prop, state.logp),
        n_accept=state.n_accept + accept.to(state.x.dtype),
    )

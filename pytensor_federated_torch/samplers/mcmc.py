"""The sampling front door: warmup adaptation, chains, draws, MAP.

Port of the JAX package's ``samplers/mcmc.py`` (``sample`` with the
NUTS, HMC and Metropolis kernels, and ``find_map``).  The JAX package
runs every chain as one ``vmap`` lane of one jitted ``scan``; here the
chains run one after another, eagerly, on the device of the initial
parameters, each with its own ``torch.Generator`` seeded from the
caller's.  Returned samples keep the params tree with leading
``(chains, draws)`` axes, as in JAX.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from ..utils import value_and_grad
from .hmc import HMCState, find_reasonable_step_size, hmc_init, hmc_step
from .metropolis import metropolis_init, metropolis_step
from .nuts import nuts_step
from .util import (
    AdaptSchedule,
    da_init,
    da_update,
    flatten_logp,
    ravel,
    welford_covariance,
    welford_init,
    welford_update,
    welford_variance,
)


class WarmupResult(NamedTuple):
    state: HMCState
    step_size: torch.Tensor
    inv_mass: torch.Tensor


def make_flat_logp_and_grad(
    logp_fn: Callable[[Any], torch.Tensor],
    init_params: Any,
    logp_and_grad_fn: Optional[Callable] = None,
):
    """Flatten the target and build its value+grad over the flat vector.

    Returns ``(flat_logp, flat_init, unravel, lg)`` where ``lg(x) ->
    (logp, grad)``; with ``logp_and_grad_fn`` (params tree -> ``(logp,
    grads tree)``) the gradient is the one it supplies, else one
    ``torch.autograd`` pass through ``logp_fn``.  A kernel with its own
    gradient (``linreg_logp_grad_fn(...).data_logp``) also enters
    through ``logp_fn`` as an autograd Function.
    """
    flat_logp, flat_init, unravel = flatten_logp(logp_fn, init_params)

    if logp_and_grad_fn is not None:

        def lg(x):
            v, g = logp_and_grad_fn(unravel(x))
            return v, ravel(g)[0]

    else:

        def lg(x):
            return value_and_grad(flat_logp, x)

    return flat_logp, flat_init.detach(), unravel, lg


def make_kernel_step(
    lg: Callable, kernel: str, *, max_depth: int = 8, num_hmc_steps: int = 16
):
    """Gradient-based transition kernel by name ("nuts" or "hmc")."""
    if kernel == "nuts":
        return partial(nuts_step, lg, max_depth=max_depth)
    if kernel == "hmc":
        return partial(hmc_step, lg, num_steps=num_hmc_steps)
    raise ValueError(f"unknown kernel {kernel!r}")


def _warmup(
    logp_and_grad,
    x0,
    generator,
    *,
    num_warmup: int,
    kernel_step,
    target_accept: float = 0.8,
    dense_mass: bool = False,
) -> WarmupResult:
    """Stan-style three-stage warmup: step size + diagonal (or, with
    ``dense_mass``, full-covariance) mass adaptation."""
    dtype, dim, device = x0.dtype, x0.shape[0], x0.device
    sched = AdaptSchedule.make(num_warmup)

    if dense_mass:
        inv_mass = torch.eye(dim, dtype=dtype, device=device)
    else:
        inv_mass = torch.ones((dim,), dtype=dtype, device=device)
    step0 = find_reasonable_step_size(logp_and_grad, x0, generator, inv_mass)
    da = da_init(step0)
    wf = welford_init(dim, dtype, dense=dense_mass, device=device)
    state = hmc_init(logp_and_grad, x0)

    for update_mass, in_slow in zip(sched.update_mass, sched.in_slow):
        state, info = kernel_step(
            state, generator, step_size=torch.exp(da.log_step), inv_mass=inv_mass
        )
        da = da_update(da, info.accept_prob, target=target_accept)
        if in_slow:
            wf = welford_update(wf, state.x)
        if update_mass:
            inv_mass = welford_covariance(wf) if dense_mass else welford_variance(wf)
            # Restart step-size search around the current averaged value.
            da = da_init(torch.exp(da.log_step_avg))
            wf = welford_init(dim, dtype, dense=dense_mass, device=device)
    # With num_warmup=0 no da_update ever ran and log_step_avg is still
    # its zero init — fall back to the found reasonable step size.
    log_step = torch.where(da.count > 0, da.log_step_avg, da.log_step)
    return WarmupResult(state, torch.exp(log_step), inv_mass)


def _stack(values: list, device) -> torch.Tensor:
    """Stack per-draw stats: device tensors as they are, host values
    (the NUTS flags and counts) in one copy."""
    if torch.is_tensor(values[0]):
        return torch.stack(values)
    return torch.tensor(values, device=device)


@dataclasses.dataclass
class SampleResult:
    """Posterior draws plus per-draw diagnostics."""

    samples: Any  # params tree with leading (chains, draws)
    stats: dict  # accept_prob / diverging / energy / depth, (chains, draws)
    step_size: torch.Tensor  # (chains,)
    inv_mass: torch.Tensor  # (chains, dim) — or (chains, dim, dim) dense

    def summary(self, *, hdi_prob: float = 0.94, rank_normalized: bool = False) -> dict:
        """mean/sd/HDI/split-R̂/ESS per component (samplers.convergence)."""
        from .convergence import summary as _summary

        return _summary(self.samples, hdi_prob=hdi_prob, rank_normalized=rank_normalized)


def sample(
    logp_fn: Callable[[Any], torch.Tensor],
    init_params: Any,
    *,
    generator: torch.Generator,
    num_warmup: int = 500,
    num_samples: int = 500,
    num_chains: int = 4,
    kernel: str = "nuts",
    max_depth: int = 8,
    num_hmc_steps: int = 16,
    target_accept: float = 0.8,
    jitter: float = 1.0,
    logp_and_grad_fn: Optional[Callable] = None,
    dense_mass: bool = False,
) -> SampleResult:
    """Run adaptive MCMC against ``logp_fn`` (params tree -> scalar).

    ``kernel`` is ``"nuts"`` (default), ``"hmc"``, or ``"metropolis"``
    (the reference's CI sampler).  Pass ``logp_and_grad_fn`` to supply a
    fused value+grad (e.g. ``FederatedLogp.logp_and_grad``); otherwise
    gradients come from ``torch.autograd`` through ``logp_fn``.
    ``generator`` lives on the device of ``init_params``, where the
    whole run happens; it draws the initial jitter and one seed per
    chain.
    """
    flat_logp, flat_init, unravel, lg = make_flat_logp_and_grad(
        logp_fn, init_params, logp_and_grad_fn
    )
    dtype, device = flat_init.dtype, flat_init.device
    init_flat = flat_init.expand(num_chains, -1)
    if jitter:
        init_flat = init_flat + jitter * torch.randn(
            init_flat.shape, generator=generator, dtype=dtype, device=device
        )
    seeds = torch.randint(
        0, 2**62, (num_chains,), generator=generator, device=device
    ).tolist()
    if kernel == "metropolis":
        return _sample_metropolis(
            flat_logp, unravel, init_flat, seeds, num_warmup, num_samples
        )
    kernel_step = make_kernel_step(
        lg, kernel, max_depth=max_depth, num_hmc_steps=num_hmc_steps
    )

    draws, stats, step_sizes, inv_masses = [], [], [], []
    for x0, seed in zip(init_flat, seeds):
        chain_gen = torch.Generator(device=device).manual_seed(seed)
        warm = _warmup(
            lg,
            x0,
            chain_gen,
            num_warmup=num_warmup,
            kernel_step=kernel_step,
            target_accept=target_accept,
            dense_mass=dense_mass,
        )
        state = warm.state
        xs, chain_stats = [], {"accept_prob": [], "diverging": [], "energy": []}
        if kernel == "nuts":
            chain_stats["depth"] = []
        for _ in range(num_samples):
            state, info = kernel_step(
                state, chain_gen, step_size=warm.step_size, inv_mass=warm.inv_mass
            )
            xs.append(state.x)
            for name, values in chain_stats.items():
                values.append(getattr(info, name))
        draws.append(torch.stack(xs))
        stats.append({k: _stack(v, device) for k, v in chain_stats.items()})
        step_sizes.append(warm.step_size)
        inv_masses.append(warm.inv_mass)

    return SampleResult(
        samples=unravel(torch.stack(draws)),
        stats={k: torch.stack([s[k] for s in stats]) for k in stats[0]},
        step_size=torch.stack(step_sizes),
        inv_mass=torch.stack(inv_masses),
    )


@torch.no_grad()
def _sample_metropolis(flat_logp, unravel, init_flat, seeds, num_warmup, num_samples):
    """Adaptive-scale random-walk Metropolis, one chain after another.

    Warmup adapts the log proposal scale Robbins-Monro style toward 0.35
    acceptance; the scale is a device tensor throughout, so no step
    waits for the host."""
    device = init_flat.device
    draws, totals, scales = [], [], []
    for x0, seed in zip(init_flat, seeds):
        chain_gen = torch.Generator(device=device).manual_seed(seed)
        state = metropolis_init(flat_logp, x0)
        log_scale = torch.zeros((), dtype=init_flat.dtype, device=device)
        for _ in range(num_warmup):
            prev_acc = state.n_accept
            state = metropolis_step(flat_logp, state, chain_gen, step_size=torch.exp(log_scale))
            log_scale = log_scale + 0.1 * ((state.n_accept - prev_acc) - 0.35)
        step_size = torch.exp(log_scale)
        xs, acc = [], []
        for _ in range(num_samples):
            state = metropolis_step(flat_logp, state, chain_gen, step_size=step_size)
            xs.append(state.x)
            acc.append(state.n_accept)
        draws.append(torch.stack(xs))
        totals.append(torch.stack(acc))
        scales.append(step_size)
    return SampleResult(
        samples=unravel(torch.stack(draws)),
        stats={"accept_total": torch.stack(totals)},
        step_size=torch.stack(scales),
        inv_mass=torch.ones_like(init_flat),
    )


def find_map(
    logp_fn: Callable[[Any], torch.Tensor],
    init_params: Any,
    *,
    num_steps: int = 500,
    learning_rate: float = 0.05,
    logp_and_grad_fn: Optional[Callable] = None,
) -> Any:
    """Maximum a-posteriori point via Adam — ``pm.find_MAP`` analog.

    Adam is written out in optax's update order (b1 0.9, b2 0.999, eps
    1e-8 added after the square root of the bias-corrected second
    moment, eps_root 0), so a run follows the JAX package's to float32
    rounding; the bias corrections are float32, computed on the host.
    Runs on the device of ``init_params`` with no host sync per step."""
    b1, b2, eps = 0.9, 0.999, 1e-8
    _, x, unravel, lg = make_flat_logp_and_grad(logp_fn, init_params, logp_and_grad_fn)
    mu = torch.zeros_like(x)
    nu = torch.zeros_like(x)
    for count in range(1, num_steps + 1):
        g = -lg(x)[1]
        mu = (1 - b1) * g + b1 * mu
        nu = (1 - b2) * (g**2) + b2 * nu
        bc1 = float(1 - np.float32(b1) ** count)  # float32 power, as optax's
        bc2 = float(1 - np.float32(b2) ** count)
        update = (mu / bc1) / (torch.sqrt(nu / bc2) + eps)
        x = x + (-learning_rate) * update
    return unravel(x)

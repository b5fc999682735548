"""Tempered Sequential Monte Carlo — massively parallel posterior sampling.

Port of the JAX package's ``samplers/smc.py``: likelihood tempering from
a Gaussian reference fitted to the initial particles,

1. particles ~ init + jitter; ``q0`` = diagonal Gaussian moment-match;
2. anneal ``logp_b(x) = (1-b) log q0(x) + b logp(x)`` from b=0 to b=1;
   each stage picks the next ``b`` by bisection (30 halvings) so the
   effective sample size of the incremental weights stays at
   ``ess_target``;
3. systematic resampling, then ``n_mutations`` random-walk Metropolis
   steps per particle, the proposal scaled by the particle sd.

The JAX package runs the anneal as one ``lax.while_loop`` on device.
Here it is an eager loop: every mutation is one batched evaluation of
all particles (through the linreg kernel, one launch), the bisection
never leaves the device, and the host reads one flag per stage, whether
to go on (``SMCResult.host_syncs`` counts them).  Also returns the log
model evidence estimate.  Where the JAX package takes a PRNG key this
takes a ``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Optional

import torch

from ..utils import LOG_2PI
from .util import flatten_logp

_BISECTIONS = 30


class SMCResult(NamedTuple):
    samples: Any  # user pytree, leaves lead with (n_particles,)
    log_evidence: torch.Tensor  # SMC estimate of log Z
    n_stages: torch.Tensor  # tempering stages actually used
    final_beta: torch.Tensor  # 1.0 on a clean run
    accept_rate: torch.Tensor  # mean mutation acceptance, last stage
    host_syncs: int = 0  # loop-condition reads by the host


def _systematic_indices(u, log_w, n):
    """Systematic resampling from one uniform ``u``: indices with
    expected counts ∝ softmax(log_w)."""
    w = torch.softmax(log_w, dim=0)
    positions = (u + torch.arange(n, dtype=log_w.dtype, device=log_w.device)) / n
    return torch.searchsorted(torch.cumsum(w, dim=0), positions, side="left").clamp(0, n - 1)


def _systematic_resample(generator, log_w, n):
    """Systematic resampling: indices with expected counts ∝ softmax(log_w)."""
    u = torch.rand((), generator=generator, dtype=log_w.dtype, device=log_w.device)
    return _systematic_indices(u, log_w, n)


def _ess(log_w):
    w = torch.softmax(log_w, dim=-1)
    return 1.0 / torch.sum(w**2, dim=-1)


def _next_beta(lp, lq, beta, target):
    """Largest beta' in (beta, 1] keeping the ESS of the incremental
    weights >= ``target``, by 30 bisections (monotone in beta'), on the
    device."""
    diff = lp - lq
    lo, hi = beta, torch.ones_like(beta)
    for _ in range(_BISECTIONS):
        mid = 0.5 * (lo + hi)
        ok = _ess((mid - beta) * diff) >= target
        lo, hi = torch.where(ok, mid, lo), torch.where(ok, hi, mid)
    full = torch.ones_like(beta)
    # If even beta'=1 keeps ESS above target, jump straight to 1.
    return torch.where(_ess((full - beta) * diff) >= target, full, lo)


def _mutation_step(batch_logp, log_q0, x, lp, lq, beta, sd, step_scale, z, u):
    """One random-walk MH step of every particle at temperature
    ``beta`` from its draws ``z`` (n, d) normal and ``u`` (n,) uniform;
    the cached ``(lp, lq)`` are carried, so one batched logp per step."""
    prop = x + step_scale * sd[None, :] * z
    lp_prop, lq_prop = batch_logp(prop), log_q0(prop)
    cur = (1.0 - beta) * lq + beta * lp
    new = (1.0 - beta) * lq_prop + beta * lp_prop
    acc = torch.log(u) < (new - cur)
    return (torch.where(acc[:, None], prop, x), torch.where(acc, lp_prop, lp),
            torch.where(acc, lq_prop, lq), torch.mean(acc.to(x.dtype)))


def _stage(batch_logp, log_q0, state, target, step_scale, u_res, mutation_draws):
    """One tempering stage from its draws: the next temperature, the
    evidence increment, systematic resampling with ``u_res`` and the
    mutations, one ``(z, u)`` pair each."""
    x, lp, lq, beta, log_z = state
    n = x.shape[0]
    beta_new = _next_beta(lp, lq, beta, target)
    dlw = (beta_new - beta) * (lp - lq)
    # Evidence increment: log mean incremental weight.
    log_z = log_z + torch.logsumexp(dlw, dim=0) - math.log(float(n))
    idx = _systematic_indices(u_res, dlw, n)
    # Gather cached logps along with the particles: no re-evaluation.
    x, lp, lq = x[idx], lp[idx], lq[idx]
    sd = torch.std(x, dim=0, correction=0) + 1e-8
    acc_sum = torch.zeros((), dtype=x.dtype, device=x.device)
    for z, u in mutation_draws:
        x, lp, lq, acc = _mutation_step(batch_logp, log_q0, x, lp, lq, beta_new, sd,
                                        step_scale, z, u)
        acc_sum = acc_sum + acc
    return (x, lp, lq, beta_new, log_z), acc_sum / len(mutation_draws)


def make_log_q0(x0):
    """The Gaussian reference moment-matched to the initial cloud, fully
    normalized (the evidence estimate depends on it)."""
    mu0 = torch.mean(x0, dim=0)
    sd0 = torch.std(x0, dim=0, correction=0) + 1e-6

    def log_q0(x):
        return torch.sum(-0.5 * ((x - mu0) / sd0) ** 2 - torch.log(sd0) - 0.5 * LOG_2PI, dim=-1)

    return log_q0


@torch.no_grad()
def smc_sample(
    logp_fn: Callable[[Any], torch.Tensor],
    init_params: Any,
    *,
    generator: torch.Generator,
    n_particles: int = 2048,
    n_mutations: int = 5,
    ess_target: float = 0.5,
    max_stages: int = 50,
    init_jitter: float = 1.0,
    step_scale: float = 0.5,
    logp_and_grad_fn: Optional[Callable] = None,  # accepted for API symmetry
) -> SMCResult:
    """Sample ``logp_fn`` (params tree -> scalar) with tempered SMC.

    The particles are evaluated as one ``vmap`` batch of ``logp_fn``, so
    a stage costs ``n_mutations`` batched evaluations.
    """
    del logp_and_grad_fn
    flat_logp, flat_init, unravel = flatten_logp(logp_fn, init_params)
    dim = flat_init.shape[0]
    dtype, device = flat_init.dtype, flat_init.device
    batch_logp = torch.func.vmap(flat_logp)
    kw = dict(generator=generator, dtype=dtype, device=device)

    x0 = flat_init[None, :] + init_jitter * torch.randn((n_particles, dim), **kw)
    log_q0 = make_log_q0(x0)
    zero = torch.zeros((), dtype=dtype, device=device)
    state = (x0, batch_logp(x0), log_q0(x0), zero, zero)
    accept, stage, syncs = zero, 0, 0
    target = ess_target * n_particles
    while stage < max_stages:
        syncs += 1
        if not bool(state[3] < 1.0):
            break
        u_res = torch.rand((), **kw)
        draws = [(torch.randn((n_particles, dim), **kw), torch.rand((n_particles,), **kw))
                 for _ in range(n_mutations)]
        state, accept = _stage(batch_logp, log_q0, state, target, step_scale, u_res, draws)
        stage += 1

    x, _, _, beta, log_z = state
    return SMCResult(
        samples=unravel(x),
        log_evidence=log_z,
        n_stages=torch.tensor(stage),
        final_beta=beta,
        accept_rate=accept,
        host_syncs=syncs,
    )

"""Parallel tempering (replica exchange) — the multimodal-posterior
sampler.

Port of the JAX package's ``samplers/tempering.py``.  NUTS/HMC mix
within a mode; for well-separated modes the gradient pushes every chain
back to the mode it started in.  Replica exchange runs K replicas of the
SAME posterior at temperatures ``beta_1 = 1 > beta_2 > ... > beta_K``
(flatter tempered targets ``beta * logp``) and proposes swapping
adjacent replicas' states, accepted with the exact Metropolis ratio
``exp((beta_i - beta_j) (U_j - U_i))``: hot replicas cross between modes
and the swaps carry those crossings down to the cold chain, whose draws
stay exactly distributed per the target.

Every replica of every stack advances in lockstep: one HMC update of a
``(chains * temps, dim)`` block per iteration — each leapfrog step one
batched evaluation (:func:`.mcmc.make_batch_logp_and_grad`) — then one
swap pass of gathers over the temperature axis.  The per-rung step
sizes, masses and ladders are ``(chains, temps, ...)`` tensors on the
device; the iteration loop runs on the host with no sync.  Swap
proposals alternate even/odd adjacent pairs.  ``temp_sharding``
partitions one stack's rungs over a mesh axis: each slot's block of
rungs is evaluated on its device, and the swap pass runs where the
gathered block lives.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import numpy as np
import torch

from .mcmc import (
    SampleResult,
    graph_batch_logp_and_grad,
    make_batch_logp_and_grad,
    make_flat_logp_and_grad,
    place_with_sharding,
)
from .util import welford_init, welford_update, welford_variance

__all__ = ["pt_sample"]


def _hmc_step(lg, x, u, g, beta, step, inv_mass, num_leapfrog, z, uniform):
    """One HMC transition of every replica of the TEMPERED target ``beta *
    logp`` (``u``, ``g`` are the UNTEMPERED logp and gradient, so the swap
    ratio can reuse them).  ``inv_mass`` is each replica's diagonal of
    M⁻¹ (hmc.py conventions: momentum ~ N(0, M), kinetic ``0.5 pᵀM⁻¹p``,
    position update ``step * inv_mass * p``).

    Shapes: ``x``, ``g``, ``inv_mass``, ``z`` ``(R, dim)``; ``u``,
    ``beta``, ``step``, ``uniform`` ``(R,)``; ``lg`` maps ``(R, dim)`` to
    ``((R,), (R, dim))``.  The draws are arguments: ``z`` standard
    normal (the momentum is ``z / sqrt(inv_mass)``) and ``uniform`` on
    [0, 1) (accept when below the acceptance probability).  Returns
    ``(x', u', g', accept_prob)``.
    """
    p0 = z / torch.sqrt(inv_mass)
    b, s = beta[:, None], step[:, None]
    xq, pq, uq, gq = x, p0, u, g
    # u rides along: the last leapfrog step already evaluated lg(x1).
    for _ in range(num_leapfrog):
        pq = pq + 0.5 * s * b * gq
        xq = xq + s * inv_mass * pq
        uq, gq = lg(xq)
        pq = pq + 0.5 * s * b * gq
    # Hamiltonian of the tempered target; non-finite energies (a
    # divergence) give acceptance probability 0.
    h0 = -beta * u + 0.5 * torch.sum(p0**2 * inv_mass, dim=-1)
    h1 = -beta * uq + 0.5 * torch.sum(pq**2 * inv_mass, dim=-1)
    log_alpha = h0 - h1
    log_alpha = torch.where(torch.isfinite(log_alpha), log_alpha, -torch.inf)
    accept_prob = torch.clamp(torch.exp(log_alpha), max=1.0)
    take = uniform < accept_prob
    return (
        torch.where(take[:, None], xq, x),
        torch.where(take, uq, u),
        torch.where(take[:, None], gq, g),
        accept_prob,
    )


def _swap_pass(u, betas, uniform, parity: int):
    """Even/odd adjacent swap proposals (all pairs of the given parity at
    once) for every stack.  Exact Metropolis: ``log alpha = (b_i -
    b_{i+1}) * (u_{i+1} - u_i)``.

    ``u``, ``betas`` ``(C, K)``; ``uniform`` ``(C, K-1)`` on [0, 1).
    Returns the induced replica PERMUTATION ``(C, K)`` plus per-pair
    ``accept`` ``(C, K-1)``, ``propose`` ``(K-1,)`` and ``alpha``
    ``(C, K-1)``, the swap probability min(1, e^{log alpha}) that the
    ladder adaptation regresses on; the caller applies the permutation
    to every per-replica tensor."""
    K = u.shape[-1]
    i = torch.arange(K - 1, device=u.device)
    propose = (i % 2) == parity
    log_alpha = (betas[..., :-1] - betas[..., 1:]) * (u[..., 1:] - u[..., :-1])
    alpha = torch.exp(torch.clamp(log_alpha, max=0.0))
    accept = (torch.log(uniform) < log_alpha) & propose
    # perm[i] = i+1 and perm[i+1] = i for each accepted pair.
    perm = torch.arange(K, device=u.device).expand(u.shape).clone()
    perm[..., :-1] = torch.where(accept, perm[..., 1:], perm[..., :-1])
    perm[..., 1:] = torch.where(accept, i, perm[..., 1:])
    return perm, accept, propose, alpha


def pt_sample(
    logp_fn: Callable[[Any], torch.Tensor],
    init_params: Any,
    *,
    generator: torch.Generator,
    num_chains: int = 1,
    num_warmup: int = 500,
    num_samples: int = 500,
    num_temps: int = 8,
    beta_min: float = 0.05,
    num_leapfrog: int = 8,
    target_accept: float = 0.7,
    jitter: float = 1.0,
    logp_and_grad_fn: Optional[Callable] = None,
    temp_sharding: Optional[Any] = None,
    adapt_ladder: bool = False,
    target_swap: float = 0.4,
    adapt_mass: bool = True,
    cuda_graph: bool = False,
) -> SampleResult:
    """Replica-exchange HMC; returns the COLD (beta = 1) chain's draws as a
    :class:`SampleResult` with ``chains = num_chains``.

    ``num_chains`` independent tempering stacks, each with its own
    ladder, masses and step sizes, all ``num_chains * num_temps``
    replicas in one batch.  ``betas`` form a geometric ladder from 1 to
    ``beta_min``.  During warmup each rung's step size adapts by
    Robbins-Monro toward ``target_accept``; replicas start from
    ``init_params`` plus ``jitter``-scaled Gaussian offsets.
    ``logp_and_grad_fn`` forwards node-supplied gradients exactly as in
    :func:`.mcmc.sample`.  ``generator`` (on the device of
    ``init_params``, where the run happens) draws every random number.

    Diagnostics: ``stats["swap_accept"]`` ``(chains, draws)``, the
    fraction of proposed swaps accepted per draw; ``extra`` holds
    ``swap_rate_per_pair`` ``(chains, K-1)``, each rung's swap rate over
    the draw phase, and ``betas`` ``(chains, K)``, the ladder each stack
    used.

    ``adapt_mass=True`` (default) adapts a per-rung DIAGONAL mass from
    each rung's own warmup samples (Welford over the first warmup half
    after a transient buffer), applied for the second half and the
    draws.  ``adapt_ladder=True`` tunes each rung's log-gap during warmup
    toward ``target_swap`` by stochastic approximation, with ``beta_1``
    pinned at 1; the ladder freezes for the draw phase.

    ``temp_sharding`` (a :class:`..parallel.mesh.NamedSharding`, e.g.
    over ``make_mesh({"temps": 4}, ...)``'s ``"temps"`` axis) partitions
    the rungs of ONE stack over the axis's slots: every leapfrog step
    evaluates slot ``j``'s block of rungs on its device, and the swap
    pass's permutation runs on the first slot's device, where the
    gathered ``(temps, dim)`` block and the generator live.  It refuses
    ``num_chains > 1`` (shard one stack's ladder or run replicated
    stacks, not both) and a ``num_temps`` the axis does not divide.

    ``cuda_graph=True`` (CUDA only) replays the replica block's value+grad
    from a CUDA graph, as :func:`.mcmc.sample`'s does: the same draws
    without the evaluation's host dispatch; ``extra["graph_replays"]``
    then counts the replayed evaluations and ``extra["graph"]`` is the
    replay itself.
    """
    if num_temps < 2:
        raise ValueError(
            f"parallel tempering needs >= 2 temperatures, got {num_temps}"
            " (with one, use samplers.sample)"
        )
    if not 0.0 < beta_min < 1.0:
        raise ValueError(
            f"beta_min must be in (0, 1), got {beta_min} (0 or negative "
            "makes the geometric ladder NaN)"
        )
    if num_chains < 1:
        raise ValueError(f"num_chains must be >= 1, got {num_chains}")
    if num_chains > 1 and temp_sharding is not None:
        raise ValueError(
            "num_chains > 1 is incompatible with temp_sharding: shard "
            "one stack's temperature ladder OR run replicated stacks "
            "(vmapped), not both"
        )
    flat_logp, flat_init, unravel, _ = make_flat_logp_and_grad(
        logp_fn, init_params, logp_and_grad_fn
    )
    lg = make_batch_logp_and_grad(flat_logp, unravel, logp_and_grad_fn)
    if temp_sharding is not None:
        flat_init = flat_init.to(temp_sharding.devices[0])
        lg = temp_sharding.map_blocks(lg)
    C, K, dim = num_chains, num_temps, flat_init.shape[0]
    dtype, device = flat_init.dtype, flat_init.device
    kw = dict(dtype=dtype, device=device)
    betas0 = torch.as_tensor(np.geomspace(1.0, beta_min, K), **kw).expand(C, K)
    # Ladder parameterization for adaptation: positive log-beta gaps rho
    # with beta_1 == 1 pinned; log beta_i = -sum_{j<i} rho_j.
    log_rho0 = torch.log(torch.diff(-torch.log(betas0), dim=-1))

    def betas_of(log_rho):
        gaps = torch.cumsum(torch.exp(log_rho), dim=-1)
        return torch.exp(-torch.cat([torch.zeros((C, 1), **kw), gaps], dim=-1))

    def lg_block(x):
        """Value+grad of the ``(C, K, dim)`` replica block, one batch."""
        v, gr = lg(x.reshape(C * K, dim))
        return v.reshape(C, K), gr.reshape(C, K, dim)

    x = flat_init + jitter * torch.randn((C, K, dim), generator=generator, **kw)
    if temp_sharding is not None:
        x = place_with_sharding(x[0], temp_sharding, axis_desc=f"num_temps={num_temps}")[None]
    if cuda_graph:
        lg = graph_batch_logp_and_grad(lg, x.reshape(C * K, dim))
    u, g = lg_block(x)
    # NaN-safe start: a replica jittered into a -inf region would freeze;
    # it restarts from the unjittered point.
    bad = ~torch.isfinite(u)
    x = torch.where(bad[..., None], flat_init, x)
    u, g = lg_block(x)

    log_step = torch.full((C, K), float(np.log(0.1 / dim**0.25)), **kw)
    log_rho = log_rho0
    inv_mass = torch.ones((C, K, dim), **kw)
    wf0 = welford_init(dim, dtype, device=device, batch=(C, K))
    wf = wf0
    t = 0

    def iteration(adapt: bool, collect: bool):
        nonlocal x, u, g, log_step, log_rho, wf, t
        # Without adaptation the ladder is EXACTLY the geometric one.
        betas = betas_of(log_rho) if adapt_ladder else betas0
        z = torch.randn((C * K, dim), generator=generator, **kw)
        uniform = torch.rand((C * K,), generator=generator, **kw)
        xs, us, gs, acc = _hmc_step(
            lg, x.reshape(C * K, dim), u.reshape(C * K), g.reshape(C * K, dim),
            betas.reshape(C * K), torch.exp(log_step).reshape(C * K),
            inv_mass.reshape(C * K, dim), num_leapfrog, z, uniform,
        )
        xs, gs = xs.reshape(C, K, dim), gs.reshape(C, K, dim)
        us, acc = us.reshape(C, K), acc.reshape(C, K)
        if collect:
            wf = welford_update(wf, xs)
        if adapt:
            # Robbins-Monro per-rung step size, eta_t ~ t^-0.6.
            eta = 2.0 / (t + 10.0) ** 0.6
            log_step = log_step + eta * (acc - target_accept)
        perm, accept, propose, alpha = _swap_pass(
            us, betas, torch.rand((C, K - 1), generator=generator, **kw), t % 2
        )
        if adapt_ladder and adapt:
            # Widen rungs that swap too easily, shrink dead ones; only the
            # pairs proposed this parity move, a non-finite alpha counts
            # as a dead rung, and each gap stays within e^±3 of its
            # requested value.
            alpha = torch.where(torch.isfinite(alpha), alpha, 0.0)
            log_rho = torch.clamp(
                log_rho + eta * propose * (alpha - target_swap),
                log_rho0 - 3.0, log_rho0 + 3.0,
            )
        # A swap exchanges WHOLE states: x, u and g permute together.
        x = torch.take_along_dim(xs, perm[..., None], dim=1)
        u = torch.take_along_dim(us, perm, dim=1)
        g = torch.take_along_dim(gs, perm[..., None], dim=1)
        n_prop = max(len(range(t % 2, K - 1, 2)), 1)  # the pairs `propose` marks
        swap_frac = accept.sum(dim=-1).to(dtype) / n_prop
        t += 1
        # acc permutes with the state, so the recorded accept_prob belongs
        # to the transition of the emitted (post-swap) cold draw.
        return x[:, 0], torch.take_along_dim(acc, perm, dim=1)[:, 0], swap_frac, accept, propose

    # Warmup: [init buffer: discard the jittered-start transient] ->
    # [mass window: collect per-rung variance] -> [adapted mass, step
    # sizes re-adapt to it].
    w1 = num_warmup // 2
    w_buf = min(75, w1 // 3) if adapt_mass else 0
    for _ in range(w_buf):
        iteration(adapt=True, collect=False)
    for _ in range(w_buf, w1):
        iteration(adapt=True, collect=adapt_mass)
    if adapt_mass and num_warmup >= 8:
        inv_mass = welford_variance(wf)
        wf = wf0
    for _ in range(w1, num_warmup):
        iteration(adapt=True, collect=False)
    outs = [iteration(adapt=False, collect=False) for _ in range(num_samples)]

    draws = torch.stack([o[0] for o in outs], dim=1)  # (C, S, dim)
    accepts = torch.stack([o[3] for o in outs], dim=1).to(dtype)  # (C, S, K-1)
    proposes = torch.stack([o[4] for o in outs]).to(dtype)  # (S, K-1)
    # Honest per-rung rate: accepted / actually proposed (parity
    # alternation makes the counts differ by one for odd num_samples).
    per_pair = accepts.sum(dim=1) / torch.clamp(proposes.sum(dim=0), min=1.0)
    return SampleResult(
        samples=unravel(draws),
        stats={
            "accept_prob": torch.stack([o[1] for o in outs], dim=1),
            "swap_accept": torch.stack([o[2] for o in outs], dim=1),
        },
        step_size=torch.exp(log_step[:, 0]),
        inv_mass=inv_mass[:, 0],
        extra={
            "swap_rate_per_pair": per_pair,
            "betas": betas_of(log_rho) if adapt_ladder else betas0.clone(),
            **({"graph_replays": lg.calls, "graph": lg} if cuda_graph else {}),
        },
    )

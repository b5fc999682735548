"""The sampling front door: warmup adaptation, chains, draws, MAP.

Port of the JAX package's ``samplers/mcmc.py`` (``sample`` with the
NUTS, HMC and Metropolis kernels, and ``find_map``).  The JAX package
runs every chain as one ``vmap`` lane of one jitted ``scan``; here every
chain runs in one batch too, eagerly, on the device of the initial
parameters: each step is one transition of all chains in lockstep, and
each leapfrog step one value+grad evaluation of all of them
(:func:`make_batch_logp_and_grad`).  Returned samples keep the params
tree with leading ``(chains, draws)`` axes, as in JAX.
"""

from __future__ import annotations

import dataclasses
import gc
import time
from functools import partial
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from ..telemetry import flightrec as _flightrec
from ..telemetry import metrics as _metrics
from ..telemetry import spans as _tspans
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
    ravel_batch,
    welford_covariance,
    welford_init,
    welford_update,
    welford_variance,
)

# Sampler step timing, with the JAX package's metric names and labels.
# A run's wall time is taken after the device has finished it; the
# per-step time is derived from it: wall / (chains * (warmup + draws)).
_SAMPLE_RUN_S = _metrics.histogram(
    "pftpu_sampler_run_seconds",
    "Device wall time of one sample() run (all chains, warmup+draws)",
    ("kernel",),
)
_STEP_S = _metrics.histogram(
    "pftpu_sampler_step_seconds",
    "Derived per-transition time: run wall / (chains * (warmup+draws))",
    ("kernel",),
)
_DRAWS = _metrics.counter(
    "pftpu_sampler_draws_total",
    "Posterior draws produced (chains * num_samples)",
    ("kernel",),
)


def _record_run(kernel, device, t0, num_chains, num_warmup, num_samples):
    """Telemetry-on path only: wait for the device (kernels run
    asynchronously; an un-synced wall time would rate the enqueueing,
    not the run), then record run wall, derived per-transition time, and
    draws.  The run settling is also a sampler phase transition for the
    flight record: an incident dump shows whether the process died
    inside or between sampling runs."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    _SAMPLE_RUN_S.labels(kernel=kernel).observe(wall)
    transitions = num_chains * (num_warmup + num_samples)
    if transitions:
        _STEP_S.labels(kernel=kernel).observe(wall / transitions)
    _DRAWS.labels(kernel=kernel).inc(num_chains * num_samples)
    _flightrec.record(
        "sampler.run",
        kernel=kernel,
        chains=num_chains,
        warmup=num_warmup,
        draws=num_samples,
        wall_s=wall,
    )


class WarmupResult(NamedTuple):
    state: HMCState
    step_size: torch.Tensor  # (C,)
    inv_mass: torch.Tensor  # (C, d) or (C, d, d)


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
    lg = _one_chain_logp_and_grad(flat_logp, unravel, logp_and_grad_fn)
    return flat_logp, flat_init.detach(), unravel, lg


def _one_chain_logp_and_grad(flat_logp, unravel, logp_and_grad_fn):
    if logp_and_grad_fn is not None:

        def lg(x):
            v, g = logp_and_grad_fn(unravel(x))
            return v, ravel(g)[0]

        return lg
    return lambda x: value_and_grad(flat_logp, x)


def make_batch_logp_and_grad(
    flat_logp: Callable,
    unravel: Callable,
    logp_and_grad_fn: Optional[Callable] = None,
) -> Callable:
    """The value+grad of a chain batch: ``lg(X: (C, d)) -> ((C,), (C,
    d))``, one evaluation for every chain.

    Without ``logp_and_grad_fn`` it is ``torch.func.vmap(flat_logp)`` and
    one ``torch.autograd`` pass through the sum of the chains' values:
    the chains are independent, so each chain's gradient of the sum is
    its own.  A kernel under ``flat_logp`` (an autograd Function with a
    vmap rule, such as the linreg kernel's) runs once for the batch.
    With ``logp_and_grad_fn`` (params tree -> ``(logp, grads tree)``) it
    is ``torch.func.vmap`` of that function: a pure-torch one (such as
    ``FederatedLogp.logp_and_grad``) is evaluated once for the batch, a
    host callback once per chain in turn (its vmap rule).

    A batch of one chain skips ``vmap``: the same evaluation without its
    host cost, about 1 ms per call (a NUTS leaf) on the CPU."""
    if logp_and_grad_fn is None:
        batched = torch.func.vmap(flat_logp)

        def lg_batch(x):
            x = x.detach().requires_grad_(True)
            v = batched(x)
            (g,) = torch.autograd.grad(v.sum(), x)
            return v.detach(), g

    else:
        batched = torch.func.vmap(lambda x: logp_and_grad_fn(unravel(x)))

        def lg_batch(x):
            v, g = batched(x)
            return v, ravel_batch(g)

    lg_one = _one_chain_logp_and_grad(flat_logp, unravel, logp_and_grad_fn)

    def lg(x):
        if x.shape[0] == 1:
            v, g = lg_one(x[0])
            return v[None], g[None]
        return lg_batch(x)

    return lg


def graph_batch_logp_and_grad(lg: Callable, example: torch.Tensor) -> Callable:
    """``lg`` (a chain batch's value+grad) captured once in a CUDA graph
    for inputs shaped like ``example`` and replayed on every call.

    A replay runs the kernels of ``lg`` on the new inputs' values (the
    same bits as ``lg`` where those kernels are deterministic), without
    the host dispatch of every operation:
    eager, a GLM family's batched evaluation is ~100-180 launches, each
    ~20-30 µs of host time; a replay is one launch.  Calls with another
    shape or dtype run ``lg`` itself.  ``replay.calls`` counts the
    replays.  Needs CUDA, and an ``lg`` with no host sync and no
    data-dependent shape (the capture refuses both); the linreg kernel's
    launch counter, a host-side count, would see only the capture.
    ``replay.cuda_graph`` is the captured ``torch.cuda.CUDAGraph``, kept
    with its ``cudaGraph_t`` (``keep_graph=True``), so that its nodes —
    the kernels every replay launches — can be read from the graph
    itself."""
    if example.device.type != "cuda":
        raise ValueError("cuda_graph=True needs the chains on a CUDA device")
    static_x = example.detach().clone()
    stream = torch.cuda.current_stream(example.device)
    side = torch.cuda.Stream(device=example.device)
    side.wait_stream(stream)
    with torch.cuda.stream(side):
        for _ in range(3):  # autograd and the allocator settle before the capture
            lg(static_x)
    stream.wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    # An earlier graph that is garbage (``replay`` below is a reference
    # cycle, freed only by the cyclic collector) must not be freed during
    # the capture: its reset there invalidates the capture.  Collect it
    # first and keep the collector off until the capture ends.
    gc.collect()
    gc_was_enabled = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.graph(graph):
            static_v, static_g = lg(static_x)
    finally:
        if gc_was_enabled:
            gc.enable()
    graph.instantiate()

    def replay(x):
        if x.shape != static_x.shape or x.dtype != static_x.dtype:
            return lg(x)
        static_x.copy_(x)
        graph.replay()
        replay.calls += 1
        return static_v.clone(), static_g.clone()

    replay.calls = 0
    replay.cuda_graph = graph
    return replay


def place_with_sharding(x: torch.Tensor, sharding: Any, *, axis_desc: str) -> torch.Tensor:
    """Validate that ``sharding`` (a :class:`..parallel.mesh.NamedSharding`)
    partitions ``x``'s leading axis, and place ``x`` on the first slot's
    device, where the sampler's loop runs — the one validation shared by
    ``sample``, ``chees_sample`` and ``pt_sample``, with the JAX
    package's error text."""
    if sharding is None:
        return x
    try:
        sharding.shard_shape(x.shape)
    except ValueError as e:
        raise ValueError(
            f"{axis_desc} is not shardable by sharding={sharding}: {e} "
            "— the leading dimension must be divisible by the mesh "
            "axis the spec partitions it over"
        ) from None
    return x.to(sharding.devices[0])


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
    """Stan-style three-stage warmup of every chain in ``x0`` (``(C,
    d)``): step size + diagonal (or, with ``dense_mass``, full-covariance)
    mass adaptation, one step size and mass per chain."""
    dtype, (C, dim), device = x0.dtype, x0.shape, x0.device
    sched = AdaptSchedule.make(num_warmup)

    def fresh_welford():
        return welford_init(dim, dtype, dense=dense_mass, device=device, batch=(C,))

    if dense_mass:
        inv_mass = torch.eye(dim, dtype=dtype, device=device).expand(C, dim, dim)
    else:
        inv_mass = torch.ones((C, dim), dtype=dtype, device=device)
    step0 = find_reasonable_step_size(logp_and_grad, x0, generator, inv_mass)
    da = da_init(step0)
    wf = fresh_welford()
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
            wf = fresh_welford()
    # With num_warmup=0 no da_update ever ran and log_step_avg is still
    # its zero init — fall back to the found reasonable step size.
    log_step = torch.where(da.count > 0, da.log_step_avg, da.log_step)
    return WarmupResult(state, torch.exp(log_step), inv_mass)


@dataclasses.dataclass
class SampleResult:
    """Posterior draws plus per-draw diagnostics."""

    samples: Any  # params tree with leading (chains, draws)
    stats: dict  # accept_prob / diverging / energy / depth, (chains, draws)
    step_size: torch.Tensor  # (chains,)
    inv_mass: torch.Tensor  # (chains, dim) — or (chains, dim, dim) dense
    #: sampler-specific diagnostics that are not per draw (ChEES's
    #: adapted trajectory length), kept out of ``stats``, whose every
    #: entry is (chains, draws).
    extra: Optional[dict] = None

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
    cuda_graph: bool = False,
    chain_sharding: Optional[Any] = None,
) -> SampleResult:
    """Run adaptive MCMC against ``logp_fn`` (params tree -> scalar).

    ``kernel`` is ``"nuts"`` (default), ``"hmc"``, or ``"metropolis"``
    (the reference's CI sampler).  Pass ``logp_and_grad_fn`` to supply a
    fused value+grad (e.g. ``FederatedLogp.logp_and_grad``); otherwise
    gradients come from ``torch.autograd`` through ``logp_fn``.

    All ``num_chains`` chains run as one batch: every transition steps
    all of them in lockstep, and every leapfrog step evaluates
    ``logp_fn`` once for all of them, under ``torch.func.vmap``.
    ``generator`` lives on the device of ``init_params``, where the whole
    run happens; it draws the initial jitter and then, step by step, the
    random numbers of every chain at once.  Chain ``c``'s draws therefore
    depend on ``num_chains`` (in the JAX package they do not: each chain
    has its own key).

    ``cuda_graph=True`` (NUTS and HMC on CUDA) captures the chain batch's
    value+grad once in a CUDA graph and replays it for every evaluation
    (:func:`graph_batch_logp_and_grad`): the same evaluations with their
    host dispatch gone; ``result.extra`` then holds ``graph_replays``,
    the batched evaluations replayed, and ``graph``, the replay itself
    (it keeps the graph's memory while the result lives; replaying it
    again, on inputs of the chain batch's shape, re-runs the same
    launches).

    ``chain_sharding`` (a :class:`..parallel.mesh.NamedSharding`, e.g.
    ``NamedSharding(make_mesh({"chains": 2}, devices=...), "chains")``)
    partitions the chain batch over the axis's slots: every batched
    evaluation sends slot ``j``'s block of chains to its device and
    evaluates it there (one vmapped call per slot), and the loop, its
    random draws (``generator`` lives there) and the chains' state stay
    on the first slot's device, wherever ``init_params`` lives.
    ``num_chains`` must be divisible by the axis.  The draws equal an
    unsharded run's wherever a chain's evaluation gives the same bits
    in a block as in the whole batch.
    """
    flat_logp, flat_init, unravel, _ = make_flat_logp_and_grad(logp_fn, init_params)
    if chain_sharding is not None:
        flat_init = flat_init.to(chain_sharding.devices[0])
    dtype, device = flat_init.dtype, flat_init.device
    init_flat = flat_init.expand(num_chains, -1)
    if jitter:
        init_flat = init_flat + jitter * torch.randn(
            init_flat.shape, generator=generator, dtype=dtype, device=device
        )
    init_flat = place_with_sharding(
        init_flat, chain_sharding, axis_desc=f"num_chains={num_chains}"
    )
    if kernel == "metropolis":
        logp = torch.func.vmap(flat_logp)
        if chain_sharding is not None:
            logp = chain_sharding.map_blocks(logp)
        with _tspans.span("mcmc.sample", kernel="metropolis", chains=num_chains):
            t0 = time.perf_counter()
            result = _sample_metropolis(
                logp, unravel, init_flat, generator, num_warmup, num_samples
            )
            if _tspans.enabled():
                _record_run("metropolis", device, t0, num_chains, num_warmup, num_samples)
        return result
    lg = make_batch_logp_and_grad(flat_logp, unravel, logp_and_grad_fn)
    if chain_sharding is not None:
        lg = chain_sharding.map_blocks(lg)
    if cuda_graph:
        lg = graph_batch_logp_and_grad(lg, init_flat)
    kernel_step = make_kernel_step(
        lg, kernel, max_depth=max_depth, num_hmc_steps=num_hmc_steps
    )

    with _tspans.span(
        "mcmc.sample", kernel=kernel, chains=num_chains, warmup=num_warmup, draws=num_samples
    ):
        t0 = time.perf_counter()
        warm = _warmup(
            lg,
            init_flat,
            generator,
            num_warmup=num_warmup,
            kernel_step=kernel_step,
            target_accept=target_accept,
            dense_mass=dense_mass,
        )
        state = warm.state
        names = ["accept_prob", "diverging", "energy"] + (["depth"] if kernel == "nuts" else [])
        xs, stats = [], {name: [] for name in names}
        for _ in range(num_samples):
            state, info = kernel_step(
                state, generator, step_size=warm.step_size, inv_mass=warm.inv_mass
            )
            xs.append(state.x)
            for name, values in stats.items():
                values.append(getattr(info, name))
        result = SampleResult(
            samples=unravel(torch.stack(xs, dim=1)),
            stats={k: torch.stack(v, dim=1) for k, v in stats.items()},
            step_size=warm.step_size,
            inv_mass=warm.inv_mass,
            extra={"graph_replays": lg.calls, "graph": lg} if cuda_graph else None,
        )
        if _tspans.enabled():
            _record_run(kernel, device, t0, num_chains, num_warmup, num_samples)
    return result


@torch.no_grad()
def _sample_metropolis(logp, unravel, init_flat, generator, num_warmup, num_samples):
    """Adaptive-scale random-walk Metropolis, every chain in one batch
    (``logp`` maps ``(C, d)`` to ``(C,)``).

    Warmup adapts each chain's log proposal scale Robbins-Monro style
    toward 0.35 acceptance; the scales are a ``(C,)`` device tensor
    throughout, so no step waits for the host."""
    state = metropolis_init(logp, init_flat)
    log_scale = torch.zeros(init_flat.shape[:1], dtype=init_flat.dtype, device=init_flat.device)
    for _ in range(num_warmup):
        prev_acc = state.n_accept
        state = metropolis_step(logp, state, generator, step_size=torch.exp(log_scale))
        log_scale = log_scale + 0.1 * ((state.n_accept - prev_acc) - 0.35)
    step_size = torch.exp(log_scale)
    xs, acc = [], []
    for _ in range(num_samples):
        state = metropolis_step(logp, state, generator, step_size=step_size)
        xs.append(state.x)
        acc.append(state.n_accept)
    return SampleResult(
        samples=unravel(torch.stack(xs, dim=1)),
        stats={"accept_total": torch.stack(acc, dim=1)},
        step_size=step_size,
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

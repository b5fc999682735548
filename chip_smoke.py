#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one GPU and check it.

    python3 chip_smoke.py                  # every phase
    python3 chip_smoke.py --only kernels   # device, build and kernels
    python3 chip_smoke.py --only federated # device, build, nuts, federated
    python3 chip_smoke.py --only models    # device, build, radon, logistic, lv_ode
    python3 chip_smoke.py --only samplers  # device, build, nuts, wide_logistic,
                                           # logistic, chees
    python3 chip_smoke.py --only slice6    # device, build, lgssm, gp, tempering
    python3 chip_smoke.py --only slice7    # device, build, families, model_check
    python3 chip_smoke.py --only slice8    # device, build, nuts, federated, pool

Run from the root of a checkout on a machine with an NVIDIA H100, the
CUDA toolkit (``nvcc``) and PyTorch built for CUDA.  With no arguments
it runs every phase and needs one card.  Phases, one JSON line each:

1. ``device``  — the card's name and power limit (``nvidia-smi``), the
   peak memory and float32 rates the bounds use, the TF32 settings.
2. ``build``   — every CUDA source of the port built by ``nvcc``, all
   started together, and timed; the ``ptxas -v`` report.
3. ``kernels`` — the kernel against its plain PyTorch version run in
   float64 on the same inputs, at every shape the tests and the main
   path use and at two realistic sizes; padding inertness; bitwise
   identical reruns, and the same bits from a grid capped to a few
   blocks; calls on two streams; CUDA launches per call (profiler);
   times (CUDA events, median; and the kernel's own duration from the
   profiler) beside the bound.  Then the chain axis: C in {1, 4, 16, 64}
   parameter sets against the same data at 8 x 64 and 8 x 131,072, each
   chain against the float64 plain version; each chain's bits in the
   batch equal to the chain called alone (C = 1: to the unbatched call);
   bitwise reruns and capped grids; one launch per call; times beside
   the bound.
4. ``autograd`` — value and gradient of ``prior + data_logp(kernel)`` at
   the flagship size against plain autograd and the sufficient-statistic
   form, at the origin and at a perturbed point; double backward raises.
5. ``nuts``    — ``sample()`` with NUTS on the flagship posterior through
   the kernel, 4 chains x 250 warmup + 250 draws in lockstep: every
   leaf is one batched evaluation of the four chains, and one kernel
   launch (the phase counts both; they must be equal).
6. ``nuts_large`` — the same at 8 x 131,072 observations, so the kernel
   moves real bytes on every leapfrog step: 1 chain x 300 warmup + 300
   draws with a dense mass matrix.  At this size the data pin every
   shard's intercept + offset to ~0.0014 while only the offsets' prior
   places the intercept (sd ~0.1): a ridge ~70x longer than it is wide.
   With a diagonal mass, the split R-hat of the intercept and offsets
   lands above 1.05 for many seeds (as with the JAX package's sampler on
   this posterior); a dense mass adapted over the warmup straightens the
   ridge.  Even then the draws move slowly along it: with 300 draws the
   split R-hat of the intercept and offsets varies around 1.05 from one
   trajectory to the next (a change in the last bits of a sum is enough
   to move it across; with 600 + 600 it read 1.011, with 900 draws
   1.029 on an H100).  The run was 600 + 600 until the families and
   model_check phases needed its time; PERF.md records each run's
   R-hat.
7. ``federated`` — the federation wire.  The kernel is built above,
   before any node starts.  Four node processes (``spawn``) each rebuild
   shards {2i, 2i+1} of the flagship data from its seed, on the card,
   and serve their logp+grad through the kernel with ``serve_tcp_once``,
   one port per size.  A driver on the CPU fans out to them with
   ``ParallelLogpGrad`` and adds the prior.  It checks the remote value
   and gradient against the in-process ones on the card at 8 x 131,072
   (three points, the autograd phase's tolerance); times a remote
   evaluation (median of 50) at 8 x 64 and 8 x 131,072, fanned out and
   with the nodes called in turn; splits one request's time into wire
   and node from the spans the nodes ship back (spans on for that short
   run only); and runs NUTS over the wire at 8 x 64, 1 chain x 150
   warmup + 150 draws, whose means must also lie within 4 combined MCSEs
   of the nuts phase's.  Each node reports its GPU and as many kernel
   launches as requests.
8. ``pool`` — the replica pool and the colocated lanes.  Eight node
   processes (``spawn``), two replicas per group of shards {2g, 2g+1}:
   groups 0-1 serve one replica over shm (``serve_shm``) and one over
   ring (``serve_ring``), groups 2-3 one over shm and one over TCP; each
   node serves ``device_compute_fn(..., batched=True)`` over the kernel
   and runs the HTTP exporter.  The driver (on the CPU) holds one
   ``NodePool`` per group (p2c, a running probe thread) behind a
   ``PooledArraysClient``, fanned out by ``ParallelLogpGrad``.  Gates:
   the federated phase's values at 8 x 131,072 and its NUTS draws (its
   sha256), bit for bit, while group 0's shm replica is SIGKILLed a
   third of the way into the run and restarted on its ports; exactly one
   reply per request; that replica's breaker open, then closed; every
   replica served before the kill; split R-hat < 1.05; windows of W in
   {4, 16, 64} requests through ``evaluate_many`` equal to each request
   alone, bit for bit, with kernel launches equal to the windows each
   node ran and no fallback; ``MicroBatcher`` over the kernel in the
   driver, 64 requests at once, one launch per window, bit for bit;
   a ``FleetCollector`` over the eight exporters whose merged request
   count equals the nodes' own; a watchdog bundle with a ``fleet``
   section; and no ``pftpu-arena-*`` file left once the nodes stop.
   Also printed: ``df`` of the arena directory and the arena size,
   ``os.cpu_count()``, the futex shim and the ring syscall counts, the
   critical path of a short traced run and an SLO burn verdict.
9. ``radon`` — BASELINE.json config 3 (the hierarchical radon GLM, 16
   county shards) on the card: value and gradient at three points against
   the same model in float64 on the CPU; ms per logp+grad evaluation
   (median of 50); NUTS, 1 chain x 300 warmup + 200 draws, its
   evaluation replayed from a CUDA graph (``cuda_graph=True``: the eager
   run's draws, bit for bit, without its host dispatch), with finite
   draws, divergence share < 0.1, |median beta - truth| < 0.3 (the JAX
   package's test gate) and split R-hat < 1.1.
10. ``logistic`` — config 5 (64 shards x 64 observations x 8 features):
   the vmapped, sufficient-statistic and flattened forms behind
   bench_suite's equality gate; the vmapped form, its bf16 compute dtype
   and the hierarchical model against float64 on the CPU; ms per
   evaluation of each form at 64 x 64 x 8 and 64 x 16,384 x 8; then
   config 8 (bench_suite.py:982): NUTS on the vmapped form, 4 chains x
   200 warmup + 200 draws in lockstep, jitter 0.1, one run (bench_suite's
   cold run is an XLA compile, which the port does not have); samples/s
   and min-ESS/s; every
   w and b within 4 sd of the generating values, split R-hat < 1.1
   (and bench_suite's < 1.2).
11. ``lv_ode`` — config 4 (Lotka-Volterra, 8 shards, 128 RK4 steps):
   values against float64 on the CPU; ms (median of 20) and CUDA
   launches (profiler) per logp+grad evaluation; ``find_map`` for 50
   steps on the card against 50 steps in float64 on the CPU.  No NUTS:
   an evaluation is launch-bound at tens of ms.
12. ``wide_logistic`` — config 7 (bench_suite.py:878): the logistic
   regression at 8 shards x 4,096 observations x 512 features (X is 64
   MiB), 64 chains at init + 0.01 N(0, 1), one batched value+grad per
   form (float32 with TF32 off, bf16 compute dtype, float32_strict),
   each chain's value and gradient against the strict form at
   bench_suite's gates; ms per batched evaluation and its share of the
   matching dense peak.
13. ``chees`` — config 9 (bench_suite.py:1050): ChEES-HMC on config 5's
   posterior, 16 chains x 200 warmup + 200 draws, jitter 0.1;
   min-ESS/s against config 8's NUTS of the same run, leapfrog
   gradients/s, the adapted step size and trajectory length; split
   R-hat < 1.2 and finite draws.
14. ``lgssm`` — config 6 (bench_suite.py:814): the linear-Gaussian
   state-space model at T = 4,096 (seed 7, d = 2, k = 1): logp+grad of
   the sequential Kalman filter and of the parallel-in-time one (an
   associative scan), float32 with TF32 off; each against the other and
   against its float64 version on the CPU (value rtol 1e-4; gradient
   rtol 1e-3, atol 1e-4: the JAX tests' tolerances), the parallel
   smoother against the sequential one at T = 512; ms per evaluation of
   each form (the sequential one from its gate call: it is launch-bound,
   ~11 s a call), their ratio, CUDA launches and FLOPs per evaluation
   (the sequential form's counted at T = 32 and 64 and extrapolated:
   linear in T).
15. ``gp`` — config 10 (bench_suite.py:1125): the federated exact GP at 8
   shards x 256 points against float64 on the CPU (value rtol 1e-4,
   gradient 1e-3 |g| + 1e-4 max|g|), one warm evaluation under
   ``torch.cuda.set_sync_debug_mode("error")`` (no host sync); ms, FLOPs
   per evaluation and FLOP/s as a share of the float32 peaks, and the
   rate bench_suite's 5% MFU pass line would need (recorded, not
   gated); the sparse GP with 32 inducing points against float64 (value
   within 1e-4 |logp| + 1e-5 n: a sum of O(n) terms that crosses zero)
   and its ms.
16. ``tempering`` — config 12 (bench_suite.py:1435): parallel tempering
   on a 16-sigma bimodal in 8 dimensions, 2 stacks x 8 temperatures, 500
   warmup + 1,000 draws, against NUTS with 4 chains and jitter 5 at the
   same lengths; each run once after a 20-iteration warm-up run; wall,
   rank-normalized min-ESS/s, max R-hat, per-chain mode-balance error,
   batched evaluations and CUDA launches per iteration; gates PT balance
   < 0.3 and the NUTS control's > 0.35 (bench_suite.py:1555-1558).

17. ``families`` — every GLM family of the port at config 5's shard
   layout, 64 shards x 64 observations x 8 features (bench_suite.py:750):
   Poisson, NB2, ZIP, ZINB, Student-t, Gamma, ordinal (5 categories),
   softmax (4 classes; raw and sufficient-statistic forms), hierarchical
   softmax and Weibull AFT, each from its own generator, and the Gaussian
   mixture (3 components) at 64 shards x 128: value and gradient at three
   points against the same model in float64 on the CPU (where float32
   itself misses the tolerance at a point, within twice the error of the
   model in float32 on the CPU there); ms (median of 30) and CUDA
   launches per logp+grad; the softmax forms behind bench.py's equality
   gate.
18. ``model_check`` — the JAX package's count-family comparison
   (tests/test_model_comparison.py:92) at width 8:
   ``generate_zi_count_data(16, n_obs=256, n_features=8, pi=0.35,
   seed=5)``; Poisson, NB2, ZIP and ZINB each fit by NUTS, 4 chains x 150
   warmup + 150 draws in lockstep; pointwise log-likelihoods (padding
   dropped), PSIS-LOO, WAIC and ``compare``; the top family's posterior
   predictive from 200 draws, its simulated share of zeros beside the
   observed one; the Laplace approximation of ZINB beside its NUTS
   posterior.  Gates: split R-hat < 1.05 on ZIP's and ZINB's slopes and
   own parameters and < 1.2 on their intercept hierarchy (see
   ``RHAT_HIERARCHY``); a zero-inflated family ranks first; Poisson's
   ``d_elpd`` beyond 2 of its ``d_se``; the observed share of zeros
   inside the predictive's central 90%; finite draws.

Phases 9-18 launch no kernel of the port: the JAX package computes
these models outside Pallas, and so does the port.

Then the kernel record line, the ``nvidia-smi`` line and, last, the
device line.  With ``--only kernels`` it stops after the kernels phase,
with ``--only federated`` it runs the nuts and federated phases only,
with ``--only models`` the radon, logistic and lv_ode phases only, with
``--only samplers`` the nuts, wide_logistic, logistic and chees phases
only, with ``--only slice6`` the lgssm, gp and tempering phases only,
with ``--only slice7`` the families and model_check phases only, with
``--only slice8`` the nuts, federated and pool phases only;
none of these prints the kernel record line or the device line.  Any
failed phase makes the script exit non-zero; without
PyTorch, without CUDA, or without the package beside it, it exits
non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import math
import os
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent

# Peak device-memory rate (bytes/s) and float32 rate outside the tensor
# cores (FLOP/s) for the bounds (NVIDIA data sheets, dense).
_PEAK = {"H100 PCIe": (2.0e12, 51e12), "H100 SXM": (3.35e12, 67e12)}
# Float operations per observation in the kernel's inner loop (an FMA
# counts two): the residual 3, z^2 2, ll 4, gmu 2, gx 3, gz 3.
_FLOPS_PER_OBS = 17

# Kernel vs its float64 plain version.  Inputs are float32 and exact in
# float64; the kernel computes each term in float32 (residual error about
# eps * (|y| + |mu|), a few 1e-7 of a term here) and sums at most ~40
# terms deep at these shapes (16 per thread, a fixed tree over the 256
# threads of a tile, at most 8 tile partials per lane, a shuffle tree
# over 32 lanes), so the worst-case error of a sum is ~40 eps ~ 3e-6 of
# the sum of the terms' magnitudes.
TOL = {
    # ll: every term has the same sign, so relative to |ll| itself.
    "ll": ("rel", 2e-5),
    # gx: with the slope off its generating value, m*r*x has a systematic
    # part, so |gx| is a good fraction of sum|m r x| — relative, with room.
    "gx": ("rel", 1e-4),
    # gmu and gz cancel near the mode (sum of residuals, sum of z^2 - 1):
    # absolute, scaled by the sum of the terms' magnitudes.
    "gmu": ("abs_of_sum_abs", 2e-5),
    "gz": ("abs_of_sum_abs", 2e-5),
}
# bench.py's equality gate for logp+grad implementations.
AUTOGRAD_RTOL_VALUE, AUTOGRAD_RTOL_GRAD, AUTOGRAD_ATOL_GRAD = 2e-4, 2e-3, 1e-3

TEST_SHAPES = [(1, 8), (5, 70), (8, 512), (12, 700)]  # tests/test_pallas.py
FLAGSHIP = (8, 64)  # bench.py's flagship size
LARGE_PATH = (8, 131_072)  # the nuts_large phase
REALISTIC = [(8, 1_048_576), (64, 65_536)]
TRUE = {"intercept": 1.5, "slope": 2.0, "sigma": 0.5}
# The federated phase: 4 node processes, node i owning shards {2i, 2i+1};
# timed at both sizes, NUTS over the wire at the flagship size.  Four
# node processes share the one card, and an evaluation over the wire
# costs ~3x one in process: 2 chains x 300 + 300 took 307 s, so the phase
# runs 1 chain x 150 warmup + 150 draws (300 + 300 until the families and
# model_check phases needed its time) and times 50 calls per mode (100
# until the pool phase needed its time), to keep the whole script well
# inside its time limit.
FED_NODES = 4
FED_SIZES = (FLAGSHIP[1], LARGE_PATH[1])
FED_TIMED_CALLS = 50
FED_NUTS = (1, 150, 150)  # chains, warmup, draws
NUTS_LARGE = (1, 300, 300)  # chains, warmup, draws of the nuts_large phase

# BASELINE.json configs 3-5 at bench_suite.py's sizes: radon
# generate_radon_data(16, seed=12) (bench_suite.py:713); Lotka-Volterra
# make_lv_model(8) (bench_suite.py:722); logistic generate_logistic_data(
# n_shards=64, n_obs=64, n_features=8) (bench_suite.py:747), also timed
# at 16,384 observations per shard (X is 32 MiB).
RADON = dict(n_counties=16, seed=12)
LOGISTIC = dict(n_shards=64, n_obs=64, n_features=8)
LOGISTIC_LARGE_OBS = 16_384
LV_SHARDS = 8
MODEL_NUTS = (1, 300, 200)  # chains, warmup, draws (radon)
# A model's float32 value and gradient on the card against the same
# model run in float64 on the CPU.  At these sizes float32 on the CPU
# lands within 4e-7 of float64 on the value and 2e-6 relative on every
# gradient component not near zero; the gates leave ~25x room for the
# card's other summation orders: value rtol 1e-5, gradient within
# 1e-4 |g| + 1e-5 max|g of its leaf|.
MODEL_VALUE_RTOL, MODEL_GRAD_RTOL, MODEL_GRAD_ATOL_OF_MAX = 1e-5, 1e-4, 1e-5
# bf16 compute_dtype against float32 arithmetic: tests/test_mixed_precision.py's band.
BF16_VALUE_RTOL, BF16_GRAD_TOL = 2e-2, 5e-2
# The chain axis of the kernel: C parameter sets against one data set.
KERNEL_CHAINS = (1, 4, 16, 64)
# The flagship nuts phase, in lockstep: chains, warmup, draws (4 x (300 +
# 300) until the pool phase needed its time).
NUTS_FLAGSHIP = (4, 250, 250)
# Config 8 (bench_suite.py:982): NUTS on config 5, 4 chains x 200 + 200,
# jitter 0.1, one run with seed 1 (bench_suite's cold run before it is an
# XLA compile, which the port does not have).
CONFIG8_NUTS = (4, 200, 200)
CONFIG8_JITTER, CONFIG8_SEED = 0.1, 1
# Config 7 (bench_suite.py:878): wide logistic regression, 64 chains in one
# batched evaluation, at init + 0.01 N(0, 1); its gates, anchored on the
# float32_strict form, per chain: value rtol 2e-2, gradient rtol 5e-2 and
# atol 5e-2 max|g| (bench_suite.py:929-939).
WIDE = dict(n_shards=8, n_obs=4096, n_features=512, seed=77)
WIDE_CHAINS, WIDE_JITTER = 64, 0.01
WIDE_VALUE_RTOL, WIDE_GRAD_TOL = 2e-2, 5e-2
WIDE_TIMED_EVALS = 30
# Config 9 (bench_suite.py:1050): ChEES-HMC on config 5, 16 chains.
CONFIG9_CHEES = (16, 200, 200)
CONFIG9_JITTER, CONFIG9_SEED = 0.1, 1
_BF16_PEAK = 989e12  # dense bf16 tensor-core rate of the H100 SXM (data sheet)
LV_FIND_MAP = dict(num_steps=50, learning_rate=0.05)
LV_FIND_MAP_ATOL = 1e-4  # log_theta, card against float64 on the CPU (CPU float32: 7e-8)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def _nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def _peak(name: str) -> tuple[str, float, float]:
    key = "H100 PCIe" if "PCIe" in name else "H100 SXM"
    return (key, *_PEAK[key])


def _bound(S, N, bw, flops, chains=1):
    """Least time (ms) for one call at (S, N) with ``chains`` parameter
    sets, and what sets it: x, y and mask (12 S N bytes) read once, each
    chain's offsets and three scalars read once, each chain's (S, 4)
    result and four totals written once; 17 float operations per
    observation and chain."""
    nbytes = 12 * S * N + chains * (4 * S + 12 + 16 * (S + 1))
    t_bytes = nbytes / bw * 1e3
    t_ops = _FLOPS_PER_OBS * chains * S * N / flops * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), nbytes


def _case(S, N, seed, device):
    """test_pallas.py's inputs at (S, N), made on the device."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((S, N), generator=g, device=device)
    y = 1.0 + 2.0 * x + 0.3 * torch.randn((S, N), generator=g, device=device)
    mask = (torch.rand((S, N), generator=g, device=device) > 0.25).float()
    offsets = torch.randn((S,), generator=g, device=device)
    scalars = torch.tensor([0.7, 1.8, -0.2], device=device)
    return scalars, offsets, x, y, mask


def _errors(got, inputs):
    """Per-output error against the float64 plain version, as the ratio
    to its tolerance (<= 1 passes), and the largest absolute error."""
    from pytensor_federated_torch.ops.linreg_kernel import linreg_reductions_ref

    scalars, offsets, x, y, mask = (t.double() for t in inputs)
    ref = linreg_reductions_ref(scalars, offsets, x, y, mask)
    inv_s2 = torch.exp(-2.0 * scalars[2])
    r = y - ((scalars[0] + offsets[:, None]) + scalars[1] * x)
    sum_abs = {
        "gmu": (mask * r.abs()).sum(1) * inv_s2,
        "gz": (mask * (r * r * inv_s2 - 1.0).abs()).sum(1),
    }
    ratios, max_abs = {}, 0.0
    for name, k, rf in zip(("ll", "gmu", "gx", "gz"), got, ref):
        err = (k.double() - rf).abs()
        max_abs = max(max_abs, float(err.max()))
        kind, tol = TOL[name]
        scale = rf.abs() if kind == "rel" else sum_abs[name]
        ratios[name] = float((err / (tol * scale.clamp_min(1e-30))).max())
    return ratios, max_abs


def _time_ms(fn, flush, *, reps=50):
    """Median of ``reps`` single-call CUDA-event timings, after warm-up.

    Before each call ``flush`` (2 GiB) is rewritten.  That evicts the
    inputs from the 50 MB L2, and the ~0.7 ms the card spends on it
    covers the host's enqueueing of the events and the call, so the
    events time the card's work alone and not a wait for the host."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _card_events(fn, reps, before=None):
    """The profiler's record of what ran on the card during ``reps`` calls
    of ``fn`` (each after ``before()``, if given), after one warm-up call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            if before is not None:
                before()
            fn()
        torch.cuda.synchronize()
    return [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]


def _device_ms(fn, flush, *, reps=30):
    """Median over ``reps`` calls of the card's own time in the kernel
    (the profiler's kernel durations, without the launch and the event
    overhead), with the inputs evicted from L2 before each call."""
    times = [e.device_time for e in _card_events(fn, reps, flush.zero_) if "linreg" in e.name]
    return statistics.median(times) / 1e3 if len(times) == reps else None


def _cuda_launches_per_call(fn, calls=10):
    """Device launches per call of ``fn``, counted by the profiler (the
    kernels, memsets and copies it records on the card), and their
    names; ``None`` when the profiler records no device activity.  A
    profile that recorded nothing at all is taken again, up to 3 times
    in all (the profiler on the GPU host now and then returns an empty
    record; a count of launches that is not zero is never retaken)."""
    for _ in range(3):
        on_card = [e.name for e in _card_events(fn, calls)]
        if on_card:
            return len(on_card) / calls, sorted(set(on_card))
    return None, []


def phase_kernels(bw, flops):
    from pytensor_federated_torch.ops import linreg_kernel
    from pytensor_federated_torch.ops.linreg_kernel import (
        linreg_reductions,
        linreg_reductions_and_totals,
        linreg_reductions_ref,
    )

    dev = torch.device("cuda")
    lib = linreg_kernel._kernel_lib()
    flush = torch.empty(512 * 1024 * 1024, dtype=torch.float32, device=dev)  # 2 GiB
    records, ok = [], True
    shapes = TEST_SHAPES + [FLAGSHIP, LARGE_PATH] + REALISTIC
    for i, (S, N) in enumerate(shapes):
        inputs = _case(S, N, seed=i, device=dev)
        got, totals = linreg_reductions_and_totals(*inputs)
        again = linreg_reductions(*inputs)
        # The same call on a grid capped to 3 blocks: partials are kept per
        # tile and summed in tile order, so the bits must not change.
        capped = linreg_kernel._launch(inputs[0].unbind(), *inputs[1:], max_blocks=3)
        torch.cuda.synchronize()
        bitwise = all(torch.equal(a, b) for a, b in zip(got, again))
        grid_bits = all(torch.equal(a, capped[:S, k]) for k, a in enumerate(got)) and torch.equal(
            totals, capped[S]
        )
        per_shard = torch.stack(got, dim=1).double()
        totals_ok = bool(
            ((totals.double() - per_shard.sum(0)).abs() <= 4e-6 * per_shard.abs().sum(0)).all()
        )
        ratios, max_abs = _errors(got, inputs)
        rec = {
            "shape": [S, N],
            "max_abs_err": max_abs,
            "err_over_tol": ratios,
            "bitwise_rerun": bitwise,
            "bits_equal_capped_grid": grid_bits,
            "totals_ok": totals_ok,
        }
        passed = bitwise and grid_bits and totals_ok and all(v <= 1.0 for v in ratios.values())
        if (S, N) in [FLAGSHIP, LARGE_PATH] + REALISTIC:
            rec["ms"] = _time_ms(lambda: linreg_reductions(*inputs), flush)
            rec["device_ms"] = _device_ms(lambda: linreg_reductions(*inputs), flush)
            rec["plain_ms"] = _time_ms(lambda: linreg_reductions_ref(*inputs), flush)
            rec["bound_ms"], rec["bound_by"], rec["bytes"] = _bound(S, N, bw, flops)
            rec["share_of_bound"] = rec["bound_ms"] / rec["ms"]
        rec["ok"] = passed
        ok &= passed
        records.append(rec)

    # Padding is inert: zero-padded observations and shards (mask 0)
    # change no real shard's result beyond the tolerance and give exact
    # zeros in the padded shards.
    scalars, offsets, x, y, mask = _case(5, 70, seed=100, device=dev)
    pad = lambda t: torch.nn.functional.pad(t, (0, 58, 0, 3))
    got = linreg_reductions(
        scalars, torch.nn.functional.pad(offsets, (0, 3)), pad(x), pad(y), pad(mask)
    )
    ratios, _ = _errors([g[:5] for g in got], (scalars, offsets, x, y, mask))
    pad_ok = all(v <= 1.0 for v in ratios.values()) and all(
        bool((g[5:] == 0).all()) for g in got
    )
    # Rows whose 16-byte alignment differs between x, y and mask take the
    # scalar path.
    storage = torch.empty(5 * 70 + 1, device=dev)
    storage[1:].copy_(x.reshape(-1))
    x_shifted = storage[1:].view(5, 70)
    got = linreg_reductions(scalars, offsets, x_shifted, y, mask)
    ratios_shift, _ = _errors(got, (scalars, offsets, x, y, mask))
    shift_ok = all(v <= 1.0 for v in ratios_shift.values())

    # Back-to-back calls on two streams, free to overlap on the card: each
    # stream keeps its own ticket, so every call gives the bits of a call
    # made alone.
    pair = [_case(*REALISTIC[0], seed=200 + k, device=dev) for k in range(2)]
    want = [linreg_reductions(*args) for args in pair]
    streams = [torch.cuda.Stream(dev) for _ in pair]
    for st in streams:
        st.wait_stream(torch.cuda.current_stream(dev))
    results = [[], []]
    for _ in range(8):
        for k, (st, args) in enumerate(zip(streams, pair)):
            with torch.cuda.stream(st):
                results[k].append(linreg_reductions(*args))
    torch.cuda.synchronize()
    streams_ok = all(
        all(torch.equal(g, w) for g, w in zip(res, want[k]))
        for k in range(2) for res in results[k]
    )

    # CUDA launches per call, from the profiler: of the wrapper, and of the
    # main path's forward (data_logp under no_grad: the kernel alone).
    inputs = _case(*LARGE_PATH, seed=300, device=dev)
    per_call, names = _cuda_launches_per_call(lambda: linreg_reductions(*inputs))
    _, _, kern, _ = _flagship(FLAGSHIP[1])
    params = {"intercept": inputs[0][0], "slope": inputs[0][1], "log_sigma": inputs[0][2],
              "offsets": torch.zeros(8, device=dev)}

    def forward():
        with torch.no_grad():
            kern.data_logp(params)

    per_forward, forward_names = _cuda_launches_per_call(forward)
    launches_ok = per_call == 1 and per_forward == 1
    ok &= pad_ok and shift_ok and streams_ok and launches_ok
    chain_ok, chain_records = _kernel_chains(bw, flops, flush)
    ok &= chain_ok
    return ok, {
        "phase": "kernels",
        "kernel": "linreg_reductions",
        "tolerance": {k: {"kind": v[0], "value": v[1]} for k, v in TOL.items()},
        "totals_tolerance": "4e-6 x sum over shards of |per-shard output| (float64 sum)",
        "tile": lib.linreg_tile(),
        "persistent_blocks": {"one_chain": lib.linreg_persistent_blocks(),
                              "batched": lib.linreg_persistent_blocks_batched()},
        "shapes": records,
        "padding_inert": pad_ok,
        "scalar_path_ok": shift_ok,
        "two_streams_ok": streams_ok,
        "cuda_launches_per_call": per_call,
        "cuda_launches_per_forward": per_forward,
        "device_activity": sorted(set(names) | set(forward_names)),
        "chains": chain_records,
        "bound_note": "the larger of 12*S*N + C*(4*S + 12) bytes read and 16*C*(S+1) written "
                      f"over the peak memory rate and {_FLOPS_PER_OBS}*C*S*N float32 operations "
                      "over the peak float32 rate (C = 1 without a chain axis)",
        "library_ms": None,
        "library_note": "no single PyTorch call computes this function",
    }


def _chain_case(S, N, chains, seed, device):
    """The kernel's inputs at (S, N) with ``chains`` parameter sets near
    test_pallas.py's: scalars (C, 3), offsets (C, S), shared data."""
    scalars, offsets, x, y, mask = _case(S, N, seed, device)
    g = torch.Generator(device=device).manual_seed(seed + 1)
    scalars = scalars + 0.1 * torch.randn((chains, 3), generator=g, device=device)
    offsets = offsets + torch.randn((chains, S), generator=g, device=device)
    return scalars, offsets, x, y, mask


def _kernel_chains(bw, flops, flush):
    """The chain axis: C parameter sets in one launch, at the flagship and
    the large size.  Each chain against the float64 plain version; each
    chain's bits against the same chain called alone (the unbatched call:
    for C = 1 that is the check that C = 1 equals the unbatched call);
    reruns and a capped grid bitwise; launches per call; times."""
    from pytensor_federated_torch.ops import linreg_kernel
    from pytensor_federated_torch.ops.linreg_kernel import (
        linreg_reductions,
        linreg_reductions_and_totals,
        linreg_reductions_ref,
    )

    dev = torch.device("cuda")
    records, ok = [], True
    for S, N in (FLAGSHIP, LARGE_PATH):
        for C in KERNEL_CHAINS:
            inputs = _chain_case(S, N, C, seed=400 + C, device=dev)
            sc, off, x, y, m = inputs
            got, totals = linreg_reductions_and_totals(*inputs)
            again, totals2 = linreg_reductions_and_totals(*inputs)
            capped = linreg_kernel._launch(sc.unbind(-1), off, x, y, m, max_blocks=3)
            torch.cuda.synchronize()
            rerun = all(torch.equal(a, b) for a, b in zip(got + (totals,), again + (totals2,)))
            grid_bits = all(torch.equal(capped[..., :S, k], got[k]) for k in range(4)) and (
                torch.equal(capped[..., S, :], totals))
            alone_bits, worst, max_abs = True, {k: 0.0 for k in TOL}, 0.0
            for c in range(C):
                one, one_totals = linreg_reductions_and_totals(sc[c], off[c], x, y, m)
                alone_bits &= all(torch.equal(a, b[c]) for a, b in zip(one, got)) and (
                    torch.equal(one_totals, totals[c]))
                ratios, err = _errors([g[c] for g in got], (sc[c], off[c], x, y, m))
                worst = {k: max(worst[k], ratios[k]) for k in worst}
                max_abs = max(max_abs, err)
            per_call, _ = _cuda_launches_per_call(lambda: linreg_reductions(*inputs))
            rec = {"shape": [S, N], "chains": C, "max_abs_err": max_abs, "err_over_tol": worst,
                   "bitwise_rerun": rerun, "bits_equal_capped_grid": grid_bits,
                   "bits_equal_chain_alone": alone_bits, "cuda_launches_per_call": per_call}
            rec["ms"] = _time_ms(lambda: linreg_reductions(*inputs), flush)
            rec["device_ms"] = _device_ms(lambda: linreg_reductions(*inputs), flush)
            rec["plain_ms"] = _time_ms(lambda: linreg_reductions_ref(*inputs), flush)
            rec["bound_ms"], rec["bound_by"], rec["bytes"] = _bound(S, N, bw, flops, C)
            rec["share_of_bound"] = rec["bound_ms"] / rec["ms"]
            rec["ok"] = (rerun and grid_bits and alone_bits and per_call == 1
                         and all(v <= 1.0 for v in worst.values()))
            ok &= rec["ok"]
            records.append(rec)
    return ok, records


def _flat_close(a, b, value_rtol=AUTOGRAD_RTOL_VALUE, grad_rtol=AUTOGRAD_RTOL_GRAD,
                grad_atol=AUTOGRAD_ATOL_GRAD):
    """Value and gradient tree ``a`` against ``b`` (bench.py's gate by
    default): value within ``value_rtol |vb|``, each gradient entry within
    ``grad_atol + grad_rtol |gb|``; compared in float64 on the CPU."""
    from pytensor_federated_torch.samplers.util import ravel

    (va, ga), (vb, gb) = a, b
    ga, gb = (ravel(g)[0].detach().cpu().double() for g in (ga, gb))
    v_ok = abs(float(va) - float(vb)) <= value_rtol * abs(float(vb))
    g_ok = bool(((ga - gb).abs() <= grad_atol + grad_rtol * gb.abs()).all())
    rel = abs(float(va) - float(vb)) / abs(float(vb))
    return v_ok and g_ok and math.isfinite(float(va)), {
        "value_rel_err": rel, "grad_max_abs_err": float((ga - gb).abs().max())}


def _flagship(n_obs):
    import pytensor_federated_torch as pft

    data, _ = pft.generate_node_data(8, n_obs=n_obs, seed=123, device="cuda")
    model = pft.FederatedLinearRegression(data)
    (x, y), mask = data.tree()
    kern = pft.linreg_logp_grad_fn(x, y, mask)

    def posterior(p):
        return model.prior_logp(p) + kern.data_logp(p)

    return data, model, kern, posterior


def phase_autograd():
    import pytensor_federated_torch as pft
    from pytensor_federated_torch.samplers.util import ravel
    from pytensor_federated_torch.utils import value_and_grad

    data, model, _, posterior = _flagship(FLAGSHIP[1])
    model_ss = pft.FederatedLinearRegression(data, use_suffstats=True)
    flat0, unravel = ravel(model.init_params())
    flat1 = flat0 + 0.1 * torch.arange(flat0.shape[0], dtype=flat0.dtype, device=flat0.device)
    ok, points = True, []
    for name, flat in (("origin", flat0), ("perturbed", flat1)):
        p = unravel(flat)
        ref = model.logp_and_grad(p)
        k_ok, k_err = _flat_close(value_and_grad(posterior, p), ref)
        s_ok, s_err = _flat_close(model_ss.logp_and_grad(p), ref)
        ok &= k_ok and s_ok
        points.append({"point": name, "kernel_vs_autograd": k_err, "suffstats_vs_autograd": s_err,
                       "ok": k_ok and s_ok})
    try:
        p = {k: v.detach().requires_grad_(True) for k, v in model.init_params().items()}
        torch.autograd.grad(posterior(p), list(p.values()), create_graph=True)
        double_raises = False
    except RuntimeError:
        double_raises = True
    ok &= double_raises
    return ok, {
        "phase": "autograd",
        "size": list(FLAGSHIP),
        "tolerance": {"value_rtol": AUTOGRAD_RTOL_VALUE, "grad_rtol": AUTOGRAD_RTOL_GRAD,
                      "grad_atol": AUTOGRAD_ATOL_GRAD, "source": "bench.py equality gate"},
        "points": points,
        "double_backward_raises": double_raises,
    }


def _recovered(derived):
    """Posterior mean, sd and Monte Carlo standard error (sd / sqrt(ESS))
    of each derived quantity, against its generating value."""
    import pytensor_federated_torch as pft

    ess = pft.samplers.effective_sample_size(derived)
    out = {}
    for k, d in derived.items():
        mean, sd = float(d.mean()), float(d.std())
        out[k] = {"mean": mean, "sd": sd, "ess": float(ess[k]),
                  "mcse": sd / float(ess[k]) ** 0.5, "true": TRUE[k],
                  "within_4sd": abs(mean - TRUE[k]) <= 4 * sd}
    return out


def phase_nuts(name, n_obs, chains, warmup, draws, dense_mass, seed=7):
    import pytensor_federated_torch as pft
    from pytensor_federated_torch.ops.linreg_kernel import linreg_reductions

    _, model, _, posterior = _flagship(n_obs)
    grad_evals = 0

    def counted(p):
        nonlocal grad_evals
        grad_evals += 1
        return posterior(p)

    gen = torch.Generator(device="cuda").manual_seed(seed)
    torch.cuda.synchronize()
    linreg_reductions.launches = 0
    t0 = time.perf_counter()
    res = pft.samplers.sample(
        counted, model.init_params(), generator=gen,
        num_warmup=warmup, num_samples=draws, num_chains=chains, dense_mass=dense_mass,
    )
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = linreg_reductions.launches

    s = res.samples
    derived = {
        "intercept": s["intercept"],
        "slope": s["slope"],
        "sigma": torch.exp(s["log_sigma"]),
    }
    rhat = pft.samplers.split_rhat(s)
    max_rhat = max(float(v.max()) for v in rhat.values())
    recovered = _recovered(derived)
    finite = all(bool(torch.isfinite(v).all()) for v in s.values())
    depth = res.stats["depth"].float()
    # One kernel launch per evaluation of the chain batch (a NUTS leaf):
    # the count of launches must equal the count of batched evaluations.
    ok = (
        launches == grad_evals > 0
        and max_rhat < 1.05
        and finite
        and all(r["within_4sd"] for r in recovered.values())
    )
    return ok, {
        "phase": name,
        "size": [8, n_obs],
        "chains": chains, "warmup": warmup, "draws": draws, "dense_mass": dense_mass,
        "wall_s": wall,
        # Evaluations of the whole chain batch (each one call of the
        # vmapped posterior), and of single chains in them.
        "grad_evals": grad_evals,
        "chain_grad_evals": grad_evals * chains,
        "kernel_launches": launches,
        "launches_per_grad_eval": launches / max(grad_evals, 1),
        "ms_per_grad_eval": wall * 1e3 / max(grad_evals, 1),
        "ms_per_draw": wall * 1e3 / (chains * (warmup + draws)),
        "mean_tree_depth": float(depth.mean()),
        # A lockstep transition runs as many leaves as its deepest chain.
        "mean_max_tree_depth": float(depth.max(dim=0).values.mean()),
        "divergences": int(res.stats["diverging"].sum()),
        "max_split_rhat": max_rhat,
        "recovered": recovered,
        "finite": finite,
    }


def _fed_node(rank, sizes, conn):
    """One federated node process.  It owns shards {2 rank, 2 rank + 1}
    of ``generate_node_data(8, n_obs, seed=123)`` for each size, rebuilt
    here from the seed (the driver never holds data), on the card; it
    serves their logp+grad, one kernel launch per request, on one TCP
    port per size, and answers the parent's commands on ``conn``."""
    sys.path.insert(0, str(ROOT))
    try:
        import threading

        import pytensor_federated_torch as pft
        from pytensor_federated_torch.ops.linreg_kernel import linreg_reductions
        from pytensor_federated_torch.service import _node_metrics, device_compute_fn, serve_tcp_once

        if not torch.cuda.is_available():
            raise RuntimeError(f"node {rank} found no GPU")
        own = slice(2 * rank, 2 * rank + 2)
        ports = {}
        for n_obs in sizes:
            data, _ = pft.generate_node_data(8, n_obs=n_obs, seed=123, device="cpu")
            (x, y), mask = data.tree()
            kern = pft.linreg_logp_grad_fn(*(t[own].to("cuda") for t in (x, y, mask)))

            def node_logp_grad(intercept, slope, log_sigma, offsets, kern=kern):
                logp, g = kern({"intercept": intercept, "slope": slope,
                                "log_sigma": log_sigma, "offsets": offsets})
                return logp, (g["intercept"], g["slope"], g["log_sigma"], g["offsets"])

            compute = device_compute_fn(pft.wrap_logp_grad_fn(node_logp_grad))
            bound = threading.Event()

            def on_ready(port, n_obs=n_obs, bound=bound):
                ports[n_obs] = port
                bound.set()

            threading.Thread(target=serve_tcp_once, args=(compute,), daemon=True,
                             kwargs={"port": 0, "concurrent": True, "ready_callback": on_ready}).start()
            if not bound.wait(60):
                raise RuntimeError(f"node {rank} did not bind a port")
        requests = _node_metrics.REQUESTS.labels(method="evaluate")
        conn.send({"rank": rank, "ports": ports, "device": torch.cuda.get_device_name(),
                   "cuda": str(compute.device)})
        earlier_launches, window_start = 0, requests.value
        while True:
            cmd = conn.recv()
            if cmd == "reset":  # counts to 0 just before a drive
                earlier_launches += linreg_reductions.launches
                linreg_reductions.launches = 0
                window_start = requests.value
            counts = {"window_requests": int(requests.value - window_start),
                      "window_launches": linreg_reductions.launches,
                      "requests": int(requests.value),
                      "launches": earlier_launches + linreg_reductions.launches}
            conn.send(counts)
            if cmd == "stop":
                return
    except Exception:
        conn.send({"error": traceback.format_exc()})


def _fed_ask(conns, cmd, timeout=120.0):
    """Send ``cmd`` to every node and collect one reply from each."""
    for c in conns:
        if cmd is not None:
            c.send(cmd)
    replies = []
    for c in conns:
        if not c.poll(timeout):
            raise TimeoutError(f"a node did not answer {cmd!r} within {timeout} s")
        msg = c.recv()
        if "error" in msg:
            raise RuntimeError(f"a node failed:\n{msg['error']}")
        replies.append(msg)
    return replies


def _remote_posterior(nodes, n_obs, parallel=True):
    """The driver: one TCP client per node, adapted to ``(logp, grads)``,
    fanned out by ``ParallelLogpGrad``; logp = prior + the nodes' sum.
    It runs on the CPU and holds the 11 parameters only.  With
    ``parallel=False`` each node is a ``blackbox_logp_grad`` op called in
    turn (the JAX remote demo's ``--sequential``), which shows what a
    node's request costs while the other nodes are idle."""
    from pytensor_federated_torch.service import TcpArraysClient

    clients = [TcpArraysClient("127.0.0.1", n["ports"][n_obs], timeout_s=120.0) for n in nodes]
    posterior, close_fan = _posterior_over(clients, parallel)

    def close():
        close_fan()
        for c in clients:
            c.close()

    return posterior, close


def _posterior_over(clients, parallel=True):
    """``(posterior, close)``: prior + the sum of the clients' replies,
    client i serving shards {2i, 2i+1}, in client order (so any clients
    that compute the same bits give the same posterior bits)."""
    import pytensor_federated_torch as pft

    def as_logp_grad(client):
        def call(*arrays):
            out = client.evaluate(*arrays)
            return out[0], out[1:]

        return call

    spec = pft.spec_of(*(torch.zeros((), dtype=torch.float32),) * 3,
                       torch.zeros(2, dtype=torch.float32))
    if parallel:
        fan = pft.ParallelLogpGrad([as_logp_grad(c) for c in clients], [spec] * len(clients))
        total = fan.total_logp
    else:
        ops = [pft.blackbox_logp_grad(as_logp_grad(c), spec) for c in clients]
        total = lambda per_node: sum(op.logp(*args) for op, args in zip(ops, per_node))

    def posterior(p):
        per_node = [(p["intercept"], p["slope"], p["log_sigma"], p["offsets"][2 * i:2 * i + 2])
                    for i in range(len(clients))]
        return pft.linreg_prior_logp(p) + total(per_node)

    def close():
        if parallel:
            fan.close()

    return posterior, close


def _wire_split(posterior, p, rounds=8, per_round=8):
    """Driver spans on for a short run: the per-request round trip
    (``rpc.evaluate``) against the node's own time (its shipped
    ``node.evaluate`` span plus the decode before it) and its compute
    (the ``compute`` span), medians in ms."""
    from pytensor_federated_torch.telemetry import reunion, spans
    from pytensor_federated_torch.utils import value_and_grad

    rpc, node, compute = [], [], []
    spans.set_enabled(True)
    try:
        for _ in range(rounds):  # rounds small enough for the trace rings
            spans.clear_traces()
            reunion.clear()
            for _ in range(per_round):
                value_and_grad(posterior, p)
            rpc += [t["duration_s"] for t in spans.recent_traces() if t["name"] == "rpc.evaluate"]
            for t in reunion.remote_traces():
                if t["name"] != "node.evaluate":
                    continue
                node.append(t["duration_s"] + t.get("attrs", {}).get("decode_s", 0.0))
                compute += [c["duration_s"] for c in t.get("children", []) if c["name"] == "compute"]
    finally:
        spans.set_enabled(False)
    med = lambda v: statistics.median(v) * 1e3 if v else None
    return {"requests": len(rpc), "node_spans": len(node), "rpc_ms": med(rpc), "node_ms": med(node),
            "node_compute_ms": med(compute),
            "wire_and_client_ms": med(rpc) - med(node) if rpc and node else None}


def phase_federated(nuts_line, seed=7):
    import multiprocessing as mp

    import pytensor_federated_torch as pft
    from pytensor_federated_torch.samplers.util import ravel
    from pytensor_federated_torch.telemetry import spans
    from pytensor_federated_torch.utils import resolve_device, value_and_grad

    cpu = resolve_device("cpu")  # the driver holds 11 floats
    spans.set_enabled(False)  # on only for the short span run
    ctx = mp.get_context("spawn")
    procs, conns, closers = [], [], []
    try:
        t0 = time.perf_counter()
        for rank in range(FED_NODES):
            parent, child = ctx.Pipe()
            proc = ctx.Process(target=_fed_node, args=(rank, FED_SIZES, child), daemon=True)
            proc.start()
            procs.append(proc)
            conns.append(parent)
        nodes = _fed_ask(conns, None, timeout=300.0)
        spawn_s = time.perf_counter() - t0
        on_card = all(n["cuda"].startswith("cuda") and n["device"] for n in nodes)

        # Values at 8 x 131,072: remote against in-process on the card.
        _, true_offsets = pft.generate_node_data(8, n_obs=8, seed=123, device="cpu")
        init = {k: torch.zeros((8,) if k == "offsets" else (), dtype=torch.float32, device=cpu)
                for k in ("intercept", "slope", "log_sigma", "offsets")}
        flat0, unravel = ravel(init)
        truth = {"intercept": torch.tensor(TRUE["intercept"]), "slope": torch.tensor(TRUE["slope"]),
                 "log_sigma": torch.tensor(math.log(TRUE["sigma"])),
                 "offsets": torch.tensor(true_offsets, dtype=torch.float32)}
        points = {"origin": flat0, "perturbed": flat0 + 0.1 * torch.arange(11, dtype=torch.float32),
                  "truth": ravel(truth)[0]}
        remote, close = _remote_posterior(nodes, LARGE_PATH[1])
        closers.append(close)
        _, _, _, local = _flagship(LARGE_PATH[1])
        values, values_ok = [], True
        for name, flat in points.items():
            rv, rg = value_and_grad(remote, unravel(flat))
            lv, lg = value_and_grad(local, unravel(flat.cuda()))
            ok, err = _flat_close((rv, rg), (lv.cpu(), {k: v.cpu() for k, v in lg.items()}))
            values.append({"point": name, **err, "remote_logp": float(rv),
                           "remote_grad": ravel(rg)[0].tolist(), "ok": ok})
            values_ok &= ok

        # Time per remote evaluation, then the wire/node split from spans:
        # the fan-out, and each node called in turn while the others idle.
        timing = {}
        for n_obs in FED_SIZES:
            timing[f"8x{n_obs}"] = {}
            for mode in ("parallel", "sequential"):
                if n_obs == LARGE_PATH[1] and mode == "parallel":
                    post = remote
                else:
                    post, close = _remote_posterior(nodes, n_obs, parallel=mode == "parallel")
                    closers.append(close)
                for _ in range(20):
                    value_and_grad(post, truth)
                times = []
                for _ in range(FED_TIMED_CALLS):
                    ts = time.perf_counter()
                    value_and_grad(post, truth)
                    times.append(time.perf_counter() - ts)
                timing[f"8x{n_obs}"][mode] = {"calls": FED_TIMED_CALLS,
                                              "ms_per_eval": statistics.median(times) * 1e3,
                                              "spans": _wire_split(post, truth)}
                if n_obs == FLAGSHIP[1] and mode == "parallel":
                    flagship = post

        # NUTS over the wire at the flagship size; node counts from zero.
        _fed_ask(conns, "reset")
        grad_evals = 0

        def counted(p):
            nonlocal grad_evals
            grad_evals += 1
            return flagship(p)

        gen = torch.Generator(device=cpu).manual_seed(seed)
        t0 = time.perf_counter()
        res = pft.samplers.sample(counted, init, generator=gen, num_warmup=FED_NUTS[1],
                                  num_samples=FED_NUTS[2], num_chains=FED_NUTS[0])
        wall = time.perf_counter() - t0
        counts = _fed_ask(conns, "counts")
        s = res.samples
        derived = {"intercept": s["intercept"], "slope": s["slope"], "sigma": torch.exp(s["log_sigma"])}
        max_rhat = max(float(v.max()) for v in pft.samplers.split_rhat(s).values())
        recovered = _recovered(derived)
        local_rec = nuts_line.get("recovered", {})
        for k, r in recovered.items():
            ref = local_rec.get(k)
            if ref is None or "mcse" not in ref:
                r["within_mcse_of_nuts"] = False
                continue
            limit = 4 * (r["mcse"] ** 2 + ref["mcse"] ** 2) ** 0.5
            r["nuts_mean"], r["mcse_limit"] = ref["mean"], limit
            r["within_mcse_of_nuts"] = abs(r["mean"] - ref["mean"]) <= limit
        finite = all(bool(torch.isfinite(v).all()) for v in s.values())
        launches = sum(c["window_launches"] for c in counts)
        per_request = all(c["window_launches"] == c["window_requests"] == grad_evals
                          and c["launches"] == c["requests"] for c in counts)
        ok = (
            on_card and values_ok and per_request and grad_evals > 0 and finite
            and max_rhat < 1.05
            and all(r["within_4sd"] and r["within_mcse_of_nuts"] for r in recovered.values())
        )
        return ok, {
            "phase": "federated",
            "nodes": [{"rank": n["rank"], "device": n["device"], "cuda": n["cuda"],
                       **{k: c[k] for k in ("requests", "launches")}} for n, c in zip(nodes, counts)],
            "spawn_s": spawn_s,
            "tolerance": {"value_rtol": AUTOGRAD_RTOL_VALUE, "grad_rtol": AUTOGRAD_RTOL_GRAD,
                          "grad_atol": AUTOGRAD_ATOL_GRAD, "source": "bench.py equality gate"},
            "values": {"size": list(LARGE_PATH), "points": values},
            "timing": timing,
            "nuts": {"size": list(FLAGSHIP), "chains": FED_NUTS[0], "warmup": FED_NUTS[1],
                     "draws": FED_NUTS[2], "wall_s": wall, "grad_evals": grad_evals,
                     "ms_per_grad_eval": wall * 1e3 / max(grad_evals, 1),
                     "in_process_ms_per_grad_eval": nuts_line.get("ms_per_grad_eval"),
                     "node_requests": [c["window_requests"] for c in counts],
                     "kernel_launches": launches,
                     "one_launch_per_request": per_request,
                     "mean_tree_depth": float(res.stats["depth"].float().mean()),
                     "divergences": int(res.stats["diverging"].sum()),
                     "max_split_rhat": max_rhat, "recovered": recovered, "finite": finite,
                     "draws_sha256": _draws_sha256(s)},
        }
    finally:
        for close in closers:
            close()
        for c in conns:
            try:
                c.send("stop")
            except (OSError, ValueError):
                pass
        for proc in procs:
            proc.join(timeout=30)
            if proc.is_alive():
                proc.kill()
                proc.join()


# The pool phase: 4 groups x 2 replicas (8 node processes), group g
# owning the federated phase's shards {2g, 2g+1}.  Each group's first
# replica serves over shm; the second over ring (groups 0-1) or TCP
# (groups 2-3).  The NUTS run, its draws and its values are the
# federated phase's: the same kernel on the same shards, summed by the
# driver in the same order, so they must agree bit for bit.
POOL_GROUPS = 4
POOL_SECOND_LANE = ("ring", "ring", "tcp", "tcp")
POOL_WINDOWS = (4, 16, 64)  # requests per evaluate_many, one window each
POOL_WINDOW_REPS = 3
POOL_MAX_BATCH = 64  # a node's padded-bucket ladder reaches one whole window
POOL_BATCHER_REQUESTS = 64
POOL_TRACED_EVALS = 16
# Each shm/ring connection maps two arenas.  tmpfs allocates pages as
# they are written, but writing past a full /dev/shm raises SIGBUS, not
# an error: when /dev/shm cannot hold every arena at the default size,
# the nodes map arenas of POOL_SMALL_ARENA bytes instead (a window of 64
# requests at 8 x 131,072 writes ~64 x 5 parameter arrays and as many
# replies, a few tens of kB; the ring's records take 256 kB).
POOL_SMALL_ARENA = 4 << 20
POOL_SLO_P99_S = 0.05
POOL_LANE_CALLS = 200  # timed single requests per lane, at the flagship size


def _pool_node(group, lane, sizes, arena_bytes, ports, dev, conn):
    """One pool replica process.  It owns shards {2 group, 2 group + 1}
    of ``generate_node_data(8, n_obs, seed=123)`` for each size, rebuilt
    here from the seed on ``dev``, served by ``device_compute_fn(...,
    batched=True)`` over the kernel on ``lane`` (one port per size; the
    given ``ports`` when restarted), with the HTTP exporter beside it; it
    answers the driver's commands on ``conn``."""
    sys.path.insert(0, str(ROOT))
    try:
        import threading

        import numpy as np

        import pytensor_federated_torch as pft
        from pytensor_federated_torch.ops.linreg_kernel import linreg_reductions
        from pytensor_federated_torch.service import (
            _node_metrics, batching, device_compute_fn, ring, serve_ring, serve_shm, serve_tcp_once,
        )
        from pytensor_federated_torch.telemetry import export

        if dev == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"pool node {group}/{lane} found no GPU")
        ports = dict(ports or {})
        own = slice(2 * group, 2 * group + 2)
        window_sizes, computes = [], {}
        for n_obs in sizes:
            data, _ = pft.generate_node_data(8, n_obs=n_obs, seed=123, device="cpu")
            (x, y), mask = data.tree()
            kern = pft.linreg_logp_grad_fn(*(t[own].to(dev) for t in (x, y, mask)))

            def node_logp_grad(intercept, slope, log_sigma, offsets, kern=kern):
                logp, g = kern({"intercept": intercept, "slope": slope,
                                "log_sigma": log_sigma, "offsets": offsets})
                return logp, (g["intercept"], g["slope"], g["log_sigma"], g["offsets"])

            compute = device_compute_fn(pft.wrap_logp_grad_fn(node_logp_grad), device=dev,
                                        batched=True, max_batch=POOL_MAX_BATCH)

            def recorded(requests, batch=compute.batch):
                window_sizes.append(len(requests))  # one window, one kernel launch
                return batch(requests)

            compute.batch = recorded
            computes[n_obs] = compute
        # A process's first vmapped call is slow (~1-2 s): pay it here, in
        # parallel with the other nodes' start, at every window shape the
        # windows part sends (a batch frame carries at most 32 requests).
        probe = (np.float32(1.5), np.float32(2.0), np.float32(-0.7), np.zeros(2, np.float32))
        for w in sorted({min(w, 32) for w in POOL_WINDOWS}):
            computes[sizes[-1]].batch([probe] * w)
        evaluate = _node_metrics.REQUESTS.labels(method="evaluate")
        kinds = {k: batching._BATCHES.labels(kind=k) for k in ("vmapped", "single", "serial",
                                                               "fallback")}

        def now():
            return {"evaluate": evaluate.value, "launches": linreg_reductions.launches,
                    "sizes": len(window_sizes), **{k: v.value for k, v in kinds.items()}}

        base = now()  # before any port is bound: every request served counts
        serve, kw = {"shm": (serve_shm, {"arena_bytes": arena_bytes}),
                     "ring": (serve_ring, {"arena_bytes": arena_bytes}),
                     "tcp": (serve_tcp_once, {})}[lane]
        for n_obs, compute in computes.items():
            bound = threading.Event()

            def on_ready(port, n_obs=n_obs, bound=bound):
                ports[n_obs] = port
                bound.set()

            threading.Thread(target=serve, args=(compute,), daemon=True,
                             kwargs={"port": ports.get(n_obs, 0), "ready_callback": on_ready,
                                     "concurrent": True, **kw}).start()
            if not bound.wait(60):
                raise RuntimeError(f"pool node {group}/{lane} did not bind a port")
        exporter = export.start_exporter(port=ports.get("exporter", 0))
        ports["exporter"] = exporter.port
        conn.send({"group": group, "lane": lane, "ports": ports, "pid": os.getpid(),
                   "device": torch.cuda.get_device_name() if dev == "cuda" else "cpu",
                   "cuda": str(compute.device)})
        while True:
            cmd = conn.recv()
            if cmd == "reset":  # counts to 0 just before a drive
                base = now()
            cur = now()
            served = export.snapshot()["metrics"].get("pftpu_server_requests_total", {})
            conn.send({
                "requests": int(cur["evaluate"] - base["evaluate"]),
                "launches": cur["launches"] - base["launches"],
                "windows": {k: int(cur[k] - base[k]) for k in kinds},
                "window_sizes": window_sizes[base["sizes"]:],
                "requests_total": sum(c["value"] for c in served.get("children", [])),
                "launches_total": linreg_reductions.launches,
                "syscalls": ring.syscall_counts() if lane == "ring" else None,
            })
            if cmd == "stop":
                exporter.close()
                return
    except Exception:
        conn.send({"error": traceback.format_exc()})


def _arena_budget(n_connections):
    """``(arena_bytes, report)``: the default arena size when /dev/shm
    can hold every connection's two arenas at it, else the small one."""
    from pytensor_federated_torch.service.arena import DEFAULT_ARENA_BYTES, arena_dir

    where = arena_dir()
    df = subprocess.run(["df", "-B1", where], capture_output=True, text=True, timeout=30).stdout
    free = os.statvfs(where)
    avail = free.f_bavail * free.f_frsize
    need = 2 * n_connections * DEFAULT_ARENA_BYTES
    arena_bytes = DEFAULT_ARENA_BYTES if avail >= 2 * need else POOL_SMALL_ARENA
    return arena_bytes, {"arena_dir": where, "df": df.strip().splitlines()[-1:], "avail_bytes": avail,
                         "connections": n_connections, "default_need_bytes": need,
                         "arena_bytes": arena_bytes}


def _arena_files(since):
    from pytensor_federated_torch.service.arena import arena_dir

    out = []
    for p in Path(arena_dir()).glob("pftpu-arena-*"):
        try:
            if p.stat().st_mtime >= since:
                out.append(p.name)
        except FileNotFoundError:
            pass
    return out


def _lane_client(lane, port):
    from pytensor_federated_torch.service import RingArraysClient, ShmArraysClient, TcpArraysClient

    cls = {"shm": ShmArraysClient, "ring": RingArraysClient, "tcp": TcpArraysClient}[lane]
    return cls("127.0.0.1", port, timeout_s=120.0)


def _median_ms(fn, calls, warm=10):
    for _ in range(warm):
        fn()
    times = []
    for _ in range(calls):
        ts = time.perf_counter()
        fn()
        times.append(time.perf_counter() - ts)
    return statistics.median(times) * 1e3


def _flat_bits(value, grads):
    from pytensor_federated_torch.samplers.util import ravel

    return [float(value)] + ravel(grads)[0].tolist()


def phase_pool(fed_line, dev="cuda", nuts=FED_NUTS, sizes=FED_SIZES, windows=POOL_WINDOWS, seed=7):
    import asyncio
    import multiprocessing as mp
    import tempfile
    import threading

    import numpy as np

    import pytensor_federated_torch as pft
    from pytensor_federated_torch.ops.linreg_kernel import linreg_reductions
    from pytensor_federated_torch.routing import NodePool, PooledArraysClient
    from pytensor_federated_torch.samplers.util import ravel
    from pytensor_federated_torch.service import MicroBatcher, device_compute_fn, ring
    from pytensor_federated_torch.telemetry import (
        BurnRateEngine, FleetCollector, Slo, critpath, reunion, spans, watchdog,
    )
    from pytensor_federated_torch.utils import resolve_device, value_and_grad

    t_phase = time.time() - 1.0
    cpu = resolve_device("cpu")
    spans.set_enabled(False)  # on only for the short traced run
    small, large = sizes
    lanes = [(g, lane) for g in range(POOL_GROUPS) for lane in ("shm", POOL_SECOND_LANE[g])]
    n_arena_conns = 2 * sum(lane != "tcp" for _, lane in lanes) + 2  # both sizes, and a restart
    arena_bytes, arena = _arena_budget(n_arena_conns)
    ctx = mp.get_context("spawn")
    procs, conns, nodes, pools, closers = {}, {}, {}, [], []
    victim = (0, "shm")
    marks = {}  # seconds from the phase's start to the end of each part

    def mark(name):
        marks[name] = time.perf_counter() - t0

    def start_node(key, ports=None):
        parent, child = ctx.Pipe()
        proc = ctx.Process(target=_pool_node, args=(*key, sizes, arena_bytes, ports, dev, child),
                           daemon=True)
        proc.start()
        procs[key], conns[key] = proc, parent

    def ask(keys, cmd, timeout=120.0):
        return dict(zip(keys, _fed_ask([conns[k] for k in keys], cmd, timeout)))

    try:
        t0 = time.perf_counter()
        for key in lanes:
            start_node(key)
        nodes.update(ask(lanes, None, timeout=300.0))
        spawn_s = time.perf_counter() - t0
        mark("spawn")
        on_card = all(n["cuda"].startswith(dev) for n in nodes.values())
        on_kernel = dev == "cuda"  # on the CPU the wrapper runs the plain version: no launches

        def make_pools(n_obs):
            out = []
            for g in range(POOL_GROUPS):
                # The default policy (p2c); a breaker trips on the first
                # failed call or probe, so the kill shows at once.
                pool = NodePool(transport="tcp", breaker_kwargs={"failure_threshold": 1})
                for key in lanes:
                    if key[0] == g:
                        pool.add_replica("127.0.0.1", nodes[key]["ports"][n_obs], transport=key[1],
                                         client_kwargs={"timeout_s": 120.0})
                pool.start()  # the probe thread
                pools.append(pool)
                out.append(pool)
            return out

        small_pools, large_pools = make_pools(small), make_pools(large)
        replies = [0] * POOL_GROUPS

        class Counted:
            """A group's pooled client, counting the replies it returns."""

            def __init__(self, g, client):
                self.g, self.client = g, client

            def evaluate(self, *arrays):
                out = self.client.evaluate(*arrays)
                replies[self.g] += 1
                return out

        small_clients = [Counted(g, PooledArraysClient(p)) for g, p in enumerate(small_pools)]
        large_clients = [PooledArraysClient(p) for p in large_pools]

        # Values at 8 x 131,072: the federated phase's points, bit for bit.
        fed_points = {v["point"]: v for v in fed_line.get("values", {}).get("points", [])}
        init = {k: torch.zeros((8,) if k == "offsets" else (), dtype=torch.float32, device=cpu)
                for k in ("intercept", "slope", "log_sigma", "offsets")}
        flat0, unravel = ravel(init)
        _, true_offsets = pft.generate_node_data(8, n_obs=8, seed=123, device="cpu")
        truth = {"intercept": torch.tensor(TRUE["intercept"]), "slope": torch.tensor(TRUE["slope"]),
                 "log_sigma": torch.tensor(math.log(TRUE["sigma"])),
                 "offsets": torch.tensor(true_offsets, dtype=torch.float32)}
        points = {"origin": flat0, "perturbed": flat0 + 0.1 * torch.arange(11, dtype=torch.float32),
                  "truth": ravel(truth)[0]}
        large_post, close = _posterior_over(large_clients)
        closers.append(close)
        values = []
        for name, flat in points.items():
            bits = _flat_bits(*value_and_grad(large_post, unravel(flat)))
            ref = fed_points.get(name, {})
            want = [ref.get("remote_logp")] + list(ref.get("remote_grad", []))
            values.append({"point": name, "logp": bits[0], "bit_equal": bits == want})
        values_ok = len(values) == 3 and all(v["bit_equal"] for v in values)

        mark("values")
        # NUTS through the pools; SIGKILL group 0's shm replica a third of
        # the way in and restart it on the same ports.
        small_post, close = _posterior_over(small_clients)
        closers.append(close)
        victim_replica = small_pools[0].replica_at("127.0.0.1", nodes[victim]["ports"][small])
        breaker_log = []
        notify = victim_replica.breaker._on_transition

        def on_transition(old, new):
            breaker_log.append((round(time.perf_counter() - t0, 3), old, new))
            notify(old, new)

        victim_replica.breaker._on_transition = on_transition
        kill_at = max(1, int(fed_line.get("nuts", {}).get("grad_evals") or 5_651) // 3)
        ask(lanes, "reset")
        replies[:] = [0] * POOL_GROUPS
        grad_evals, before_kill, restart = 0, {}, {}

        def restart_victim():
            try:
                start_node(victim, nodes[victim]["ports"])
                restart.update(ask([victim], None, timeout=300.0)[victim])
            except Exception:
                restart["error"] = traceback.format_exc()

        def counted(p):
            nonlocal grad_evals
            grad_evals += 1
            if grad_evals == kill_at:
                before_kill.update(ask(lanes, "counts"))
                restart["killed_at_s"] = time.perf_counter() - t0
                procs[victim].kill()  # SIGKILL: no shutdown, no unlink
                procs[victim].join(timeout=30)
                restart["thread"] = threading.Thread(target=restart_victim, daemon=True)
                restart["thread"].start()
            return small_post(p)

        gen = torch.Generator(device=cpu).manual_seed(seed)
        t_nuts = time.perf_counter()
        res = pft.samplers.sample(counted, init, generator=gen, num_warmup=nuts[1],
                                  num_samples=nuts[2], num_chains=nuts[0])
        nuts_wall = time.perf_counter() - t_nuts
        nuts_replies = list(replies)
        thread = restart.pop("thread", None)
        if thread is not None:
            thread.join(timeout=300)
        if "error" in restart:
            raise RuntimeError(f"the restarted node failed:\n{restart['error']}")
        after = ask(lanes, "counts")
        # The restarted replica's breaker closes (the probe thread or a call).
        deadline = time.perf_counter() + 60
        while victim_replica.breaker.state != "closed" and time.perf_counter() < deadline:
            value_and_grad(small_post, truth)
            time.sleep(0.05)
        s = res.samples
        max_rhat = max(float(v.max()) for v in pft.samplers.split_rhat(s).values())
        sha = _draws_sha256(s)
        served_before_kill = {f"{g}/{lane}": c["requests"] for (g, lane), c in before_kill.items()}
        # Node-side launches and requests: the victim's up to its kill,
        # everyone's (the restarted victim's from its start) after.
        node_requests = sum(c["requests"] for c in after.values()) + before_kill.get(victim, {}).get(
            "requests", 0)
        nuts_launches = sum(c["launches"] for c in after.values()) + before_kill.get(victim, {}).get(
            "launches", 0)
        # Open, then closed again: by a half-open trial call, or by a
        # probe of the restarted node (the probe thread closes an open
        # breaker whose node answers).
        states = [new for _, _, new in breaker_log]
        breaker_ok = ("open" in states and "closed" in states[states.index("open"):]
                      and victim_replica.breaker.state == "closed")
        # Exactly one reply per request, and each request computed once:
        # at the driver, every group's client returned one reply per
        # evaluation; at the nodes, the group's replicas served as many.
        one_reply = (all(r == grad_evals for r in nuts_replies) and grad_evals > 0
                     and node_requests == POOL_GROUPS * grad_evals)
        nuts_ok = (
            sha == fed_line.get("nuts", {}).get("draws_sha256") and one_reply and breaker_ok
            and len(before_kill) == len(lanes) and all(v >= 1 for v in served_before_kill.values())
            and max_rhat < 1.05 and (nuts_launches == node_requests or not on_kernel)
        )

        mark("nuts")
        # Windows at 8 x 131,072: W parameter sets per evaluate_many, each
        # reply against the same request alone; launches against windows.
        rng = np.random.default_rng(seed)
        window_reqs = {
            w: [(np.float32(1.5 + 0.1 * rng.normal()), np.float32(2.0 + 0.1 * rng.normal()),
                 np.float32(math.log(0.5) + 0.05 * rng.normal()),
                 (true_offsets + 0.05 * rng.normal(size=8)).astype(np.float32))
                for _ in range(w)] for w in windows}
        ask(lanes, "reset")
        window_ms, window_out = {}, {}
        for w, reqs in window_reqs.items():
            times = []
            for _ in range(POOL_WINDOW_REPS):
                for g, client in enumerate(large_clients):
                    share = [(a, b, c, o[2 * g:2 * g + 2]) for a, b, c, o in reqs]
                    ts = time.perf_counter()
                    out = client.evaluate_many(share, window=w)
                    times.append(time.perf_counter() - ts)
                    window_out.setdefault((w, g), []).append(out)
            window_ms[w] = statistics.median(times) * 1e3
        window_counts = ask(lanes, "counts")
        singles_ms, window_bits_ok = [], True
        for (w, g), outs in window_out.items():
            for i, (a, b, c, o) in enumerate(window_reqs[w]):
                ts = time.perf_counter()
                one = large_clients[g].evaluate(a, b, c, o[2 * g:2 * g + 2])
                singles_ms.append((time.perf_counter() - ts) * 1e3)
                for out in outs:
                    window_bits_ok &= all(np.asarray(x).tobytes() == np.asarray(y).tobytes()
                                          for x, y in zip(out[i], one))
        per_replica = {
            f"{g}/{lane}": {"launches": c["launches"], **c["windows"], "window_sizes": c["window_sizes"]}
            for (g, lane), c in window_counts.items()}
        windows_launch_ok = sum(c["windows"]["vmapped"] for c in window_counts.values()) > 0 and all(
            c["windows"]["fallback"] == 0 and c["windows"]["serial"] == 0
            and (c["launches"] == c["windows"]["vmapped"] + c["windows"]["single"] or not on_kernel)
            for c in window_counts.values())
        window_launches = sum(c["launches"] for c in window_counts.values())

        mark("windows")
        # One request at the flagship size on each lane, straight through
        # its own client, and through a pool (group 1: shm + ring).
        probe = (np.float32(1.5), np.float32(2.0), np.float32(-0.7), np.zeros(2, np.float32))
        lane_ms = {}
        for lane, key in (("shm", (2, "shm")), ("ring", (1, "ring")), ("tcp", (2, "tcp"))):
            client = _lane_client(lane, nodes[key]["ports"][small])
            try:
                lane_ms[lane] = _median_ms(lambda: client.evaluate(*probe), POOL_LANE_CALLS)
            finally:
                client.close()
        lane_ms["pooled"] = _median_ms(lambda: small_clients[1].client.evaluate(*probe),
                                       POOL_LANE_CALLS)
        mark("lanes")
        # MicroBatcher in the driver's process, over the kernel on the card.
        data, _ = pft.generate_node_data(8, n_obs=large, seed=123, device="cpu")
        (x, y), mask = data.tree()
        kern = pft.linreg_logp_grad_fn(*(t.to(dev) for t in (x, y, mask)))

        def driver_logp_grad(intercept, slope, log_sigma, offsets):
            logp, g = kern({"intercept": intercept, "slope": slope, "log_sigma": log_sigma,
                            "offsets": offsets})
            return logp, (g["intercept"], g["slope"], g["log_sigma"], g["offsets"])

        compute = device_compute_fn(pft.wrap_logp_grad_fn(driver_logp_grad), device=dev,
                                    batched=True, max_batch=POOL_BATCHER_REQUESTS)
        batcher = MicroBatcher(compute, compute.batch, max_batch=POOL_BATCHER_REQUESTS)
        breqs = [(np.float32(1.5 + 0.1 * rng.normal()), np.float32(2.0 + 0.1 * rng.normal()),
                  np.float32(math.log(0.5) + 0.05 * rng.normal()),
                  (true_offsets + 0.05 * rng.normal(size=8)).astype(np.float32))
                 for _ in range(POOL_BATCHER_REQUESTS)]
        asyncio.run(MicroBatcher(compute, compute.batch, max_batch=POOL_BATCHER_REQUESTS)
                    .submit_many(breqs[::-1]))  # warm the vmapped call
        _sync(dev)
        linreg_reductions.launches = 0
        ts = time.perf_counter()
        bout = asyncio.run(batcher.submit_many(breqs))
        _sync(dev)
        batcher_ms = (time.perf_counter() - ts) * 1e3
        batcher_launches = linreg_reductions.launches
        bstats = batcher.stats()
        batcher_bits = all(not isinstance(o, Exception) and all(
            np.asarray(u).tobytes() == np.asarray(v).tobytes() for u, v in zip(o, compute(*r)))
            for o, r in zip(bout, breqs))
        batcher_ok = (batcher_bits and bstats["fallbacks_total"] == 0 and bstats["batches_total"] >= 1
                      and (batcher_launches == bstats["batches_total"] or not on_kernel))

        mark("batcher")
        # Fleet telemetry: the collector over the 8 exporters (probes off,
        # so no request moves while it scrapes).
        for pool in pools:
            pool.stop()
        nodes[victim].update(restart)
        fleet_counts = ask(lanes, "counts")
        targets = {f"127.0.0.1:{nodes[k]['ports'][small]}": ("127.0.0.1", nodes[k]["ports"]["exporter"])
                   for k in lanes}
        engine = BurnRateEngine(Slo(p99_s=POOL_SLO_P99_S), windows_s=(60.0,))
        collector = FleetCollector(http_targets=targets, interval_s=3600.0,
                                   observers=[engine.observe]).start()
        try:
            snap = collector.scrape_once()  # the engine's first sample too
            merged_requests = sum(
                c["value"] for a, sc in snap.replicas.items() if a in targets
                for c in sc.metrics.get("pftpu_server_requests_total", {}).get("children", []))
            own_requests = sum(c["requests_total"] for c in fleet_counts.values())
            # A short traced pooled run, then its critical path.
            spans.set_enabled(True)
            try:
                spans.clear_traces()
                reunion.clear()
                for _ in range(POOL_TRACED_EVALS):
                    value_and_grad(small_post, truth)
                report = critpath.analyze_recent()
            finally:
                spans.set_enabled(False)
            collector.scrape_once()  # the engine's second sample: the traced calls
            burn = engine.report() or {}
            bundle_dir = tempfile.mkdtemp(prefix="chip-smoke-bundle-")
            with open(watchdog.write_incident_bundle("pool-phase", dir=bundle_dir)) as fh:
                bundle = json.load(fh)
        finally:
            collector.stop()
        fleet_ok = (snap.complete and merged_requests == own_requests > 0
                    and isinstance(bundle.get("fleet"), list) and len(bundle["fleet"]) >= 1)
        mark("fleet")
        driver_syscalls = ring.syscall_counts()
        gates = {"on_card": on_card, "values": values_ok, "nuts": nuts_ok,
                 "window_bits": window_bits_ok, "window_launches": windows_launch_ok,
                 "batcher": batcher_ok, "fleet": fleet_ok}
        line = {
            "phase": "pool",
            "gates": gates,
            "nodes": [{"replica": f"{k[0]}/{k[1]}", "device": nodes[k]["device"],
                       "cuda": nodes[k]["cuda"], "pid": nodes[k]["pid"]} for k in lanes],
            "spawn_s": spawn_s, "marks_s": marks, "cpu_count": os.cpu_count(), "arena": arena,
            "futex_available": ring.futex_available(),
            "values": {"size": [8, large], "points": values, "bit_equal_to_federated": values_ok},
            "nuts": {"size": [8, small], "chains": nuts[0], "warmup": nuts[1], "draws": nuts[2],
                     "wall_s": nuts_wall, "grad_evals": grad_evals,
                     "ms_per_grad_eval": nuts_wall * 1e3 / max(grad_evals, 1),
                     "federated_ms_per_grad_eval": fed_line.get("nuts", {}).get("ms_per_grad_eval"),
                     "draws_sha256": sha, "draws_equal_federated":
                         sha == fed_line.get("nuts", {}).get("draws_sha256"),
                     "replies_per_group": nuts_replies, "one_reply_per_request": one_reply,
                     "killed": f"{victim[0]}/{victim[1]}", "kill_at_eval": kill_at,
                     "killed_at_s": restart.get("killed_at_s"),
                     "served_before_kill": served_before_kill,
                     "breaker_transitions": breaker_log, "breaker_ok": breaker_ok,
                     "node_requests": node_requests,
                     "kernel_launches": nuts_launches, "max_split_rhat": max_rhat},
            "lanes_ms": {"size": [8, small], "calls": POOL_LANE_CALLS, **lane_ms},
            "windows": {"size": [8, large], "windows": list(windows), "reps": POOL_WINDOW_REPS,
                        "ms_per_window": window_ms,
                        "ms_per_request": {w: window_ms[w] / w for w in windows},
                        "single_ms": statistics.median(singles_ms),
                        "bit_equal_to_single": window_bits_ok, "per_replica": per_replica,
                        "launches_equal_windows": windows_launch_ok,
                        "kernel_launches": window_launches},
            "batcher": {"requests": POOL_BATCHER_REQUESTS, "kernel_launches": batcher_launches,
                        "ms": batcher_ms, "bit_equal_to_single": batcher_bits, "stats": bstats},
            "fleet": {"complete": snap.complete, "stale": snap.stale,
                      "merged_requests": merged_requests, "nodes_own_requests": own_requests,
                      "critpath": {k: report.get(k) for k in ("n_traces", "n_skipped",
                                                               "coverage_frac", "dominant_stage",
                                                               "stages")},
                      "slo": {"p99_s": POOL_SLO_P99_S, "burn_rate": burn.get("burn_rate"),
                              "violating": burn.get("violating")},
                      "bundle_fleet_sections": len(bundle.get("fleet") or [])},
            "syscalls": {"driver": driver_syscalls,
                         "ring_nodes": {f"{g}/{lane}": c["syscalls"] for (g, lane), c in
                                        fleet_counts.items() if lane == "ring"}},
            # Node-side launches of the NUTS run and the windows (the
            # kernel line adds them); the batcher's are the driver's.
            "kernel_launches": nuts_launches + window_launches,
        }
    finally:
        for close in closers:
            close()
        for pool in pools:
            pool.close()
        for c in conns.values():
            try:
                c.send("stop")
            except (OSError, ValueError):
                pass
        for proc in procs.values():
            proc.join(timeout=30)
            if proc.is_alive():
                proc.kill()
                proc.join()
    mark("stop")
    # Every node has stopped (one of them by SIGKILL): no arena file of
    # this phase may remain.
    arena["left_after_stop"] = _arena_files(t_phase)
    gates["no_arena_left"] = not arena["left_after_stop"]
    return all(gates.values()), line


def _draws_sha256(samples):
    """sha256 of the draws' bytes, leaves in sorted order."""
    h = hashlib.sha256()
    for k in sorted(samples):
        h.update(samples[k].detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _sync(dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def _as_cpu(data, dtype=None):
    """A ``ShardedData``, a params dict or a tensor on the CPU, in
    ``dtype`` if given (float64: the inputs of a model's plain float64
    version)."""
    import pytensor_federated_torch as pft
    from pytensor_federated_torch.utils import tree_map

    move = lambda t: t.detach().cpu() if dtype is None else t.detach().cpu().to(dtype)
    if torch.is_tensor(data):
        return move(data)
    if isinstance(data, dict):
        return tree_map(move, data)
    return pft.ShardedData(data=tree_map(move, data.data), mask=move(data.mask))


def _as_f64_cpu(data):
    return _as_cpu(data, torch.float64)


def _three_points(init, seed=5):
    """The origin (``init_params``), origin + 0.1 * arange, and a seeded
    normal perturbation of scale 0.3, as params trees."""
    from pytensor_federated_torch.samplers.util import ravel

    flat, unravel = ravel(init)
    gen = torch.Generator().manual_seed(seed)
    noise = 0.3 * torch.randn(flat.shape, generator=gen)
    steps = 0.1 * torch.arange(flat.shape[0], dtype=flat.dtype)
    return {"origin": init, "perturbed": unravel(flat + steps.to(flat.device)),
            "normal": unravel(flat + noise.to(flat.device))}


def _against_f64(model, model64, points, *, value_rtol=MODEL_VALUE_RTOL,
                 grad_rtol=MODEL_GRAD_RTOL, grad_atol_of_max=MODEL_GRAD_ATOL_OF_MAX,
                 value_atol=0.0):
    """A model's value and gradient on its device against its float64
    version on the CPU at each point; per point the relative value error,
    the largest gradient error as a share of its tolerance, and ok.  The
    value passes within ``value_rtol |v64| + value_atol``."""
    out, ok = [], True
    for name, p in points.items():
        v, g = model.logp_and_grad(p)
        v64, g64 = model64.logp_and_grad({k: t.detach().cpu().double() for k, t in p.items()})
        rel = abs(float(v) - float(v64)) / abs(float(v64))
        worst = 0.0
        for k in g64:
            err = (g[k].detach().cpu().double() - g64[k]).abs()
            tol = grad_rtol * g64[k].abs() + grad_atol_of_max * float(g64[k].abs().max())
            worst = max(worst, float((err / tol.clamp_min(1e-30)).max()))
        value_ok = abs(float(v) - float(v64)) <= value_rtol * abs(float(v64)) + value_atol
        point_ok = value_ok and worst <= 1.0 and math.isfinite(float(v))
        out.append({"point": name, "logp": float(v), "value_rel_err": rel,
                    "grad_err_over_tol": worst, "ok": point_ok})
        ok &= point_ok
    return ok, out


def _ms_per_eval(fn, dev, reps):
    """Median host time of ``reps`` synchronised calls, after 3 warm-ups."""
    for _ in range(3):
        fn()
    _sync(dev)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        _sync(dev)
        times.append(time.perf_counter() - t0)
    return statistics.median(times) * 1e3


def _launches(fn, dev, calls):
    """CUDA launches per call of ``fn`` by the profiler; None off the card."""
    return _cuda_launches_per_call(fn, calls)[0] if torch.device(dev).type == "cuda" else None


def _model_nuts(model, dev, seed, nuts=MODEL_NUTS, jitter=1.0, cuda_graph=False):
    """NUTS on ``model.logp`` with gradient evaluations (of the chain
    batch) counted; the run's draws, wall time, stats and min-ESS/s.
    With ``cuda_graph`` the evaluations replayed from the graph count
    too (beside the eager ones: the graph's warm-up and capture)."""
    import pytensor_federated_torch as pft

    grad_evals = 0

    def counted(p):
        nonlocal grad_evals
        grad_evals += 1
        return model.logp(p)

    chains, warmup, draws = nuts
    gen = torch.Generator(device=dev).manual_seed(seed)
    _sync(dev)
    t0 = time.perf_counter()
    res = pft.samplers.sample(counted, model.init_params(), generator=gen, num_warmup=warmup,
                              num_samples=draws, num_chains=chains, jitter=jitter,
                              cuda_graph=cuda_graph)
    _sync(dev)
    wall = time.perf_counter() - t0
    if cuda_graph:
        grad_evals += res.extra["graph_replays"]
    s = res.samples
    max_rhat = max(float(v.max()) for v in pft.samplers.split_rhat(s).values())
    min_ess = min(float(v.min()) for v in pft.samplers.effective_sample_size(s).values())
    return res, {
        "chains": chains, "warmup": warmup, "draws": draws, "jitter": jitter, "seed": seed,
        "wall_s": wall, "samples_per_s": chains * draws / wall,
        "min_ess": min_ess, "min_ess_per_s": min_ess / wall,
        "grad_evals": grad_evals, "ms_per_grad_eval": wall * 1e3 / max(grad_evals, 1),
        "mean_tree_depth": float(res.stats["depth"].float().mean()),
        "divergence_share": float(res.stats["diverging"].float().mean()),
        "max_split_rhat": max_rhat,
        "finite": all(bool(torch.isfinite(v).all()) for v in s.values()),
    }


def phase_radon(dev="cuda", nuts=MODEL_NUTS):
    """BASELINE config 3 on ``dev``: values against float64 on the CPU,
    time per evaluation, NUTS with the JAX test's recovery gate."""
    import pytensor_federated_torch as pft

    data, true = pft.generate_radon_data(**RADON, device=dev)
    model = pft.HierarchicalRadonGLM(data)
    model64 = pft.HierarchicalRadonGLM(_as_f64_cpu(data))
    values_ok, values = _against_f64(model, model64, _three_points(model.init_params()))
    p = model.init_params()
    ms = _ms_per_eval(lambda: model.logp_and_grad(p), dev, 50)
    launches = _launches(lambda: model.logp_and_grad(p), dev, 10)
    graph = torch.device(dev).type == "cuda"
    res, run = _model_nuts(model, dev, seed=11, nuts=nuts, cuda_graph=graph)
    run["cuda_graph"] = graph
    beta_median = float(res.samples["beta"].median())
    run["beta_median"], run["beta_true"] = beta_median, true["beta"]
    ok = (values_ok and run["finite"] and run["divergence_share"] < 0.1
          and abs(beta_median - true["beta"]) < 0.3 and run["max_split_rhat"] < 1.1)
    return ok, {
        "phase": "radon", "config": "BASELINE.json config 3, bench_suite.py:713",
        "size": {"counties": data.n_shards, "max_obs": data.max_len,
                 "observations": int(data.mask.sum()),
                 "params": sum(t.numel() for t in model.init_params().values())},
        "tolerance": {"value_rtol": MODEL_VALUE_RTOL, "grad_rtol": MODEL_GRAD_RTOL,
                      "grad_atol": f"{MODEL_GRAD_ATOL_OF_MAX} x max|grad of the leaf|",
                      "against": "the same model in float64 on the CPU"},
        "values": values,
        "ms_per_logp_and_grad": ms,
        "cuda_launches_per_logp_and_grad": launches,
        "nuts": run,
        "gates": "finite, divergence share < 0.1, |median beta - true| < 0.3, split R-hat < 1.1",
    }


def phase_logistic(dev="cuda", nuts=CONFIG8_NUTS, large_obs=LOGISTIC_LARGE_OBS):
    """BASELINE config 5 on ``dev``: the three exact forms behind
    bench_suite's equality gate, the hierarchical model and the bf16
    compute dtype against float64 on the CPU, times per evaluation at two
    sizes; then config 8, NUTS on the plain form with its chains in
    lockstep."""
    import pytensor_federated_torch as pft
    from pytensor_federated_torch.samplers.util import ravel

    forms = {"vmapped": {}, "suffstats": {"use_suffstats": True}, "flat": {"flatten": True}}
    data, true = pft.generate_logistic_data(**LOGISTIC, device=dev)
    models = {name: pft.FederatedLogisticRegression(data, **kw) for name, kw in forms.items()}
    plain = models["vmapped"]
    flat0, unravel = ravel(plain.init_params())
    gate, gate_ok = [], True
    for name, x in (("x0", flat0), ("x0+0.1*arange", flat0 + 0.1 * torch.arange(
            flat0.shape[0], dtype=flat0.dtype, device=flat0.device))):
        ref = plain.logp_and_grad(unravel(x))
        for other in ("suffstats", "flat"):
            o_ok, err = _flat_close(models[other].logp_and_grad(unravel(x)), ref)
            gate.append({"point": name, "form": other, **err, "ok": o_ok})
            gate_ok &= o_ok

    data64 = _as_f64_cpu(data)
    plain_ok, plain_values = _against_f64(plain, pft.FederatedLogisticRegression(data64),
                                          _three_points(plain.init_params()))
    bf16 = pft.FederatedLogisticRegression(data, compute_dtype=torch.bfloat16)
    bf16_ok, bf16_values = _against_f64(
        bf16, pft.FederatedLogisticRegression(data64), _three_points(plain.init_params()),
        value_rtol=BF16_VALUE_RTOL, grad_rtol=BF16_GRAD_TOL, grad_atol_of_max=BF16_GRAD_TOL)
    hdata, _ = pft.generate_hier_logistic_data(**LOGISTIC, device=dev)
    hier = pft.HierarchicalLogisticRegression(hdata)
    hier_ok, hier_values = _against_f64(hier, pft.HierarchicalLogisticRegression(_as_f64_cpu(hdata)),
                                        _three_points(hier.init_params()))

    timing = {}
    for n_obs in (LOGISTIC["n_obs"], large_obs):
        tdata = data if n_obs == LOGISTIC["n_obs"] else pft.generate_logistic_data(
            **{**LOGISTIC, "n_obs": n_obs}, device=dev)[0]
        row = {"x_bytes": int(tdata.data[0].numel()) * 4}
        for name, kw in forms.items():
            m = models[name] if tdata is data else pft.FederatedLogisticRegression(tdata, **kw)
            p = m.init_params()
            row[name + "_ms"] = _ms_per_eval(lambda: m.logp_and_grad(p), dev, 50)
            row[name + "_cuda_launches"] = _launches(lambda: m.logp_and_grad(p), dev, 10)
        timing[f"{LOGISTIC['n_shards']}x{n_obs}x{LOGISTIC['n_features']}"] = row
        del tdata

    res, run = _model_nuts(plain, dev, seed=CONFIG8_SEED, nuts=nuts, jitter=CONFIG8_JITTER)
    run["max_rhat_w"] = float(pft.samplers.split_rhat(res.samples)["w"].max())
    recovered = {}
    for name, want in (("w", torch.as_tensor(true["w"], dtype=torch.float32)),
                       ("b", torch.tensor(true["b"], dtype=torch.float32))):
        d = res.samples[name].reshape(-1, *want.shape).cpu()
        mean, sd = d.mean(0), d.std(0)
        recovered[name] = {"mean": mean.tolist(), "sd": sd.tolist(), "true": want.tolist(),
                           "within_4sd": bool(((mean - want).abs() <= 4 * sd).all())}
    run["recovered"] = recovered
    ok = (gate_ok and plain_ok and bf16_ok and hier_ok and run["finite"]
          and run["max_split_rhat"] < 1.1 and run["max_rhat_w"] < 1.2
          and all(r["within_4sd"] for r in recovered.values()))
    return ok, {
        "phase": "logistic", "config": "BASELINE.json config 5, bench_suite.py:747",
        "size": LOGISTIC,
        "equality_gate": {"tolerance": {"value_rtol": AUTOGRAD_RTOL_VALUE,
                                        "grad_rtol": AUTOGRAD_RTOL_GRAD,
                                        "grad_atol": AUTOGRAD_ATOL_GRAD,
                                        "source": "bench_suite.py's equality gate"},
                          "points": gate},
        "tolerance": {"value_rtol": MODEL_VALUE_RTOL, "grad_rtol": MODEL_GRAD_RTOL,
                      "grad_atol": f"{MODEL_GRAD_ATOL_OF_MAX} x max|grad of the leaf|",
                      "bf16": {"value_rtol": BF16_VALUE_RTOL, "grad_rtol": BF16_GRAD_TOL,
                               "grad_atol": f"{BF16_GRAD_TOL} x max|grad of the leaf|"},
                      "against": "the plain form in float64 on the CPU"},
        "vmapped_vs_f64": plain_values,
        "bf16_vs_f64": bf16_values,
        "hierarchical_vs_f64": hier_values,
        "timing": timing,
        "nuts": {**run, "config": "bench_suite.py config 8 (:982)"},
        "gates": "equality gate, values, finite, split R-hat < 1.1 (and of w < 1.2, "
                 "bench_suite's), every w and b within 4 sd",
    }


def phase_lv_ode(dev="cuda", reps=20):
    """BASELINE config 4 on ``dev``: values against float64 on the CPU,
    time and CUDA launches per evaluation, and find_map against its
    float64 run on the CPU."""
    import pytensor_federated_torch as pft

    model, meta = pft.make_lv_model(LV_SHARDS, device=dev)
    model64 = pft.LotkaVolterraModel(_as_f64_cpu(model.observations), meta["y0"], meta["dt"],
                                     meta["n_steps"], meta["obs_idx"])
    values_ok, values = _against_f64(model, model64, _three_points(model.init_params()))
    p = model.init_params()
    ms = _ms_per_eval(lambda: model.logp_and_grad(p), dev, reps)
    launches = _launches(lambda: model.logp_and_grad(p), dev, 1)
    _sync(dev)
    t0 = time.perf_counter()
    est = model.find_map(**LV_FIND_MAP)
    _sync(dev)
    map_s = time.perf_counter() - t0
    est64 = pft.samplers.find_map(
        model64.logp, {k: v.cpu().double() for k, v in model.init_params().items()}, **LV_FIND_MAP)
    map_err = float((est["log_theta"].cpu().double() - est64["log_theta"]).abs().max())
    ok = values_ok and map_err <= LV_FIND_MAP_ATOL and (
        launches is not None or torch.device(dev).type != "cuda")
    return ok, {
        "phase": "lv_ode", "config": "BASELINE.json config 4, bench_suite.py:722",
        "size": {"shards": LV_SHARDS, "obs": len(meta["obs_idx"]), "species": 2,
                 "rk4_steps": meta["n_steps"]},
        "tolerance": {"value_rtol": MODEL_VALUE_RTOL, "grad_rtol": MODEL_GRAD_RTOL,
                      "grad_atol": f"{MODEL_GRAD_ATOL_OF_MAX} x max|grad of the leaf|",
                      "find_map_log_theta_atol": LV_FIND_MAP_ATOL,
                      "against": "the same model in float64 on the CPU"},
        "values": values,
        "ms_per_logp_and_grad": ms,
        "timed_evals": reps,
        "cuda_launches_per_logp_and_grad": launches,
        "find_map": {**LV_FIND_MAP, "wall_s": map_s, "log_theta": est["log_theta"].tolist(),
                     "log_theta_f64_cpu": est64["log_theta"].tolist(),
                     "max_abs_err": map_err, "theta_true": meta["theta"].tolist()},
    }


def phase_wide_logistic(dev="cuda", reps=WIDE_TIMED_EVALS, wide=WIDE, chains=WIDE_CHAINS):
    """Config 7: one batched value+grad of ``chains`` chains per form on
    the wide logistic regression, each chain against the float32_strict
    form at bench_suite's gates; time per batched evaluation and its
    share of the matching dense peak."""
    import pytensor_federated_torch as pft
    from pytensor_federated_torch.samplers.mcmc import (
        make_batch_logp_and_grad,
        make_flat_logp_and_grad,
    )

    data, _ = pft.generate_logistic_data(**wide, device=dev)
    forms = {"f32": None, "bf16": torch.bfloat16, "f32_strict": "float32_strict"}
    lgs = {}
    for name, compute_dtype in forms.items():
        model = pft.FederatedLogisticRegression(data, compute_dtype=compute_dtype)
        flat_logp, flat0, unravel, _ = make_flat_logp_and_grad(model.logp, model.init_params())
        lgs[name] = make_batch_logp_and_grad(flat_logp, unravel)
    g = torch.Generator(device=dev).manual_seed(3)
    x = flat0[None] + WIDE_JITTER * torch.randn((chains, flat0.shape[0]), generator=g, device=dev)
    out = {name: lg(x) for name, lg in lgs.items()}
    v_s, g_s = (t.double() for t in out["f32_strict"])
    atol = WIDE_GRAD_TOL * float(g_s.abs().max())
    gates, gates_ok = {}, True
    for name in ("f32", "bf16"):
        v, gr = (t.double() for t in out[name])
        v_err = float(((v - v_s).abs() / v_s.abs()).max())
        g_ratio = float(((gr - g_s).abs() / (atol + WIDE_GRAD_TOL * g_s.abs())).max())
        finite = bool(torch.isfinite(v).all() and torch.isfinite(gr).all())
        gates[name] = {"value_max_rel_err": v_err, "grad_err_over_tol": g_ratio,
                       "ok": finite and v_err <= WIDE_VALUE_RTOL and g_ratio <= 1.0}
        gates_ok &= gates[name]["ok"]
    S, N, F = wide["n_shards"], wide["n_obs"], wide["n_features"]
    # X @ w for every chain forward, and the product behind d/dw backward.
    flop = 2 * (2 * S * N * F * chains)
    f32_peak = _peak(torch.cuda.get_device_name(0) if torch.device(dev).type == "cuda" else "")[2]
    timing = {}
    for name, lg in lgs.items():
        ms = _ms_per_eval(lambda: lg(x), dev, reps)
        peak = _BF16_PEAK if name == "bf16" else f32_peak
        timing[name] = {"ms_per_batched_eval": ms, "gflop_per_s": flop / (ms * 1e-3) / 1e9,
                        "share_of_peak": flop / (ms * 1e-3) / peak,
                        "peak": "bf16 tensor cores" if name == "bf16" else "float32, no tensor cores",
                        "cuda_launches_per_eval": _launches(lambda: lg(x), dev, 3)}
    return gates_ok, {
        "phase": "wide_logistic", "config": "bench_suite.py config 7 (:878)",
        "size": {**wide, "chains": chains, "x_bytes": S * N * F * 4},
        "flop_per_batched_eval": flop,
        "tf32": {"matmul": torch.backends.cuda.matmul.allow_tf32,
                 "cudnn": torch.backends.cudnn.allow_tf32},
        "tolerance": {"value_rtol": WIDE_VALUE_RTOL, "grad_rtol": WIDE_GRAD_TOL,
                      "grad_atol": f"{WIDE_GRAD_TOL} x max|grad of f32_strict|",
                      "anchor": "f32_strict", "source": "bench_suite.py:929-939"},
        "gates": gates,
        "timing": timing,
    }


def phase_chees(nuts_line, dev="cuda", chees=CONFIG9_CHEES):
    """Config 9: ChEES-HMC on config 5's posterior; min-ESS/s against
    config 8's NUTS of the same run (``nuts_line``: the logistic phase's
    ``nuts`` record)."""
    import pytensor_federated_torch as pft

    data, _ = pft.generate_logistic_data(**LOGISTIC, device=dev)
    model = pft.FederatedLogisticRegression(data)
    chains, warmup, draws = chees
    gen = torch.Generator(device=dev).manual_seed(CONFIG9_SEED)
    _sync(dev)
    t0 = time.perf_counter()
    res = pft.samplers.chees_sample(model.logp, model.init_params(), generator=gen,
                                    num_warmup=warmup, num_samples=draws, num_chains=chains,
                                    jitter=CONFIG9_JITTER)
    _sync(dev)
    wall = time.perf_counter() - t0
    s = res.samples
    max_rhat = max(float(v.max()) for v in pft.samplers.split_rhat(s).values())
    min_ess = min(float(v.min()) for v in pft.samplers.effective_sample_size(s).values())
    # A lower bound: the leapfrog steps of the draw phase over the whole
    # wall time (warmup included), as bench_suite's config 9 counts them.
    grads = float(res.stats["n_steps"][0].sum()) * chains
    nuts_rate = nuts_line.get("min_ess_per_s")
    finite = all(bool(torch.isfinite(v).all()) for v in s.values())
    ok = finite and max_rhat < 1.2
    return ok, {
        "phase": "chees", "config": "bench_suite.py config 9 (:1050)",
        "size": LOGISTIC, "chains": chains, "warmup": warmup, "draws": draws,
        "jitter": CONFIG9_JITTER, "wall_s": wall,
        "min_ess": min_ess, "min_ess_per_s": min_ess / wall,
        "nuts_min_ess_per_s": nuts_rate,
        "ratio_to_nuts": (min_ess / wall) / nuts_rate if nuts_rate else None,
        "leapfrog_grads_per_s_lower_bound": grads / wall,
        "mean_leapfrog_steps": float(res.stats["n_steps"][0].float().mean()),
        "step_size": float(res.step_size[0]),
        "traj_len": float(res.extra["traj_len"]),
        "accept_prob": float(res.stats["accept_prob"].mean()),
        "max_split_rhat": max_rhat, "finite": finite,
        "gates": "finite draws, split R-hat < 1.2",
    }


# Config 6 (bench_suite.py:814): generate_lgssm_data(T=4096), seed 7, d=2,
# k=1; the sequential and the parallel-in-time filter at the same float32
# precision (TF32 off).  Gates are the JAX tests' tolerances
# (tests/test_statespace.py:91, :103): value rtol 1e-4; gradient rtol 1e-3,
# atol 1e-4; the smoothers compared at T=512.
LGSSM = dict(T=4096, seed=7, d=2, k=1)
LGSSM_VALUE_RTOL, LGSSM_GRAD_RTOL, LGSSM_GRAD_ATOL = 1e-4, 1e-3, 1e-4
LGSSM_SMOOTHER_T = 512
LGSSM_PAR_REPS = 30
LGSSM_COUNT_T = (32, 64)  # the sequential filter's launches and FLOPs, extrapolated
# Config 10 (bench_suite.py:1125): FederatedExactGP on generate_gp_data(8,
# n_obs=256, seed=9), sqexp; against float64 on the CPU at value rtol 1e-4
# and gradient 1e-3 |g| + 1e-4 max|g|; bench_suite's pass line is 5% MFU
# (recorded, not gated).  The sparse GP beside it: 32 inducing points
# evenly spaced on [-2, 2].
GP = dict(n_shards=8, n_obs=256, seed=9)
GP_VALUE_RTOL, GP_GRAD_RTOL, GP_GRAD_ATOL_OF_MAX = 1e-4, 1e-3, 1e-4
GP_INDUCING = 32
# The sparse bound is a sum of terms of size O(n) (n log 2πσ², the
# quadratic form, the log-determinant, the trace residual) whose total
# crosses zero: its float32 error scales with n, not with |logp|.  Value
# within 1e-4 |logp64| + 1e-5 n (n = 2,048 real observations).
GP_SPARSE_VALUE_ATOL_PER_OBS = 1e-5
GP_TARGET_MFU = 0.05
GP_TIMED_EVALS = 50
# Config 12 (bench_suite.py:1435): a 16-sigma bimodal in 8 dimensions
# (modes at +-4, width 0.5); parallel tempering, 2 stacks x 8 temperatures,
# beta_min 0.01, 8 leapfrog steps, 500 warmup + 1000 draws; the NUTS
# control, 4 chains with jitter 5 at the same lengths.  Each sampler runs
# once, after a 20-iteration warm-up run; bench_suite's gates
# (bench_suite.py:1555-1558): PT's mode-balance error (the worst chain's)
# < 0.3, NUTS's > 0.35.
BIMODAL = dict(dim=8, sep=4.0, width=0.5)
PT_RUN = dict(num_chains=2, num_temps=8, beta_min=0.01, num_leapfrog=8)
PT_LENGTHS, NUTS_LENGTHS = (500, 1000), (500, 1000)
NUTS_CONTROL = dict(num_chains=4, jitter=5.0)
WARMUP_ITERS = 20
# The rated runs' generator seeds, bench_suite's own (:1499); the warm-up
# runs use 0.  One PT run of these lengths fails the balance gate about
# one time in three (PERF.md §6: of seeds 1-9 on an H100, 1, 5 and 6
# fail).  So PT's gate reads bench_suite's statistic on PT_GATE_RUNS more
# independent runs, made as one batched call of 2 x PT_GATE_RUNS stacks
# (every stack adapts alone), and holds their mean under 0.3; the rated
# run's own balance is recorded beside it.  On an H100 the 32 runs of
# seed 2 read a mean of 0.215, 9 of them at or over 0.3.
PT_SEED, NUTS_SEED, PT_GATE_SEED = 1, 1, 2
PT_GATE_RUNS = 32
PT_BALANCE_MAX, NUTS_BALANCE_MIN = 0.3, 0.35


def _close(got, want, rtol, atol):
    """``|got - want| <= atol + rtol |want|`` elementwise, float64 on the
    CPU; the largest error as a share of its tolerance."""
    got, want = got.detach().cpu().double(), want.detach().cpu().double()
    ratio = float(((got - want).abs() / (atol + rtol * want.abs()).clamp_min(1e-300)).max())
    return ratio <= 1.0 and bool(torch.isfinite(got).all()), ratio


def phase_lgssm(dev="cuda", lgssm=LGSSM, smoother_t=LGSSM_SMOOTHER_T, par_reps=LGSSM_PAR_REPS):
    """Config 6: the sequential and the parallel-in-time Kalman filter's
    logp+grad at T=4096 in the same run and precision: each against the
    other and against its float64 version on the CPU; ms per evaluation,
    their ratio (bench_suite's vs_baseline), CUDA launches and FLOPs per
    evaluation; the parallel smoother against the sequential one."""
    import pytensor_federated_torch as pft
    from pytensor_federated_torch import flopcount
    from pytensor_federated_torch.models import statespace as ss
    from pytensor_federated_torch.utils import value_and_grad

    y, params = pft.generate_lgssm_data(**lgssm, device=dev)
    y64, p64 = y.cpu().double(), {k: v.cpu().double() for k, v in params.items()}
    forms = {"seq": ss.kalman_logp_seq, "parallel": ss.kalman_logp_parallel}
    tol = (LGSSM_VALUE_RTOL, LGSSM_GRAD_RTOL, LGSSM_GRAD_ATOL)
    out, f64, gates = {}, {}, {}
    for name, fn in forms.items():
        t0 = time.perf_counter()
        out[name] = value_and_grad(lambda q, fn=fn: fn(q, y), params)
        _sync(dev)
        first_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        f64[name] = value_and_grad(lambda q, fn=fn: fn(q, y64), p64)
        gates[name + "_vs_f64_cpu"] = dict(zip(("ok", "errors"), _flat_close(out[name], f64[name], *tol)))
        gates[name + "_vs_f64_cpu"]["f64_cpu_s"] = time.perf_counter() - t0
        gates[name + "_vs_f64_cpu"]["first_call_s"] = first_s
    gates["parallel_vs_seq"] = dict(zip(("ok", "errors"), _flat_close(out["parallel"], out["seq"], *tol)))
    sm_seq = ss.kalman_smoother_seq(params, y[:smoother_t])
    sm_par = ss.kalman_smoother_parallel(params, y[:smoother_t])
    sm_ok, sm_ratio = zip(*(_close(a, b, LGSSM_GRAD_RTOL, LGSSM_GRAD_ATOL) for a, b in zip(sm_par, sm_seq)))
    gates["smoother_parallel_vs_seq"] = {"ok": all(sm_ok), "T": smoother_t,
                                         "err_over_tol": {"means": sm_ratio[0], "covs": sm_ratio[1]}}
    ok = all(g["ok"] for g in gates.values())

    timing = {}
    for name, fn in forms.items():
        call = lambda fn=fn, y=y: value_and_grad(lambda q: fn(q, y), params)
        t0 = time.perf_counter()
        if name == "seq":
            # One timed call after the gate call, its warm-up (~11 s: the
            # same operations repeat 4,096 times).  Its launches and FLOPs
            # are linear in T (the same work per step, forward and
            # backward), so they are counted at two short lengths and
            # extrapolated: the profiler's record of ~660,000 launches at
            # T = 4,096 costs minutes to process.
            call()
            _sync(dev)
            ms = (time.perf_counter() - t0) * 1e3
            counts = {}
            for t_small in LGSSM_COUNT_T:
                small = lambda t_small=t_small: value_and_grad(
                    lambda q: fn(q, y[:t_small]), params)
                counts[t_small] = (_launches(small, dev, 1), flopcount.flops_per_eval(small))
            (t1, c1), (t2, c2) = counts.items()
            launches, flops = (None if a is None else b + (b - a) / (t2 - t1) * (y.shape[0] - t2)
                               for a, b in zip(c1, c2))
            extra = {"counted_at": {str(k): {"cuda_launches": v[0], "flops": v[1]}
                                    for k, v in counts.items()},
                     "count_note": f"extrapolated linearly in T from T = {t1} and T = {t2}"}
        else:
            ms = _ms_per_eval(call, dev, par_reps)
            launches, flops, extra = _launches(call, dev, 3), flopcount.flops_per_eval(call), {}
        timing[name] = {"ms_per_logp_and_grad": ms, "reps": 1 if name == "seq" else par_reps,
                        "cuda_launches_per_eval": launches, "flops_per_eval": flops, **extra,
                        "seconds": time.perf_counter() - t0}
    ratio = timing["seq"]["ms_per_logp_and_grad"] / timing["parallel"]["ms_per_logp_and_grad"]
    return ok, {
        "phase": "lgssm", "config": "bench_suite.py config 6 (:814)",
        "size": lgssm, "precision": "float32, TF32 off",
        "tolerance": {"value_rtol": LGSSM_VALUE_RTOL, "grad_rtol": LGSSM_GRAD_RTOL,
                      "grad_atol": LGSSM_GRAD_ATOL, "source": "tests/test_statespace.py:91, :103"},
        "gates": gates,
        "logp": {"seq": float(out["seq"][0]), "parallel": float(out["parallel"][0]),
                 "f64_cpu": float(f64["seq"][0])},
        "timing": timing,
        "vs_baseline": ratio,
        "vs_baseline_note": "sequential ms (one warm call) over parallel ms (median of the timed "
                            "calls after 3 warm-ups) per logp+grad, same run, same precision",
    }


def phase_gp(dev="cuda", gp=GP, inducing=GP_INDUCING, reps=GP_TIMED_EVALS):
    """Config 10: the federated exact GP's logp+grad against float64 on the
    CPU, with no host sync inside an evaluation; ms, FLOPs and the share
    of the float32 peaks; the sparse GP's value against float64 and its
    ms."""
    import pytensor_federated_torch as pft
    from pytensor_federated_torch import flopcount

    data, _ = pft.generate_gp_data(gp["n_shards"], n_obs=gp["n_obs"], seed=gp["seed"], device=dev)
    data64 = _as_f64_cpu(data)
    model, model64 = pft.FederatedExactGP(data), pft.FederatedExactGP(data64)
    points = _three_points(model.init_params())
    values_ok, values = _against_f64(model, model64, points, value_rtol=GP_VALUE_RTOL,
                                     grad_rtol=GP_GRAD_RTOL, grad_atol_of_max=GP_GRAD_ATOL_OF_MAX)
    p = model.init_params()
    call = lambda: model.logp_and_grad(p)
    call()
    _sync(dev)
    sync_free = None
    if torch.device(dev).type == "cuda":
        torch.cuda.set_sync_debug_mode("error")
        try:
            call()
            sync_free = True
        except RuntimeError:
            sync_free = False
        finally:
            torch.cuda.set_sync_debug_mode(0)
    ms = _ms_per_eval(call, dev, reps)
    flops = flopcount.flops_per_eval(call)
    rate = flops / (ms * 1e-3) if flops else None
    if torch.device(dev).type == "cuda":
        peak, basis = flopcount.peak_flops(dev)
        measured = flopcount.measured_matmul_peak(dev)
    else:
        peak, basis, measured = None, "not measured off the card", None
    share = lambda pk: rate / pk if rate and pk else None

    z = torch.linspace(-2.0, 2.0, inducing)
    sparse = pft.FederatedSparseGP(data, z)
    sparse64 = pft.FederatedSparseGP(data64, z.double())
    n_obs = int(data.mask.sum())
    sp_ok, sp_values = _against_f64(sparse, sparse64, _three_points(sparse.init_params()),
                                    value_rtol=GP_VALUE_RTOL, grad_rtol=GP_GRAD_RTOL,
                                    grad_atol_of_max=GP_GRAD_ATOL_OF_MAX,
                                    value_atol=GP_SPARSE_VALUE_ATOL_PER_OBS * n_obs)
    sp = sparse.init_params()
    sp_ms = _ms_per_eval(lambda: sparse.logp_and_grad(sp), dev, reps)
    ok = values_ok and sp_ok and sync_free is not False and (
        sync_free is True or torch.device(dev).type != "cuda")
    return ok, {
        "phase": "gp", "config": "bench_suite.py config 10 (:1125)",
        "size": {**gp, "kernel": "sqexp", "params": 3},
        "tolerance": {"value_rtol": GP_VALUE_RTOL, "grad_rtol": GP_GRAD_RTOL,
                      "grad_atol": f"{GP_GRAD_ATOL_OF_MAX} x max|grad of the leaf|",
                      "against": "the same model in float64 on the CPU"},
        "values": values,
        "no_host_sync_in_eval": sync_free,
        "ms_per_logp_and_grad": ms,
        "cuda_launches_per_logp_and_grad": _launches(call, dev, 3),
        "flops_per_eval": flops,
        "flops_note": "matrix products and the linalg formulas of flopcount.py, forward and backward",
        "flop_per_s": rate,
        "peak": {"f32_flop_per_s": peak, "basis": basis, "measured_f32_matmul_flop_per_s": measured},
        "share_of_f32_peak": share(peak),
        "share_of_measured_matmul_peak": share(measured),
        "evals_per_s": 1e3 / ms,
        "evals_per_s_at_5pct_mfu": GP_TARGET_MFU * peak / flops if (peak and flops) else None,
        "mfu_line_note": "bench_suite's pass line for config 10 (5% MFU), recorded, not gated",
        "sparse": {"inducing": inducing, "values": sp_values, "ms_per_logp_and_grad": sp_ms,
                   "value_atol": GP_SPARSE_VALUE_ATOL_PER_OBS * n_obs,
                   "cuda_launches_per_logp_and_grad": _launches(lambda: sparse.logp_and_grad(sp),
                                                                dev, 3)},
    }


def _bimodal_logp(params):
    x = params["x"]
    la = -0.5 * torch.sum(((x + BIMODAL["sep"]) / BIMODAL["width"]) ** 2)
    lb = -0.5 * torch.sum(((x - BIMODAL["sep"]) / BIMODAL["width"]) ** 2)
    return torch.logaddexp(la, lb)


def _chain_balance(draws):
    """Each chain's mode-balance error: a draw's mode is the sign of its
    mean coordinate, the error |P(right) - 1/2|."""
    side = (draws.mean(dim=-1) > 0).double()
    return (side.mean(dim=1) - 0.5).abs()


def _balance_and_ess(res, wall):
    """bench_suite's mode-balance error (the worst chain's) and the
    rank-normalized min-ESS/s with the max split R-hat."""
    draws = res.samples["x"].detach().cpu()
    balance = float(_chain_balance(draws).max())
    summ = res.summary(rank_normalized=True)
    ess = min(float(v.min()) for v in summ["ess"].values())
    rhat = max(float(v.max()) for v in summ["rhat"].values())
    return {"wall_s": wall, "mode_balance_error": balance, "rank_min_ess": ess,
            "rank_min_ess_per_s": ess / wall, "max_split_rhat": rhat,
            "finite": bool(torch.isfinite(draws).all())}


def phase_tempering(dev="cuda", pt_lengths=PT_LENGTHS, nuts_lengths=NUTS_LENGTHS,
                    warm=WARMUP_ITERS):
    """Config 12: parallel tempering on the 16-sigma bimodal against NUTS
    with overdispersed inits; each run once after a short warm-up run,
    and PT's balance gate on PT_GATE_RUNS more runs in one batch."""
    import pytensor_federated_torch as pft

    init = {"x": torch.zeros(BIMODAL["dim"], device=dev)}
    evals = 0

    def counted(p):
        nonlocal evals
        evals += 1
        return _bimodal_logp(p)

    def run_pt(seed, warmup, draws):
        gen = torch.Generator(device=dev).manual_seed(seed)
        return pft.samplers.pt_sample(counted, init, generator=gen, num_warmup=warmup,
                                      num_samples=draws, **PT_RUN)

    def run_nuts(seed, warmup, draws):
        gen = torch.Generator(device=dev).manual_seed(seed)
        return pft.samplers.sample(counted, init, generator=gen, num_warmup=warmup,
                                   num_samples=draws, **NUTS_CONTROL)

    lines = {}
    for name, run, (warmup, draws) in (("pt", run_pt, pt_lengths), ("nuts", run_nuts, nuts_lengths)):
        _sync(dev)
        t0 = time.perf_counter()
        run(0, warm // 2, warm - warm // 2)
        _sync(dev)
        warm_s = time.perf_counter() - t0
        launches = None
        if torch.device(dev).type == "cuda":
            n_iter = 8
            on_card = _card_events(lambda: run(0, n_iter // 2, n_iter // 2), 1)
            launches = len(on_card) / n_iter
        evals = 0
        _sync(dev)
        t0 = time.perf_counter()
        res = run(PT_SEED if name == "pt" else NUTS_SEED, warmup, draws)
        _sync(dev)
        wall = time.perf_counter() - t0
        line = {"seed": PT_SEED if name == "pt" else NUTS_SEED, "warmup": warmup, "draws": draws,
                "warm_up_run": {"iterations": warm, "wall_s": warm_s},
                "batched_evals": evals, "ms_per_batched_eval": wall * 1e3 / max(evals, 1),
                "cuda_launches_per_iteration": launches, **_balance_and_ess(res, wall)}
        if name == "pt":
            grads = PT_RUN["num_leapfrog"] * PT_RUN["num_temps"] * PT_RUN["num_chains"] * draws
            line.update(PT_RUN, grads_per_s_lower_bound=grads / wall,
                        swap_rate_per_pair=res.extra["swap_rate_per_pair"].tolist(),
                        swap_accept=float(res.stats["swap_accept"].mean()))
        else:
            line.update(NUTS_CONTROL, mean_tree_depth=float(res.stats["depth"].float().mean()),
                        mean_max_tree_depth=float(res.stats["depth"].max(dim=0).values.float().mean()))
        lines[name] = line

    # PT's gate: bench_suite's statistic on PT_GATE_RUNS independent
    # runs, stacks 2k and 2k+1 of one batched call being run k.
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(PT_GATE_SEED)
    res = pft.samplers.pt_sample(_bimodal_logp, init, generator=gen, num_warmup=pt_lengths[0],
                                 num_samples=pt_lengths[1],
                                 **{**PT_RUN, "num_chains": PT_RUN["num_chains"] * PT_GATE_RUNS})
    draws = res.samples["x"].detach().cpu()
    per_run = _chain_balance(draws).view(PT_GATE_RUNS, PT_RUN["num_chains"]).max(dim=1).values
    gate = {"seed": PT_GATE_SEED, "runs": PT_GATE_RUNS, "stacks": PT_RUN["num_chains"] * PT_GATE_RUNS,
            "mean_mode_balance_error": float(per_run.mean()),
            "median_mode_balance_error": float(per_run.median()),
            "runs_at_or_over_max": int((per_run >= PT_BALANCE_MAX).sum()),
            "finite": bool(torch.isfinite(draws).all()), "wall_s": time.perf_counter() - t0}
    ok = (lines["pt"]["finite"] and gate["finite"]
          and gate["mean_mode_balance_error"] < PT_BALANCE_MAX
          and lines["nuts"]["mode_balance_error"] > NUTS_BALANCE_MIN)
    return ok, {
        "phase": "tempering", "config": "bench_suite.py config 12 (:1435)",
        "target": BIMODAL,
        "pt": lines["pt"], "nuts": lines["nuts"], "pt_gate": gate,
        "ratio_pt_to_nuts_rank_min_ess_per_s": lines["pt"]["rank_min_ess_per_s"]
        / max(lines["nuts"]["rank_min_ess_per_s"], 1e-300),
        "gates": f"PT: the mean over {PT_GATE_RUNS} runs of the mode-balance error < "
                 f"{PT_BALANCE_MAX}; the NUTS control's > {NUTS_BALANCE_MIN} "
                 "(bench_suite.py:1555-1558)",
    }


# Slice 7: the GLM families at config 5's shard layout, 64 shards x 64
# observations x 8 features (bench_suite.py:750), the widest GLM layout the
# repo benchmarks; the Gaussian mixture at 64 shards x its generator's 128
# observations, 3 components.  No kernel: the JAX package computes these
# families outside Pallas, and so does the port.
FAMILY_LAYOUT = dict(n_shards=64, n_obs=64, n_features=8)
MIXTURE_LAYOUT = dict(n_shards=64, n_obs=128)
FAMILY_TIMED_EVALS = 30
# The model_check phase: the count-family comparison of the JAX package's
# tests/test_model_comparison.py:92 at width 8 on zero-inflated data, with
# config 3's 16 shards; each family fit by NUTS, 4 chains x 150 + 150 in
# lockstep; the top family's posterior predictive from 200 draws.
MODEL_CHECK_DATA = dict(n_shards=16, n_obs=256, n_features=8, pi=0.35, seed=5)
MODEL_CHECK_NUTS = (4, 150, 150)
MODEL_CHECK_SEED = 1
MODEL_CHECK_PREDICTIVE_DRAWS = 200
# Its R-hat gate.  The slopes and each family's own parameters must have
# mixed (< 1.05).  The intercept hierarchy (b0 + tau * b_raw) is a ridge
# that 150 + 150 draws do not resolve: the JAX package on the same data
# reads 1.05-1.10 there (tests/test_torch_model_comparison.py, run as a
# script), so it is held to bench_suite's < 1.2.
RHAT_MIXED, RHAT_HIERARCHY = 1.05, 1.2
HIERARCHY_LEAVES = ("b0", "b_raw", "log_tau")


def _family_cases():
    """(name, class, the function making its data, model kwargs) of each
    family of the families phase."""
    from pytensor_federated_torch import models as M

    L = FAMILY_LAYOUT
    return [
        ("poisson", M.FederatedPoissonGLM, lambda d: M.generate_count_data(**L, device=d), {}),
        ("negbin", M.FederatedNegBinGLM,
         lambda d: M.generate_count_data(**L, dispersion=4.0, device=d), {}),
        ("zip", M.FederatedZeroInflPoissonGLM,
         lambda d: M.generate_zi_count_data(**L, pi=0.3, device=d), {}),
        ("zinb", M.FederatedZeroInflNegBinGLM,
         lambda d: M.generate_zi_count_data(**L, pi=0.3, dispersion=4.0, device=d), {}),
        ("robust", M.FederatedRobustRegression, lambda d: M.generate_robust_data(**L, device=d), {}),
        ("gamma", M.FederatedGammaGLM, lambda d: M.generate_gamma_data(**L, device=d), {}),
        ("ordinal", M.FederatedOrdinalRegression,
         lambda d: M.generate_ordinal_data(**L, n_categories=5, device=d), {"n_categories": 5}),
        ("softmax", M.FederatedSoftmaxRegression,
         lambda d: M.generate_multinomial_data(**L, n_classes=4, device=d), {"n_classes": 4}),
        ("softmax_suffstats", M.FederatedSoftmaxRegression,
         lambda d: M.generate_multinomial_data(**L, n_classes=4, device=d),
         {"n_classes": 4, "use_suffstats": True}),
        ("hier_softmax", M.HierarchicalSoftmaxRegression,
         lambda d: M.generate_hier_multinomial_data(**L, n_classes=4, device=d), {"n_classes": 4}),
        ("weibull", M.FederatedWeibullAFT, lambda d: M.generate_survival_data(**L, device=d), {}),
        ("mixture", M.FederatedGaussianMixture,
         lambda d: M.generate_mixture_data(**MIXTURE_LAYOUT, device=d), {"n_components": 3}),
    ]


def phase_families(dev="cuda", reps=FAMILY_TIMED_EVALS):
    """Each GLM family and the Gaussian mixture on ``dev``: value and
    gradient at three points against the same model in float64 on the
    CPU; ms and CUDA launches per logp+grad; the softmax model's raw and
    sufficient-statistic forms behind bench.py's equality gate."""
    from pytensor_federated_torch.samplers.util import ravel

    rows, ok, datasets = {}, True, {}
    for name, cls, build, kw in _family_cases():
        base = name.replace("_suffstats", "")  # the two softmax forms share data
        if base not in datasets:
            datasets[base] = build(dev)[0]
        data = datasets[base]
        model = cls(data, **kw)
        model64 = cls(_as_f64_cpu(data), **kw)
        points = _three_points(model.init_params())
        values_ok, values = _against_f64(model, model64, points)
        # Where float32 arithmetic itself misses the gate (the Student-t's
        # nu-gradient at nu ~ 670 is a difference of digammas that cancels
        # to ~1e-3 of its terms), the card must land within twice the error
        # of the same model in float32 on the CPU at that point.
        _, cpu32 = _against_f64(cls(_as_cpu(data), **kw), model64,
                                {k: _as_cpu(v) for k, v in points.items()})
        for card, ref in zip(values, cpu32):
            card["cpu_f32_value_rel_err"] = ref["value_rel_err"]
            card["cpu_f32_grad_err_over_tol"] = ref["grad_err_over_tol"]
            if not card["ok"] and not ref["ok"] and math.isfinite(card["logp"]):
                card["ok"] = (card["grad_err_over_tol"] <= 2 * ref["grad_err_over_tol"]
                              and card["value_rel_err"] <= max(
                                  MODEL_VALUE_RTOL, 2 * ref["value_rel_err"]))
                card["gate"] = "within 2x the CPU float32 error"
        values_ok = all(v["ok"] for v in values)
        p = model.init_params()
        row = {
            "class": cls.__name__, **kw,
            "size": {"shards": data.n_shards, "max_obs": data.max_len,
                     "observations": int(data.mask.sum()),
                     "params": sum(t.numel() for t in p.values())},
            "values": values,
            "ms_per_logp_and_grad": _ms_per_eval(lambda: model.logp_and_grad(p), dev, reps),
            "cuda_launches_per_logp_and_grad": _launches(lambda: model.logp_and_grad(p), dev, 5),
            "ok": values_ok,
        }
        if name == "softmax_suffstats":
            raw = cls(data, n_classes=kw["n_classes"])
            flat0, unravel = ravel(p)
            gate = []
            for pname, x in (("x0", flat0), ("x0+0.1*arange", flat0 + 0.1 * torch.arange(
                    flat0.shape[0], dtype=flat0.dtype, device=flat0.device))):
                g_ok, err = _flat_close(model.logp_and_grad(unravel(x)),
                                        raw.logp_and_grad(unravel(x)))
                gate.append({"point": pname, **err, "ok": g_ok})
                row["ok"] &= g_ok
            row["equality_gate_vs_raw"] = gate
        rows[name] = row
        ok &= row["ok"]
    return ok, {
        "phase": "families",
        "layout": {"glm": {**FAMILY_LAYOUT, "source": "config 5, bench_suite.py:750"},
                   "mixture": {**MIXTURE_LAYOUT, "components": 3,
                               "source": "generate_mixture_data's n_obs"}},
        "tolerance": {"value_rtol": MODEL_VALUE_RTOL, "grad_rtol": MODEL_GRAD_RTOL,
                      "grad_atol": f"{MODEL_GRAD_ATOL_OF_MAX} x max|grad of the leaf|",
                      "against": "the same model in float64 on the CPU",
                      "softmax_forms": {"value_rtol": AUTOGRAD_RTOL_VALUE,
                                        "grad_rtol": AUTOGRAD_RTOL_GRAD,
                                        "grad_atol": AUTOGRAD_ATOL_GRAD,
                                        "source": "bench.py's equality gate"}},
        "families": rows,
        "gates": "every family's values against float64 (or within 2x the CPU float32 "
                 "error where float32 misses the tolerance); softmax suffstats == raw",
    }


def _zero_share(y, keep):
    return (y[..., keep] == 0).double().mean(-1)


MODEL_CHECK_FAMILIES = {"poisson": "FederatedPoissonGLM", "negbin": "FederatedNegBinGLM",
                        "zip": "FederatedZeroInflPoissonGLM", "zinb": "FederatedZeroInflNegBinGLM"}


def _model_check_data(data_kw, dev):
    from pytensor_federated_torch import models as M

    kw = dict(data_kw)
    return M.generate_zi_count_data(kw.pop("n_shards"), **kw, device=dev)[0]


def _model_check_fit(name, data_kw, nuts, dev, conn):
    """One family's fit in a process of its own: the data rebuilt from
    the seed on ``dev``, NUTS, the pointwise log-likelihood matrix
    (padding dropped) and the split R-hat of each leaf, sent back on
    ``conn`` with the draws."""
    sys.path.insert(0, str(ROOT))
    try:
        from pytensor_federated_torch import models as M
        from pytensor_federated_torch import samplers as S

        if torch.device(dev).type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"the {name} fit found no GPU")
        torch.set_num_threads(1)  # four fits share the host's cores
        data = _model_check_data(data_kw, dev)
        m = getattr(M, MODEL_CHECK_FAMILIES[name])(data)
        res, run = _model_nuts(m, dev, seed=MODEL_CHECK_SEED, nuts=nuts,
                               cuda_graph=torch.device(dev).type == "cuda")
        run["cuda_graph"] = torch.device(dev).type == "cuda"
        t0 = time.perf_counter()
        ll = S.pointwise_loglik_matrix(m.pointwise_loglik, res.samples, mask=data.mask)
        run["loglik_matrix_s"] = time.perf_counter() - t0
        conn.send({"name": name, "run": run, "ll": ll,
                   "rhat": {k: float(v.max()) for k, v in S.split_rhat(res.samples).items()},
                   "samples": {k: v.cpu().numpy() for k, v in res.samples.items()},
                   "device": torch.cuda.get_device_name() if torch.cuda.is_available() else dev})
    except Exception:
        conn.send({"name": name, "error": traceback.format_exc()})
    finally:
        conn.close()


def phase_model_check(dev="cuda", nuts=MODEL_CHECK_NUTS, data_kw=MODEL_CHECK_DATA,
                      predictive_draws=MODEL_CHECK_PREDICTIVE_DRAWS, timeout=900.0):
    """The model-checking workflow on ``dev``: Poisson, NB2, ZIP and ZINB
    fit by NUTS to zero-inflated counts; pointwise log-likelihoods, PSIS-LOO,
    WAIC and the ranking; the top family's posterior predictive share of
    zeros against the observed one; the Laplace approximation of ZINB
    beside its NUTS posterior.

    The four fits are independent, and each is bound by its host thread
    (eager dispatch, ~100-180 launches per evaluation, the card idle most
    of the time), so each runs in a process of its own (``spawn``), all
    four at once on the one card, as a modeller would fit competing
    models; the ranking, the predictive and Laplace run here after."""
    import multiprocessing as mp

    import numpy as np

    from pytensor_federated_torch import models as M
    from pytensor_federated_torch import samplers as S

    ctx = mp.get_context("spawn")
    procs, conns = [], {}
    t0 = time.perf_counter()
    try:
        for name in MODEL_CHECK_FAMILIES:
            parent, child = ctx.Pipe()
            proc = ctx.Process(target=_model_check_fit, args=(name, data_kw, nuts, dev, child),
                               daemon=True)
            proc.start()
            procs.append(proc)
            conns[name] = parent
        replies = {}
        for name, conn in conns.items():
            if not conn.poll(max(1.0, timeout - (time.perf_counter() - t0))):
                raise RuntimeError(f"the {name} fit did not answer within {timeout} s")
            replies[name] = conn.recv()
            if "error" in replies[name]:
                raise RuntimeError(f"the {name} fit failed:\n{replies[name]['error']}")
    finally:
        for proc in procs:
            proc.join(timeout=30)
            if proc.is_alive():
                proc.kill()
                proc.join()
    fits_s = time.perf_counter() - t0

    data = _model_check_data(data_kw, dev)
    (_X, y), mask = data.tree()
    keep = mask > 0
    obs_zero = float(_zero_share(y, keep))
    lls = {name: r["ll"] for name, r in replies.items()}
    rhat = {name: r["rhat"] for name, r in replies.items()}
    fits = {}
    for name, r in replies.items():
        loo, w = S.psis_loo(lls[name]), S.waic(lls[name])
        fits[name] = {"nuts": r["run"], "device": r["device"], "split_rhat": rhat[name],
                      "elpd_loo": loo["elpd_loo"], "p_loo": loo["p_loo"], "se": loo["se"],
                      "n_bad_k": loo["n_bad_k"], "elpd_waic": w["elpd_waic"],
                      "p_waic": w["p_waic"], "loglik_matrix": list(lls[name].shape)}
    rows = S.compare(lls)
    top = rows[0]["model"]
    samples = {name: {k: torch.as_tensor(v, device=dev) for k, v in r["samples"].items()}
               for name, r in replies.items()}
    models = {name: getattr(M, cls)(data) for name, cls in MODEL_CHECK_FAMILIES.items()}
    t1 = time.perf_counter()
    sims = S.posterior_predictive(models[top].predictive, samples[top],
                                  torch.Generator(device=dev).manual_seed(2),
                                  num_draws=predictive_draws)
    _sync(dev)
    predictive_s = time.perf_counter() - t1
    sim_zero = _zero_share(sims, keep).cpu().numpy()
    t1 = time.perf_counter()
    zinb = models["zinb"]
    lap = S.laplace_approximation(zinb.logp, zinb.init_params())
    laplace_s = time.perf_counter() - t1
    lap_sd = lap.stddev()

    def nuts_moments(k):
        d = samples["zinb"][k].reshape(-1, *lap.mode[k].shape)
        return d.mean(0).reshape(-1).tolist(), d.std(0).reshape(-1).tolist()

    beside = {k: dict(zip(("nuts_mean", "nuts_sd"), nuts_moments(k)),
                      laplace_mean=lap.mode[k].reshape(-1).tolist(),
                      laplace_sd=lap_sd[k].reshape(-1).tolist())
              for k in ("logit_pi", "log_phi", "b0", "w")}
    by_name = {r["model"]: r for r in rows}
    lo, hi = np.quantile(sim_zero, [0.05, 0.95])
    zi = [rhat["zip"], rhat["zinb"]]
    gates = {
        "rhat_zi_mixed_below_1.05": all(
            v < RHAT_MIXED for r in zi for k, v in r.items() if k not in HIERARCHY_LEAVES),
        "rhat_zi_hierarchy_below_1.2": all(
            v < RHAT_HIERARCHY for r in zi for k, v in r.items() if k in HIERARCHY_LEAVES),
        "zero_inflated_first": top in ("zip", "zinb"),
        "poisson_beyond_2_se": -by_name["poisson"]["d_elpd"] > 2 * by_name["poisson"]["d_se"],
        "zero_share_in_central_90": bool(lo <= obs_zero <= hi),
        "finite": all(f["nuts"]["finite"] for f in fits.values()) and bool(
            torch.isfinite(sims).all()),
    }
    return all(gates.values()), {
        "phase": "model_check",
        "data": {**data_kw, "observations": int(keep.sum()),
                 "source": "tests/test_model_comparison.py:92 at width 8, config 3's 16 shards"},
        "nuts": {"chains": nuts[0], "warmup": nuts[1], "draws": nuts[2], "seed": MODEL_CHECK_SEED},
        "fits_s": fits_s,
        "fits": fits,
        "compare": rows,
        "predictive": {"family": top, "draws": predictive_draws, "seconds": predictive_s,
                       "shape": list(sims.shape), "observed_zero_share": obs_zero,
                       "simulated_zero_share_mean": float(sim_zero.mean()),
                       "central_90": [float(lo), float(hi)]},
        "laplace_zinb": {"seconds": laplace_s, "logp_at_mode": lap.logp_at_mode,
                         "beside_nuts": beside},
        "gates": gates,
    }


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--only", choices=["kernels", "federated", "models", "samplers", "slice6",
                                           "slice7", "slice8"],
                        help="kernels: device, build and kernels only; federated: device, "
                             "build, nuts and federated only; models: device, build, radon, "
                             "logistic and lv_ode only; samplers: device, build, nuts, "
                             "wide_logistic, logistic and chees only; slice6: device, build, "
                             "lgssm, gp and tempering only; slice7: device, build, families "
                             "and model_check only; slice8: device, build, nuts, federated "
                             "and pool only")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    if not (ROOT / "pytensor_federated_torch").is_dir():
        print(f"chip_smoke: no pytensor_federated_torch package beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))

    # The dense mass matrix's matvecs (nuts_large) are the port's only
    # float32 matmuls: full float32, TF32 held off for matmuls and cuDNN.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    smi = _nvidia_smi()
    part, bw, flops = _peak(name)
    emit({"phase": "device", "name": name, "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "count": torch.cuda.device_count(),
          "peak": {"part": part, "bytes_per_s": bw, "f32_flop_per_s": flops},
          "tf32": {"matmul": torch.backends.cuda.matmul.allow_tf32,
                   "cudnn": torch.backends.cudnn.allow_tf32}})

    from pytensor_federated_torch.ops import _build

    t0 = time.perf_counter()
    build_s = _build.build_all()
    emit({"phase": "build", "seconds": build_s, "wall_s": time.perf_counter() - t0,
          "ptxas": {k: [ln for ln in v.splitlines() if "registers" in ln or "spill" in ln]
                    for k, v in _build.build_logs.items()}})

    phases = [
        ("kernels", lambda: phase_kernels(bw, flops)),
        ("autograd", phase_autograd),
        ("nuts", lambda: phase_nuts("nuts", FLAGSHIP[1], *NUTS_FLAGSHIP,
                                    dense_mass=False)),
        ("nuts_large",
         lambda: phase_nuts("nuts_large", LARGE_PATH[1], *NUTS_LARGE, dense_mass=True)),
        ("federated", lambda: phase_federated(lines.get("nuts", {}))),
        ("pool", lambda: phase_pool(lines.get("federated", {}))),
        ("radon", phase_radon),
        ("logistic", phase_logistic),
        ("lv_ode", phase_lv_ode),
        ("wide_logistic", phase_wide_logistic),
        ("chees", lambda: phase_chees(lines.get("logistic", {}).get("nuts", {}))),
        ("lgssm", phase_lgssm),
        ("gp", phase_gp),
        ("tempering", phase_tempering),
        ("families", phase_families),
        ("model_check", phase_model_check),
    ]
    if args.only == "kernels":
        phases = phases[:1]
    elif args.only == "federated":
        phases = [ph for ph in phases if ph[0] in ("nuts", "federated")]
    elif args.only == "models":
        phases = [ph for ph in phases if ph[0] in ("radon", "logistic", "lv_ode")]
    elif args.only == "samplers":
        phases = [ph for ph in phases
                  if ph[0] in ("nuts", "wide_logistic", "logistic", "chees")]
    elif args.only == "slice6":
        phases = [ph for ph in phases if ph[0] in ("lgssm", "gp", "tempering")]
    elif args.only == "slice7":
        phases = [ph for ph in phases if ph[0] in ("families", "model_check")]
    elif args.only == "slice8":
        phases = [ph for ph in phases if ph[0] in ("nuts", "federated", "pool")]
    all_ok, lines = True, {}
    for pname, fn in phases:
        t0 = time.perf_counter()
        try:
            ok, line = fn()
        except Exception:
            traceback.print_exc()
            ok, line = False, {"phase": pname, "error": traceback.format_exc(limit=3)}
        line["phase_s"] = time.perf_counter() - t0
        line["ok"] = ok
        emit(line)
        lines[pname] = line
        all_ok &= ok
    if args.only:
        return 0 if all_ok else 1

    large = next(
        (r for r in lines["kernels"].get("shapes", []) if r["shape"] == list(LARGE_PATH)), {}
    )
    emit({"kernels": [{
        "name": "linreg_reductions",
        "route": "cuda",
        "source": "pytensor_federated_torch/ops/csrc/linreg_reductions.cu",
        "replaces": "pytensor_federated_tpu/ops/pallas_kernels.py:78",
        # Counted from zero just before each NUTS phase, read just after
        # (in the federated phase, by the four node processes; in the pool
        # phase, by the eight nodes, over its NUTS run and its windows).
        "launches": sum(lines[p].get("kernel_launches", 0) for p in ("nuts", "nuts_large", "pool"))
                    + lines["federated"].get("nuts", {}).get("kernel_launches", 0),
        "cuda_launches_per_call": lines["kernels"].get("cuda_launches_per_call"),
        "shape": list(LARGE_PATH),
        "max_abs_err": large.get("max_abs_err"),
        "ms": large.get("ms"),
        "device_ms": large.get("device_ms"),
        "plain_ms": large.get("plain_ms"),
        "bound_ms": large.get("bound_ms"),
        "bound_by": large.get("bound_by"),
        "library_ms": None,
        # The chain axis: one launch for C parameter sets, at 8 x 131,072.
        "chain_batched": [
            {k: r.get(k) for k in ("chains", "ms", "device_ms", "plain_ms", "bound_ms",
                                   "bound_by", "max_abs_err", "cuda_launches_per_call")}
            for r in lines["kernels"].get("chains", []) if r["shape"] == list(LARGE_PATH)
        ],
    }]})
    if not all_ok:
        print("chip_smoke: a phase failed", file=sys.stderr)
        return 1
    print(smi)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

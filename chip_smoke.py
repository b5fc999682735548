#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one GPU and check it.

    python3 chip_smoke.py                  # every phase
    python3 chip_smoke.py --only kernels   # device, build and kernels

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
   profiler) beside the bound.
4. ``autograd`` — value and gradient of ``prior + data_logp(kernel)`` at
   the flagship size against plain autograd and the sufficient-statistic
   form, at the origin and at a perturbed point; double backward raises.
5. ``nuts``    — ``sample()`` with NUTS on the flagship posterior through
   the kernel, 2 chains x 300 warmup + 300 draws.
6. ``nuts_large`` — the same at 8 x 131,072 observations, so the kernel
   moves real bytes on every leapfrog step: 1 chain x 600 warmup + 900
   draws with a dense mass matrix.  At this size the data pin every
   shard's intercept + offset to ~0.0014 while only the offsets' prior
   places the intercept (sd ~0.1): a ridge ~70x longer than it is wide.
   With a diagonal mass or a short warmup, the split R-hat of the
   intercept and offsets lands above 1.05 for many seeds (as with the
   JAX package's sampler on this posterior); a dense mass adapted over
   600 warmup draws straightens the ridge.  Even then the draws move
   slowly along it: with 300 draws the split R-hat of the intercept and
   offsets varies around 1.05 from one trajectory to the next (a change
   in the last bits of a sum is enough to move it across), so the phase
   takes 900.

Then the kernel record line, the ``nvidia-smi`` line and, last, the
device line.  With ``--only kernels`` it stops after the kernels phase
and prints neither the kernel record line nor the device line.  Any
failed phase makes the script exit non-zero; without
PyTorch, without CUDA, or without the package beside it, it exits
non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
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


def _bound(S, N, bw, flops):
    """Least time (ms) for one call at (S, N), and what sets it: x, y and
    mask (12 S N bytes), the offsets and the three scalars read once, the
    (S, 4) result and the four totals written once."""
    nbytes = 12 * S * N + 4 * S + 12 + 16 * (S + 1)
    t_bytes = nbytes / bw * 1e3
    t_ops = _FLOPS_PER_OBS * S * N / flops * 1e3
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
    names; ``None`` when the profiler records no device activity."""
    on_card = [e.name for e in _card_events(fn, calls)]
    if not on_card:
        return None, []
    return len(on_card) / calls, sorted(set(on_card))


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
    return ok, {
        "phase": "kernels",
        "kernel": "linreg_reductions",
        "tolerance": {k: {"kind": v[0], "value": v[1]} for k, v in TOL.items()},
        "totals_tolerance": "4e-6 x sum over shards of |per-shard output| (float64 sum)",
        "tile": lib.linreg_tile(),
        "persistent_blocks": lib.linreg_persistent_blocks(),
        "shapes": records,
        "padding_inert": pad_ok,
        "scalar_path_ok": shift_ok,
        "two_streams_ok": streams_ok,
        "cuda_launches_per_call": per_call,
        "cuda_launches_per_forward": per_forward,
        "device_activity": sorted(set(names) | set(forward_names)),
        "bound_note": "the larger of 12*S*N + 4*S + 12 bytes read and 16*(S+1) written over "
                      f"the peak memory rate and {_FLOPS_PER_OBS}*S*N float32 operations over "
                      "the peak float32 rate",
        "library_ms": None,
        "library_note": "no single PyTorch call computes this function",
    }


def _flat_close(a, b):
    from pytensor_federated_torch.samplers.util import ravel

    (va, ga), (vb, gb) = a, b
    ga, gb = ravel(ga)[0], ravel(gb)[0]
    v_ok = abs(float(va) - float(vb)) <= AUTOGRAD_RTOL_VALUE * abs(float(vb))
    g_ok = bool(
        ((ga - gb).abs() <= AUTOGRAD_ATOL_GRAD + AUTOGRAD_RTOL_GRAD * gb.abs()).all()
    )
    rel = abs(float(va) - float(vb)) / abs(float(vb))
    return v_ok and g_ok, {"value_rel_err": rel, "grad_max_abs_err": float((ga - gb).abs().max())}


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
    recovered = {}
    for k, d in derived.items():
        mean, sd = float(d.mean()), float(d.std())
        recovered[k] = {"mean": mean, "sd": sd, "true": TRUE[k],
                        "within_4sd": abs(mean - TRUE[k]) <= 4 * sd}
    finite = all(bool(torch.isfinite(v).all()) for v in s.values())
    ok = (
        launches >= grad_evals > 0
        and max_rhat < 1.05
        and finite
        and all(r["within_4sd"] for r in recovered.values())
    )
    return ok, {
        "phase": name,
        "size": [8, n_obs],
        "chains": chains, "warmup": warmup, "draws": draws, "dense_mass": dense_mass,
        "wall_s": wall,
        "grad_evals": grad_evals,
        "kernel_launches": launches,
        "launches_per_grad_eval": launches / max(grad_evals, 1),
        "ms_per_grad_eval": wall * 1e3 / max(grad_evals, 1),
        "mean_tree_depth": float(res.stats["depth"].float().mean()),
        "divergences": int(res.stats["diverging"].sum()),
        "max_split_rhat": max_rhat,
        "recovered": recovered,
        "finite": finite,
    }


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--only", choices=["kernels"],
                        help="stop after the kernels phase (device, build, kernels)")
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
        ("nuts", lambda: phase_nuts("nuts", FLAGSHIP[1], 2, 300, 300, dense_mass=False)),
        ("nuts_large",
         lambda: phase_nuts("nuts_large", LARGE_PATH[1], 1, 600, 900, dense_mass=True)),
    ]
    if args.only == "kernels":
        phases = phases[:1]
    all_ok, lines = True, {}
    for pname, fn in phases:
        try:
            ok, line = fn()
        except Exception:
            traceback.print_exc()
            ok, line = False, {"phase": pname, "error": traceback.format_exc(limit=3)}
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
        # Counted from zero just before each NUTS phase, read just after.
        "launches": sum(lines[p].get("kernel_launches", 0) for p in ("nuts", "nuts_large")),
        "cuda_launches_per_call": lines["kernels"].get("cuda_launches_per_call"),
        "shape": list(LARGE_PATH),
        "max_abs_err": large.get("max_abs_err"),
        "ms": large.get("ms"),
        "device_ms": large.get("device_ms"),
        "plain_ms": large.get("plain_ms"),
        "bound_ms": large.get("bound_ms"),
        "bound_by": large.get("bound_by"),
        "library_ms": None,
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

"""Shared constants, device resolution, the card's preflight probe, a
minimal pytree walker, the load-balancing pick and the host transport's
per-thread event loop.

The port keeps its own copy of what it needs from the JAX package's
``utils.py`` (it imports nothing from that package), and replaces
``jax.tree_util`` with the small walkers below: parameter and shard
trees in this package are nested tuples, lists and dicts of tensors,
and that is all they need to walk.
"""

from __future__ import annotations

import asyncio
import math
import os
import subprocess
import sys
import threading
from pathlib import Path
from typing import Any, Callable, List, Optional, Sequence, Tuple, TypeVar

import torch

# Shared Gaussian constant — single definition for every model/kernel.
LOG_2PI = math.log(2.0 * math.pi)


def resolve_device(device: Any = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless told otherwise.

    Raises when CUDA is asked for (explicitly, or by passing ``None``)
    and no CUDA device is present — an entry point never carries on
    quietly on the CPU; callers that mean the CPU pass ``device="cpu"``.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but CUDA is not available; "
            "pass device='cpu' to run on the CPU"
        )
    return dev


_PROBE_LIVE = (
    "import torch\n"
    "assert torch.cuda.is_available(), 'CUDA is not available'\n"
    "assert float(torch.ones((), device='cuda').sum()) == 1.0\n"
    "print('LIVE', flush=True)\n"
)
# Build (into the caller's build directory, passed as $PFTPU_CACHE_DIR)
# and launch the Hopper kernel at 8 x 64: ones for x, 2 for y, all
# parameters 0, so each shard's gmu (sum of residuals / sigma^2) is 2 N.
_PROBE_KERNEL = (
    "from pytensor_federated_torch.utils import enable_compilation_cache\n"
    "enable_compilation_cache()\n"
    "from pytensor_federated_torch.ops.linreg_kernel import linreg_reductions\n"
    "S, N = 8, 64\n"
    "x = torch.ones((S, N), device='cuda'); y = 2.0 * x; m = torch.ones_like(x)\n"
    "sc = torch.zeros(3, device='cuda'); off = torch.zeros(S, device='cuda')\n"
    "ll, gmu, gx, gz = linreg_reductions(sc, off, x, y, m)\n"
    "assert bool((gmu.cpu() == 2.0 * N).all()), gmu.cpu()\n"
    "print('KERNEL_OK', flush=True)\n"
)


def _probe(try_kernel: bool, timeout_s: float) -> Tuple[bool, bool, str]:
    """Run the probe's child; ``(live, kernel_ok, stderr)``."""
    from .ops import _build
    from .telemetry import flightrec

    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
    env["PFTPU_CACHE_DIR"] = str(_build.BUILD_DIR)
    code = _PROBE_LIVE + (_PROBE_KERNEL if try_kernel else "")
    timed_out = False
    try:
        res = subprocess.run(
            [sys.executable, "-c", code], timeout=timeout_s, capture_output=True, env=env
        )
        out = (res.stdout or b"").decode("utf-8", "replace")
        err = (res.stderr or b"").decode("utf-8", "replace")
    except subprocess.TimeoutExpired as e:
        out = (e.stdout or b"").decode("utf-8", "replace")
        err = (e.stderr or b"").decode("utf-8", "replace") + (
            f"\nthe probe timed out after {timeout_s} s"
        )
        timed_out = True
    except OSError as e:
        flightrec.record("probe.backend", verdict="unrunnable", error=str(e))
        return False, False, f"the probe could not run: {e}"
    live, kernel_ok = "LIVE" in out, "KERNEL_OK" in out
    flightrec.record(
        "probe.backend",
        verdict="live" if live else ("timeout" if timed_out else "dead"),
        try_kernel=try_kernel,
        kernel_ok=kernel_ok,
        timeout_s=timeout_s,
    )
    return live, kernel_ok, err


def probe_backend(*, try_kernel: bool = False, timeout_s: float = 180.0) -> Tuple[bool, bool]:
    """Probe the card in a subprocess: ``(live, kernel_ok)``.

    One child process, so that a hung driver or a failed build cannot
    take the caller with it.  The child prints ``LIVE`` after an op on
    ``cuda`` and — only with ``try_kernel`` — ``KERNEL_OK`` after it
    has built (``nvcc``, at first use) and launched the Hopper kernel
    and checked its answer.  A hang is cut off by the timeout, and the
    partial output still tells a dead card from a failed kernel.  The
    child's stderr goes to this process's stderr when it failed."""
    live, kernel_ok, err = _probe(try_kernel, timeout_s)
    if not live or (try_kernel and not kernel_ok):
        print("# backend probe failed:\n" + err[-2000:], file=sys.stderr)
    return live, kernel_ok


def ensure_live_backend(
    *, try_kernel: bool = True, timeout_s: float = 150.0, device: Any = None
) -> bool:
    """Preflight the card before this process uses it; returns whether
    the kernel ran (``try_kernel``).

    A caller that means the CPU passes ``device="cpu"`` and is not
    probed (returns False).  Otherwise the card is probed in a
    subprocess (:func:`probe_backend`); a dead or missing card, or with
    ``try_kernel`` a kernel that does not build, launch or agree,
    raises ``RuntimeError`` with the probe's stderr.  Nothing falls back
    to the CPU."""
    if torch.device("cuda" if device is None else device).type == "cpu":
        return False
    live, kernel_ok, err = _probe(try_kernel, timeout_s)
    if not live:
        raise RuntimeError(f"the CUDA device is not usable (probe output below):\n{err[-4000:]}")
    if try_kernel and not kernel_ok:
        raise RuntimeError(
            f"the CUDA device is live but the kernel failed (probe output below):\n{err[-4000:]}"
        )
    return try_kernel


def force_cpu_backend() -> None:
    """Hide CUDA from this process (``CUDA_VISIBLE_DEVICES=""``), for
    CPU-only work.  Call it before anything asks for CUDA: it raises if
    CUDA was already initialised or a device is still visible after it
    (a device count torch had already cached)."""
    if torch.cuda.is_initialized():
        raise RuntimeError(
            "CUDA is already initialised in this process; force_cpu_backend must run "
            "before the first CUDA call"
        )
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    if torch.cuda.is_available():
        raise RuntimeError(
            "CUDA devices were counted before force_cpu_backend; call it before the "
            "first CUDA query"
        )


def enable_compilation_cache(path: Optional[str] = None) -> None:
    """Point the kernels' build directory (``ops/_build.py:BUILD_DIR``)
    at ``path`` (default: ``$PFTPU_CACHE_DIR``; without it the directory
    stays ``build/torch_kernels`` under the checkout).  Libraries built
    there are found by later processes, keyed by a hash of the source
    and flags.  Call before the first kernel use in the process."""
    from .ops import _build

    path = path or os.environ.get("PFTPU_CACHE_DIR")
    if path is None:
        return
    os.makedirs(path, exist_ok=True)
    _build.BUILD_DIR = Path(path)


def tree_structure(tree: Any) -> Any:
    """A hashable description of the container layout (leaves elided).

    Dict keys are sorted, as ``jax.tree_util`` orders them."""
    if isinstance(tree, dict):
        return ("dict", tuple((k, tree_structure(tree[k])) for k in sorted(tree)))
    if isinstance(tree, (tuple, list)):
        return (type(tree).__name__, tuple(tree_structure(t) for t in tree))
    return "*"


def tree_leaves(tree: Any) -> List[Any]:
    """Leaves in ``jax.tree_util.tree_leaves`` order (sorted dict keys)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [leaf for t in tree for leaf in tree_leaves(t)]
    return [tree]


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` leafwise over trees of one structure, visiting leaves
    in :func:`tree_leaves` order (so ``fn`` may consume an iterator)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    if isinstance(tree, (tuple, list)):
        return type(tree)(
            tree_map(fn, t, *(r[i] for r in rest)) for i, t in enumerate(tree)
        )
    return fn(tree, *rest)


def value_and_grad(fn: Callable[[Any], torch.Tensor], params: Any) -> Tuple[torch.Tensor, Any]:
    """``(fn(params), d fn / d params)`` by one reverse pass.

    ``params`` is a tree of tensors; the gradient has its structure.
    Inputs are detached first, so the call never writes into the
    caller's autograd graph.  Inside ``torch.func.vmap`` (over chains,
    say), where ``torch.autograd.grad`` cannot run on batched tensors,
    the same reverse pass is ``torch.func.vjp``'s, run without building a
    graph of the backward (first order, as outside vmap)."""
    if torch._C._are_functorch_transforms_active():
        value, vjp_fn = torch.func.vjp(fn, params)
        (grads,) = vjp_fn(torch.ones_like(value), create_graph=False)
        return value, grads
    leaves = tree_map(lambda t: t.detach().requires_grad_(True), params)
    value = fn(leaves)
    grads = torch.autograd.grad(value, tree_leaves(leaves))
    it = iter(grads)
    return value.detach(), tree_map(lambda _: next(it), leaves)


def value_and_first_grad(fn: Callable[[Any], torch.Tensor], params: Any) -> Tuple[torch.Tensor, Any]:
    """``(fn(params), d fn / d params)`` by one reverse pass, where the
    value keeps its autograd graph to ``params``: a caller's own
    backward through the value (a sampler differentiating a model that
    contains it) runs through ``fn`` again, first order, while the
    returned gradient is first order and carries no graph.  Each leaf
    of ``params`` gets its own gradient, also where one tensor is
    passed twice.  A value that is not a scalar gets the gradient of its
    sum.  Inside ``torch.func`` transforms (``vmap`` over
    chains) it is :func:`value_and_grad`'s first-order ``torch.func.vjp``,
    whose value stays differentiable at the outer level."""
    if torch._C._are_functorch_transforms_active():
        return value_and_grad(fn, params)
    with torch.enable_grad():
        leaves = tree_map(
            lambda t: t.view_as(t) if t.requires_grad else t.detach().requires_grad_(True),
            params,
        )
        value = fn(leaves)
        grads = torch.autograd.grad(value, tree_leaves(leaves), torch.ones_like(value),
                                    retain_graph=True)
    it = iter(grads)
    return value, tree_map(lambda _: next(it), leaves)


def cholesky_or_nan(a: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of each matrix in ``a``, NaN where the
    factorization fails — the value ``jnp.linalg.cholesky`` gives.

    ``torch.linalg.cholesky`` raises on a non-positive-definite input,
    and on CUDA reads its error flag back to the host to do so: one host
    sync per call, and a crash on a proposal that a sampler should
    simply reject.  ``cholesky_ex`` without its check does neither; the
    failed matrices' factors become NaN, so the NaN reaches the energy
    and the proposal is rejected, as in the JAX package (whose failed
    factor is NaN below the diagonal and zero above it, as here)."""
    factor, info = torch.linalg.cholesky_ex(a, check_errors=False)
    return torch.where((info == 0)[..., None, None], factor, torch.nan).tril()


def solve_or_nan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a⁻¹ b`` for matrices ``b`` (``(..., n, k)``), NaN where ``a`` is
    singular, with no host sync (see :func:`cholesky_or_nan`)."""
    x, info = torch.linalg.solve_ex(a, b, check_errors=False)
    return torch.where((info == 0)[..., None, None], x, torch.nan)


T = TypeVar("T")


def argmin_none_or_func(
    items: Sequence[Optional[T]], func: Callable[[T], float]
) -> Optional[int]:
    """Index of the item minimizing ``func``, ignoring ``None`` entries.

    Returns ``None`` if every item is ``None``.  The gRPC client's load
    balancing picks the least-loaded healthy server with it (``None``
    marks an unresponsive one); ties go to the first.
    """
    best_i: Optional[int] = None
    best_v: Optional[float] = None
    for i, item in enumerate(items):
        if item is None:
            continue
        v = func(item)
        if best_v is None or v < best_v:
            best_i, best_v = i, v
    return best_i


_thread_loops = threading.local()


def get_event_loop() -> asyncio.AbstractEventLoop:
    """Return THIS thread's event loop (create and cache if necessary).

    The running loop when called from a coroutine; otherwise a private
    loop per thread, created once and kept: the sync wrappers of the
    host transports (``NodePool.probe_once``,
    ``PooledArraysClient.evaluate``, ``FleetCollector.scrape_once``)
    run their coroutines on it.  It is deliberately not installed with
    ``asyncio.set_event_loop``, so it never clobbers a loop the
    application registered for its own use.
    """
    try:
        return asyncio.get_running_loop()
    except RuntimeError:
        pass
    loop = getattr(_thread_loops, "loop", None)
    if loop is None or loop.is_closed():
        loop = asyncio.new_event_loop()
        _thread_loops.loop = loop
    return loop

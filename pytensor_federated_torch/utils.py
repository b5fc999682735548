"""Shared constants, device resolution, a minimal pytree walker and the
host transport's per-thread event loop.

The port keeps its own copy of what it needs from the JAX package's
``utils.py`` (it imports nothing from that package), and replaces
``jax.tree_util`` with the small walkers below: parameter and shard
trees in this package are nested tuples, lists and dicts of tensors,
and that is all they need to walk.
"""

from __future__ import annotations

import asyncio
import math
import threading
from typing import Any, Callable, List, Tuple

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

"""Chain-parallel federated sampling over a 2-D device mesh.

Port of the JAX package's ``parallel/multichain.py``.  The reference's
two outer parallelism axes — chains in separate host processes and
federated shards behind gRPC — become the two axes of one mesh:

    mesh = make_mesh({"chains": C, "shards": S}, devices=...)

Shard data are cut over ``"shards"`` and replicated over ``"chains"``:
slot ``(i, j)`` of the grid holds shard block ``j`` on its device.  The
chains are cut over ``"chains"``: chains slot ``i``'s block of chains is
evaluated on the devices of its row, each shards slot ``j`` taking the
value and gradient of its own shard block, and the row's partial values
and gradients are added on the row's first device in slot order — the
twin of the JAX package's ``_det_allsum`` (an ``all_gather`` and a
fixed-order sum), never a collective.  The prior is added once per
chain, after that sum.

In the JAX package every chain row runs its own loop in one SPMD
program, its members in lockstep.  Here ONE lockstep loop steps every
chain of every row (:func:`..samplers.mcmc.sample`'s design): a NUTS
transition runs as many leaves as the deepest chain needs, and each
leaf evaluates every row's block on its devices, one row after
another.  The loop's state and its random draws live on the grid's first
device.  On one card (a mesh of ``[cuda:0] * n``) that shows the
partition and the cross-slot sum, not concurrency across cards.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import numpy as np
import torch

from ..samplers.hmc import hmc_init
from ..samplers.mcmc import _warmup, graph_batch_logp_and_grad, make_kernel_step
from ..samplers.util import ravel
from ..utils import tree_map
from .mesh import CHAINS_AXIS, SHARDS_AXIS, Mesh
from .sharded import _leading_dim

__all__ = ["multichain_logp_and_grad", "multichain_sample"]


def _grid(mesh: Mesh, chains_axis: str, shards_axis: str) -> np.ndarray:
    """The mesh's devices as a ``(chains, shards)`` grid (the first
    device of every other axis)."""
    for axis in (chains_axis, shards_axis):
        if axis not in mesh.axis_names:
            raise ValueError(f"mesh has no axis {axis!r}: {mesh.axis_names}")
    grid = np.moveaxis(
        mesh.devices,
        (mesh.axis_names.index(chains_axis), mesh.axis_names.index(shards_axis)),
        (0, 1),
    )
    return grid.reshape(grid.shape[0], grid.shape[1], -1)[:, :, 0]


def multichain_logp_and_grad(
    per_shard_logp: Callable[[Any, Any], torch.Tensor],
    data: Any,
    unravel: Callable,
    *,
    mesh: Mesh,
    prior_logp: Optional[Callable[[Any], torch.Tensor]] = None,
    chains_axis: str = CHAINS_AXIS,
    shards_axis: str = SHARDS_AXIS,
) -> Callable[[torch.Tensor], tuple]:
    """The chain batch's value+grad on the 2-D mesh: ``lg(X: (C, d)) ->
    ((C,), (C, d))`` on the grid's first device, ``C`` divisible by the
    chains axis.

    For chains slot ``i`` and shards slot ``j``: the block of chains goes
    to device ``(i, j)``, where ``torch.func.vmap`` over its chains of
    the summed ``per_shard_logp`` over shard block ``j`` gives the local
    values, and one ``torch.autograd.grad`` of their sum the local
    gradients (each chain's own).  The row adds its shards slots' values
    and gradients on device ``(i, 0)`` in slot order, then the prior's."""
    grid = _grid(mesh, chains_axis, shards_axis)
    n_rows, n_cols = grid.shape
    n_shards = _leading_dim(data)
    if n_shards % n_cols != 0:
        raise ValueError(
            f"n_shards={n_shards} not divisible by mesh axis "
            f"{shards_axis!r} of size {n_cols}"
        )
    per = n_shards // n_cols
    blocks, placed = [], {}
    for i in range(n_rows):
        row = []
        for j in range(n_cols):
            key = (str(grid[i, j]), j)  # a device that repeats holds one copy
            if key not in placed:
                placed[key] = tree_map(
                    lambda leaf: leaf[j * per:(j + 1) * per].to(grid[i, j]), data)
            row.append(placed[key])
        blocks.append(row)
    home = grid[0, 0]

    def local(x, block):
        x = x.detach().requires_grad_(True)
        v = torch.func.vmap(
            lambda xc: torch.func.vmap(lambda d: per_shard_logp(unravel(xc), d))(block).sum()
        )(x)
        (g,) = torch.autograd.grad(v.sum(), x)
        return v.detach(), g

    def prior(x):
        x = x.detach().requires_grad_(True)
        v = torch.func.vmap(lambda xc: prior_logp(unravel(xc)))(x)
        (g,) = torch.autograd.grad(v.sum(), x)
        return v.detach(), g

    def lg(X: torch.Tensor):
        if X.shape[0] % n_rows != 0:
            raise ValueError(
                f"{X.shape[0]} chains not divisible by mesh axis "
                f"{chains_axis!r} of size {n_rows}"
            )
        per_row = X.shape[0] // n_rows
        vs, gs = [], []
        for i in range(n_rows):
            xi, row_dev = X[i * per_row:(i + 1) * per_row], grid[i, 0]
            v = g = None
            for j in range(n_cols):
                lv, lgr = local(xi.to(grid[i, j]), blocks[i][j])
                v = lv.to(row_dev) if v is None else v + lv.to(row_dev)
                g = lgr.to(row_dev) if g is None else g + lgr.to(row_dev)
            if prior_logp is not None:
                pv, pg = prior(xi.to(row_dev))
                v, g = v + pv, g + pg
            vs.append(v.to(home))
            gs.append(g.to(home))
        return torch.cat(vs), torch.cat(gs)

    return lg


def multichain_sample(
    per_shard_logp: Callable[[Any, Any], torch.Tensor],
    data: Any,
    init_params: Any,
    *,
    mesh: Mesh,
    generator: torch.Generator,
    num_samples: int = 100,
    num_warmup: int = 0,
    step_size: float = 0.1,
    kernel: str = "nuts",
    max_depth: int = 6,
    num_hmc_steps: int = 16,
    target_accept: float = 0.8,
    dense_mass: bool = False,
    prior_logp: Optional[Callable[[Any], torch.Tensor]] = None,
    chains_axis: str = CHAINS_AXIS,
    shards_axis: str = SHARDS_AXIS,
    jitter: float = 0.5,
    cuda_graph: bool = False,
    return_extra: bool = False,
):
    """Run C independent chains over S-sharded data on the 2-D mesh.

    ``init_params`` is one params tree; each chain starts from a jittered
    copy (``jitter`` times standard normals from ``generator``).  Returns
    ``(draws, accept, unravel)`` where ``draws`` has shape ``(chains,
    num_samples, dim)`` (flat parameter vectors) and ``accept`` ``(chains,
    num_samples)``, both on the grid's first device, where ``generator``
    must live.

    ``num_warmup > 0`` runs the same Stan-style warmup as
    :func:`..samplers.sample` (dual-averaged step size and a diagonal,
    or with ``dense_mass=True`` full, mass) with statistics per chain.
    With ``num_warmup=0`` the given ``step_size`` and a unit mass are
    used.  ``kernel`` is ``"nuts"`` or ``"hmc"``.  ``cuda_graph=True``
    (CUDA only) replays the chain batch's value+grad from a CUDA graph
    (:func:`..samplers.mcmc.graph_batch_logp_and_grad`).
    ``return_extra=True`` (port-only) appends a fourth element, a dict
    like :class:`..samplers.mcmc.SampleResult`'s ``extra``: with
    ``cuda_graph=True``, ``graph_replays`` (the batched evaluations
    replayed) and ``graph`` (the replay itself); else empty.

    This evaluates the caller's ``per_shard_logp`` over each slot's
    block; it adds no route of its own to a kernel."""
    if kernel not in ("nuts", "hmc"):
        raise ValueError(f"unknown kernel {kernel!r}")
    flat0, unravel = ravel(init_params)
    lg = multichain_logp_and_grad(
        per_shard_logp, data, unravel, mesh=mesh, prior_logp=prior_logp,
        chains_axis=chains_axis, shards_axis=shards_axis,
    )
    n_chains = mesh.shape[chains_axis]
    home = _grid(mesh, chains_axis, shards_axis)[0, 0]
    dim, dtype = flat0.shape[0], flat0.dtype
    init_flat = flat0.detach().to(home) + jitter * torch.randn(
        (n_chains, dim), generator=generator, dtype=dtype, device=home
    )
    if cuda_graph:
        lg = graph_batch_logp_and_grad(lg, init_flat)
    kernel_step = make_kernel_step(lg, kernel, max_depth=max_depth, num_hmc_steps=num_hmc_steps)
    if num_warmup > 0:
        warm = _warmup(
            lg, init_flat, generator, num_warmup=num_warmup, kernel_step=kernel_step,
            target_accept=target_accept, dense_mass=dense_mass,
        )
        state, eps, inv_mass = warm.state, warm.step_size, warm.inv_mass
    else:
        state = hmc_init(lg, init_flat)
        eps, inv_mass = step_size, torch.ones((dim,), dtype=dtype, device=home)
    draws, accept = [], []
    for _ in range(num_samples):
        state, info = kernel_step(state, generator, step_size=eps, inv_mass=inv_mass)
        draws.append(state.x)
        accept.append(info.accept_prob)
    out = (torch.stack(draws, dim=1), torch.stack(accept, dim=1), unravel)
    if return_extra:
        return out + ({"graph_replays": lg.calls, "graph": lg} if cuda_graph else {},)
    return out

"""Collectives across the processes of a multi-process mesh.

A mesh whose slots belong to several processes (:mod:`.multihost`) is
evaluated by every process on its own slots; these two functions carry
what crosses the process boundary, over the ``torch.distributed``
world the processes joined:

- :func:`gather_slots` — every slot's value, each process contributing
  its own slots', stacked in slot order on every process.  Its backward
  is the identity on the cotangent: each process passes back the
  cotangent of its own slots only.  Summing the gathered values in slot
  order gives every process the same bits as one process driving every
  slot would.
- :func:`exchange_slices` — the all-to-all of a reduce-scatter: slice
  ``i`` of every slot's vector goes to the process of slot ``i`` only,
  which adds them in slot order (the same bits again).
- :func:`sum_grads_across_processes` — the identity on a replicated
  parameter tree whose backward sums the cotangent over processes (in
  rank order, so every process holds the same bits).

Together they are the reference's ``fed_sum`` / ``fed_broadcast``
transpose pair: the forward sum's backward does not sum again, and the
parameter each process copies in receives every process's gradient
once.  An all-reduce whose backward all-reduces the cotangent as well
would multiply the gradient by the world size.

With the ``gloo`` backend the collectives run on CPU copies; with
``nccl`` on the tensors' own device.
"""

from __future__ import annotations

from typing import Any, List, Sequence

import torch

from ..utils import tree_leaves, tree_map
from .mesh import process_index


def _collective_device(t: torch.Tensor) -> torch.device:
    return t.device if torch.distributed.get_backend() == "nccl" else torch.device("cpu")


def all_gather_stacked(t: torch.Tensor) -> torch.Tensor:
    """Every process's ``t`` (one shape and dtype everywhere), stacked
    in rank order on ``t``'s device."""
    dist = torch.distributed
    src = t.detach().to(_collective_device(t)).contiguous()
    bufs = [torch.empty_like(src) for _ in range(dist.get_world_size())]
    dist.all_gather(bufs, src)
    return torch.stack(bufs).to(t.device)


class _GatherSlots(torch.autograd.Function):
    """``(owners, rank, home, *local) -> (n_slots, *shape)`` on ``home``:
    slot ``j``'s value from process ``owners[j]``; ``local`` are this
    process's slots' values, in slot order."""

    @staticmethod
    def forward(ctx, owners, rank, home, *local):
        # Each process sends its own slots' values only (every process
        # of a multihost mesh drives as many slots).
        stacked = all_gather_stacked(torch.stack([v.detach().to(home) for v in local]))
        place = [owners[:j].count(p) for j, p in enumerate(owners)]
        ctx.mine = [j for j, p in enumerate(owners) if p == rank]
        ctx.devices = [v.device for v in local]
        return torch.stack([stacked[p, k] for p, k in zip(owners, place)])

    @staticmethod
    def backward(ctx, g):
        return (None, None, None, *(g[j].to(d) for j, d in zip(ctx.mine, ctx.devices)))


def gather_slots(local: Sequence[torch.Tensor], owners: Sequence[int],
                 home: torch.device) -> torch.Tensor:
    """Every slot's value (``(n_slots, *shape)`` on ``home``), from this
    process's slots' values ``local`` (in slot order) and the other
    processes' own; ``owners[j]`` is the rank of slot ``j``'s process."""
    if torch._C._are_functorch_transforms_active():
        raise ValueError(
            "a multi-process mesh evaluates one parameter set at a time; "
            "it does not run under torch.func transforms"
        )
    return _GatherSlots.apply(tuple(int(p) for p in owners), process_index(), home, *local)


def exchange_slices(local: Sequence[torch.Tensor],
                    owners: Sequence[int]) -> List[List[torch.Tensor]]:
    """For each of this process's slots ``i`` (in slot order), slice ``i``
    of every slot's vector, in slot order.

    ``local`` are this process's slots' vectors (in slot order, one
    length and dtype, ``len(owners)`` equal slices each); ``owners[j]``
    is the rank of slot ``j``'s process.  One ``all_to_all``: each
    process sends every other process the slices of its slots, and
    receives ``len(local) * len(vector)`` elements in all, not every
    slot's whole vector.  Not differentiable."""
    dist = torch.distributed
    world, rank, n = dist.get_world_size(), process_index(), len(owners)
    slots_of = [[i for i, p in enumerate(owners) if p == q] for q in range(world)]
    mine = slots_of[rank]
    dev = _collective_device(local[0])
    pieces = torch.stack([g.detach().to(dev).reshape(n, -1) for g in local])  # (m, n, L)
    m, L = pieces.shape[0], pieces.shape[2]
    send = torch.cat([pieces[:, slots_of[q]].transpose(0, 1).reshape(-1) for q in range(world)])
    recv = send.new_empty(len(mine) * n * L)
    dist.all_to_all_single(
        recv, send.contiguous(),
        output_split_sizes=[len(mine) * len(slots_of[q]) * L for q in range(world)],
        input_split_sizes=[len(slots_of[q]) * m * L for q in range(world)],
    )
    by_source = torch.split(recv, [len(mine) * len(slots_of[q]) * L for q in range(world)])
    out: List[List[Any]] = [[None] * n for _ in mine]
    for q, chunk in enumerate(by_source):
        chunk = chunk.reshape(len(mine), len(slots_of[q]), L)
        for a in range(len(mine)):
            for b, j in enumerate(slots_of[q]):
                out[a][j] = chunk[a, b]
    return out


def _rank_order_sum(stacked: torch.Tensor) -> torch.Tensor:
    total = stacked[0]
    for part in stacked[1:]:
        total = total + part
    return total


class _SumGradsAcrossProcesses(torch.autograd.Function):
    """The identity on its inputs; the backward sums each cotangent over
    the processes (one collective per dtype)."""

    @staticmethod
    def forward(ctx, *leaves):
        ctx.meta = [(leaf.shape, leaf.dtype, leaf.device) for leaf in leaves]
        return tuple(leaf.view_as(leaf) for leaf in leaves)

    @staticmethod
    def backward(ctx, *grads):
        grads = [torch.zeros(shape, dtype=dt, device=dev) if g is None else g
                 for g, (shape, dt, dev) in zip(grads, ctx.meta)]
        out: List[Any] = [None] * len(grads)
        for dtype in dict.fromkeys(g.dtype for g in grads):
            idx = [i for i, g in enumerate(grads) if g.dtype == dtype]
            home = grads[idx[0]].device
            flat = torch.cat([grads[i].reshape(-1).to(home) for i in idx])
            summed = _rank_order_sum(all_gather_stacked(flat))
            for i, part in zip(idx, torch.split(summed, [grads[i].numel() for i in idx])):
                out[i] = part.reshape(grads[i].shape).to(grads[i].device)
        return tuple(out)


def sum_grads_across_processes(params: Any) -> Any:
    """``params`` unchanged, with a backward that sums each leaf's
    gradient over the processes: the parameter a multi-process mesh
    replicates then receives every process's gradient once."""
    leaves = tree_leaves(params)
    it = iter(_SumGradsAcrossProcesses.apply(*leaves))
    return tree_map(lambda _: next(it), params)

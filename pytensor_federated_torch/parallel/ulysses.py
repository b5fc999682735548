"""All-to-all (Ulysses-style) sequence parallelism.

Port of the JAX package's ``parallel/ulysses.py``, the second of the two
standard sequence/context-parallel schemes (the first, ring attention,
lives in :mod:`.ring`).

Scheme: ``q, k, v`` of global shape ``(T, H, d)`` are cut along the
sequence axis (slot ``i`` holds ``(T/n, H, d)``).  One all-to-all
re-cuts them by *head* — every slot then holds the FULL sequence for
``H/n`` heads — so each head's attention is an ordinary dense local
computation.  A second all-to-all moves the output back to sequence
blocks.

The JAX package runs each slot's body inside ``shard_map`` and calls
``lax.all_to_all(split_axis=1, concat_axis=0, tiled=True)``.  Here one
process drives the slots (:mod:`.mesh`): a slot's local view is its
entry in a list of blocks, and the all-to-all sends head chunk ``j`` of
slot ``i``'s sequence block to slot ``j``'s device with ``.to(device)``,
where the received blocks are concatenated in source-slot order (global
sequence order, since slot ``i`` owns contiguous block ``i``).  The
inverse is symmetric.  Autograd flows back through the copies.

Trade-off vs. ring attention: Ulysses does 2 all-to-alls moving
``O(T·H·d / n)`` per slot regardless of ring size, but materializes
per-head ``T×T`` scores; ring attention never holds more than a
``(T/n)²`` block and has no head-count constraint.  Ulysses needs
``H % n == 0``.  Both are exact and differentiable.
"""

from __future__ import annotations

import math
from typing import List, Sequence

import torch

from .mesh import SEQ_AXIS, Mesh
from .ring import _split

__all__ = ["heads_to_seq", "seq_to_heads", "ulysses_attention"]


def seq_to_heads(blocks: Sequence[torch.Tensor],
                 devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """Re-cut ``(T/n, H, d)`` sequence blocks (slot ``i``'s the ``i``-th,
    on ``devices[i]``) into ``(T, H/n, d)`` head blocks with one
    all-to-all: head chunk ``j`` of every slot travels to slot ``j``;
    the received sequence blocks concatenate in source-slot order."""
    n = len(devices)
    hn = blocks[0].shape[1] // n
    return [torch.cat([b[:, j * hn:(j + 1) * hn].to(d) for b in blocks], dim=0)
            for j, d in enumerate(devices)]


def heads_to_seq(blocks: Sequence[torch.Tensor],
                 devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """Inverse of :func:`seq_to_heads`: ``(T, H/n, d)`` head blocks back
    to ``(T/n, H, d)`` sequence blocks.  Heads concatenate in
    source-slot order, restoring the global head order."""
    n = len(devices)
    tn = blocks[0].shape[0] // n
    return [torch.cat([b[i * tn:(i + 1) * tn].to(d) for b in blocks], dim=1)
            for i, d in enumerate(devices)]


def _dense_heads_attention(q, k, v, *, causal: bool):
    """Per-head dense softmax attention; ``q, k, v``: (T, Hl, d)."""
    t = q.shape[0]
    scale = 1.0 / torch.sqrt(torch.tensor(float(q.shape[-1]), dtype=q.dtype, device=q.device))
    # (Hl, T, T) scores; heads moved to front for the matmul batch dim.
    s = torch.einsum("thd,shd->hts", q, k) * scale
    if causal:
        mask = torch.tril(torch.ones((t, t), dtype=torch.bool, device=q.device))
        s = torch.where(mask[None, :, :], s, -math.inf)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("hts,shd->thd", p, v)


def ulysses_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    mesh: Mesh,
    axis: str = SEQ_AXIS,
    causal: bool = False,
) -> torch.Tensor:
    """Exact multi-head attention over a sequence cut along ``axis``.

    ``q, k, v``: global shape ``(T, H, d)``, cut on ``T``.  Requires
    ``T % n == 0`` and ``H % n == 0`` for ``n`` slots on the axis.
    Returns the attention output ``(T, H, d)`` on the first slot's
    device, the slots' sequence blocks in slot order.

    See the module docstring for the trade-off against
    :func:`..ring.ring_attention` (which handles the single-head /
    head-count-indivisible cases)."""
    if axis not in mesh.axis_names:
        raise ValueError(f"mesh has no axis {axis!r}: {mesh.axis_names}")
    n = mesh.shape[axis]
    if q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"q/k/v shapes differ: {tuple(q.shape)} {tuple(k.shape)} {tuple(v.shape)}")
    if q.ndim != 3:
        raise ValueError(f"expected (T, H, d) inputs, got shape {tuple(q.shape)}")
    t, h = q.shape[0], q.shape[1]
    if t % n != 0:
        raise ValueError(f"sequence length {t} not divisible by {n} devices")
    if h % n != 0:
        raise ValueError(
            f"head count {h} not divisible by {n} devices "
            "(use ring_attention for head-count-indivisible layouts)"
        )
    devices = mesh.slot_devices(axis)
    qh, kh, vh = (seq_to_heads(_split(x, devices), devices) for x in (q, k, v))
    out = [_dense_heads_attention(a, b, c, causal=causal) for a, b, c in zip(qh, kh, vh)]
    home = devices[0]
    return torch.cat([o.to(home) for o in heads_to_seq(out, devices)])

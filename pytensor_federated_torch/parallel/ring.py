"""Ring collectives: sequence/context parallelism over the device mesh.

Port of the JAX package's ``parallel/ring.py``.  A sequence is cut along
the ``"seq"`` mesh axis into contiguous blocks, block ``i`` on slot
``i``'s device, and cross-block coupling is computed by passing blocks
around the ring of slots.  The JAX package runs each function inside
``shard_map`` with ``lax.ppermute``; here one process drives the slots
(:mod:`.mesh`), a slot's local view is its entry in a list of blocks,
and one ring step is a rotation of that list, each block copied to its
new slot's device with ``.to(device)``.  Autograd flows back through
those copies; the backward of a copy adds the gradient into the block
or parameter it came from, once per slot that used it.

- :func:`ring_shift` / :func:`shift_right_across_shards` — boundary
  passing for Markov-factored likelihoods (state-space, AR): each slot
  only needs its left neighbour's last element.
- :func:`ring_all_pairs_sum` — all-pairs block reductions for densely
  coupled likelihoods: every block visits every slot once around the
  ring; a slot holds its own block and one travelling block.
- :func:`ring_attention` — blockwise-softmax attention over the ring
  (an online max/normalizer update per incoming key/value block).

The JAX package's ``mark_varying`` (its ``ring.py:40`` import) has no
counterpart: in a single controller nothing tracks which values vary
over an axis, so the loop carries that the JAX code marks start as
plain tensors (see :mod:`.mesh`).  Slots that share a device run one
after another on its stream.
"""

from __future__ import annotations

import math
from typing import Any, Callable, List, Sequence

import torch

from ..utils import tree_leaves, tree_map
from .mesh import SEQ_AXIS, Mesh

__all__ = [
    "ring_all_pairs_sum",
    "ring_attention",
    "ring_shift",
    "seq_sharded_markov_logp",
    "shift_right_across_shards",
]


def _ring_devices(mesh: Mesh, axis: str) -> List[torch.device]:
    if axis not in mesh.axis_names:
        raise ValueError(f"mesh has no axis {axis!r}: {mesh.axis_names}")
    return mesh.slot_devices(axis)


def _split(x: Any, devices: Sequence[torch.device]) -> List[Any]:
    """Slot ``i``'s contiguous block of every leaf's leading axis, on its
    device (the leading axis must divide evenly)."""
    per = tree_leaves(x)[0].shape[0] // len(devices)
    return [tree_map(lambda a: a[i * per:(i + 1) * per].to(d), x) for i, d in enumerate(devices)]


def _cross_slot_sum(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """The slots' values added on the first slot's device, in slot order
    (where the JAX package's ``lax.psum`` ends a body)."""
    total = parts[0]
    for part in parts[1:]:
        total = total + part.to(total.device)
    return total


def ring_shift(
    blocks: Sequence[Any], devices: Sequence[torch.device], *, reverse: bool = False
) -> List[Any]:
    """One ring step: each slot's block (a tensor or a tuple of tensors)
    passes to the next slot on the ring, ``devices`` being the ring's
    slots in order: slot ``i`` ends up holding slot ``i - 1``'s block
    (``i + 1``'s with ``reverse``), on its own device."""
    n = len(devices)
    src = (lambda i: (i + 1) % n) if reverse else (lambda i: (i - 1) % n)
    return [tree_map(lambda a, d=devices[i]: a.to(d), blocks[src(i)]) for i in range(n)]


def shift_right_across_shards(
    blocks: Sequence[torch.Tensor], devices: Sequence[torch.device]
) -> List[torch.Tensor]:
    """Shift a sequence cut into ``blocks`` (slot ``i`` holding
    ``x[i*Tb:(i+1)*Tb]``) right by one *global* position.

    Returned block ``i`` is the same slice of the globally right-shifted
    sequence: its element 0 is the left neighbour's last element (zero
    on slot 0, as ``ppermute`` leaves an unaddressed destination).  This
    is the whole communication of a Markov-factored sequence likelihood:
    one element per slot."""
    out = []
    for i, (x, d) in enumerate(zip(blocks, devices)):
        prev_last = torch.zeros_like(x[-1:]) if i == 0 else blocks[i - 1][-1:].to(d)
        out.append(torch.cat([prev_last, x[:-1]], dim=0))
    return out


def seq_sharded_markov_logp(
    trans_logp: Callable[[Any, torch.Tensor, torch.Tensor], torch.Tensor],
    init_logp: Callable[[Any, torch.Tensor], torch.Tensor],
    y: torch.Tensor,
    *,
    mesh: Mesh,
    axis: str = SEQ_AXIS,
) -> Callable[[Any], torch.Tensor]:
    """Sequence-parallel log-likelihood of a Markov-factored model.

    ``logp(params) = init_logp(params, y[0]) + Σ_{t>=1} trans_logp(params,
    y[t-1], y[t])`` with ``y`` (length T, optionally trailing feature
    dims) cut along ``axis``.  ``trans_logp`` is vectorized over time
    (``y_prev``, ``y_curr`` of shape ``(Tb, ...)`` -> per-step logps
    ``(Tb,)``).  Each slot evaluates its block on its device with its own
    copy of the parameters; the slots' sums are added on the first slot's
    device.  Differentiable in ``params``: the backward of each slot's
    copy adds that slot's gradient into the parameter once."""
    devices = _ring_devices(mesh, axis)
    n = len(devices)
    if y.shape[0] % n != 0:
        raise ValueError(f"sequence length {y.shape[0]} not divisible by {n}")
    blocks = _split(y, devices)
    y_prev = shift_right_across_shards(blocks, devices)
    tb = y.shape[0] // n

    def logp(params: Any) -> torch.Tensor:
        parts = []
        for idx, (d, y_local, prev) in enumerate(zip(devices, blocks, y_prev)):
            p = tree_map(lambda a: a.to(d), params)
            step_lp = trans_logp(p, prev, y_local)
            # Global position of each local element: t = 0 contributes
            # init_logp instead of a transition term.
            pos = idx * tb + torch.arange(tb, device=d)
            lp = torch.sum(torch.where(pos > 0, step_lp, torch.zeros_like(step_lp)))
            if idx == 0:
                lp = lp + init_logp(p, y_local[0])
            parts.append(lp)
        return _cross_slot_sum(parts)

    return logp


def ring_all_pairs_sum(
    pair_fn: Callable[[Any, Any], torch.Tensor],
    data: Any,
    *,
    mesh: Mesh,
    axis: str = SEQ_AXIS,
    include_self: bool = True,
) -> torch.Tensor:
    """Σ over all *ordered* block pairs ``pair_fn(my_block, other_block)``.

    ``data`` is a tensor or a tuple of tensors whose leading axis is cut
    along ``axis``.  Each slot keeps its resident block and receives
    every other block once as it travels around the ring (``n`` folds,
    ``n - 1`` ring steps).  With ``include_self=False`` the diagonal term
    (ring step 0) is skipped.  For a symmetric ``pair_fn`` each unordered
    pair counts twice.  Differentiable end to end."""
    devices = _ring_devices(mesh, axis)
    n = len(devices)
    mine = _split(data, devices)
    # The JAX package marks the accumulator varying (mark_varying) so its
    # fori_loop carry types agree; a plain zero is the same here.
    acc = [torch.zeros((), device=d) for d in devices]
    travelling = list(mine)
    for r in range(n):
        if include_self or r > 0:
            acc = [a + pair_fn(m, t) for a, m, t in zip(acc, mine, travelling)]
        if r < n - 1:  # no dead last ring step
            travelling = ring_shift(travelling, devices)
    return _cross_slot_sum(acc)


def _online_softmax_block(q, k, v, m, l, o, valid_mask):
    """One incoming (k, v) block's contribution, flash-attention style.

    ``q``: (Tq, d); ``k``/``v``: (Tk, d); running max ``m`` (Tq,),
    normalizer ``l`` (Tq,), output accumulator ``o`` (Tq, d).
    ``valid_mask`` (Tq, Tk) — True where attention is allowed."""
    d = q.shape[-1]
    s = (q @ k.T) / math.sqrt(d)
    s = torch.where(valid_mask, s, -torch.inf)
    m_new = torch.maximum(m, torch.amax(s, dim=-1))
    # exp(-inf - -inf) guard: rows with no valid key yet keep m = -inf.
    safe_m = torch.where(torch.isfinite(m_new), m_new, torch.zeros_like(m_new))
    alpha = torch.where(torch.isfinite(m), torch.exp(m - safe_m), torch.zeros_like(m))
    p = torch.where(valid_mask, torch.exp(s - safe_m[:, None]), torch.zeros_like(s))
    l_new = alpha * l + torch.sum(p, dim=-1)
    o_new = alpha[:, None] * o + p.to(v.dtype) @ v
    return m_new, l_new, o_new


def ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    mesh: Mesh,
    axis: str = SEQ_AXIS,
    causal: bool = False,
) -> torch.Tensor:
    """Exact attention over a sequence cut along ``axis``.

    ``q, k, v``: ``(T, d)``, cut on ``T``.  Key/value blocks travel the
    ring; each slot folds every incoming block into a running (max,
    normalizer, accumulator) triple — the blockwise online softmax — so
    no slot holds the ``T x T`` score matrix or the whole K/V.  Per step
    a slot computes a ``(Tb, d) @ (d, Tb)`` product.  The same result as
    dense softmax attention, and differentiable.  Returns ``(T, d)`` on
    the first slot's device, the slots' blocks in slot order."""
    devices = _ring_devices(mesh, axis)
    n = len(devices)
    if q.shape[0] % n != 0:
        raise ValueError(f"sequence length {q.shape[0]} not divisible by {n}")
    tb = q.shape[0] // n
    qs = _split(q, devices)
    travelling = list(zip(_split(k, devices), _split(v, devices)))
    # The JAX package marks m0 and l0 varying (mark_varying); plain
    # tensors here.
    state = [
        (torch.full((tb,), -torch.inf, dtype=q.dtype, device=d),
         torch.zeros((tb,), dtype=q.dtype, device=d),
         torch.zeros_like(qb))
        for qb, d in zip(qs, devices)
    ]
    for r in range(n):
        new_state = []
        for idx, (d, qb, (m, l, o), (kb, vb)) in enumerate(zip(devices, qs, state, travelling)):
            # After r ring steps, slot idx holds block (idx - r) mod n.
            src = (idx - r) % n
            if causal:
                q_pos = idx * tb + torch.arange(tb, device=d)
                k_pos = src * tb + torch.arange(tb, device=d)
                valid = q_pos[:, None] >= k_pos[None, :]
            else:
                valid = torch.ones((tb, tb), dtype=torch.bool, device=d)
            new_state.append(_online_softmax_block(qb, kb, vb, m, l, o, valid))
        state = new_state
        if r < n - 1:  # no dead last ring step
            travelling = ring_shift(travelling, devices)
    home = devices[0]
    tiny = torch.finfo(q.dtype).tiny
    return torch.cat([(o / torch.clamp(l, min=tiny)[:, None]).to(home) for m, l, o in state])

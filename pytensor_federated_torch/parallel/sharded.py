"""The sharded evaluator: ``logp(params) = Σ_shards per_shard_logp``.

The port of the JAX package's ``FederatedLogp``: the per-shard callable
is mapped over the leading shard axis of the data tree with
``torch.func.vmap`` and the per-shard contributions are summed on the
device.  Gradients come from ``torch.autograd`` through the map and the
sum, so one backward pass gives every parameter's gradient.

With a mesh (:mod:`.mesh`) each slot along the mesh axis holds a
contiguous block of shards on its device; the parameters reach each
slot by ``.to(device)``, each slot maps its own block, and the slots'
sums cross onto the first slot's device and are added in slot order,
where the JAX package's ``shard_map`` ends in a ``lax.psum``.  The
backward of the copies adds every slot's gradient into the one
parameter, so a replicated parameter's gradient is the unsharded one.
The slots on one device run one after another on its stream.
"""

from __future__ import annotations

import math
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch

from ..utils import tree_leaves, tree_map, value_and_grad
from .mesh import SHARDS_AXIS, Mesh

# per_shard_logp(params, shard_data) -> scalar logp contribution of one shard.
PerShardLogpFn = Callable[[Any, Any], torch.Tensor]
# per_shard_fn(params, shard_data) -> tree of per-shard outputs.
PerShardComputeFn = Callable[[Any, Any], Any]


def _leading_dim(data: Any) -> int:
    leaves = tree_leaves(data)
    if not leaves:
        raise ValueError("data pytree has no leaves")
    dims = {int(leaf.shape[0]) for leaf in leaves}
    if len(dims) != 1:
        raise ValueError(
            f"all data leaves must share a leading shard axis, got {dims}"
        )
    return dims.pop()


def _shard_data_to_mesh(data: Any, mesh: Mesh, axis: str) -> List[Any]:
    """Split the stacked data tree's leading axis into ``mesh.shape[axis]``
    contiguous blocks, slot ``j``'s block on its device: the one-time
    layout after which shard data never moves between slots."""
    devices = mesh.slot_devices(axis)
    per_slot = _leading_dim(data) // len(devices)
    return [
        tree_map(lambda leaf: leaf[j * per_slot : (j + 1) * per_slot].to(d), data)
        for j, d in enumerate(devices)
    ]


def _to(tree: Any, device: torch.device) -> Any:
    return tree_map(lambda t: t.to(device), tree)


def _cross_slot_sum(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """The slots' sums added on the first slot's device, in slot order."""
    total = parts[0]
    for part in parts[1:]:
        total = total + part.to(total.device)
    return total


class NoFederatedShards:
    """Sentinel for models built without a federated shard axis.

    Assigned to ``model.fed`` when a construction option (e.g.
    ``flatten=True``) collapses the shard axis, so that any attempt to
    use a ``.fed``-dependent API (``logp_minibatch``, mesh placement)
    fails with a targeted message instead of an opaque
    ``AttributeError`` on ``None``.
    """

    def __init__(self, reason: str):
        self._reason = reason

    def __bool__(self) -> bool:
        return False

    def __getattr__(self, name: str):
        raise AttributeError(
            f"this model has no federated shard axis ({self._reason}); "
            f"'.fed.{name}' is unavailable — construct the model without "
            "that option to use federated/minibatch/mesh APIs"
        )


class FederatedLogp:
    """Sharded log-potential over a data tree with a leading shard axis.

    ``data`` leaves carry a leading ``n_shards`` axis (build
    heterogeneous shards with :func:`..parallel.packing.pack_shards`).

    ``remat=True`` saves only the shard map's inputs for the backward
    pass, which recomputes the shards' intermediate tensors instead of
    holding them in device memory: arithmetic traded for memory when
    shards are large (:class:`_Remat`).  It holds inside
    ``torch.func.vmap`` too, as ``jax.checkpoint`` composes with
    ``jax.vmap``: for a batch of chains whose graph a later
    ``torch.autograd.grad`` walks, and under ``torch.func.vjp`` (as
    :func:`..utils.value_and_grad` runs inside ``vmap``), which
    otherwise holds every intermediate until its ``vjp_fn`` runs.
    Values and gradients equal the non-remat path's.

    With ``mesh`` (a :class:`.mesh.Mesh`), ``n_shards`` must divide
    evenly over the mesh's ``axis``; each slot evaluates its block of
    shards on its device and the slots' sums are added on the first
    slot's device (the module docstring).  Mesh and no-mesh results
    differ in the order of summation only.

    Every method works under an outer ``torch.func.vmap`` over chains
    (the shard map is then a vmap nested in it).
    """

    def __init__(
        self,
        per_shard_logp: PerShardLogpFn,
        data: Any,
        *,
        mesh: Optional[Mesh] = None,
        axis: str = SHARDS_AXIS,
        remat: bool = False,
    ):
        self.per_shard_logp = per_shard_logp
        self.axis = axis
        self.mesh = mesh
        self.n_shards = _leading_dim(data)
        self.data = data
        self.remat = remat
        if mesh is not None:
            if axis not in mesh.axis_names:
                raise ValueError(f"mesh has no axis {axis!r}: {mesh.axis_names}")
            axis_size = mesh.shape[axis]
            if self.n_shards % axis_size != 0:
                raise ValueError(
                    f"n_shards={self.n_shards} not divisible by mesh axis "
                    f"{axis!r} of size {axis_size}"
                )
            self._slot_devices = mesh.slot_devices(axis)
            self._slots = _shard_data_to_mesh(data, mesh, axis)

    def _shard_map(self, params: Any, data: Any) -> torch.Tensor:
        def run(params, data):
            return torch.func.vmap(lambda d: self.per_shard_logp(params, d))(data)

        if not self.remat:
            return run(params, data)
        # _Remat differentiates one flat parameter vector: its nested vjp
        # under vmap trips a functorch internal assert (``batched ==
        # nullptr``, torch 2.13) with several differentiated inputs.
        p_leaves, d_leaves = tree_leaves(params), tree_leaves(data)
        meta = [(leaf.shape, leaf.dtype) for leaf in p_leaves]
        flat = torch.cat([leaf.reshape(-1) for leaf in p_leaves])

        def run_flat(flat, *d_leaves):
            parts = torch.split(flat, [math.prod(shape) for shape, _ in meta])
            it_p = (part.reshape(shape).to(dtype) for part, (shape, dtype) in zip(parts, meta))
            it_d = iter(d_leaves)
            return run(tree_map(lambda _: next(it_p), params), tree_map(lambda _: next(it_d), data))

        return _Remat.apply(run_flat, flat, *d_leaves)

    def _per_slot(self, params: Any, blocks: Sequence[Any]) -> List[torch.Tensor]:
        """Each slot's per-shard vector over its ``blocks`` entry, on its
        device."""
        return [
            self._shard_map(_to(params, d), block)
            for d, block in zip(self._slot_devices, blocks)
        ]

    def per_shard_logps(self, params: Any) -> torch.Tensor:
        """Vector of per-shard contributions (with a mesh, the slots'
        vectors in slot order on the first slot's device)."""
        if self.mesh is None:
            return self._shard_map(params, self.data)
        first = self._slot_devices[0]
        return torch.cat([v.to(first) for v in self._per_slot(params, self._slots)], dim=-1)

    def logp(self, params: Any) -> torch.Tensor:
        """Scalar total log-potential."""
        if self.mesh is None:
            return self.per_shard_logps(params).sum()
        return _cross_slot_sum([v.sum(-1) for v in self._per_slot(params, self._slots)])

    def logp_and_grad(self, params: Any) -> Tuple[torch.Tensor, Any]:
        """(logp, grads) from one forward and one backward pass."""
        return value_and_grad(self.logp, params)

    __call__ = logp

    def logp_batch(self, params_batch: Any) -> torch.Tensor:
        """Evaluate B parameter sets at once: leaves carry a leading batch
        axis; returns ``(B,)`` logps."""
        return torch.func.vmap(self.logp)(params_batch)

    def logp_minibatch(
        self, params: Any, generator: torch.Generator, num_shards: int
    ) -> torch.Tensor:
        """Unbiased minibatch estimate of :meth:`logp` from a random
        subset of ``num_shards`` shards, drawn without replacement from
        ``generator`` and scaled by ``S/k``.

        The subsample is a gather, not a mask, so compute really drops
        to ``k/S`` of the full pass — the data subsampling of
        stochastic-gradient samplers."""
        return self._minibatch_estimate(params, self._draw_shards(generator, num_shards))

    def logp_and_grad_minibatch(
        self, params: Any, generator: torch.Generator, num_shards: int
    ) -> Tuple[torch.Tensor, Any]:
        """(estimate, grad-estimate) of the minibatch logp — the
        stochastic gradient for SGLD/SGHMC-style samplers."""
        idx = self._draw_shards(generator, num_shards)
        return value_and_grad(lambda p: self._minibatch_estimate(p, idx), params)

    def _minibatch_estimate(self, params: Any, idx: torch.Tensor) -> torch.Tensor:
        """``S/k`` times the summed logp of the ``k`` shards ``idx`` — the
        estimator :meth:`logp_minibatch` evaluates on a random draw of
        ``idx``.  Without a mesh ``idx`` is ``(k,)`` shard indices; with
        one it is ``(axis_size, k / axis_size)``, each row indices into
        its slot's own block, so no shard data moves between slots."""
        scale = self.n_shards / int(idx.numel())
        take = lambda tree, i: tree_map(lambda a: torch.index_select(a, 0, i.to(a.device)), tree)
        if self.mesh is None:
            return self._shard_map(params, take(self.data, idx)).sum() * scale
        blocks = [take(block, i) for block, i in zip(self._slots, idx)]
        return _cross_slot_sum([v.sum(-1) for v in self._per_slot(params, blocks)]) * scale

    def _draw_shards(self, generator: torch.Generator, num_shards: int) -> torch.Tensor:
        if not (0 < num_shards <= self.n_shards):
            raise ValueError(
                f"num_shards must be in 1..{self.n_shards}, got {num_shards}"
            )
        if self.mesh is None:
            perm = torch.randperm(self.n_shards, generator=generator, device=generator.device)
            return perm[:num_shards]
        axis_size = self.mesh.shape[self.axis]
        if num_shards % axis_size != 0:
            raise ValueError(
                f"num_shards={num_shards} not divisible by mesh axis "
                f"{self.axis!r} of size {axis_size}"
            )
        per_slot = self.n_shards // axis_size
        return torch.stack([
            torch.randperm(per_slot, generator=generator, device=generator.device)[
                : num_shards // axis_size
            ]
            for _ in range(axis_size)
        ])


class _Remat(torch.autograd.Function):
    """``fn(flat_params, *data)`` whose backward recomputes ``fn``.

    Saves only its inputs; the backward pass runs ``fn`` again under
    ``torch.func.vjp`` with respect to ``flat_params`` (the data need no
    gradient).  A ``setup_context`` Function with a generated vmap rule,
    so it composes with ``torch.func.vmap`` over chains and with a grad
    transform inside it, where ``torch.utils.checkpoint`` cannot
    recompute."""

    generate_vmap_rule = True

    @staticmethod
    def forward(fn, flat, *data):
        return fn(flat, *data)

    @staticmethod
    def setup_context(ctx, inputs, output):
        fn, *leaves = inputs
        ctx.fn = fn
        ctx.save_for_backward(*leaves)

    @staticmethod
    def backward(ctx, grad_out):
        flat, *data = ctx.saved_tensors
        _, vjp_fn = torch.func.vjp(lambda p: ctx.fn(p, *data), flat)
        return (None, *vjp_fn(grad_out), *(None,) * len(data))


def sharded_compute(
    per_shard_fn: PerShardComputeFn,
    data: Any,
    *,
    mesh: Optional[Mesh] = None,
    axis: str = SHARDS_AXIS,
) -> Callable[[Any], Any]:
    """Generic arrays->arrays over every shard, outputs stacked by shard.

    For compute that is not a log-potential: returns ``fn(params) ->
    tree`` whose leaves have a leading ``n_shards`` axis.  With a mesh
    each slot maps its block of shards on its device with its own copy
    of ``params`` (a gradient taken inside ``per_shard_fn`` stays the
    slot's own), and the slots' outputs are stacked in slot order on the
    first slot's device."""
    n_shards = _leading_dim(data)
    if mesh is None:

        def fn(params):
            return torch.func.vmap(lambda d: per_shard_fn(params, d))(data)

        return fn

    axis_size = mesh.shape[axis]
    if n_shards % axis_size != 0:
        raise ValueError(
            f"n_shards={n_shards} not divisible by mesh axis size {axis_size}"
        )
    devices = mesh.slot_devices(axis)
    blocks = _shard_data_to_mesh(data, mesh, axis)

    def fn_mesh(params):
        outs = [
            torch.func.vmap(lambda d, p=_to(params, dev): per_shard_fn(p, d))(block)
            for dev, block in zip(devices, blocks)
        ]
        return tree_map(lambda *leaves: torch.cat([v.to(devices[0]) for v in leaves]), *outs)

    return fn_mesh

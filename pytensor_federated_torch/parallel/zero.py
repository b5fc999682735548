"""ZeRO-style gradient/optimizer-state sharding over the shards axis.

Port of the JAX package's ``parallel/zero.py``.  The reference's
federated exchange materializes the FULL gradient in the sampling process; the
sharded form follows the cross-replica weight-update sharding recipe
(Xu et al., arXiv:2004.13336): the cross-shard reduction of the
gradient is a reduce-scatter, so each slot ends the evaluation holding
only its ``1/axis_size`` slice of the summed gradient, updates run on
slices, and one gather per step rebuilds the parameter vector.

The JAX body runs inside ``shard_map``: it marks the replicated vector
varying, takes a local ``value_and_grad``, and ends in ``psum`` (the
logp) and a tiled ``psum_scatter`` (the flat gradient).  Here one
process drives the slots (:mod:`.mesh`): each slot differentiates its
own block's sum at its ``.to(device)`` copy of the padded flat vector
(the per-slot ``torch.func.vmap`` of :class:`.sharded.FederatedLogp`,
over the same data placement), and slot ``i`` receives slice ``i`` of
the summed gradient on its own device, the slots' slices added in slot
order as :func:`.sharded._cross_slot_sum` adds their sums.  On a mesh
that spans processes each process evaluates its own slots; the slots'
logps are all-gathered, and one ``all_to_all`` sends slice ``i`` of
every slot's gradient to the process of slot ``i`` only, which adds
them in slot order (:func:`._collectives.exchange_slices`): the bits of
one process driving every slot.  Each process then sends and receives
``local slots x padded_dim`` gradient elements per evaluation, not
every slot's whole gradient; adding a process's own slots first would
cut that to ``padded_dim`` but change the order of summation.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

from ..ppl.elbo import adam_updates
from ..samplers.util import ravel
from ._collectives import exchange_slices, gather_slots
from .mesh import SHARDS_AXIS, Mesh, process_index
from .sharded import FederatedLogp, _cross_slot_sum, _leading_dim

__all__ = ["ScatteredGrads", "ZeroShardedLogpGrad"]


class ScatteredGrads(NamedTuple):
    """Reduce-scattered gradient: per-slot slices plus their layout.

    ``grad_slices[i]`` is slot ``i``'s ``padded_dim / axis_size`` slice of
    the summed gradient, on slot ``i``'s device (``None`` for a slot of
    another process)."""

    logp: torch.Tensor  # scalar total logp, on this process's first slot's device
    grad_slices: Tuple[Optional[torch.Tensor], ...]
    padded_dim: int
    dim: int


class ZeroShardedLogpGrad:
    """Federated logp whose gradient exchange is reduce-scattered.

    ``per_shard_logp(params, shard_data) -> scalar`` — the same contract
    as :class:`.sharded.FederatedLogp`, but the summed gradient never
    materializes whole on any slot (each slot's gradient of its own
    block does, and is scattered):

    - :meth:`logp_and_scattered_grad`: the total logp and each slot's
      1/N slice of the summed gradient.
    - :meth:`sgd_steps` / :meth:`adam_steps`: gradient-ascent updates
      that touch only the slots' slices; one gather per step rebuilds
      the parameter vector.

    Numerically the replicated path (held against
    ``FederatedLogp.logp_and_grad``); the difference is where bytes
    live.  The flat vector is padded to ``padded_dim``, ``dim`` rounded
    up to the axis size."""

    def __init__(
        self,
        per_shard_logp: Callable[[Any, Any], torch.Tensor],
        data: Any,
        example_params: Any,
        *,
        mesh: Mesh,
        axis: str = SHARDS_AXIS,
    ):
        self.axis = axis
        self.mesh = mesh
        self.n_shards = _leading_dim(data)
        if axis not in mesh.axis_names:
            raise ValueError(f"mesh has no axis {axis!r}: {mesh.axis_names}")
        axis_size = mesh.shape[axis]
        if self.n_shards % axis_size != 0:
            raise ValueError(
                f"n_shards={self.n_shards} not divisible by mesh axis "
                f"{axis!r} of size {axis_size}"
            )
        self._fed = FederatedLogp(per_shard_logp, data, mesh=mesh, axis=axis)
        self.data = self._fed._slots
        self.axis_size = axis_size
        self._devices = mesh.slot_devices(axis)
        self._owners = mesh.slot_processes(axis)
        self._home = self._fed._home
        me = process_index()
        self._local = [j for j, p in enumerate(self._owners) if p == me]

        flat, unravel = ravel(example_params)
        self.dim = int(flat.shape[0])
        self.padded_dim = -(-self.dim // axis_size) * axis_size
        self.slice_len = self.padded_dim // axis_size
        self.unravel = unravel

    # -- flat-vector plumbing ---------------------------------------------

    def flatten(self, params: Any) -> torch.Tensor:
        """The padded flat vector of ``params`` (``ravel_pytree`` order),
        on this process's first slot's device."""
        vec, _ = ravel(params)
        vec = vec.detach().to(self._home)
        return torch.cat([vec, vec.new_zeros(self.padded_dim - self.dim)])

    def _slice(self, vec: torch.Tensor, i: int) -> torch.Tensor:
        return vec[i * self.slice_len:(i + 1) * self.slice_len]

    # -- evaluation --------------------------------------------------------

    def _scattered(self, vec: torch.Tensor) -> Tuple[torch.Tensor, Dict[int, torch.Tensor]]:
        """``(logp, {slot: its slice of the summed gradient})`` at the
        padded vector ``vec``, for this process's slots."""
        values, grads = [], []
        for j in self._local:
            d = self._devices[j]
            v = vec.detach().to(d).requires_grad_(True)
            lp = self._fed._shard_map(self.unravel(v[: self.dim]), self.data[j]).sum()
            (g,) = torch.autograd.grad(lp, v)
            values.append(lp.detach())
            grads.append(g)
        if self.mesh.is_multiprocess:
            values = list(gather_slots(values, self._owners, self._home))
            parts = exchange_slices(grads, self._owners)
        else:
            parts = [[self._slice(g, i) for g in grads] for i in self._local]
        slices = {i: _cross_slot_sum([p.to(self._devices[i]) for p in ps])
                  for i, ps in zip(self._local, parts)}
        return _cross_slot_sum(values), slices

    def logp_and_scattered_grad(self, params: Any) -> ScatteredGrads:
        logp, slices = self._scattered(self.flatten(params))
        return ScatteredGrads(
            logp, tuple(slices.get(i) for i in range(self.axis_size)), self.padded_dim, self.dim
        )

    def _gather_vec(self, slices: Dict[int, torch.Tensor]) -> torch.Tensor:
        """The padded vector from every slot's slice, on this process's
        first slot's device (the all_gather)."""
        local = [slices[i] for i in self._local]
        if self.mesh.is_multiprocess:
            return gather_slots(local, self._owners, self._home).reshape(-1)
        return torch.cat([s.to(self._home) for s in local])

    def gather_grad(self, sg: ScatteredGrads) -> Any:
        """Materialize the full gradient tree (diagnostic/interop path —
        defeats the sharding purpose if called every step)."""
        slices = {i: s for i, s in enumerate(sg.grad_slices) if s is not None}
        return self.unravel(self._gather_vec(slices)[: self.dim])

    # -- sharded optimizer loop --------------------------------------------

    def sgd_steps(
        self,
        params: Any,
        *,
        learning_rate: float,
        num_steps: int,
    ) -> Tuple[Any, torch.Tensor]:
        """Gradient ascent on the logp with sharded grads and updates.

        Each step evaluates, reduce-scatters, updates every slot's slice
        (``slice + lr * g``) and gathers the vector once.  Returns the
        final params tree and the per-step logp trace (the logp before
        each step's update)."""

        def update(state, g, my_slice, lr):
            return state, my_slice + lr * g

        return self._loop(params, learning_rate, num_steps, lambda n, dt, dev: (), update)

    def adam_steps(
        self,
        params: Any,
        *,
        learning_rate: float,
        num_steps: int,
        b1: float = 0.9,
        b2: float = 0.999,
        eps: float = 1e-8,
    ) -> Tuple[Any, torch.Tensor]:
        """Adam ascent with FULLY sharded optimizer state.

        The first/second-moment vectors never exist whole anywhere: each
        slot carries only its 1/N slices, updated from its scattered
        gradient slice — the optimizer-state half of the ZeRO recipe.
        The update is optax's ``scale_by_adam(mu_dtype=float32)`` (the
        moments in float32, the gradient cast to float32), then ``slice
        + lr * u``.  Returns ``(final_params, logp_trace)``."""
        def init(n, dtype, device):
            zeros = torch.zeros((n,), dtype=torch.float32, device=device)
            return (0, zeros, zeros.clone())

        def update(state, g, my_slice, lr):
            count, mu, nu = state
            count += 1
            (u,), (mu,), (nu,) = adam_updates(
                [g.to(torch.float32)], [mu], [nu], count, -1.0, b1=b1, b2=b2, eps=eps,
                # optax computes the bias corrections in the default float
                # type (float64 under jax_enable_x64: a float64 run here)
                # and casts them to float32.
                correction_dtype=my_slice.dtype,
            )
            return (count, mu, nu), my_slice + lr * u

        return self._loop(params, learning_rate, num_steps, init, update)

    def _loop(self, params, learning_rate, num_steps, init_opt_state, update_rule):
        """Shared sharded-optimizer scaffold: ``init_opt_state(slice_len,
        dtype, device)`` per slot; ``update_rule(opt_state, g_slice,
        my_slice, lr) -> (new_opt_state, new_slice)`` runs on one slot's
        slices only."""
        vec = self.flatten(params)
        # The JAX loop carries the learning rate as a float32 operand.
        lr = torch.tensor(learning_rate, dtype=torch.float32)
        states = {i: init_opt_state(self.slice_len, vec.dtype, self._devices[i])
                  for i in self._local}
        logps: List[torch.Tensor] = []
        for _ in range(num_steps):
            logp, g_slices = self._scattered(vec)
            new = {}
            for i in self._local:
                d = self._devices[i]
                states[i], new[i] = update_rule(
                    states[i], g_slices[i], self._slice(vec, i).to(d), lr.to(d)
                )
                new[i] = new[i].to(vec.dtype)
            vec = self._gather_vec(new)
            logps.append(logp)
        trace = torch.stack(logps) if logps else vec.new_zeros((0,))
        return self.unravel(vec[: self.dim]), trace

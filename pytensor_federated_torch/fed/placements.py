"""Placement-aware lowering of the ``fed`` primitives.

The port of the JAX package's ``fed/placements.py``.  A
:class:`Placement` decides WHERE the shards of a ``fed_map`` live and
HOW the per-shard program executes there:

- :class:`MeshPlacement` — shards are positions along a named mesh
  axis; ``fed_map`` lowers onto the mesh machinery of
  ``parallel/sharded.py``: each slot maps its block of shards with
  ``torch.func.vmap`` on its device, and the slots' outputs are stacked
  in slot order on the first slot's device.
- :class:`PoolPlacement` — shards are requests over an RPC node pool;
  ``fed_map`` lowers to ONE pipelined ``evaluate_many`` window,
  differentiable through the reference's forward-supplied-gradient
  contract (nodes reply ``[logp, *grads]``; the backward applies
  ``g · grads``).  A *group* of independent ``fed_map`` calls lowers to
  a single fused window.
- :class:`MixedPlacement` — splits the shard range: the leading shards
  ride a mesh, the trailing shards a pool, outputs concatenate (and
  gradients flow through both lanes).

Lowerings are built as PERSISTENT **executors**: ``map_executor(spec)``
/ ``group_executor(specs)`` build their closures once per recorded
program (``lowering.py`` caches them beside the graph).

A mapped operand that the program made with ``fed_broadcast`` arrives
at an executor as the broadcast's source, one value for every shard
(``MapSpec.x_shared``): the mesh lanes vmap over it unbatched, as
``FederatedLogp`` passes its parameters (so the kernel's shard-batched
vmap rule makes one launch per slot), and the pool lanes send it in
every shard's request, as the JAX package's requests carry every
shard's row of the broadcast.

The wire contract of a pool-placed ``fed_map``: each request carries
exactly the shard's MAPPED leaves, in ``tree_leaves`` order.  Closure
values never leave the driver — driver state a node needs must arrive
via ``fed_broadcast`` (which makes it a mapped operand), and the node's
deployed compute must be the same per-shard function
(:func:`make_node_compute` builds it from the identical Python
callable, so driver and node cannot disagree).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Sequence, Tuple

import numpy as np
import torch

from ..ops.ops import refuse_second_order, vmap_sequential
from ..parallel._collectives import gather_slots, sum_grads_across_processes
from ..parallel.mesh import SHARDS_AXIS, process_index
from ..parallel.sharded import _home_device
from ..telemetry import flightrec as _flightrec
from ..telemetry import spans as _spans
from ..utils import resolve_device, tree_leaves

__all__ = [
    "MapSpec",
    "MeshPlacement",
    "MixedPlacement",
    "Placement",
    "PoolPlacement",
    "make_node_compute",
]


@dataclasses.dataclass(frozen=True)
class MapSpec:
    """The static shape of one ``fed_map`` call: everything an executor
    needs besides the runtime operand values.

    ``fn(consts, shard_leaves) -> outputs`` is the per-shard program
    over the call's driver-varying closure values (``consts``) and one
    shard's mapped leaves.  ``x_avals`` and ``out_avals`` are ``(shape,
    dtype)`` pairs: the stacked mapped operands (shards axis included)
    and the per-shard outputs."""

    fn: Callable[[Sequence[Any], Sequence[Any]], List[Any]]
    n_consts: int
    n_shards: int
    x_avals: Tuple[Tuple[tuple, torch.dtype], ...]
    out_avals: Tuple[Tuple[tuple, torch.dtype], ...]
    # Which mapped operands arrive as one value shared by every shard
    # (a fed_broadcast's source) rather than stacked along the shards.
    x_shared: Tuple[bool, ...] = ()
    # How many closure values are DRIVER-VARYING: derived from program
    # inputs rather than concrete trace-time constants.  A node cannot
    # know such values, so pool lanes (which ship only mapped leaves)
    # must refuse them loudly; in this port every closure value the
    # per-shard program receives as an operand is such a value.
    n_varying_consts: int = 0

    @property
    def grad_contract(self) -> bool:
        """Whether this call fits the logp+grad wire contract: exactly
        one scalar inexact output per shard."""
        return (
            len(self.out_avals) == 1
            and tuple(self.out_avals[0][0]) == ()
            and _inexact(self.out_avals[0][1])
        )

    def sliced(self, lo: int, hi: int) -> "MapSpec":
        return dataclasses.replace(
            self,
            n_shards=hi - lo,
            x_avals=tuple(
                av if shared else ((hi - lo,) + tuple(av[0])[1:], av[1])
                for av, shared in zip(self.x_avals, self.x_shared)
            ),
        )


def _inexact(dtype: torch.dtype) -> bool:
    return dtype.is_floating_point or dtype.is_complex


def _grad_dtype(dtype: torch.dtype) -> torch.dtype:
    return dtype if _inexact(dtype) else torch.float32


# An executor takes (consts, xs) value tuples and returns the stacked
# outputs; a group executor takes one (consts, xs) pair per member.
MapExecutor = Callable[[Tuple[Any, ...], Tuple[Any, ...]], List[Any]]


class Placement:
    """Where/how ``fed_map`` shards execute.  Subclasses implement
    :meth:`map_executor`; :meth:`group_executor` fuses a group of
    independent calls when the lane can (pool windows)."""

    def map_executor(self, spec: MapSpec) -> MapExecutor:
        raise NotImplementedError

    def fusion_key(self) -> tuple:
        """Equivalence key for cross-potential fusion: two placements
        with the same key lower identically."""
        return ("placement", id(self))

    def group_executor(self, specs: Sequence[MapSpec]) -> Callable:
        members = [self.map_executor(s) for s in specs]

        def run(args: Sequence[Tuple[tuple, tuple]]) -> List[List[Any]]:
            return [ex(c, x) for ex, (c, x) in zip(members, args)]

        return run

    # Convenience single-shot lowering (wrappers, tests): build an
    # executor and run it once.
    def lower_map(self, spec: MapSpec, consts: Any, xs: Any) -> List[Any]:
        return self.map_executor(spec)(tuple(consts), tuple(xs))


class MeshPlacement(Placement):
    """Shards along a named mesh axis: ``parallel/sharded.py``'s mesh
    machinery behind the primitive graph.

    ``n_shards`` may exceed the axis size (each slot vmaps its local
    block) but must divide evenly.  Each slot receives its own
    ``.to(device)`` copy of the closure values and of the shared
    operands, whose backward adds every slot's gradient into the one
    driver value, as ``FederatedLogp`` does with its parameters (the JAX
    package marks them varying for the same reason; torch needs no
    counterpart).  The slots run one after another, in slot order, and
    their outputs are concatenated in slot order on the first slot's
    device.  On a mesh that spans processes each process maps only its
    own slots; the outputs are gathered from every process, and the
    replicated values' gradients summed over the processes, as
    ``sharded_compute`` does, so every process holds the bits one
    process driving every slot would.
    """

    def __init__(self, mesh: Any, axis: str = SHARDS_AXIS) -> None:
        if axis not in mesh.axis_names:
            raise ValueError(
                f"mesh has no axis {axis!r}: {mesh.axis_names}"
            )
        self.mesh = mesh
        self.axis = axis

    def fusion_key(self) -> tuple:
        return ("mesh", id(self.mesh), self.axis)

    def map_executor(self, spec: MapSpec) -> MapExecutor:
        axis, mesh = self.axis, self.mesh
        axis_size = mesh.shape[axis]
        if spec.n_shards % axis_size != 0:
            raise ValueError(
                f"n_shards={spec.n_shards} not divisible by mesh axis "
                f"{axis!r} of size {axis_size}"
            )
        devices, owners = mesh.slot_devices(axis), mesh.slot_processes(axis)
        local = [j for j, owner in enumerate(owners) if owner == process_index()]
        home = _home_device(mesh, axis)
        per = spec.n_shards // axis_size
        in_dims = tuple(None if shared else 0 for shared in spec.x_shared)
        # The per-slot blocks of the last stacked operand seen at each
        # position: a program's constant data is split once.
        blocks: dict = {}

        def slot_blocks(k: int, x: torch.Tensor) -> List[torch.Tensor]:
            held = blocks.get(k)
            if held is None or held[0] is not x:
                held = (x, [x[j * per:(j + 1) * per].to(d) for j, d in enumerate(devices)])
                blocks[k] = held
            return held[1]

        def run(consts: Any, xs: Any) -> List[Any]:
            replicated = list(consts) + [x for x, sh in zip(xs, spec.x_shared) if sh]
            if mesh.is_multiprocess and replicated:
                # Each process passes back its own slots' cotangents only.
                it = iter(sum_grads_across_processes(replicated))
                consts = [next(it) for _ in consts]
                xs = [next(it) if sh else x for x, sh in zip(xs, spec.x_shared)]
            per_x = [
                [x.to(d) for d in devices] if shared else slot_blocks(k, x)
                for k, (x, shared) in enumerate(zip(xs, spec.x_shared))
            ]
            outs = []
            for j in local:
                c = [t.to(devices[j]) for t in consts]
                outs.append(torch.func.vmap(
                    lambda *shard, c=c: tuple(spec.fn(c, shard)), in_dims=in_dims
                )(*(bx[j] for bx in per_x)))
            if mesh.is_multiprocess:
                return [gather_slots([o[i] for o in outs], owners, home).flatten(0, 1)
                        for i in range(len(outs[0]))]
            return [torch.cat([o[i].to(home) for o in outs]) for i in range(len(outs[0]))]

        return run


class _HostWindow(torch.autograd.Function):
    """One host window: ``host(*numpy operands)`` returns the outputs
    and, for a differentiable window, the node-supplied gradients after
    them.  The backward applies them through ``rule(cts, grads)``, which
    maps the outputs' cotangents to the operands' (``None`` where an
    operand takes none).  A window without ``rule`` is forward-only:
    differentiating through it raises.  Under ``torch.func.vmap`` the
    window runs once per batch member, in turn — the JAX lane's
    ``vmap_method="sequential"``."""

    @staticmethod
    def forward(host, n_out, rule, *flat):
        dev = next((x.device for x in flat if _inexact(x.dtype)), flat[0].device)
        outs = host(*(x.detach().cpu().numpy() for x in flat))
        return tuple(torch.as_tensor(np.asarray(o)).to(dev) for o in outs)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _host, n_out, rule, *_flat = inputs
        ctx.n_out, ctx.rule = n_out, rule
        ctx.set_materialize_grads(False)
        ctx.mark_non_differentiable(*output[n_out:])
        ctx.save_for_backward(*output[n_out:])

    @staticmethod
    def backward(ctx, *cts):
        refuse_second_order(cts[ctx.n_out:])
        if ctx.rule is None:
            raise RuntimeError(
                "differentiating through a forward-only pool window: only a "
                "fed_map whose per-shard program returns one scalar carries "
                "the nodes' gradients"
            )
        return (None, None, None, *ctx.rule(cts[:ctx.n_out], ctx.saved_tensors))

    @staticmethod
    def vmap(info, in_dims, *args):
        return vmap_sequential(_HostWindow, info, in_dims, *args)


def _window(host, n_out, rule, flat) -> List[torch.Tensor]:
    return list(_HostWindow.apply(host, n_out, rule, *flat))[:n_out]


def _mapped_cotangent(g, grad, x_aval, shared):
    """A mapped operand's cotangent from its stacked per-shard
    logps' cotangent ``g`` (``(n_shards,)``) and the nodes' per-shard
    gradients ``grad``: ``g_s · grad_s``, summed over the shards for a
    shared operand (the ``fed_broadcast`` adjoint)."""
    if g is None or not _inexact(x_aval[1]):
        return None
    ct = g.reshape((-1,) + (1,) * (grad.dim() - 1)).to(grad.dtype) * grad
    return (ct.sum(0) if shared else ct).to(x_aval[1])


class PoolPlacement(Placement):
    """Shards as requests over a replica pool (or any transport client
    with ``evaluate_many(requests, window=)`` — ``PooledArraysClient``,
    the gRPC/TCP clients, or their typed adapters).

    Differentiation uses the reference's logp+grad contract: for a
    ``fed_map`` whose per-shard program returns one scalar, the node
    replies ``[logp, *grads]`` (one grad per mapped leaf — deploy with
    :func:`make_node_compute`), and an autograd Function applies the
    forward-supplied gradients.  Non-scalar maps execute forward-only
    (``grads=False`` node deployments); differentiating through one
    raises.

    A group of independent ``fed_map`` calls lowers to ONE pipelined
    window: requests from every call ride a single ``evaluate_many``
    (span ``fed.window`` / flightrec ``fed.fused_window`` carry the
    evidence).  All calls in a fused window hit the same client, so the
    deployed node compute must serve every member's request shape —
    the reference's one-service-fn-per-node topology.
    """

    def __init__(
        self,
        client: Any,
        *,
        window: int = 8,
        logp_dtype: Any = None,
        reduce: bool = False,
        tag: str = "pool",
    ) -> None:
        """``reduce=True`` opts eligible ``fed_sum(fed_map(...))`` pairs
        into the REDUCED window lowering: the whole window rides one
        reduce-scatter call (``client.evaluate_reduced``), so reply bytes
        scale with pool width instead of shard count.  Eligibility is
        gated at lowering time (lowering.py ``_plan_reduce``): the summed
        ``fed_map`` must fit the logp+grad contract and every inexact
        mapped operand must be broadcast-derived or a trace-time constant
        — gradients w.r.t. per-shard PROGRAM INPUTS cannot survive a sum,
        so such programs fall back to the per-shard window.

        ``tag`` labels this placement's spans/flight events (the ``lane``
        attribute of ``fed.window`` / ``fed.reduce_window``)."""
        self.client = client
        self.window = int(window)
        self.logp_dtype = logp_dtype
        self.reduce = bool(reduce)
        self.tag = str(tag)

    def fusion_key(self) -> tuple:
        return (
            "pool", id(self.client), self.window, self.logp_dtype,
            self.reduce, self.tag,
        )

    # -- host side ---------------------------------------------------------

    def _run_window(
        self, metas: Sequence[Tuple[int, Tuple[bool, ...]]], flat_np: Sequence[Any]
    ) -> List[list]:
        """One fused evaluate_many over every call's shards.  Returns
        the raw reply list per request, sliced per call."""
        requests: list = []
        slices = []
        i = 0
        for n_shards, shared in metas:
            xs = flat_np[i : i + len(shared)]
            i += len(shared)
            lo = len(requests)
            for s in range(n_shards):
                requests.append(tuple(x if sh else x[s] for x, sh in zip(xs, shared)))
            slices.append((lo, len(requests)))
        with _spans.span(
            "fed.window",
            lane=self.tag,
            calls=len(metas),
            requests=len(requests),
        ):
            _flightrec.record(
                "fed.fused_window",
                lane=self.tag,
                calls=len(metas),
                requests=len(requests),
                window=self.window,
            )
            replies = self.client.evaluate_many(
                requests, window=self.window
            )
        return [replies[lo:hi] for lo, hi in slices]

    # -- executors ---------------------------------------------------------

    def map_executor(self, spec: MapSpec) -> MapExecutor:
        group = self.group_executor([spec])

        def run(consts: Any, xs: Any) -> List[Any]:
            return group([(consts, xs)])[0]

        return run

    def group_executor(self, specs: Sequence[MapSpec]) -> Callable:
        specs = list(specs)
        for s in specs:
            if s.n_varying_consts:
                # Computing anyway would be SILENTLY wrong: the node
                # would use whatever it baked at deploy time and the
                # gradient of the dropped operand would be zero.
                raise ValueError(
                    f"a pool-placed fed_map closes over "
                    f"{s.n_varying_consts} driver-varying value(s); "
                    "pool placements ship only MAPPED operands, so "
                    "route driver state through fed_broadcast (making "
                    "it a mapped operand) instead of closure capture"
                )
        grad_idx = [i for i, s in enumerate(specs) if s.grad_contract]
        fwd_idx = [i for i, s in enumerate(specs) if not s.grad_contract]
        grad_exec = (
            self._grad_window_executor([specs[i] for i in grad_idx])
            if grad_idx
            else None
        )
        fwd_exec = (
            self._forward_group_executor([specs[i] for i in fwd_idx])
            if fwd_idx
            else None
        )

        def run(args: Sequence[Tuple[tuple, tuple]]) -> List[List[Any]]:
            results: dict = {}
            if grad_exec is not None:
                outs = grad_exec([args[i][1] for i in grad_idx])
                for i, o in zip(grad_idx, outs):
                    results[i] = o
            if fwd_exec is not None:
                outs = fwd_exec([args[i][1] for i in fwd_idx])
                for i, o in zip(fwd_idx, outs):
                    results[i] = o
            return [results[i] for i in range(len(specs))]

        return run

    def _grad_window_executor(self, specs: Sequence[MapSpec]) -> Callable:
        """Fused differentiable window, built ONCE: the outputs are each
        call's stacked per-shard logps; the backward applies the
        node-supplied per-shard gradients (mapped cotangent = ``g_s ·
        grad_s``, summed over the shards for a shared operand)."""
        metas = [(s.n_shards, s.x_shared) for s in specs]
        # Per MEMBER dtype: fused members need not share one.
        logp_dts = [self.logp_dtype or s.out_avals[0][1] for s in specs]
        x_avals = [av for s in specs for av in s.x_avals]
        shared = [sh for s in specs for sh in s.x_shared]
        arity = [len(s.x_avals) for s in specs]
        n_calls = len(specs)

        grad_dts = [_np_dtype(_grad_dtype(av[1])) for av in x_avals]

        def host(*arrays: Any) -> list:
            per_call = self._run_window(metas, arrays)
            logps = [
                np.asarray([r[0] for r in replies], _np_dtype(dt))
                for replies, dt in zip(per_call, logp_dts)
            ]
            grads = [
                np.stack([np.asarray(r[1 + j]) for r in replies])
                for replies, n_in in zip(per_call, arity)
                for j in range(n_in)
            ]
            return logps + [g.astype(dt) for g, dt in zip(grads, grad_dts)]

        def rule(cts: Sequence[Any], grads: Sequence[torch.Tensor]) -> list:
            g_of = [ci for ci, n_in in enumerate(arity) for _ in range(n_in)]
            return [
                _mapped_cotangent(cts[g_of[k]], grads[k], x_avals[k], shared[k])
                for k in range(len(x_avals))
            ]

        def run(xs_per_call: Sequence[tuple]) -> List[List[Any]]:
            flat = [x for xs in xs_per_call for x in xs]
            return [[lp] for lp in _window(host, n_calls, rule, flat)]

        return run

    def reduced_sum_executor(self, spec: MapSpec) -> Callable:
        """One ``fed_sum(fed_map)`` pair as a REDUCED window (built
        once; lowering.py pairs the nodes).

        Forward: the shard requests ride ONE ``client.evaluate_reduced``
        — the node (or aggregator tree) sums the per-shard ``[logp,
        *grads]`` replies and returns ``[logp_sum, flat_grad_sum]``; the
        output is the summed scalar, so the ``fed_sum`` node is absorbed.

        Backward: the cotangent of the summed logp is one scalar ``g``;
        the summed per-operand gradient is exactly ``Σ_s grad_s``.  A
        shared operand (a ``fed_broadcast``'s source) takes ``g · Σ_s
        grad_s``; a stacked one takes it at shard slot 0 with zeros
        elsewhere, exact only for a consumer whose adjoint sums over the
        shards, which is why eligibility admits no stacked operand that
        is a program input."""
        n_shards = spec.n_shards
        shard_shapes = [
            tuple(av[0]) if sh else tuple(av[0])[1:]
            for av, sh in zip(spec.x_avals, spec.x_shared)
        ]
        shard_sizes = [int(np.prod(s, dtype=np.int64)) if s else 1 for s in shard_shapes]
        total = int(sum(shard_sizes))
        logp_dt = self.logp_dtype or spec.out_avals[0][1]
        grad_dts = [_grad_dtype(av[1]) for av in spec.x_avals]
        client, window = self.client, self.window

        def host(*arrays: Any) -> list:
            requests = [
                tuple(a if sh else a[s] for a, sh in zip(arrays, spec.x_shared))
                for s in range(n_shards)
            ]
            with _spans.span(
                "fed.reduce_window", lane=self.tag, requests=n_shards
            ):
                _flightrec.record(
                    "fed.reduce_window",
                    lane=self.tag,
                    requests=n_shards,
                    total=total,
                    window=window,
                )
                head, flat = client.evaluate_reduced(
                    requests, window=window, total=total
                )
            out = [np.asarray(head, _np_dtype(logp_dt))]
            flat = np.asarray(flat)
            lo = 0
            for shape, size, dt in zip(shard_shapes, shard_sizes, grad_dts):
                out.append(np.asarray(flat[lo : lo + size], _np_dtype(dt)).reshape(shape))
                lo += size
            return out

        def rule(cts: Sequence[Any], grads: Sequence[torch.Tensor]) -> list:
            (g,) = cts
            out = []
            for grad, av, sh in zip(grads, spec.x_avals, spec.x_shared):
                if g is None or not _inexact(av[1]):
                    out.append(None)
                    continue
                ct = (g.to(grad.dtype) * grad).to(av[1])
                if not sh:
                    ct = torch.cat([ct[None], ct.new_zeros((n_shards - 1,) + ct.shape)])
                out.append(ct)
            return out

        def run(consts: Any, xs: Any) -> List[Any]:
            # Unmapped operands are dropped, exactly like the per-shard
            # pool window: n_varying_consts == 0 was checked at pairing
            # time.
            del consts
            return _window(host, 1, rule, list(xs))

        return run

    def _forward_group_executor(self, specs: Sequence[MapSpec]) -> Callable:
        """Fused forward-only window (no grad contract): every member's
        shards ride one ``evaluate_many``; replies slice back per call.
        Differentiating through it raises."""
        metas = [(s.n_shards, s.x_shared) for s in specs]
        out_dts = [[_np_dtype(av[1]) for av in s.out_avals] for s in specs]
        n_out = sum(len(d) for d in out_dts)

        def host(*arrays: Any) -> list:
            per_call = self._run_window(metas, arrays)
            return [
                np.stack([np.asarray(r[k]) for r in replies]).astype(dt)
                for replies, dts in zip(per_call, out_dts)
                for k, dt in enumerate(dts)
            ]

        def run(xs_per_call: Sequence[tuple]) -> List[List[Any]]:
            outs = _window(host, n_out, None, [x for xs in xs_per_call for x in xs])
            result, k = [], 0
            for dts in out_dts:
                result.append(outs[k : k + len(dts)])
                k += len(dts)
            return result

        return run


def _np_dtype(dt: torch.dtype) -> np.dtype:
    return torch.empty((), dtype=dt).numpy().dtype


class MixedPlacement(Placement):
    """Shard range split across two lanes: the first ``n - pool_shards``
    shards execute on ``mesh``, the trailing ``pool_shards`` on
    ``pool``; stacked outputs concatenate in shard order on the mesh's
    first slot's device, and gradients flow through both lanes (slice
    and concatenation adjoints are exact)."""

    def __init__(
        self,
        mesh: MeshPlacement,
        pool: PoolPlacement,
        *,
        pool_shards: int,
    ) -> None:
        self.mesh = mesh
        self.pool = pool
        self.pool_shards = int(pool_shards)
        if self.pool_shards < 1:
            raise ValueError("pool_shards must be >= 1")

    def fusion_key(self) -> tuple:
        return (
            "mixed",
            self.mesh.fusion_key(),
            self.pool.fusion_key(),
            self.pool_shards,
        )

    def _cut(self, spec: MapSpec) -> int:
        k = self.pool_shards
        if not (0 < k < spec.n_shards):
            raise ValueError(
                f"pool_shards={k} must be in 1..{spec.n_shards - 1} "
                f"(got a {spec.n_shards}-shard fed_map)"
            )
        return spec.n_shards - k

    def map_executor(self, spec: MapSpec) -> MapExecutor:
        group = self.group_executor([spec])

        def run(consts: Any, xs: Any) -> List[Any]:
            return group([(consts, xs)])[0]

        return run

    def group_executor(self, specs: Sequence[MapSpec]) -> Callable:
        specs = list(specs)
        cuts = [self._cut(s) for s in specs]
        mesh_execs = [
            self.mesh.map_executor(s.sliced(0, cut))
            for s, cut in zip(specs, cuts)
        ]
        pool_group = self.pool.group_executor(
            [s.sliced(cut, s.n_shards) for s, cut in zip(specs, cuts)]
        )

        def part(xs, shared, sl):
            return tuple(x if sh else x[sl] for x, sh in zip(xs, shared))

        def run(args: Sequence[Tuple[tuple, tuple]]) -> List[List[Any]]:
            mesh_outs = [
                ex(c, part(xs, s.x_shared, slice(None, cut)))
                for ex, s, cut, (c, xs) in zip(mesh_execs, specs, cuts, args)
            ]
            pool_outs = pool_group(
                [
                    (c, part(xs, s.x_shared, slice(cut, None)))
                    for s, cut, (c, xs) in zip(specs, cuts, args)
                ]
            )
            return [
                [
                    torch.cat([m, p.to(m.device)], dim=0)
                    for m, p in zip(m_out, p_out)
                ]
                for m_out, p_out in zip(mesh_outs, pool_outs)
            ]

        return run


def make_node_compute(
    per_shard_fn: Callable[..., Any], *, grads: bool = True, device: Any = None
) -> Callable[..., list]:
    """Node-side compute for a pool-placed ``fed_map``.

    ``per_shard_fn(*leaves)`` takes one shard's mapped leaves (the
    request arrays, ``tree_leaves`` order — broadcast driver state
    first if the program broadcasts it before the data), as tensors on
    ``device`` (CUDA unless the caller asks for the CPU).  With
    ``grads=True`` (the differentiable logp contract) it must return a
    scalar, and the node replies ``[logp, *grads]`` with one gradient
    per request array (zeros for integer leaves).  With ``grads=False``
    the reply is the flat output list.

    Built from the SAME Python callable the driver's ``fed_map`` maps,
    so the two sides cannot drift apart.
    """
    dev = resolve_device(device)

    def tensors(arrays: Sequence[Any]) -> List[torch.Tensor]:
        return [torch.as_tensor(np.asarray(a)).to(dev) for a in arrays]

    if grads:

        def compute(*arrays: Any) -> list:
            args = tensors(arrays)
            diff_idx = [i for i, a in enumerate(args) if _inexact(a.dtype)]
            for i in diff_idx:
                args[i].requires_grad_(True)
            with torch.enable_grad():
                val = per_shard_fn(*args)
                dgrads = torch.autograd.grad(
                    val, [args[i] for i in diff_idx], allow_unused=True
                )
            by_idx = dict(zip(diff_idx, dgrads))
            out = [val.detach().cpu().numpy()]
            for i, a in enumerate(args):
                g = by_idx.get(i)
                if g is None:
                    g = torch.zeros_like(a, dtype=_grad_dtype(a.dtype))
                out.append(g.cpu().numpy())
            return out

        return compute

    def compute_fwd(*arrays: Any) -> list:
        out = per_shard_fn(*tensors(arrays))
        return [torch.as_tensor(o).detach().cpu().numpy() for o in tree_leaves(out)]

    return compute_fwd

"""``fed.program``: record once, lower per placement, fuse windows.

The port of the JAX package's ``fed/lowering.py``.  ``program(fn,
placement)`` returns a callable with ``fn``'s signature that (1)
records ``fn`` — whose body uses :mod:`.primitives` — as a
``torch.fx`` graph, (2) plans the window-fusion groups (:mod:`.batching`)
and the reduced pairs, and builds one persistent placement EXECUTOR per
``fed_map`` node or group, and (3) interprets the graph, handing
``fed_map`` nodes to their executors and running every other node as
the torch call it records.  Because the interpreter runs ordinary torch
calls, the SAME program object works eagerly, under ``torch.autograd``
and under ``torch.func.vmap``: the mesh lane differentiates through its
per-slot maps, the pool lane through its forward-supplied-gradient
Functions, the mixed lane through both.

The graph is recorded by running ``fn`` once on the call's own values
under a ``TorchFunctionMode``, the way ``jax.make_jaxpr`` traces with
concrete shapes: every torch call on a value derived from the
program's inputs becomes a node, a concrete tensor ``fn`` captures
becomes a constant of the graph (the JAX trace's baked constants), and
a call on constants alone is evaluated then and there.  The ``fed``
functions add their own nodes (``fed_map_p``, ``fed_sum_p``,
``fed_broadcast_p``).  A ``fed_map`` node holds its per-shard callable
in the node's ``meta``, not as an argument; the values derived from
program inputs that the callable closes over (found in its closure
cells, default arguments and ``functools.partial`` arguments, nested
functions included) are the node's driver-varying operands, and the
callable is rebuilt around each call's values.  While the per-shard
callable runs once on shard 0 to learn its outputs' shapes, any other
path by which a program-derived value reaches it raises.  Converting a
program-derived value to a Python value (``bool``, ``item``, ``numpy``)
raises, as a JAX tracer's concretization does.

With ``placement=None`` the wrapper is the identity: the primitives'
dense semantics execute directly.

Graph, plan and executors are cached per argument structure, shape,
dtype and device, unless the recording captured a ``torch.func``
transform's wrapped tensor as a constant — such values are
call-specific and must not leak into a cache.
"""

from __future__ import annotations

import functools
import operator
import types
from contextlib import contextmanager
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.fx
from torch.overrides import TorchFunctionMode

from ..utils import (
    resolve_device,
    tree_leaves,
    tree_map,
    tree_structure,
    value_and_first_grad,
    value_and_grad,
)
from .batching import plan_windows
from .placements import MapSpec, Placement, make_node_compute
from .primitives import (
    _STATE,
    _broadcast,
    _leading_dim,
    _sum,
    _unflatten,
    fed_broadcast,
    fed_broadcast_p,
    fed_map,
    fed_map_p,
    fed_sum,
    fed_sum_p,
)

__all__ = ["ConcretizationError", "FederatedLogpGrad", "canonical_round", "program"]


class ConcretizationError(TypeError):
    """A program-derived value was converted to a Python value while the
    program recorded its graph (JAX's ``ConcretizationTypeError``).
    Code that can do without the concrete value catches this one
    exception, nothing broader."""


def canonical_round(
    per_shard_fn: Callable,
    data: Any,
    n_shards: int,
) -> Callable:
    """The canonical broadcast→map→sum round as a placement-free fed
    model: ``round(*params) = fed_sum(fed_map(per_shard_fn, (params
    broadcast to every shard, data)))``.

    ``per_shard_fn(*params, shard_data)`` is the per-shard term;
    ``data`` is the stacked shard pytree (a concrete pytree becomes the
    graph's constants, which pool lanes accept — the node's deployed
    copy of the function carries the same data).  Parameters reach the
    shards through ``fed_broadcast``, which makes them MAPPED operands:
    the shape every pool deployment must follow (closure capture of
    driver-varying values is refused at lowering), and the shape that
    keeps the reduced-window lowering eligible.  This is the single
    implementation behind :class:`FederatedLogpGrad`."""
    n = int(n_shards)

    def round_model(*params: Any) -> Any:
        pb = fed_broadcast(tuple(params), n)
        lps = fed_map(
            lambda shard: per_shard_fn(*shard[0], shard[1]), (pb, data)
        )
        return fed_sum(lps)

    return round_model


# ---------------------------------------------------------------------------
# recording
# ---------------------------------------------------------------------------

#: Tensor methods that turn a value into a Python one: recording one of
#: a program-derived value would bake this call's value into the graph.
_CONCRETIZING = frozenset({
    "item", "tolist", "numpy", "__bool__", "__int__", "__float__",
    "__index__", "__complex__", "__array__",
})


def _is_wrapped(t: torch.Tensor) -> bool:
    return torch._C._functorch.is_functorch_wrapped_tensor(t)


def _tensors(tree: Any) -> Iterator[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (tuple, list)):
        for t in tree:
            yield from _tensors(t)
    elif isinstance(tree, dict):
        for t in tree.values():
            yield from _tensors(t)


class _Recorder(TorchFunctionMode):
    """Records a program's graph while the program runs once."""

    def __init__(self) -> None:
        super().__init__()
        self.graph = torch.fx.Graph()
        self.constants: Dict[str, torch.Tensor] = {}
        self.cacheable = True
        self._node_of: Dict[int, Any] = {}
        self._varying: set = set()
        self._alive: List[torch.Tensor] = []  # keeps every id unique
        self._paused = False
        # While a per-shard callable runs on shard 0: the ids of the
        # program-derived values it may use (its found closure values).
        self._inner: Optional[set] = None

    # -- values and nodes --------------------------------------------------

    def bind(self, t: torch.Tensor, node: Any) -> None:
        """Make ``t`` a program-derived value computed by ``node``."""
        node.meta["aval"] = (tuple(t.shape), t.dtype)
        self._node_of[id(t)] = node
        self._varying.add(id(t))
        self._alive.append(t)

    def varying(self, t: Any) -> bool:
        return isinstance(t, torch.Tensor) and id(t) in self._varying

    def node(self, t: torch.Tensor) -> Any:
        """``t``'s node: a constant of the graph unless program-derived."""
        n = self._node_of.get(id(t))
        if n is None:
            name = f"_const{len(self.constants)}"
            self.constants[name] = t
            self.cacheable &= not _is_wrapped(t)
            n = self.graph.get_attr(name)
            n.meta["aval"] = (tuple(t.shape), t.dtype)
            self._node_of[id(t)] = n
            self._alive.append(t)
        return n

    def _arg(self, a: Any) -> Any:
        if isinstance(a, torch.Tensor):
            return self.node(a)
        if isinstance(a, (tuple, list)):
            return type(a)(self._arg(x) for x in a) if not isinstance(a, torch.Size) else tuple(a)
        if isinstance(a, dict):
            return {k: self._arg(v) for k, v in a.items()}
        return a

    @contextmanager
    def paused(self) -> Iterator[None]:
        was, self._paused = self._paused, True
        try:
            yield
        finally:
            self._paused = was

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self._paused:
            return func(*args, **kwargs)
        used = [t for t in _tensors((args, kwargs)) if id(t) in self._varying]
        if self._inner is not None:
            if any(id(t) not in self._inner for t in used):
                raise ValueError(
                    "a value derived from the fed program's inputs reaches a "
                    "per-shard function other than through its closure cells, "
                    "default arguments or partial arguments; pass it through "
                    "fed_broadcast as mapped data, or close over it directly"
                )
            return func(*args, **kwargs)
        if not used:
            return func(*args, **kwargs)
        if getattr(func, "__name__", None) in _CONCRETIZING:
            raise ConcretizationError(
                f"{func.__name__} of a value derived from a fed program's "
                "inputs: the program's graph cannot depend on its values"
            )
        out = func(*args, **kwargs)
        if not any(True for _ in _tensors(out)):
            return out
        if not isinstance(out, torch.Tensor) and (not isinstance(out, (tuple, list)) or any(
            isinstance(o, (tuple, list, dict)) and any(True for _ in _tensors(o)) for o in out
        )):
            raise NotImplementedError(
                f"{getattr(func, '__name__', func)} returns tensors inside nested "
                "containers, which a fed program's graph does not record"
            )
        node = self.graph.call_function(func, self._arg(tuple(args)), self._arg(kwargs))
        if isinstance(out, torch.Tensor):
            self.bind(out, node)
        else:
            for i, o in enumerate(out):
                if isinstance(o, torch.Tensor):
                    self.bind(o, self.graph.call_function(operator.getitem, (node, i)))
        return out

    # -- the fed primitives ------------------------------------------------

    def fed_sum(self, x: Any) -> torch.Tensor:
        with self.paused():
            x = torch.as_tensor(x)
            out = _sum(x)
            self.bind(out, self.graph.call_function(fed_sum_p, (self.node(x),)))
        return out

    def fed_broadcast(self, x: Any, n: int) -> torch.Tensor:
        with self.paused():
            x = torch.as_tensor(x)
            out = _broadcast(x, n)
            self.bind(out, self.graph.call_function(fed_broadcast_p, (self.node(x), n)))
        return out

    def fed_map(self, fn: Callable, data: Any) -> Any:
        with self.paused():
            leaves = [torch.as_tensor(leaf) for leaf in tree_leaves(data)]
            n_shards = _leading_dim(leaves)
            skeleton = tree_map(lambda _: None, data)
            found: List[torch.Tensor] = []
            rebuild = _capture(fn, self, found, set())
            shard0 = [leaf[0] for leaf in leaves]
        self._inner = {id(t) for t in found}
        try:
            out = fn(_unflatten(skeleton, shard0))
        finally:
            self._inner = None
        with self.paused():
            outs = [torch.as_tensor(o) for o in tree_leaves(out)]
            node = self.graph.call_function(
                fed_map_p,
                (tuple(self.node(c) for c in found), tuple(self.node(x) for x in leaves)),
            )
            node.meta["fed"] = _MapInfo(
                fn, rebuild, skeleton, n_shards,
                tuple((tuple(o.shape), o.dtype) for o in outs),
            )
            stacked = [o.new_zeros((n_shards,) + tuple(o.shape)) for o in outs]
            for i, s in enumerate(stacked):
                self.bind(s, self.graph.call_function(operator.getitem, (node, i)))
        out_skeleton = tree_map(lambda _: None, out)
        return _unflatten(out_skeleton, stacked)


def _capture(obj: Any, rec: _Recorder, found: List[torch.Tensor], seen: set) -> Optional[Callable]:
    """Where ``obj`` holds program-derived values: appends each (once)
    to ``found`` and returns ``rebuild(values) -> obj`` with them
    replaced by ``values`` (in ``found``'s order); ``None`` where it
    holds none.  Looks into tuples, lists, dicts, the closure cells and
    defaults of Python functions and ``functools.partial`` objects, and
    marks the recording uncacheable where it meets a ``torch.func``
    transform's wrapped tensor."""
    if isinstance(obj, torch.Tensor):
        if not rec.varying(obj):
            rec.cacheable &= not _is_wrapped(obj)
            return None
        for k, t in enumerate(found):
            if t is obj:
                break
        else:
            k = len(found)
            found.append(obj)
        return lambda values: values[k]
    if id(obj) in seen:
        return None
    seen = seen | {id(obj)}
    if isinstance(obj, (tuple, list)):
        subs = [_capture(o, rec, found, seen) for o in obj]
        if not any(subs):
            return None
        parts = lambda v: [s(v) if s else o for s, o in zip(subs, obj)]
        if hasattr(obj, "_fields"):
            return lambda v: type(obj)(*parts(v))
        return lambda v: type(obj)(parts(v))
    if isinstance(obj, dict):
        subs = {k: _capture(o, rec, found, seen) for k, o in obj.items()}
        if not any(subs.values()):
            return None
        return lambda v: {k: subs[k](v) if subs[k] else o for k, o in obj.items()}
    if isinstance(obj, functools.partial):
        sub = _capture((obj.func, obj.args, obj.keywords), rec, found, seen)
        if sub is None:
            return None

        def rebuild_partial(v):
            func, args, keywords = sub(v)
            return functools.partial(func, *args, **keywords)

        return rebuild_partial
    if isinstance(obj, types.FunctionType):
        cells = obj.__closure__ or ()
        contents = []
        for cell in cells:
            try:
                contents.append(cell.cell_contents)
            except ValueError:  # an empty cell
                contents.append(None)
        subs = [_capture(c, rec, found, seen) for c in contents]
        defaults = _capture(obj.__defaults__ or (), rec, found, seen)
        kwdefaults = _capture(obj.__kwdefaults__ or {}, rec, found, seen)
        if not any(subs) and defaults is None and kwdefaults is None:
            return None

        def rebuild_function(v):
            new = types.FunctionType(
                obj.__code__, obj.__globals__, obj.__name__,
                tuple(defaults(v)) if defaults else obj.__defaults__,
                tuple(types.CellType(s(v)) if s else cell for s, cell in zip(subs, cells)),
            )
            new.__kwdefaults__ = kwdefaults(v) if kwdefaults else obj.__kwdefaults__
            new.__dict__.update(obj.__dict__)
            return new

        return rebuild_function
    return None


class _MapInfo:
    """What a ``fed_map`` node's ``meta["fed"]`` holds: the per-shard
    callable, how to rebuild it around the node's closure operands, the
    data's container layout, the shard count and the per-shard outputs'
    ``(shape, dtype)``."""

    def __init__(self, fn, rebuild, skeleton, n_shards, out_avals) -> None:
        self.fn, self.rebuild, self.skeleton = fn, rebuild, skeleton
        self.n_shards, self.out_avals = n_shards, out_avals

    def per_shard(self, consts: Sequence[Any], leaves: Sequence[Any]) -> List[Any]:
        fn = self.rebuild(consts) if self.rebuild else self.fn
        return tree_leaves(fn(_unflatten(self.skeleton, leaves)))


def _record(fn: Callable, args: Any, leaves: Sequence[torch.Tensor]) -> Tuple[_Recorder, Any]:
    """``fn``'s graph, recorded on ``leaves`` (``args``' leaves)."""
    if getattr(_STATE, "recorder", None) is not None:
        raise NotImplementedError("a fed program cannot run while another one records")
    rec = _Recorder()
    aliases = []
    for i, leaf in enumerate(leaves):
        alias = leaf.detach()
        rec.bind(alias, rec.graph.placeholder(f"arg{i}"))
        aliases.append(alias)
    _STATE.recorder = rec
    try:
        with rec, torch.no_grad():
            out = fn(*_unflatten(tree_map(lambda _: None, args), aliases))
    finally:
        _STATE.recorder = None
    with rec.paused():
        outs = tuple(rec.node(torch.as_tensor(o)) for o in tree_leaves(out))
    rec.graph.output(outs)
    return rec, tree_map(lambda _: None, out)


# ---------------------------------------------------------------------------
# planning
# ---------------------------------------------------------------------------


def _spec(node: Any) -> MapSpec:
    """The :class:`MapSpec` of a ``fed_map`` node.  A mapped operand
    made by ``fed_broadcast`` is shared (the executor receives the
    broadcast's source) unless every operand is."""
    info: _MapInfo = node.meta["fed"]
    consts, xs = node.args
    shared = tuple(x.target is fed_broadcast_p for x in xs)
    if all(shared):
        shared = (False,) * len(xs)
    x_avals = tuple(_aval(x.args[0] if sh else x) for x, sh in zip(xs, shared))
    return MapSpec(
        fn=info.per_shard,
        n_consts=len(consts),
        n_shards=info.n_shards,
        x_avals=x_avals,
        out_avals=info.out_avals,
        x_shared=shared,
        n_varying_consts=len(consts),
    )


def _aval(node: Any) -> Tuple[tuple, torch.dtype]:
    return node.meta["aval"]


def _plan_reduce(
    graph: Any,
    plan: Dict[Any, List[Any]],
    placement: Placement,
    specs: Dict[Any, MapSpec],
) -> Dict[Any, Any]:
    """Pair eligible ``fed_sum(fed_map(...))`` nodes for the REDUCED
    window lowering -> ``{map_node: sum_node}``.

    Eligibility (every check is a correctness gate, not a heuristic):

    - the placement opted in (``reduce=True``) and provides
      ``reduced_sum_executor``;
    - the ``fed_map`` fits the logp+grad wire contract (one scalar
      inexact output), ships no driver-varying closure values, and is
      not in a window-fusion group;
    - its single output feeds EXACTLY one node — the ``fed_sum`` — and
      is not itself a program output (anyone else reading the per-shard
      values needs them un-summed);
    - every INEXACT mapped operand is ``fed_broadcast``-derived or a
      constant of the graph: the reduced gradient is ``Σ_s grad_s``,
      which is only a usable cotangent for consumers whose adjoint SUMS
      over shards (broadcast) or who need no cotangent at all
      (constants, integers).  A per-shard program INPUT fails the gate
      and the pair falls back to the per-shard window — correct, just
      not reduced."""
    if not getattr(placement, "reduce", False) or not hasattr(
        placement, "reduced_sum_executor"
    ):
        return {}
    grouped = {n for group in plan.values() for n in group}
    outputs = set(next(n for n in graph.nodes if n.op == "output").all_input_nodes)
    pairs: Dict[Any, Any] = {}
    for sum_node in graph.nodes:
        if sum_node.target is not fed_sum_p:
            continue
        (v,) = sum_node.args
        if v in outputs or v.target is not operator.getitem:
            continue
        map_node = v.args[0]
        if map_node.target is not fed_map_p or map_node in grouped or map_node in pairs:
            continue
        if len(map_node.users) != 1 or len(v.users) != 1:
            continue
        spec = specs[map_node]
        if not spec.grad_contract or spec.n_varying_consts:
            continue
        _, xs = map_node.args
        if all(
            x.op == "get_attr"
            or x.target is fed_broadcast_p
            or not _inexact_node(x)
            for x in xs
        ):
            pairs[map_node] = sum_node
    return pairs


def _inexact_node(node: Any) -> bool:
    dtype = _aval(node)[1]
    return dtype.is_floating_point or dtype.is_complex


def _build_executors(
    graph: Any, placement: Placement, plan: Dict[Any, List[Any]]
) -> Tuple[Dict[Any, MapSpec], Dict[Any, Callable], Dict[Any, Any]]:
    """One persistent executor per ``fed_map`` node: fused groups share a
    group executor keyed at every member; eligible ``fed_sum(fed_map)``
    pairs lower to ONE reduced window (:func:`_plan_reduce`).  Returns
    the nodes' specs, their executors and the reduced pairs."""
    specs = {n: _spec(n) for n in graph.nodes if n.target is fed_map_p}
    reduce_pairs = _plan_reduce(graph, plan, placement, specs)
    executors: Dict[Any, Callable] = {}
    done_groups: Dict[tuple, Any] = {}
    for node, spec in specs.items():
        if node in reduce_pairs:
            executors[node] = placement.reduced_sum_executor(spec)  # type: ignore[attr-defined]
            continue
        group = plan.get(node)
        if group is None:
            executors[node] = placement.map_executor(spec)
            continue
        key = tuple(group)
        if key not in done_groups:
            done_groups[key] = placement.group_executor([specs[m] for m in group])
        executors[node] = done_groups[key]
    return specs, executors, reduce_pairs


# ---------------------------------------------------------------------------
# the program
# ---------------------------------------------------------------------------


class _Program:
    """One recorded signature of a program: its graph, plan and
    executors."""

    def __init__(self, fn: Callable, args: Any, leaves: Sequence[torch.Tensor],
                 placement: Placement, fuse: bool) -> None:
        rec, self.out_skeleton = _record(fn, args, leaves)
        self.graph, self.constants, self.cacheable = rec.graph, rec.constants, rec.cacheable
        self.plan = plan_windows(self.graph) if fuse else {}
        self.specs, self.executors, self.reduce_pairs = _build_executors(
            self.graph, placement, self.plan
        )


def program(
    fn: Callable,
    placement: Optional[Placement] = None,
    *,
    fuse: bool = True,
) -> Callable:
    """Placement-aware executable form of a ``fed``-primitive model.

    ``fn`` takes/returns pytrees of tensors; its body expresses the
    federated algebra with :func:`fed_map` / :func:`fed_sum` /
    :func:`fed_broadcast` / :func:`fed_mean`.  ``fuse=True`` coalesces
    independent ``fed_map`` calls into one window where the placement
    supports it (pool lanes).
    """
    if placement is None:
        return fn
    cache: dict = {}

    def wrapped(*args: Any) -> Any:
        leaves = [torch.as_tensor(x) for x in tree_leaves(args)]
        key = (
            tree_structure(args),
            tuple((tuple(x.shape), x.dtype, x.device) for x in leaves),
        )
        prog = cache.get(key)
        if prog is None:
            prog = _Program(fn, args, leaves, placement, fuse)
            if prog.cacheable:
                cache[key] = prog
        return _unflatten(prog.out_skeleton, _interpret(prog, leaves))

    wrapped.__name__ = getattr(fn, "__name__", "fed_program")
    return wrapped


def _interpret(prog: _Program, leaves: Sequence[torch.Tensor]) -> list:
    env: Dict[Any, Any] = {}
    calls = []
    it = iter(leaves)
    for node in prog.graph.nodes:
        if node.op == "placeholder":
            env[node] = next(it)
        elif node.op == "get_attr":
            env[node] = prog.constants[node.target]
        elif node.op == "call_function":
            calls.append(node)
        else:
            out_node = node

    def ready(node: Any) -> bool:
        return all(n in env for n in node.all_input_nodes)

    def operands(node: Any) -> Tuple[tuple, tuple]:
        consts, xs = node.args
        shared = prog.specs[node].x_shared
        return (
            tuple(env[c] for c in consts),
            tuple(env[x.args[0]] if sh else env[x] for x, sh in zip(xs, shared)),
        )

    def run_node(node: Any) -> None:
        if node.target is fed_map_p:
            env[node] = prog.executors[node](*operands(node))
        elif node.target is fed_sum_p:
            env[node] = _sum(env[node.args[0]])
        elif node.target is fed_broadcast_p:
            env[node] = _broadcast(env[node.args[0]], node.args[1])
        else:
            args = torch.fx.node.map_arg(node.args, env.__getitem__)
            kwargs = torch.fx.node.map_arg(node.kwargs, env.__getitem__)
            env[node] = node.target(*args, **kwargs)

    remaining = dict.fromkeys(calls)
    while remaining:
        progressed = False
        for node in list(remaining):
            if node not in remaining:
                continue
            if node in prog.reduce_pairs:
                # A fed_sum(fed_map) pair lowered to one REDUCED window:
                # the executor's scalar IS the fed_sum's output; the
                # per-shard stack never materializes.
                if not ready(node):
                    continue
                sum_node = prog.reduce_pairs[node]
                (env[sum_node],) = prog.executors[node](*operands(node))
                for n in (node, sum_node.args[0], sum_node):
                    del remaining[n]
                progressed = True
                continue
            group = prog.plan.get(node)
            if group is not None:
                if not all(m in remaining and ready(m) for m in group):
                    continue
                outs = prog.executors[node]([operands(m) for m in group])
                for m, o in zip(group, outs):
                    env[m] = o
                    del remaining[m]
                progressed = True
                continue
            if not ready(node):
                continue
            run_node(node)
            del remaining[node]
            progressed = True
        if not progressed:  # pragma: no cover - grouping guarantees progress
            raise RuntimeError(
                "fed program scheduling wedged: remaining nodes "
                f"{list(remaining)} have unmet inputs"
            )
    return [env[n] for n in out_node.args[0]]


class FederatedLogpGrad:
    """One federated log-potential, every lane: the ``fed.program``
    evaluator.

    ``per_shard_fn(*params, shard_data)`` is the per-shard
    log-potential; ``data`` is the stacked shard pytree (moved to
    ``device``: CUDA unless the caller asks for the CPU).  The model it
    programs is the canonical broadcast→map→sum round::

        logp(params) = fed_sum(fed_map(f, (fed_broadcast(params), data)))

    Surfaces:

    - :meth:`logp` / :meth:`logp_and_grad` — torch-side evaluation under
      the placement (``torch.autograd`` works through all lanes, and
      ``torch.func.vmap`` over a batch of chains).
    - ``__call__(*arrays) -> (logp, [grads])`` — the host
      ``LogpGradFn`` signature: numpy in, numpy out.
    - :meth:`torch_fn` — the ``(logp, grads)`` callable that the bridge's
      PyTorch lane (``federated_potential``) reads.
    - :meth:`node_compute` — the matching node-side deployment
      (``service.run_node(ev.node_compute(), ...)``) for pool lanes.
    """

    def __init__(
        self,
        per_shard_fn: Callable,
        data: Any,
        *,
        placement: Optional[Placement] = None,
        fuse: bool = True,
        device: Any = None,
    ) -> None:
        self.device = resolve_device(device)
        self.per_shard_fn = per_shard_fn
        self.data = tree_map(lambda leaf: torch.as_tensor(leaf).to(self.device), data)
        self.placement = placement
        leaves = tree_leaves(self.data)
        dims = {int(leaf.shape[0]) for leaf in leaves}
        if len(dims) != 1:
            raise ValueError(
                f"data leaves must share a leading shard axis, got {dims}"
            )
        self.n_shards = dims.pop()
        self._data_skeleton = tree_map(lambda _: None, self.data)
        # The canonical round, in primitives (placement-free: `program`
        # owns the lowering).
        self._model = canonical_round(self.per_shard_fn, self.data, self.n_shards)
        self._program = program(self._model, placement=placement, fuse=fuse)

    def fed_model(self, *params: Any) -> Any:
        """The raw primitive-level model (no placement)."""
        return self._model(*params)

    def logp(self, *params: Any) -> torch.Tensor:
        return self._program(*params)

    def logp_and_grad(self, *params: Any) -> Tuple[Any, Any]:
        """``(logp, grads)``, one gradient per parameter (a tuple)."""
        return value_and_grad(lambda ps: self._program(*ps), tuple(params))

    def torch_fn(self, *params: Any) -> Tuple[Any, List[Any]]:
        """``(logp, grads)`` for the bridge's PyTorch lane: ``logp`` keeps
        its autograd graph to ``params`` (a sampler's backward through a
        model that contains the potential reaches it), ``grads`` are first
        order."""
        logp, grads = value_and_first_grad(lambda ps: self._program(*ps), tuple(params))
        return logp, list(grads)

    def __call__(self, *arrays: Any) -> Tuple[Any, List[Any]]:
        """Host ``LogpGradFn``: numpy in, ``(logp, [grads])`` out."""
        logp, grads = self.logp_and_grad(
            *[torch.as_tensor(np.asarray(a)).to(self.device) for a in arrays]
        )
        return logp.cpu().numpy(), [g.cpu().numpy() for g in grads]

    def node_compute(self, *, grads: bool = True) -> Callable[..., list]:
        """Node-side compute matching this evaluator's wire contract:
        requests carry ``(params leaves..., data leaves...)``."""
        skeleton = self._data_skeleton
        n_data = len(tree_leaves(skeleton))
        per_shard = self.per_shard_fn

        def flat(*arrays: Any) -> Any:
            params = arrays[: len(arrays) - n_data]
            dleaves = arrays[len(arrays) - n_data :]
            return per_shard(*params, _unflatten(skeleton, dleaves))

        return make_node_compute(flat, grads=grads, device=self.device)

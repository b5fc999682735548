"""Test-only fake ``pytensor`` for the PyTorch port's bridge.

PyTensor is not installed here nor on the GPU host, so the port's
Apply/optdb glue (``pytensor_federated_torch/bridge/pytensor_ops.py`` and
``fusion.py``) runs under this fake, injected through ``sys.modules``
so the REAL bridge modules import and execute.  It proves our-side
logic — the glue's make_node/perform/grad/rewrite paths and the
``pytorch_funcify`` lane — not compatibility with real PyTensor.

The graph classes are the numpy-only ones of :mod:`pytensor_shim`
(the JAX package's fake), imported as they are; that module's
``build_modules`` and ``bridge_under_shim`` import JAX and the JAX
bridge and are never called here.  What this module adds is the
PyTorch side: a ``pytensor.link.pytorch.dispatch.pytorch_funcify``
registry with torch elementwise rules, and :func:`compile_graph_to_torch`,
the stand-in for PyTensor's PyTorch linker.  Nothing here imports JAX.
"""

from __future__ import annotations

import functools
import importlib
import sys
import types
from contextlib import contextmanager

import torch

from pytensor_shim import (  # the JAX package's fake: its numpy-only classes
    Add,
    Apply,
    Constant,
    DisconnectedType,
    FunctionGraph,
    GraphRewriter,
    Mul,
    Op,
    ReplaceValidate,
    Sub,
    Subtensor,
    TensorType,
    Variable,
    _OptDB,
    _walk_applies,
    as_tensor,
    as_tensor_variable,
    config,
    eval_graph,
    scalar,
)


def _make_pytorch_funcify():
    @functools.singledispatch
    def pytorch_funcify(op, **kwargs):
        raise NotImplementedError(f"no pytorch_funcify for {type(op).__name__}")

    @pytorch_funcify.register(Mul)
    def _(op, **kw):
        return torch.mul

    @pytorch_funcify.register(Add)
    def _(op, **kw):
        return torch.add

    @pytorch_funcify.register(Sub)
    def _(op, **kw):
        return torch.sub

    @pytorch_funcify.register(Subtensor)
    def _(op, **kw):
        return lambda x: x[op.idx]

    return pytorch_funcify


def compile_graph_to_torch(outputs, inputs, pytorch_funcify):
    """Compile variables into one torch callable of ``inputs`` — the
    PyTorch-linker stand-in.  Each apply is lowered through the
    ``pytorch_funcify`` registry, as PyTensor's PyTorch backend consumes
    the bridge's registrations.  Constants become tensors on the device
    of the first argument."""

    def fn(*args):
        values = {id(v): a for v, a in zip(inputs, args)}
        device = args[0].device if args and torch.is_tensor(args[0]) else None

        def value_of(var):
            if id(var) in values:
                return values[id(var)]
            if isinstance(var, Constant):
                return torch.as_tensor(var.data, device=device)
            raise KeyError(f"no value for {var!r}")

        for node in _walk_applies(outputs):
            member = pytorch_funcify(node.op)
            res = member(*[value_of(i) for i in node.inputs])
            if not isinstance(res, (tuple, list)):
                res = (res,)
            if len(res) != len(node.outputs):
                raise ValueError(
                    f"{type(node.op).__name__} torch callable returned "
                    f"{len(res)} outputs for {len(node.outputs)} vars"
                )
            for out, r in zip(node.outputs, res):
                values[id(out)] = r
        return [value_of(o) for o in outputs]

    return fn


SHIM_MODULES = [
    "pytensor",
    "pytensor.tensor",
    "pytensor.gradient",
    "pytensor.graph",
    "pytensor.graph.basic",
    "pytensor.graph.op",
    "pytensor.graph.features",
    "pytensor.graph.fg",
    "pytensor.graph.rewriting",
    "pytensor.graph.rewriting.basic",
    "pytensor.compile",
    "pytensor.link",
    "pytensor.link.pytorch",
    "pytensor.link.pytorch.dispatch",
]

BRIDGE_MODULES = [
    "pytensor_federated_torch.bridge.pytensor_ops",
    "pytensor_federated_torch.bridge.fusion",
]

# The bridge package may already be imported with HAS_PYTENSOR=False (its
# gate ran without pytensor); under the fake it re-imports so the gate
# flips, and so does the demo that imports from it.  Both are restored
# after, so the rest of the process sees the original module objects.
REIMPORT_MODULES = [
    "pytensor_federated_torch.bridge",
    "pytensor_federated_torch.demos.demo_pymc",
]


def build_modules():
    """Fresh fake-module tree (a new optdb and registry each install, so
    repeated runs never see stale registrations)."""
    mods = {name: types.ModuleType(name) for name in SHIM_MODULES}
    pytorch_funcify = _make_pytorch_funcify()
    optdb = _OptDB()

    pt = mods["pytensor"]
    pt.config = config
    pt.tensor = mods["pytensor.tensor"]
    pt.gradient = mods["pytensor.gradient"]
    pt.graph = mods["pytensor.graph"]
    pt.compile = mods["pytensor.compile"]
    pt.link = mods["pytensor.link"]
    pt.__path__ = []

    t = mods["pytensor.tensor"]
    t.as_tensor_variable = as_tensor_variable
    t.as_tensor = as_tensor
    t.scalar = scalar
    t.TensorType = TensorType

    mods["pytensor.gradient"].DisconnectedType = DisconnectedType

    g = mods["pytensor.graph"]
    g.__path__ = []
    g.basic = mods["pytensor.graph.basic"]
    g.op = mods["pytensor.graph.op"]
    g.features = mods["pytensor.graph.features"]
    g.fg = mods["pytensor.graph.fg"]
    g.rewriting = mods["pytensor.graph.rewriting"]
    g.FunctionGraph = FunctionGraph
    mods["pytensor.graph.basic"].Apply = Apply
    mods["pytensor.graph.basic"].Variable = Variable
    mods["pytensor.graph.basic"].Constant = Constant
    mods["pytensor.graph.op"].Op = Op
    mods["pytensor.graph.features"].ReplaceValidate = ReplaceValidate
    mods["pytensor.graph.fg"].FunctionGraph = FunctionGraph
    mods["pytensor.graph.rewriting"].__path__ = []
    mods["pytensor.graph.rewriting"].basic = mods["pytensor.graph.rewriting.basic"]
    mods["pytensor.graph.rewriting.basic"].GraphRewriter = GraphRewriter

    mods["pytensor.compile"].optdb = optdb

    mods["pytensor.link"].__path__ = []
    mods["pytensor.link"].pytorch = mods["pytensor.link.pytorch"]
    mods["pytensor.link.pytorch"].__path__ = []
    mods["pytensor.link.pytorch"].dispatch = mods["pytensor.link.pytorch.dispatch"]
    mods["pytensor.link.pytorch.dispatch"].pytorch_funcify = pytorch_funcify
    return mods, optdb, pytorch_funcify


@contextmanager
def bridge_under_torch_shim():
    """Install the fake, import the port's REAL bridge glue under it,
    yield a namespace, then remove the fake and the glue from
    ``sys.modules`` and restore what was there.  Refuses while any
    ``pytensor`` module (the JAX package's fake, or a real one) is
    loaded: the two fakes are installed one after the other."""
    present = [n for n in SHIM_MODULES + BRIDGE_MODULES + ["pymc"] if n in sys.modules]
    if present:
        raise RuntimeError(
            f"{present[0]} is already imported; the port's fake pytensor "
            "installs only where no other pytensor is loaded"
        )
    saved = {name: sys.modules.pop(name) for name in REIMPORT_MODULES if name in sys.modules}
    mods, optdb, pytorch_funcify = build_modules()
    sys.modules.update(mods)
    try:
        bridge = importlib.import_module("pytensor_federated_torch.bridge")
        if not bridge.HAS_PYTENSOR:
            raise RuntimeError("the fake pytensor did not satisfy the bridge's import gate")
        yield types.SimpleNamespace(
            bridge=bridge,
            pytensor_ops=sys.modules["pytensor_federated_torch.bridge.pytensor_ops"],
            fusion=sys.modules["pytensor_federated_torch.bridge.fusion"],
            optdb=optdb,
            pytorch_funcify=pytorch_funcify,
            Apply=Apply,
            Op=Op,
            Variable=Variable,
            Constant=Constant,
            TensorType=TensorType,
            DisconnectedType=DisconnectedType,
            FunctionGraph=FunctionGraph,
            ReplaceValidate=ReplaceValidate,
            as_tensor_variable=as_tensor_variable,
            scalar=scalar,
            config=config,
            eval_graph=eval_graph,
            compile_graph_to_torch=compile_graph_to_torch,
        )
    finally:
        for name in SHIM_MODULES + BRIDGE_MODULES + REIMPORT_MODULES:
            sys.modules.pop(name, None)
        sys.modules.update(saved)
        # Re-point (or clear) the parent packages' attributes, so that
        # ``pytensor_federated_torch.bridge`` keeps meaning the original.
        for name in REIMPORT_MODULES + BRIDGE_MODULES:
            parent, _, child = name.rpartition(".")
            if parent not in sys.modules:
                continue
            if name in saved:
                setattr(sys.modules[parent], child, saved[name])
            elif hasattr(sys.modules[parent], child):
                delattr(sys.modules[parent], child)

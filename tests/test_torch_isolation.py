"""The PyTorch port stands alone: it imports neither JAX nor the JAX
package, it imports gRPC only at the first gRPC call, and its entry
points never fall back to the CPU quietly."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import pytensor_federated_torch as pft
from pytensor_federated_torch.utils import resolve_device

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "pytensor_federated_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "pytensor_federated_tpu", "grpc")
#: The port's subpackages and top-level modules, each imported on its own.
SUBPACKAGES = (
    "service", "telemetry", "faultinject", "routing", "ops", "signatures",
    "wrappers", "fanout_exec", "models", "parallel", "samplers", "precision",
    "flopcount", "_assoc_scan", "gateway", "ppl", "checkpoint", "demos", "demos.demo_node",
    "demos.demo_model", "optim", "diagnostics", "fed", "fed.primitives", "fed.placements",
    "fed.lowering", "fed.batching", "bridge", "bridge.grouping", "bridge.core",
    "bridge.fanout_exec", "demos.demo_pymc", "parallel.federated",
    "ppl.distributions", "ppl.handlers", "ppl.radon", "ppl.compiler", "ppl.svi", "version",
    "linalg", "linalg.blocks", "linalg.service", "linalg.ops",
)


#: Port modules that import ``pytensor`` at their top, as their JAX twins
#: do: they cannot be imported where PyTensor is not installed (here and
#: on the GPU host).  They run under the port's fake pytensor instead
#: (``tests/torch_pytensor_shim.py``; ``test_the_ports_fakes_load_no_jax``
#: below walks them there).
NEEDS_PYTENSOR = ("bridge.pytensor_ops", "bridge.fusion")


def test_importing_the_port_loads_no_jax():
    """In a fresh interpreter, importing the port and every submodule
    (the two that need PyTensor aside) leaves JAX, the JAX package and
    gRPC out of ``sys.modules``."""
    modules = sorted(
        "pytensor_federated_torch." + ".".join(p.relative_to(ROOT / "pytensor_federated_torch").with_suffix("").parts)
        for p in PORT_FILES[:-1]
        if p.name != "__init__.py"
    )
    modules = [m for m in modules if m not in {"pytensor_federated_torch." + n for n in NEEDS_PYTENSOR}]
    code = (
        "import importlib, sys\n"
        "assert not any(m.split('.')[0] in {forbidden} for m in sys.modules), 'preloaded'\n"
        "for name in {modules}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in {forbidden})\n"
        "print('BAD', bad)\n"
    ).format(forbidden=set(FORBIDDEN), modules=modules)
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout


@pytest.mark.parametrize("name", SUBPACKAGES)
def test_each_subpackage_alone_loads_no_jax_or_grpc(name):
    """Each subpackage, imported first and alone in a fresh interpreter,
    pulls in neither JAX, nor the JAX package, nor gRPC."""
    code = (
        "import importlib, sys\n"
        f"importlib.import_module('pytensor_federated_torch.{name}')\n"
        f"print('BAD', sorted(m for m in sys.modules if m.split('.')[0] in {set(FORBIDDEN)}))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout


def test_ppl_alone_with_every_name_loads_no_jax_or_grpc():
    """``pytensor_federated_torch.ppl``, imported first and alone in a
    fresh interpreter, resolves every name of its ``__all__`` (the JAX
    package's ``ppl.__all__``) and pulls in neither JAX, nor the JAX
    package, nor gRPC."""
    code = (
        "import sys\n"
        "import pytensor_federated_torch.ppl as ppl\n"
        "missing = [n for n in ppl.__all__ if getattr(ppl, n, None) is None]\n"
        f"print('BAD', missing, sorted(m for m in sys.modules if m.split('.')[0] in {set(FORBIDDEN)}))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert "BAD [] []" in out.stdout, out.stdout
    assert _all_of(ROOT / "pytensor_federated_torch" / "ppl" / "__init__.py") == _all_of(
        ROOT / "pytensor_federated_tpu" / "ppl" / "__init__.py")


def test_linalg_exports_the_jax_packages_all():
    """``linalg.__all__`` is the JAX package's, name for name."""
    assert _all_of(ROOT / "pytensor_federated_torch" / "linalg" / "__init__.py") == _all_of(
        ROOT / "pytensor_federated_tpu" / "linalg" / "__init__.py")


#: The host-federation modules of the replica pool, the lanes (gRPC's
#: too) and the gateway: each must import without loading gRPC.
FEDERATION_MODULES = (
    "utils", "service.npproto_codec", "service.batching", "service.arena", "service.shm",
    "service.ring", "service._grpc", "service.server", "service.client", "service.clients",
    "routing.breaker", "routing.budget", "routing.policies", "routing.pool",
    "routing.pooled_client", "telemetry.collector", "telemetry.critpath", "telemetry.slo",
    "telemetry.watchdog", "gateway.fairness", "gateway.autoscale", "gateway.server",
)


def test_each_federation_module_loads_no_jax_or_grpc():
    """In one fresh interpreter, the federation modules are imported one
    at a time; after each, no JAX, JAX package or gRPC module is loaded."""
    code = (
        "import importlib, sys\n"
        "import torch  # the package needs it; it is not under test\n"
        f"for name in {list(FEDERATION_MODULES)!r}:\n"
        "    importlib.import_module('pytensor_federated_torch.' + name)\n"
        f"    bad = sorted(m for m in sys.modules if m.split('.')[0] in {set(FORBIDDEN)})\n"
        "    print(name, 'BAD', bad)\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines == [f"{name} BAD []" for name in FEDERATION_MODULES], out.stdout


def test_grpc_loads_only_at_the_first_grpc_call():
    """Importing the package, the gateway and the gRPC lane's modules
    (and their names through ``service.__getattr__``), building pools on
    the default gRPC transport and classifying failures load no
    ``grpc``; the first gRPC call (a GetLoad to a closed port) does."""
    code = (
        "import asyncio, socket, sys\n"
        "import pytensor_federated_torch, pytensor_federated_torch.gateway\n"
        "import pytensor_federated_torch.service.server, pytensor_federated_torch.service.client\n"
        "from pytensor_federated_torch.routing import NodePool, pooled_client\n"
        "from pytensor_federated_torch.service import (ArraysToArraysServiceClient,\n"
        "    LogpGradServiceClient, get_load_async)\n"
        "from pytensor_federated_torch.telemetry import FleetCollector\n"
        "pool = NodePool([('127.0.0.1', 1)])\n"
        "collector = FleetCollector(targets=['127.0.0.1:1'])\n"
        "tcp = NodePool(transport='tcp')\n"
        "transient = [tcp.is_transient(e) for e in (ConnectionError('x'), RuntimeError('x'))]\n"
        "checked = pooled_client._is_transport_error(OSError('x'))\n"
        "before = 'grpc' in sys.modules\n"
        "with socket.socket() as s:\n"
        "    s.bind(('127.0.0.1', 0))\n"
        "    port = s.getsockname()[1]\n"
        "load = asyncio.run(get_load_async('127.0.0.1', port, timeout=2.0))\n"
        "print(pool.transport, transient, checked, before, load, 'grpc' in sys.modules,\n"
        "      pooled_client._grpc_classifier()[0] is sys.modules['grpc'].aio.AioRpcError)\n"
        "pool.close(); tcp.close()\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "grpc [True, False] True False None True True", out.stdout


def test_grpc_lane_without_grpcio_raises_naming_it():
    """Where ``grpcio`` is missing, the lane's modules still import, and
    the first gRPC use raises ``ImportError`` naming ``grpcio`` instead
    of carrying on over another lane."""
    code = (
        "import asyncio, sys\n"
        "sys.modules['grpc'] = None  # as on a host without grpcio\n"
        "from pytensor_federated_torch.routing import NodePool\n"
        "from pytensor_federated_torch.service import ArraysToArraysServiceClient, serve\n"
        "from pytensor_federated_torch.service.client import get_load_async\n"
        "errors = []\n"
        "for call in (lambda: ArraysToArraysServiceClient('127.0.0.1', 1).evaluate(1.0),\n"
        "             lambda: asyncio.run(get_load_async('127.0.0.1', 1)),\n"
        "             lambda: asyncio.run(serve(lambda x: [x], port=0)),\n"
        "             lambda: NodePool([('127.0.0.1', 1)]).probe_once()):\n"
        "    try:\n"
        "        call()\n"
        "        errors.append('no error')\n"
        "    except ImportError as e:\n"
        "        errors.append('grpcio' in str(e))\n"
        "print(errors)\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[True, True, True, True]", out.stdout


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_import_statement_names_jax(path):
    """No import statement names JAX or the JAX package; ``grpc`` is
    named only inside a function body (imported at first use)."""
    tree = ast.parse(path.read_text())
    in_function = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            in_function.update(id(n) for n in ast.walk(node) if n is not node)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        forbidden = set(FORBIDDEN) - ({"grpc"} if id(node) in in_function else set())
        assert not any(n.split(".")[0] in forbidden for n in names), (path, names)


def test_resolve_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda:0")
    assert resolve_device("cpu") == torch.device("cpu")


def test_entry_points_default_to_cuda(monkeypatch):
    """Without ``device=``, an entry point asks for CUDA and raises when
    there is none, instead of carrying on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pft.generate_node_data(2, n_obs=4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pft.pack_shards([(torch.zeros(3).numpy(),)])


@pytest.mark.parametrize(
    "call",
    [
        lambda: pft.generate_lgssm_data(T=4),
        lambda: pft.models.statespace.default_lgssm_params(),
        lambda: pft.generate_gp_data(2, n_obs=4),
        lambda: pft.FederatedLGSSMPanel(torch.zeros(2, 4).numpy()),
        lambda: pft.flopcount.peak_flops(),
        lambda: __import__("pytensor_federated_torch.demos.demo_node",
                           fromlist=["x"]).make_node_compute(50000),
        lambda: __import__("pytensor_federated_torch.demos.demo_model",
                           fromlist=["x"]).run_local(draws=1),
        lambda: pft.make_mesh(),
        lambda: pft.make_mesh({"shards": 1}),
        lambda: pft.single_device_mesh(),
        lambda: pft.get_load(),
        lambda: pft.healthy_devices(),
        lambda: pft.diagnostics.log_device_load(),
        lambda: pft.models.SeqShardedAR1(torch.zeros(4).numpy()),
        lambda: pft.fed.FederatedLogpGrad(lambda p, d: d.sum(), torch.zeros(2, 3).numpy()),
        lambda: pft.fed.make_node_compute(lambda p: p.sum()),
        lambda: pft.ppl.make_radon_example(4),
        lambda: pft.ppl.seed(lambda: None, rng_key=0),
    ],
    ids=["generate_lgssm_data", "default_lgssm_params", "generate_gp_data", "FederatedLGSSMPanel",
         "peak_flops", "demo_node.make_node_compute", "demo_model.run_local", "make_mesh",
         "make_mesh_shape", "single_device_mesh", "get_load", "healthy_devices",
         "log_device_load", "SeqShardedAR1", "FederatedLogpGrad", "fed.make_node_compute",
         "ppl.make_radon_example", "ppl.seed"],
)
def test_new_entry_points_default_to_cuda(monkeypatch, call):
    """The state-space, GP, FLOP, demo, mesh, ``fed`` and ``ppl`` entry points ask for CUDA
    without ``device=`` (a mesh, without ``devices=``) and raise when
    there is none: no mesh is built on the CPU by default."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        call()


#: JAX top-level names whose modules the port does not have yet, each
#: with the ROADMAP Queue 1 item that ports it: none, since ``ppl/`` and
#: ``version.py`` landed.
UNPORTED_TOP_LEVEL: dict = {}
#: Top-level names of the port that the JAX package's __init__ does not
#: export (it exports them from its subpackages).
PORT_ONLY_TOP_LEVEL = {
    "LOG_2PI", "FederatedExactGP", "FederatedLGSSMPanel", "FederatedLinearRegression",
    "FederatedLogisticRegression", "FederatedSparseGP", "HierarchicalLogisticRegression",
    "HierarchicalRadonGLM", "LotkaVolterraModel", "NoFederatedShards", "ShapeDtypeStruct",
    "flopcount", "generate_gp_data", "generate_hier_logistic_data", "generate_lgssm_data",
    "generate_logistic_data", "generate_lv_data", "generate_node_data", "generate_radon_data",
    "kalman_logp_parallel", "kalman_logp_seq", "linreg_logp_grad_fn", "linreg_prior_logp",
    "linreg_reductions", "linreg_reductions_ref", "linreg_suffstats", "make_lv_model",
    "params_from_jax", "resolve_device", "samplers", "sharded_data_from_jax",
}


def _all_of(init: Path) -> list:
    """The literal ``__all__`` of a package ``__init__``, read by AST."""
    for node in ast.parse(init.read_text()).body:
        if isinstance(node, ast.Assign) and any(
            isinstance(t, ast.Name) and t.id == "__all__" for t in node.targets
        ):
            return ast.literal_eval(node.value)
    raise AssertionError(f"{init} has no literal __all__")


def test_top_level_all_is_the_jax_packages_minus_the_unported():
    """The port's top-level ``__all__`` is the JAX package's, less the
    names whose modules are not ported, plus the port's own listed
    names; every name resolves."""
    jax_all = _all_of(ROOT / "pytensor_federated_tpu" / "__init__.py")
    port_all = _all_of(ROOT / "pytensor_federated_torch" / "__init__.py")
    assert len(port_all) == len(set(port_all))
    assert set(port_all) - PORT_ONLY_TOP_LEVEL == set(jax_all) - set(UNPORTED_TOP_LEVEL)
    assert PORT_ONLY_TOP_LEVEL <= set(port_all) and set(UNPORTED_TOP_LEVEL) <= set(jax_all)
    assert [n for n in port_all if not hasattr(pft, n)] == []


#: Names of the JAX package's ``parallel/__init__.py`` whose module the
#: port does not have yet: none, since ``parallel/federated.py`` landed
#: with ``fed/``.
UNPORTED_PARALLEL: dict = {}
#: Names of the port's ``parallel`` that the JAX package's does not
#: export (its mesh is ``jax.sharding.Mesh``; ``NamedSharding`` comes
#: from ``jax.sharding`` there).
PORT_ONLY_PARALLEL = {"Mesh", "NamedSharding", "NoFederatedShards"}


def test_parallel_all_is_the_jax_packages_minus_the_unported():
    """The port's ``parallel.__all__`` is the JAX package's, ZeRO,
    tensor, expert, Ulysses, the multi-process layer, ``fedavg`` and the
    four ``federated_*`` names included, plus the port's own; every name
    resolves."""
    jax_all = _all_of(ROOT / "pytensor_federated_tpu" / "parallel" / "__init__.py")
    port_all = _all_of(ROOT / "pytensor_federated_torch" / "parallel" / "__init__.py")
    assert len(port_all) == len(set(port_all))
    assert set(jax_all) - set(port_all) == set(UNPORTED_PARALLEL)
    assert set(port_all) - set(jax_all) == PORT_ONLY_PARALLEL
    assert [n for n in port_all if not hasattr(pft.parallel, n)] == []


#: Names that the port's ``models``, ``ops``, ``samplers`` and ``fed``
#: export beyond the JAX package's ``__all__`` of the same package.
PORT_ONLY = {
    "models": {"HierarchicalGLMBase", "linear_predictor", "linreg_suffstats",
               "log_halfnormal_draw"},
    "ops": {"linreg_reductions_ref"},
    "samplers": {
        "DualAveragingState", "HMCInfo", "IntegratorState", "MetropolisState", "NUTSDraws",
        "WelfordState", "da_init", "da_update", "draw_nuts", "kinetic_energy",
        "make_batch_logp_and_grad", "make_flat_logp_and_grad", "make_kernel_step", "ravel",
        "ravel_batch", "sample_momentum", "welford_covariance", "welford_init",
        "welford_update", "welford_variance",
    },
    "fed": set(),
    "ppl": set(),
}


@pytest.mark.parametrize("package", sorted(PORT_ONLY))
def test_package_all_is_the_jax_packages_plus_the_ports_own(package):
    """The port's ``__all__`` of ``models``, ``ops``, ``samplers`` and
    ``fed`` is a literal list: the JAX package's, plus exactly the
    listed port-only names; every name resolves, and a star import
    exports exactly that list."""
    jax_all = _all_of(ROOT / "pytensor_federated_tpu" / package / "__init__.py")
    port_all = _all_of(ROOT / "pytensor_federated_torch" / package / "__init__.py")
    assert len(port_all) == len(set(port_all))
    assert set(jax_all) <= set(port_all)
    assert set(port_all) - set(jax_all) == PORT_ONLY[package]
    module = getattr(pft, package)
    assert [n for n in port_all if not hasattr(module, n)] == []
    namespace: dict = {}
    exec(f"from pytensor_federated_torch.{package} import *", namespace)
    assert set(namespace) - {"__builtins__"} == set(port_all)


def test_fed_primitives_are_named_stand_ins():
    """``fed_map_p``, ``fed_sum_p`` and ``fed_broadcast_p`` carry the JAX
    primitives' names, and a program graph's nodes point at them."""
    from pytensor_federated_torch import fed

    assert [p.name for p in (fed.fed_map_p, fed.fed_sum_p, fed.fed_broadcast_p)] == [
        "fed_map", "fed_sum", "fed_broadcast"]
    assert fed.fed_map_p.multiple_results
    with pytest.raises(TypeError, match="target of a fed program"):
        fed.fed_sum_p(torch.zeros(2))


#: The modules of the rest of the parallel layer and elastic sampling.
PARALLEL_MODULES = (
    "parallel.zero", "parallel.tensor", "parallel.expert", "parallel.ulysses",
    "parallel.multihost", "parallel._collectives", "samplers.elastic", "parallel.federated",
    "fed",
)


@pytest.mark.parametrize("name", PARALLEL_MODULES)
def test_each_parallel_module_alone_loads_no_jax_or_grpc_and_joins_no_world(name):
    """Each module, imported first and alone in a fresh interpreter,
    pulls in neither JAX, nor the JAX package, nor gRPC, and initialises
    no ``torch.distributed`` process group."""
    code = (
        "import importlib, sys, torch\n"
        f"importlib.import_module('pytensor_federated_torch.{name}')\n"
        f"print('BAD', sorted(m for m in sys.modules if m.split('.')[0] in {set(FORBIDDEN)}),\n"
        "      torch.distributed.is_initialized())\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert "BAD [] False" in out.stdout, out.stdout


def test_models_export_every_name_of_the_jax_models():
    """Every name of the JAX package's ``models.__all__`` resolves on the
    port's ``models``: with ``SeqShardedAR1``, ``SeqShardedLGSSM`` and
    ``generate_ar1_data`` none is missing."""
    jax_all = _all_of(ROOT / "pytensor_federated_tpu" / "models" / "__init__.py")
    assert [n for n in jax_all if not hasattr(pft.models, n)] == []


def test_bridge_without_pytensor_is_gated():
    """Where PyTensor is missing, ``import pytensor_federated_torch.bridge``
    succeeds with ``HAS_PYTENSOR`` false, every gated name raises
    ``ImportError`` on access, and the grouping algorithm (which the
    ``fed`` window planner imports) stays importable."""
    code = (
        "import sys\n"
        "sys.modules['pytensor'] = None  # as on a host without pytensor\n"
        "import pytensor_federated_torch.bridge as b\n"
        "from pytensor_federated_torch.bridge.grouping import group_independent\n"
        "errors = []\n"
        f"for name in {_GATED!r}:\n"
        "    try:\n"
        "        getattr(b, name)\n"
        "        errors.append('no error')\n"
        "    except ImportError as e:\n"
        "        errors.append('PyTensor' in str(e))\n"
        "print(b.HAS_PYTENSOR, b.__all__, errors, callable(b.group_independent))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == f"False ['HAS_PYTENSOR'] {[True] * len(_GATED)} True", out.stdout


_GATED = (
    "FederatedArraysToArraysOp", "FederatedFusionRewriter", "FederatedLogpGradOp",
    "FederatedLogpOp", "ParallelFederatedOp", "federated_potential",
)
#: Names that speak of the backend: the JAX package's name, the port's.
RENAMED = {"member_jax_callable": "member_torch_callable",
           "fused_jax_callable": "fused_torch_callable"}


def _all_lists(path: Path) -> list:
    """Every literal ``__all__`` assigned anywhere in a module (both
    branches of the bridge's import gate), in source order."""
    return [ast.literal_eval(node.value) for node in ast.walk(ast.parse(path.read_text()))
            if isinstance(node, ast.Assign)
            and any(isinstance(t, ast.Name) and t.id == "__all__" for t in node.targets)]


@pytest.mark.parametrize("module", ["__init__", "core", "pytensor_ops", "fusion", "fanout_exec"])
def test_bridge_exports_the_jax_packages_names(module):
    """``bridge``'s ``__all__`` (with PyTensor and without) and that of
    ``bridge.core``, ``pytensor_ops``, ``fusion`` and ``fanout_exec`` are
    the JAX package's, name for name, with the backend's renamed pairs
    (``RENAMED``) swapped."""
    jax_lists = _all_lists(ROOT / "pytensor_federated_tpu" / "bridge" / f"{module}.py")
    port_lists = _all_lists(ROOT / "pytensor_federated_torch" / "bridge" / f"{module}.py")
    assert jax_lists
    assert port_lists == [[RENAMED.get(n, n) for n in names] for names in jax_lists]


def test_the_ports_fakes_load_no_jax():
    """In a fresh interpreter, the port's fake pytensor and pymc
    (``tests/torch_pytensor_shim.py``, ``tests/torch_pymc_shim.py``, which
    ``chip_smoke.py`` uses too) install, import the port's bridge glue
    (``NEEDS_PYTENSOR``) and ``demos.demo_pymc`` under them, and leave
    JAX, the JAX package and gRPC out of ``sys.modules``."""
    code = (
        "import importlib, sys\n"
        f"sys.path.insert(0, {str(ROOT / 'tests')!r})\n"
        "import torch_pymc_shim\n"
        "with torch_pymc_shim.demo_pymc_under_torch_shims('cpu') as ns:\n"
        f"    for name in {list(NEEDS_PYTENSOR)!r}:\n"
        "        importlib.import_module('pytensor_federated_torch.' + name)\n"
        "    ok = ns.bridge.bridge.HAS_PYTENSOR and callable(ns.demo.main)\n"
        f"print('BAD', ok, sorted(m for m in sys.modules if m.split('.')[0] in {set(FORBIDDEN)}))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert "BAD True []" in out.stdout, out.stdout

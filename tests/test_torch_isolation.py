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
    "demos.demo_model", "optim", "diagnostics",
)


def test_importing_the_port_loads_no_jax():
    """In a fresh interpreter, importing the port and every submodule
    leaves JAX, the JAX package and gRPC out of ``sys.modules``."""
    modules = sorted(
        "pytensor_federated_torch." + ".".join(p.relative_to(ROOT / "pytensor_federated_torch").with_suffix("").parts)
        for p in PORT_FILES[:-1]
        if p.name != "__init__.py"
    )
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
    ],
    ids=["generate_lgssm_data", "default_lgssm_params", "generate_gp_data", "FederatedLGSSMPanel",
         "peak_flops", "demo_node.make_node_compute", "demo_model.run_local", "make_mesh",
         "make_mesh_shape", "single_device_mesh", "get_load", "healthy_devices",
         "log_device_load", "SeqShardedAR1"],
)
def test_new_entry_points_default_to_cuda(monkeypatch, call):
    """The state-space, GP, FLOP, demo and mesh entry points ask for CUDA
    without ``device=`` (a mesh, without ``devices=``) and raise when
    there is none: no mesh is built on the CPU by default."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        call()


#: JAX top-level names whose modules the port does not have yet, each
#: with the ROADMAP Queue 1 item that ports it.
UNPORTED_TOP_LEVEL = {
    "__version__": "item 6 (version.py)",
    "fed": "item 5 (fed/)",
    "ppl": "item 5 (ppl/: only ppl/elbo.py is ported)",
}
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
#: port does not have yet: ``parallel/federated.py`` binds the ``fed/``
#: primitives (ROADMAP Queue 1 item 5).  Every other module is ported.
UNPORTED_PARALLEL = {
    "fedavg": "federated.py", "federated_broadcast": "federated.py",
    "federated_map": "federated.py", "federated_mean": "federated.py",
    "federated_sum": "federated.py",
}
#: Names of the port's ``parallel`` that the JAX package's does not
#: export (its mesh is ``jax.sharding.Mesh``; ``NamedSharding`` comes
#: from ``jax.sharding`` there).
PORT_ONLY_PARALLEL = {"Mesh", "NamedSharding", "NoFederatedShards"}


def test_parallel_all_is_the_jax_packages_minus_the_unported():
    """The port's ``parallel.__all__`` is the JAX package's, ZeRO,
    tensor, expert, Ulysses and the multi-process layer included, less
    exactly ``fedavg`` and the four ``federated_*`` names, plus the
    port's own; every name resolves."""
    jax_all = _all_of(ROOT / "pytensor_federated_tpu" / "parallel" / "__init__.py")
    port_all = _all_of(ROOT / "pytensor_federated_torch" / "parallel" / "__init__.py")
    assert len(port_all) == len(set(port_all))
    assert set(jax_all) - set(port_all) == set(UNPORTED_PARALLEL)
    assert set(port_all) - set(jax_all) == PORT_ONLY_PARALLEL
    assert [n for n in port_all if not hasattr(pft.parallel, n)] == []


#: The modules of the rest of the parallel layer and elastic sampling.
PARALLEL_MODULES = (
    "parallel.zero", "parallel.tensor", "parallel.expert", "parallel.ulysses",
    "parallel.multihost", "parallel._collectives", "samplers.elastic",
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

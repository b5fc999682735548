"""The PyTorch port stands alone: it imports neither JAX, nor the JAX
package, nor gRPC, and its entry points never fall back to the CPU
quietly."""

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
    "flopcount", "_assoc_scan",
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


#: The host-federation modules of the replica pool and the colocated
#: lanes: each must import, and run its gRPC seams, without gRPC.
FEDERATION_MODULES = (
    "utils", "service.npproto_codec", "service.batching", "service.arena", "service.shm",
    "service.ring", "service._grpc_lane", "routing.breaker", "routing.budget", "routing.policies",
    "routing.pool", "routing.pooled_client", "telemetry.collector", "telemetry.critpath",
    "telemetry.slo", "telemetry.watchdog",
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


def test_grpc_seams_raise_without_loading_grpc():
    """A pool or collector asked for the gRPC lane raises its named
    error, and classifying failures on the other lanes never imports
    ``grpc`` (it is installed here, so an import would succeed)."""
    code = (
        "import sys\n"
        "from pytensor_federated_torch.routing import NodePool, pooled_client\n"
        "from pytensor_federated_torch.service._grpc_lane import GrpcLaneUnavailable\n"
        "from pytensor_federated_torch.telemetry import FleetCollector\n"
        "raised = []\n"
        "for make in (lambda: NodePool([('127.0.0.1', 1)]),\n"
        "             lambda: FleetCollector(targets=['127.0.0.1:1'])):\n"
        "    try:\n"
        "        make()\n"
        "    except GrpcLaneUnavailable:\n"
        "        raised.append(True)\n"
        "pool = NodePool(transport='tcp')\n"
        "transient = [pool.is_transient(e) for e in (ConnectionError('x'), RuntimeError('x'))]\n"
        "checked = pooled_client._is_transport_error(OSError('x'))\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {set(FORBIDDEN)})\n"
        "print(raised, transient, checked, 'BAD', bad)\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[True, True] [True, False] True BAD []", out.stdout


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_import_statement_names_jax(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        assert not any(n.split(".")[0] in FORBIDDEN for n in names), (path, names)


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
    ],
    ids=["generate_lgssm_data", "default_lgssm_params", "generate_gp_data", "FederatedLGSSMPanel",
         "peak_flops"],
)
def test_new_entry_points_default_to_cuda(monkeypatch, call):
    """The state-space, GP and FLOP entry points ask for CUDA without
    ``device=`` and raise when there is none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        call()

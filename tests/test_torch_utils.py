"""The port's ``utils.py`` tail — the card's preflight probe, the CPU
switch and the kernels' build directory — against the JAX package's
contracts for ``probe_backend``, ``ensure_live_backend``,
``force_cpu_backend`` and ``enable_compilation_cache``, with the port's
rule that nothing gives way to the CPU quietly: where the JAX package
falls back to its CPU backend, the port raises."""

import inspect
import os

import pytest
import torch

from pytensor_federated_tpu import utils as jutils
from pytensor_federated_torch import utils
from pytensor_federated_torch.ops import _build
from pytensor_federated_torch.telemetry import flightrec


def _cuda_present():
    return torch.cuda.is_available()


def test_signatures_follow_the_jax_packages():
    """The same keyword-only surface, with ``mosaic`` read as the
    kernel (``try_mosaic`` -> ``try_kernel``) and ``device=`` added to
    ``ensure_live_backend`` (a caller that means the CPU)."""
    sig = lambda f: list(inspect.signature(f).parameters)
    rename = {"try_mosaic": "try_kernel"}
    assert sig(utils.probe_backend) == [rename.get(n, n) for n in sig(jutils.probe_backend)]
    assert sig(utils.ensure_live_backend) == [
        rename.get(n, n) for n in sig(jutils.ensure_live_backend)] + ["device"]
    assert sig(utils.enable_compilation_cache) == sig(jutils.enable_compilation_cache)
    assert inspect.signature(utils.probe_backend).parameters["timeout_s"].default == 180.0


def test_probe_without_a_card_reports_dead(capfd):
    """Here (no CUDA) the probe's child fails its first op: ``(False,
    False)`` with the child's error on stderr and a ``dead`` verdict in
    the flight record."""
    if _cuda_present():
        pytest.skip("a CUDA device is present; the GPU tests probe it")
    was = flightrec.set_enabled(True)
    flightrec.clear()
    try:
        assert utils.probe_backend(try_kernel=True, timeout_s=120) == (False, False)
        events = [e for e in flightrec.events() if e["kind"] == "probe.backend"]
    finally:
        flightrec.set_enabled(was)
    assert "CUDA is not available" in capfd.readouterr().err
    assert [e["verdict"] for e in events] == ["dead"]
    assert events[0]["try_kernel"] is True and events[0]["kernel_ok"] is False


def test_probe_timeout_is_cut_off(monkeypatch):
    """A hung child is cut off at the timeout; the verdict says so."""
    monkeypatch.setattr(utils, "_PROBE_LIVE", "import time\ntime.sleep(30)\n")
    was = flightrec.set_enabled(True)
    flightrec.clear()
    try:
        live, kernel_ok, err = utils._probe(False, 1.0)
        events = [e for e in flightrec.events() if e["kind"] == "probe.backend"]
    finally:
        flightrec.set_enabled(was)
    assert (live, kernel_ok) == (False, False)
    assert "timed out after 1.0 s" in err
    assert events[-1]["verdict"] == "timeout"


def test_ensure_live_backend_raises_without_a_card():
    """The JAX function falls back to the CPU on a dead backend; the
    port's raises, naming the probe's error."""
    if _cuda_present():
        pytest.skip("a CUDA device is present; the GPU tests probe it")
    with pytest.raises(RuntimeError, match="not usable(.|\n)*CUDA is not available"):
        utils.ensure_live_backend(timeout_s=120)
    with pytest.raises(RuntimeError, match="not usable"):
        utils.ensure_live_backend(try_kernel=False, timeout_s=120)


def test_ensure_live_backend_raises_on_a_failed_kernel(monkeypatch):
    """A live card whose kernel fails raises too (no quiet downgrade)."""
    monkeypatch.setattr(utils, "_probe", lambda try_kernel, timeout_s: (True, False, "nvcc: boom"))
    with pytest.raises(RuntimeError, match="kernel failed(.|\n)*nvcc: boom"):
        utils.ensure_live_backend()
    assert utils.ensure_live_backend(try_kernel=False) is False
    monkeypatch.setattr(utils, "_probe", lambda try_kernel, timeout_s: (True, True, ""))
    assert utils.ensure_live_backend() is True


def test_ensure_live_backend_on_the_cpu_is_not_probed(monkeypatch):
    def no_probe(*a, **k):
        raise AssertionError("probed")

    monkeypatch.setattr(utils, "_probe", no_probe)
    assert utils.ensure_live_backend(device="cpu") is False
    assert utils.ensure_live_backend(device=torch.device("cpu")) is False


def test_force_cpu_backend_hides_cuda(monkeypatch):
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    utils.force_cpu_backend()
    utils.force_cpu_backend()  # idempotent, as the JAX function
    assert os.environ["CUDA_VISIBLE_DEVICES"] == ""


def test_force_cpu_backend_raises_after_cuda_init(monkeypatch):
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    with pytest.raises(RuntimeError, match="already initialised"):
        utils.force_cpu_backend()
    assert "CUDA_VISIBLE_DEVICES" not in os.environ


def test_force_cpu_backend_raises_when_devices_were_counted(monkeypatch):
    """A device count torch cached before the call still shows a card:
    the process cannot be made CPU-only any more, so it raises."""
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(RuntimeError, match="counted before"):
        utils.force_cpu_backend()


def test_enable_compilation_cache_moves_the_build_directory(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)
    default = _build.BUILD_DIR
    monkeypatch.delenv("PFTPU_CACHE_DIR", raising=False)
    utils.enable_compilation_cache()
    assert _build.BUILD_DIR == default  # the default stays as it is
    target = tmp_path / "kernels"
    utils.enable_compilation_cache(str(target))
    assert target.is_dir() and _build.BUILD_DIR == target
    assert _build.library_path("linreg_reductions").parent == target
    env_target = tmp_path / "from_env"
    monkeypatch.setenv("PFTPU_CACHE_DIR", str(env_target))
    utils.enable_compilation_cache()
    assert _build.BUILD_DIR == env_target and env_target.is_dir()


def test_value_and_first_grad_keeps_the_values_graph():
    """The value stays differentiable w.r.t. the caller's tensors, the
    gradient carries no graph, and one tensor passed twice gets each
    occurrence's own gradient."""
    a = torch.tensor([1.0, 2.0], requires_grad=True)
    fn = lambda ps: (ps[0] ** 2).sum() + 3.0 * ps[1].sum()
    value, (g0, g1) = utils.value_and_first_grad(fn, (a, a))
    assert value.requires_grad and not g0.requires_grad and not g1.requires_grad
    torch.testing.assert_close(g0, 2.0 * a.detach())
    torch.testing.assert_close(g1, torch.full((2,), 3.0))
    (back,) = torch.autograd.grad(value, a)
    torch.testing.assert_close(back, g0 + g1)
    plain = torch.tensor([1.0, 2.0])
    value, (g0, _) = utils.value_and_first_grad(fn, (plain, plain))
    torch.testing.assert_close(g0, 2.0 * plain)
    assert not plain.requires_grad

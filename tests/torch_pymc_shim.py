"""Test-only fake ``pymc`` for the PyTorch port's ``demos/demo_pymc.py``.

Builds on :mod:`torch_pytensor_shim`.  It implements exactly the pymc
surface the demo touches — ``Model`` (context manager), ``Normal`` /
``HalfNormal`` free RVs, observed ``Normal`` likelihoods, ``Potential``,
``find_MAP``, ``sample`` — by RECORDING the model and delegating the
numerics to the port's own machinery:

- graphs lower to torch through :func:`torch_pytensor_shim.compile_graph_to_torch`,
  which consumes the bridge's REAL ``pytorch_funcify`` registrations as
  PyTensor's PyTorch linker would;
- ``find_MAP`` delegates to ``samplers.mcmc.find_map`` (Adam);
- ``sample`` delegates to ``samplers.mcmc.sample`` (NUTS, the chains in
  lockstep) in unconstrained space — HalfNormal RVs get the log
  transform with its Jacobian term, as pymc reparameterizes them.

The device of the free variables is the installer's (``device=``), the
same device the demo's data live on; with ``cuda_graph=True`` the port's
sampler replays the chains' batched evaluation from a CUDA graph
(``sample(cuda_graph=True)``), its result kept on the returned
``_InferenceData.result``.  This proves that the demo's
model-building and driver code runs and yields the right posterior
against the port's samplers — not real-pymc compatibility.  Nothing here
imports JAX.
"""

from __future__ import annotations

import importlib
import math
import sys
import types
from contextlib import contextmanager
from typing import Any

import numpy as np
import torch

import torch_pytensor_shim as tps

_LOG_2PI = math.log(2.0 * math.pi)

_MODEL_STACK: list = []
#: Device of the free variables and observed data, and whether ``sample``
#: replays its evaluations from a CUDA graph; set by the installer.
_STATE = {"device": torch.device("cpu"), "cuda_graph": False}


def _current_model():
    if not _MODEL_STACK:
        raise TypeError("No model on context stack")
    return _MODEL_STACK[-1]


class _FreeRV:
    def __init__(self, name, var, shape, transform, logprior):
        self.name = name
        self.var = var  # fake Variable, CONSTRAINED value
        self.shape = shape
        self.transform = transform  # "identity" | "log"
        self.logprior = logprior  # constrained value -> scalar tensor


class Model:
    def __init__(self):
        self.free_rvs: list[_FreeRV] = []
        self.potentials: list = []  # fake Variables (scalar)
        self.observed: list = []  # (mu_var, sigma_var, data)
        self.device = _STATE["device"]

    def __enter__(self):
        _MODEL_STACK.append(self)
        return self

    def __exit__(self, *exc):
        _MODEL_STACK.pop()
        return False

    def _compiled_graph_parts(self):
        """One compile of every graph output the logp needs:
        [*potentials, *observed mu, *observed sigma], as a function of
        the free RVs' CONSTRAINED values."""
        pytorch_funcify = sys.modules["pytensor.link.pytorch.dispatch"].pytorch_funcify
        inputs = [rv.var for rv in self.free_rvs]
        outputs = list(self.potentials)
        for mu, sigma, _ in self.observed:
            outputs.append(tps.as_tensor_variable(mu))
            outputs.append(tps.as_tensor_variable(sigma))
        return tps.compile_graph_to_torch(outputs, inputs, pytorch_funcify)

    def logp_fn(self):
        """Unconstrained param dict -> total model logp (a torch scalar)."""
        graph_fn = self._compiled_graph_parts()
        free_rvs = list(self.free_rvs)
        observed = [(torch.as_tensor(d, device=self.device)) for _, _, d in self.observed]
        n_pot = len(self.potentials)

        def logp(u):
            total = 0.0
            constrained = []
            for rv in free_rvs:
                val = u[rv.name]
                if rv.transform == "log":
                    x = torch.exp(val)
                    # |dx/du| = e^u: the log transform's Jacobian
                    total = total + torch.sum(val)
                else:
                    x = val
                constrained.append(x)
                total = total + rv.logprior(x)
            parts = graph_fn(*constrained)
            for p in parts[:n_pot]:
                total = total + torch.sum(p)
            for k, data in enumerate(observed):
                mu = parts[n_pot + 2 * k]
                sigma = parts[n_pot + 2 * k + 1]
                z = (data - mu) / sigma
                total = total + torch.sum(-0.5 * z * z - torch.log(sigma) - 0.5 * _LOG_2PI)
            return total

        return logp

    def initial_unconstrained(self):
        return {
            rv.name: torch.zeros(rv.shape, dtype=torch.float32, device=self.device)
            for rv in self.free_rvs
        }

    def constrain(self, u):
        """Map an unconstrained draw dict to constrained numpy values."""
        out = {}
        for rv in self.free_rvs:
            val = np.asarray(torch.as_tensor(u[rv.name]).detach().cpu())
            out[rv.name] = np.exp(val) if rv.transform == "log" else val
        return out


def _shape_tuple(shape):
    if shape is None:
        return ()
    if isinstance(shape, int):
        return (shape,)
    return tuple(shape)


def Normal(name, mu=0.0, sigma=1.0, shape=None, observed=None):
    model = _current_model()
    if observed is not None:
        # Observed likelihood: mu/sigma may be graph expressions over
        # the free RVs (build_native_model's per-shard likelihoods).
        model.observed.append(
            (tps.as_tensor_variable(mu), tps.as_tensor_variable(sigma), np.asarray(observed))
        )
        return None
    if not isinstance(mu, (int, float)) or not isinstance(sigma, (int, float)):
        raise NotImplementedError("fake prior params must be scalars")
    shp = _shape_tuple(shape)
    var = tps.TensorType("float32", shp)(name=name)

    def logprior(x, mu=float(mu), sigma=float(sigma)):
        z = (x - mu) / sigma
        return torch.sum(-0.5 * z * z - math.log(sigma) - 0.5 * _LOG_2PI)

    model.free_rvs.append(_FreeRV(name, var, shp, "identity", logprior))
    return var


def HalfNormal(name, sigma=1.0, shape=None):
    model = _current_model()
    shp = _shape_tuple(shape)
    var = tps.TensorType("float32", shp)(name=name)

    def logprior(x, sigma=float(sigma)):
        # HalfNormal(sigma) on the CONSTRAINED value x > 0.
        return torch.sum(0.5 * math.log(2.0 / math.pi) - math.log(sigma) - 0.5 * (x / sigma) ** 2)

    model.free_rvs.append(_FreeRV(name, var, shp, "log", logprior))
    return var


def Potential(name, var):
    model = _current_model()
    model.potentials.append(var)
    return var


def find_MAP(progressbar=True, model=None):
    model = model or _current_model()
    from pytensor_federated_torch.samplers.mcmc import find_map

    u = find_map(
        model.logp_fn(), model.initial_unconstrained(), num_steps=600, learning_rate=0.05
    )
    out = {}
    for name, val in model.constrain(u).items():
        val = np.asarray(val)
        out[name] = float(val) if val.ndim == 0 else val
    return out


class _PostArray:
    def __init__(self, arr):
        self.arr = np.asarray(arr)  # (chains, draws, *shape)

    def median(self):
        return np.median(self.arr)

    def mean(self):
        return np.mean(self.arr)

    def __array__(self, dtype=None):
        a = self.arr
        return a.astype(dtype) if dtype is not None else a


class _InferenceData:
    def __init__(self, posterior, result: Any):
        self.posterior = posterior
        self.result = result  # the port's SampleResult, for its counts


def sample(
    draws=1000,
    tune=1000,
    chains=4,
    cores=None,
    progressbar=True,
    random_seed=None,
    model=None,
    **kwargs,
):
    model = model or _current_model()
    from pytensor_federated_torch.samplers.mcmc import sample as pft_sample

    seed = 0 if random_seed is None else int(random_seed)
    res = pft_sample(
        model.logp_fn(),
        model.initial_unconstrained(),
        generator=torch.Generator(device=model.device).manual_seed(seed),
        num_warmup=int(tune),
        num_samples=int(draws),
        num_chains=int(chains),
        kernel="nuts",
        cuda_graph=_STATE["cuda_graph"],
    )
    posterior = {}
    for rv in model.free_rvs:
        arr = res.samples[rv.name].detach().cpu().numpy()  # (chains, draws, *shape)
        if rv.transform == "log":
            arr = np.exp(arr)
        posterior[rv.name] = _PostArray(arr)
    return _InferenceData(posterior, res)


@contextmanager
def demo_pymc_under_torch_shims(device="cpu", cuda_graph=False):
    """The port's fake pytensor + this fake pymc (its variables on
    ``device``, ``sample`` replaying a CUDA graph with ``cuda_graph``) + a
    fresh import of the port's REAL ``demos/demo_pymc.py``; yields (demo
    module, pymc, bridge namespace)."""
    with tps.bridge_under_torch_shim() as ns:
        pymc = types.ModuleType("pymc")
        pymc.Model = Model
        pymc.Normal = Normal
        pymc.HalfNormal = HalfNormal
        pymc.Potential = Potential
        pymc.find_MAP = find_MAP
        pymc.sample = sample
        sys.modules["pymc"] = pymc
        prev = dict(_STATE)
        _STATE.update(device=torch.device(device), cuda_graph=bool(cuda_graph))
        try:
            demo = importlib.import_module("pytensor_federated_torch.demos.demo_pymc")
            yield types.SimpleNamespace(demo=demo, pymc=pymc, bridge=ns)
        finally:
            _STATE.update(prev)
            sys.modules.pop("pymc", None)

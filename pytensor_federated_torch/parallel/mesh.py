"""Device mesh construction, axis conventions, and device health.

Port of the JAX package's ``parallel/mesh.py``.  As there, the mesh is
single-controller: one process drives a grid of the devices it can see,
and each "node" of the reference is a slot along a named axis.  A
:class:`Mesh` keeps the JAX mesh's ``axis_names``, ``shape[axis]`` and
device grid (``devices``), so the sharded evaluator's divisibility
checks and error strings carry over.  It holds ``torch.device``s, and a
device may appear more than once (``[torch.device("cuda", 0)] * 4``: four
slots on one card run one after another on its stream), as
``jax.sharding.Mesh`` accepts a repeated device.  The multi-process
layer (``torch.distributed``) is a separate module, as the JAX
package's ``parallel/multihost.py`` is, and is not ported.

Axis conventions (all optional — models use what they need):

- ``"shards"``  : federated data shards (the reference's one scale axis).
- ``"chains"``  : independent MCMC chains.
- ``"seq"``     : sequence/context parallelism for long-sequence
  likelihoods.

:class:`NamedSharding` is the twin of ``NamedSharding(mesh, P(axis))``:
a mesh and one axis, along which a batch's leading dimension is cut into
contiguous blocks, block ``j`` evaluated on slot ``j``'s device
(:meth:`NamedSharding.map_blocks`).

The JAX package's ``mark_varying`` has no counterpart here.  Under
``shard_map`` a replicated parameter must be marked device-varying
before user code differentiates it inside the body, or its gradient
transposes to a sum over the axis.  In single-controller torch code a
replicated parameter reaches each slot through ``.to(device)``, and the
backward of that copy adds each slot's gradient into the one parameter:
the gradient over the mesh equals the unsharded one and is never
multiplied by the slot count (``tests/test_torch_mesh.py`` pins it).
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Any, Callable, List, Mapping, Optional, Sequence

import numpy as np
import torch

SHARDS_AXIS = "shards"
CHAINS_AXIS = "chains"
SEQ_AXIS = "seq"

__all__ = [
    "CHAINS_AXIS",
    "SEQ_AXIS",
    "SHARDS_AXIS",
    "DeviceLoad",
    "Mesh",
    "NamedSharding",
    "get_load",
    "healthy_devices",
    "make_mesh",
    "single_device_mesh",
]


class Mesh:
    """A named grid of ``torch.device``s: ``devices`` is an object array
    whose axes are ``axis_names``; ``shape`` maps each name to its size
    (an ``OrderedDict``, as ``jax.sharding.Mesh.shape``)."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        devices = np.asarray(devices, dtype=object)
        axis_names = tuple(axis_names)
        if devices.ndim != len(axis_names):
            raise ValueError(
                f"mesh devices have {devices.ndim} axes but {len(axis_names)} "
                f"names were given: {axis_names}"
            )
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"mesh axis names repeat: {axis_names}")
        self.devices = devices
        self.axis_names = axis_names
        self.shape = OrderedDict(zip(axis_names, devices.shape))

    def slot_devices(self, axis: str) -> List[torch.device]:
        """The device of each slot along ``axis``: where the slot's block
        of shards lives and is evaluated.  Over the other axes a block is
        replicated; it is evaluated on the first device of that
        replica group."""
        grid = np.moveaxis(self.devices, self.axis_names.index(axis), 0)
        return list(grid.reshape(grid.shape[0], -1)[:, 0])

    def __repr__(self) -> str:
        return f"Mesh({dict(self.shape)}, devices={self.devices.reshape(-1).tolist()})"


class NamedSharding:
    """A mesh and one of its axes: the leading dimension of a batch is
    cut into ``mesh.shape[axis]`` contiguous blocks, block ``j`` on the
    device of slot ``j`` along ``axis`` (:meth:`Mesh.slot_devices`).

    The twin of the JAX package's ``NamedSharding(mesh, P(axis))`` for
    a leading axis.  In a single controller a block does not stay on its
    device between calls: :meth:`map_blocks` sends each block to its
    slot's device, runs a function there, and gathers the results on the
    first slot's device in slot order, where the caller's loop lives."""

    def __init__(self, mesh: Mesh, axis: str):
        if axis not in mesh.axis_names:
            raise ValueError(f"mesh has no axis {axis!r}: {mesh.axis_names}")
        self.mesh = mesh
        self.axis = axis

    @property
    def devices(self) -> List[torch.device]:
        return self.mesh.slot_devices(self.axis)

    def shard_shape(self, shape: Sequence[int]) -> tuple:
        """The shape of one block of an array of ``shape``; raises when
        the axis does not divide its leading dimension."""
        shape = tuple(int(s) for s in shape)
        n = self.mesh.shape[self.axis]
        if not shape or shape[0] % n != 0:
            raise ValueError(
                f"Sharding {self!r} implies that array axis 0 is partitioned {n} times, "
                f"but the dimension size is {shape[0] if shape else None} (full shape: {shape})"
            )
        return (shape[0] // n,) + shape[1:]

    def map_blocks(self, fn: Callable[[torch.Tensor], Any]) -> Callable[[torch.Tensor], Any]:
        """``fn`` of a batch, computed block by block: slot ``j``'s block
        of ``x`` goes to its device and through ``fn`` there, and the
        outputs (a tensor or a tuple of tensors, each with the batch as
        its leading axis) are concatenated on the first slot's device in
        slot order.  A batch the axis does not divide (a one-chain probe)
        runs whole on the first slot's device."""
        devices = self.devices
        home = devices[0]

        def mapped(x: torch.Tensor) -> Any:
            n = len(devices)
            if x.shape[0] % n != 0:
                return _gather([fn(x.to(home))], home)
            per = x.shape[0] // n
            return _gather([fn(x[j * per:(j + 1) * per].to(d)) for j, d in enumerate(devices)],
                           home)

        return mapped

    def __repr__(self) -> str:
        return f"NamedSharding(mesh={dict(self.mesh.shape)}, spec=P({self.axis!r}))"


def _gather(outs: List[Any], home: torch.device) -> Any:
    """The blocks' outputs concatenated along their leading axis on
    ``home``, output by output."""
    if torch.is_tensor(outs[0]):
        return torch.cat([o.to(home) for o in outs])
    return type(outs[0])(torch.cat([o[i].to(home) for o in outs]) for i in range(len(outs[0])))


def _visible_devices() -> List[torch.device]:
    """Every visible CUDA device; raises when there is none (no mesh,
    load report or probe runs on the CPU unless its devices are given)."""
    if not torch.cuda.is_available() or torch.cuda.device_count() == 0:
        raise RuntimeError(
            "a mesh of the visible CUDA devices was requested but CUDA is not "
            "available; pass devices= (e.g. [torch.device('cpu')] * 8) to use "
            "other devices"
        )
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(
    shape: Optional[Mapping[str, int]] = None,
    *,
    devices: Optional[Sequence[Any]] = None,
) -> Mesh:
    """Build a named device mesh.

    ``shape`` maps axis name -> size; by default a 1-D ``("shards",)``
    mesh over every visible CUDA device.  ``devices`` (anything
    ``torch.device`` takes) may repeat a device."""
    devices = _visible_devices() if devices is None else [torch.device(d) for d in devices]
    if shape is None:
        shape = {SHARDS_AXIS: len(devices)}
    names = tuple(shape.keys())
    sizes = tuple(int(shape[n]) for n in names)
    n_needed = int(np.prod(sizes)) if sizes else 1
    if n_needed > len(devices):
        raise ValueError(
            f"Mesh shape {dict(shape)} needs {n_needed} devices, "
            f"only {len(devices)} available."
        )
    grid = np.empty(n_needed, dtype=object)
    grid[:] = devices[:n_needed]
    return Mesh(grid.reshape(sizes), names)


def single_device_mesh(axis: str = SHARDS_AXIS, *, device: Any = None) -> Mesh:
    """A 1-device mesh — lets all sharded code paths run on one card
    (the first visible CUDA device unless ``device`` is given)."""
    device = _visible_devices()[0] if device is None else device
    return make_mesh({axis: 1}, devices=[device])


@dataclasses.dataclass(frozen=True)
class DeviceLoad:
    """Health/load snapshot of one device, as the JAX package's:
    ``platform`` is ``"gpu"`` for a CUDA device; ``bytes_in_use`` is
    what this process's caching allocator holds allocated and
    ``bytes_limit`` the card's memory (``None`` on the CPU)."""

    device_id: int
    platform: str
    process_index: int
    bytes_in_use: Optional[int]
    bytes_limit: Optional[int]

    @property
    def percent_hbm(self) -> Optional[float]:
        if self.bytes_in_use is None or not self.bytes_limit:
            return None
        return 100.0 * self.bytes_in_use / self.bytes_limit


def get_load(devices: Optional[Sequence[Any]] = None) -> list[DeviceLoad]:
    """Load snapshot for every device (every visible CUDA device by
    default).  A device whose statistics cannot be read is reported
    with ``None`` stats."""
    devices = _visible_devices() if devices is None else [torch.device(d) for d in devices]
    out = []
    for d in devices:
        in_use = limit = None
        if d.type == "cuda":
            try:
                in_use = int(torch.cuda.memory_stats(d).get("allocated_bytes.all.current", 0))
                limit = int(torch.cuda.mem_get_info(d)[1])
            except (RuntimeError, AssertionError):
                in_use = limit = None
        out.append(
            DeviceLoad(
                device_id=d.index or 0,
                platform="gpu" if d.type == "cuda" else d.type,
                process_index=0,
                bytes_in_use=in_use,
                bytes_limit=limit,
            )
        )
    return out


def healthy_devices(devices: Optional[Sequence[Any]] = None) -> list[torch.device]:
    """Devices this process can drive that answer a trivial computation
    (every visible CUDA device by default): a one-element tensor written
    on the device and read back.  The failover analog: a dead device is
    left out when the mesh is built."""
    devices = _visible_devices() if devices is None else [torch.device(d) for d in devices]
    alive = []
    for d in devices:
        try:
            if float(torch.ones((), device=d)) == 1.0:
                alive.append(d)
        except (RuntimeError, AssertionError):
            continue
    return alive

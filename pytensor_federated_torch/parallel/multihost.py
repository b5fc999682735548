"""Multi-process scaling and elastic mesh recovery.

Port of the JAX package's ``parallel/multihost.py``, with
``torch.distributed`` where that module has ``jax.distributed``:

- **Scale-out**: one process per host (or per card), joined into one
  world by :func:`initialize_multihost`; :func:`make_multihost_mesh`
  lays out a mesh whose *outer* axis spans the processes, host-major,
  and tags each slot with its process's rank.  Every process holds the
  same mesh and evaluates only its own slots, from its full host copy
  of the data (:class:`.sharded.FederatedLogp`,
  :class:`.zero.ZeroShardedLogpGrad`); only the reduction crosses the
  process boundary, as the reference's sum of per-node replies crosses
  the network.
- **Elastic recovery**: drop dead processes' and devices' slots and
  rebuild the mesh at the largest size the survivors support
  (:func:`remesh_after_failure`); re-placement is constructing a new
  evaluator from the host copies of the data.
- **Failure detection**: :class:`HeartbeatServer` +
  :func:`detect_dead_peers`: every process answers a trivial TCP
  liveness probe, survivors poll their peers, and a peer that refuses N
  consecutive probes is declared dead.  The reply
  ``alive:<process_index>:<pid>`` is the JAX package's, byte for byte,
  so either package's probe reads the other's server.

The backend is an explicit argument: ``"nccl"`` where each process has
a card of its own, ``"gloo"`` on the CPU and for several processes on
one card (NCCL refuses two ranks on one GPU).  A backend this build
lacks raises; nothing swaps backends quietly.  A process that has
initialised CUDA cannot fork a process that uses the card: start the
ranks by ``spawn`` or from a fork server started before CUDA.
"""

from __future__ import annotations

import datetime
import logging
import os
import socket
import threading
import time
from typing import Any, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ..telemetry import flightrec as _flightrec
from .mesh import (
    SHARDS_AXIS,
    Mesh,
    _visible_devices,
    healthy_devices,
    make_mesh,
    process_count,
    process_index,
)

_log = logging.getLogger("pytensor_federated_torch")

__all__ = [
    "HeartbeatServer",
    "detect_dead_peers",
    "initialize_multihost",
    "make_multihost_mesh",
    "probe_peer",
    "remesh_after_failure",
]

#: The launcher's environment that ``initialize_multihost()`` reads.
_LAUNCHER_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    *,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: str = "gloo",
    timeout_s: float = 120.0,
) -> int:
    """Join this process into a ``torch.distributed`` world; returns the
    process count.

    With *explicit* arguments (``coordinator_address="host:port"``,
    ``num_processes``, ``process_id``) a failure re-raises: the caller
    asked for a specific cluster.  With no arguments the launcher's
    environment is read (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT``, as ``torchrun`` sets them); when there is no
    cluster to join — or the world is already initialised — nothing is
    raised and the current process count is returned (1 without a
    world).  ``backend`` names the collectives' backend (module
    docstring); one this build lacks raises ``RuntimeError`` either way.
    ``timeout_s`` bounds the rendezvous and every collective."""
    dist = torch.distributed
    if not dist.is_available() or not dist.is_backend_available(backend):
        raise RuntimeError(f"torch.distributed backend {backend!r} is not available here")
    if dist.is_initialized():
        return dist.get_world_size()
    explicit = coordinator_address is not None or num_processes is not None
    timeout = datetime.timedelta(seconds=timeout_s)
    if explicit:
        if coordinator_address is None or num_processes is None or process_id is None:
            raise ValueError(
                "initialize_multihost needs coordinator_address, num_processes and "
                "process_id together"
            )
        dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                                world_size=int(num_processes), rank=int(process_id),
                                timeout=timeout)
        return dist.get_world_size()
    if not all(os.environ.get(k) for k in _LAUNCHER_ENV):
        _log.debug("multihost auto-init skipped: no launcher environment")
        return process_count()
    try:
        dist.init_process_group(backend, init_method="env://", timeout=timeout)
    except (RuntimeError, ValueError) as e:
        _log.debug("multihost auto-init skipped: %s", e)
    return process_count()


def make_multihost_mesh(
    inner: Optional[Mapping[str, int]] = None,
    *,
    host_axis: str = SHARDS_AXIS,
    devices: Optional[Sequence[Any]] = None,
    num_processes: Optional[int] = None,
) -> Mesh:
    """Mesh whose leading ``host_axis`` spans the processes, inner axes
    within each.

    ``devices`` are THIS process's devices (every visible CUDA device by
    default; a device may repeat); every process of the world passes as
    many.  The mesh's devices are ordered host-major (process 0's first),
    so positions along ``host_axis`` map to processes and each slot
    carries its process's rank (``mesh.processes``): the sum over
    ``host_axis`` does one cross-process reduction.  ``inner`` axes
    (e.g. ``{"chains": 4}``) subdivide each process's devices.  With one
    process this is a normal mesh with ``host_axis`` over its devices
    (inner axes must then divide the device count).  ``num_processes``
    defaults to the world's size."""
    local = _visible_devices() if devices is None else [torch.device(d) for d in devices]
    n_hosts = process_count() if num_processes is None else int(num_processes)
    all_devices = [d for _ in range(n_hosts) for d in local]
    owners = [p for p in range(n_hosts) for _ in local]
    inner = dict(inner or {})
    if host_axis in inner:
        raise ValueError(
            f"inner axes must not include the host axis {host_axis!r}"
        )
    inner_size = int(np.prod(list(inner.values()))) if inner else 1
    if len(all_devices) % inner_size != 0:
        raise ValueError(
            f"inner axes {inner} (size {inner_size}) do not divide "
            f"{len(all_devices)} devices"
        )
    outer = len(all_devices) // inner_size
    if n_hosts > 1 and outer % n_hosts != 0:
        raise ValueError(
            f"outer axis size {outer} not divisible by {n_hosts} hosts"
        )
    shape = {host_axis: outer, **inner}
    mesh = make_mesh(shape, devices=all_devices)
    if n_hosts == 1:
        return mesh
    return Mesh(mesh.devices, mesh.axis_names,
                processes=np.asarray(owners).reshape(mesh.devices.shape))


class HeartbeatServer:
    """Answer peer liveness probes: one daemon thread, one TCP accept
    loop, replies ``alive:<process_index>:<pid>`` and closes.

    The in-band half of the mesh failure-detection story (module
    docstring): a process that dies — SIGKILL included — stops
    accepting, and its peers' :func:`detect_dead_peers` probes turn
    connection-refused within one kernel RST.  Start one per process,
    before the work loop:

        hb = HeartbeatServer(port=base_port + idx, process_index=idx)

    ``port=0`` picks a free port.  The default bind is LOOPBACK: the
    reply leaks the pid and process identity, so answering probes from
    other interfaces is an explicit deployment decision
    (``allow_external=True``, which binds ``host``, default then
    ``"0.0.0.0"``); a non-loopback ``host`` without the opt-in raises.
    Under the wildcard bind ``address[0]`` is ``"0.0.0.0"``, which is
    not routable from another host: share ``(this_host_ip, hb.port)``.

    ``process_index`` goes into the reply so probers can verify they
    reached the RIGHT peer (a recycled port must not impersonate the
    old incarnation).  It is a plain argument, not read from the
    ``torch.distributed`` world, so a liveness utility never touches the
    collectives."""

    def __init__(
        self,
        host: Optional[str] = None,
        port: int = 0,
        *,
        process_index: Optional[int] = None,
        allow_external: bool = False,
    ):
        if host is None:
            host = "0.0.0.0" if allow_external else "127.0.0.1"
        elif not allow_external and host not in (
            # AF_INET loopback spellings only ("::1" would pass the
            # guard and then fail at the IPv4 socket's bind).
            "127.0.0.1", "localhost",
        ):
            raise ValueError(
                f"refusing to bind heartbeat to {host!r} without "
                "allow_external=True — an externally routable liveness "
                "endpoint is an explicit deployment decision"
            )
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(16)
        self._sock.settimeout(0.25)  # lets the serve loop see _stop
        self._stop = threading.Event()
        idx = -1 if process_index is None else int(process_index)
        self._reply = f"alive:{idx}:{os.getpid()}".encode()
        self._thread = threading.Thread(
            target=self._serve, name="pftpu-heartbeat", daemon=True
        )
        self._thread.start()

    @property
    def address(self) -> Tuple[str, int]:
        """The BOUND (host, port) — under the ``allow_external=True``
        wildcard bind the host is ``"0.0.0.0"``; see the class
        docstring before sharing it with remote peers."""
        host, port = self._sock.getsockname()[:2]
        return host, port

    @property
    def port(self) -> int:
        return self._sock.getsockname()[1]

    def _serve(self):
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return  # socket closed under us during stop()
            try:
                conn.sendall(self._reply)
            except OSError:
                pass  # prober vanished mid-reply
            finally:
                conn.close()

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=2.0)
        self._sock.close()


def probe_peer(
    address: Tuple[str, int],
    *,
    timeout: float = 1.0,
    expect_process_index: Optional[int] = None,
) -> bool:
    """One liveness probe: connect, read the banner, verdict.

    With ``expect_process_index``, a banner that carries a DIFFERENT
    index fails the probe.  A banner index of -1 (server started
    without ``process_index``) cannot be identity-checked and is
    accepted on prefix alone."""
    try:
        with socket.create_connection(address, timeout=timeout) as s:
            s.settimeout(timeout)
            # Read to EOF: the server closes after its sendall, and one
            # recv may deliver a PARTIAL banner.
            chunks = []
            total = 0
            while total < 64:
                chunk = s.recv(64 - total)
                if not chunk:
                    break
                chunks.append(chunk)
                total += len(chunk)
            banner = b"".join(chunks)
    except OSError:
        return False
    if not banner.startswith(b"alive:"):
        return False
    if expect_process_index is None:
        return True
    try:
        idx = int(banner.split(b":")[1])
    except (IndexError, ValueError):
        return False
    return idx == -1 or idx == int(expect_process_index)


def detect_dead_peers(
    peers: Mapping[int, Tuple[str, int]],
    *,
    timeout: float = 1.0,
    retries: int = 3,
    retry_wait: float = 0.5,
) -> List[int]:
    """Probe each peer's :class:`HeartbeatServer` CONCURRENTLY; return
    the process ids that failed ``retries`` consecutive probes (or
    answered with the wrong identity).

    A collective with a dead participant gives a survivor no per-call
    error channel it can rely on (it may just wait), so the pattern is:
    probe BETWEEN collective steps, and only enter a collective with
    peers that answered.  One failed probe is suspicion, ``retries``
    failures are a verdict; peers are probed on separate threads, so a
    sweep costs one worst-case peer."""

    def verdict(item):
        pid, addr = item
        for attempt in range(retries):
            if probe_peer(addr, timeout=timeout, expect_process_index=pid):
                return None
            if attempt + 1 < retries:
                time.sleep(retry_wait)
        _log.warning(
            "peer %d at %s:%d failed %d consecutive liveness probes: "
            "declaring dead",
            pid,
            addr[0],
            addr[1],
            retries,
        )
        _flightrec.record(
            "mesh.peer_dead",
            peer=pid,
            addr=f"{addr[0]}:{addr[1]}",
            retries=retries,
        )
        return pid

    items = sorted(peers.items())
    if not items:
        return []
    if len(items) == 1:
        results = [verdict(items[0])]
    else:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=len(items)) as pool:
            results = list(pool.map(verdict, items))
    return [pid for pid in results if pid is not None]


def remesh_after_failure(
    mesh: Mesh,
    *,
    axis: Optional[str] = None,
    devices: Optional[Sequence[Any]] = None,
    dead_process_ids: Optional[Sequence[int]] = None,
) -> Mesh:
    """Rebuild a mesh over the devices that still respond.

    The failover analog (the reference drops the dead connection and
    rebalances): probe ``mesh``'s devices (or the given candidates, this
    process's), keep the healthy ones, and rebuild the same axis layout
    at the largest size they support — the ``axis`` dimension shrinks,
    other axes keep their extent.  Raises ``TimeoutError`` if no healthy
    device remains (the reference's answer when every server is dead).
    The caller then re-places the data by constructing a new evaluator
    over the returned mesh.

    ``dead_process_ids`` carries a DETECTION verdict (from
    :func:`detect_dead_peers`): those processes' slots are dropped
    knowingly and silently.  Slots of other processes nobody declared
    dead are dropped too (local-view recovery) but with a warning,
    because dropping a live peer's slots is only correct if that peer
    rebuilds its own side.  The rebuilt mesh holds only THIS process's
    healthy devices; a new multi-process mesh needs the survivors to
    agree out of band and run :func:`initialize_multihost` +
    :func:`make_multihost_mesh` again."""
    axis = axis or mesh.axis_names[0]
    me = process_index()
    dead_set = set(dead_process_ids or ())
    if devices is None:
        owners = (mesh.processes.reshape(-1) if mesh.processes is not None
                  else [me] * mesh.devices.size)
        pairs = [(d, int(p)) for d, p in zip(mesh.devices.reshape(-1), owners)]
    else:
        pairs = [(torch.device(d), me) for d in devices]
    pairs = [(d, p) for d, p in pairs if p not in dead_set]
    n_remote = sum(1 for _, p in pairs if p != me)
    if n_remote:
        _log.warning(
            "remesh: dropping %d device(s) of other processes NOT declared "
            "dead (local-view recovery; see remesh_after_failure docstring)",
            n_remote,
        )
    candidates = [d for d, p in pairs if p == me]
    alive = healthy_devices(candidates) if candidates else []
    if not alive:
        raise TimeoutError("no healthy devices remain")
    other = {name: size for name, size in mesh.shape.items() if name != axis}
    other_size = int(np.prod(list(other.values()))) if other else 1
    new_axis_size = len(alive) // other_size
    if new_axis_size < 1:
        raise TimeoutError(
            f"{len(alive)} healthy devices cannot fill axes {other}"
        )
    if new_axis_size < mesh.shape[axis]:
        _log.warning(
            "remesh: axis %r shrinking %d -> %d after device failure",
            axis,
            mesh.shape[axis],
            new_axis_size,
        )
    # Preserve the original axis ORDER (make_multihost_mesh puts the host
    # axis first on purpose).
    shape = {name: (new_axis_size if name == axis else size) for name, size in mesh.shape.items()}
    _flightrec.record(
        "mesh.remesh",
        axis=axis,
        old_size=mesh.shape[axis],
        new_size=new_axis_size,
        dead_process_ids=sorted(dead_set),
        n_alive=len(alive),
    )
    return make_mesh(shape, devices=alive)

"""Host-federation transport: the npwire format over gRPC, TCP, shared
memory and descriptor rings.

A node serves ``arrays in -> arrays out`` with :func:`serve` /
:func:`run_node` (gRPC: the :class:`ArraysToArraysService`),
:func:`serve_tcp_once` (TCP), :func:`serve_shm` (a colocated driver:
requests and replies in a shared-memory arena, a TCP doorbell) or
:func:`serve_ring` (the same arena, futex-parked descriptor rings
instead of the doorbell); a driver calls it with
:class:`ArraysToArraysServiceClient`, :class:`TcpArraysClient`,
:class:`ShmArraysClient` or :class:`RingArraysClient`.  The frames are
byte for byte those of the JAX package (and, on TCP, of
``native/cpp_node``), so torch, JAX and C++ nodes and drivers mix
freely; on gRPC, :mod:`.npproto_codec` also speaks the reference's
protobuf wire.  :func:`device_compute_fn` adapts a torch function on a
device to the numpy compute contract; :class:`MicroBatcher` coalesces
concurrent requests into one vectorized call.

The gRPC client names (:mod:`.client`, :mod:`.clients`) resolve on
first access, through the module ``__getattr__``; no import of this
package loads ``grpc``, which is imported at the first gRPC call.
"""

import importlib

from .batching import MicroBatcher, batched_compute_fn, execute_window_sync
from .deadline import DeadlineExceeded, deadline_scope
from .npwire import (
    WireError,
    decode_arrays,
    decode_batch,
    encode_arrays,
    encode_batch,
)
from .ring import RingArraysClient, serve_ring
from .server import ArraysToArraysService, device_compute_fn, run_node, serve
from .shm import ShmArraysClient, serve_shm
from .tcp import RemoteComputeError, TcpArraysClient, serve_tcp_once

#: The gRPC client names, each with the module it lives in.
_GRPC_CLIENT_NAMES = {
    "ArraysToArraysServiceClient": ".client",
    "ClientPrivates": ".client",
    "get_load_async": ".client",
    "get_loads_async": ".client",
    "get_node_telemetry": ".client",
    "get_node_telemetry_async": ".client",
    "get_node_traces": ".client",
    "get_node_traces_async": ".client",
    "thread_pid_id": ".client",
    "LogpGradServiceClient": ".clients",
    "LogpServiceClient": ".clients",
}


def __getattr__(name):
    module = _GRPC_CLIENT_NAMES.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(module, __name__), name)
    globals()[name] = value
    return value


__all__ = [
    "ArraysToArraysService",
    "ArraysToArraysServiceClient",
    "ClientPrivates",
    "DeadlineExceeded",
    "LogpGradServiceClient",
    "LogpServiceClient",
    "MicroBatcher",
    "RemoteComputeError",
    "RingArraysClient",
    "ShmArraysClient",
    "TcpArraysClient",
    "WireError",
    "batched_compute_fn",
    "deadline_scope",
    "decode_arrays",
    "decode_batch",
    "device_compute_fn",
    "encode_arrays",
    "encode_batch",
    "execute_window_sync",
    "get_load_async",
    "get_loads_async",
    "get_node_telemetry",
    "get_node_telemetry_async",
    "get_node_traces",
    "get_node_traces_async",
    "run_node",
    "serve",
    "serve_ring",
    "serve_shm",
    "serve_tcp_once",
    "thread_pid_id",
]

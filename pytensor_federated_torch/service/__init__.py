"""Host-federation transport: the npwire format over TCP, shared memory
and descriptor rings.

A node serves ``arrays in -> arrays out`` with :func:`serve_tcp_once`
(TCP), :func:`serve_shm` (a colocated driver: requests and replies in a
shared-memory arena, a TCP doorbell) or :func:`serve_ring` (the same
arena, futex-parked descriptor rings instead of the doorbell); a driver
calls it with :class:`TcpArraysClient`, :class:`ShmArraysClient` or
:class:`RingArraysClient`.  The frames are byte for byte those of the
JAX package (and, on TCP, of ``native/cpp_node``), so torch, JAX and C++
nodes and drivers mix freely.  :func:`device_compute_fn` adapts a torch
function on a device to the numpy compute contract;
:class:`MicroBatcher` coalesces concurrent requests into one vectorized
call.  :mod:`.npproto_codec` is the reference's protobuf wire, for the
gRPC lane, which the port does not carry yet (:mod:`._grpc_lane`).
"""

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
from .server import device_compute_fn
from .shm import ShmArraysClient, serve_shm
from .tcp import RemoteComputeError, TcpArraysClient, serve_tcp_once

__all__ = [
    "DeadlineExceeded",
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
    "serve_ring",
    "serve_shm",
    "serve_tcp_once",
]

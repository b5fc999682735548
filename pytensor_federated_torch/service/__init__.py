"""Host-federation transport: the npwire format over plain TCP.

A node serves ``arrays in -> arrays out`` with :func:`serve_tcp_once`;
a driver calls it with :class:`TcpArraysClient`.  The frames are byte
for byte those of the JAX package and of ``native/cpp_node``, so torch,
JAX and C++ nodes and drivers mix freely.  :func:`device_compute_fn`
adapts a torch function on a device to the numpy compute contract.
The gRPC service and client, the shared-memory and ring lanes and the
asyncio micro-batcher of the JAX package are not ported yet.
"""

from .batching import batched_compute_fn, execute_window_sync
from .deadline import DeadlineExceeded, deadline_scope
from .npwire import (
    WireError,
    decode_arrays,
    decode_batch,
    encode_arrays,
    encode_batch,
)
from .server import device_compute_fn
from .tcp import RemoteComputeError, TcpArraysClient, serve_tcp_once

__all__ = [
    "DeadlineExceeded",
    "RemoteComputeError",
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
    "serve_tcp_once",
]

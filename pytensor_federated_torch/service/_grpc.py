"""The gRPC runtime, loaded at its first use.

The gRPC lane (:class:`.server.ArraysToArraysService`, :func:`.server.serve`,
:mod:`.client`, :mod:`.clients`) needs the ``grpcio`` package; nothing
else in this package does, and a host may serve the TCP, shm and ring
lanes without it.  So no module of the package imports ``grpc`` when it
is itself imported: the gRPC modules name :data:`grpc` below, which
stands in for the module and imports it at the first attribute read.
Where ``grpcio`` is missing, that read raises ``ImportError`` naming it:
a caller that asked for gRPC is told so, never carried on over another
lane.
"""

from __future__ import annotations

from types import ModuleType
from typing import Any, Optional

__all__ = ["grpc", "load"]

_module: Optional[ModuleType] = None


def load() -> ModuleType:
    """Import ``grpc`` (and ``grpc.aio``) once and return it."""
    global _module
    if _module is None:
        try:
            import grpc as module
            import grpc.aio  # noqa: F401  (the asyncio API lives here)
        except ImportError as e:
            raise ImportError(
                "the gRPC lane of pytensor_federated_torch needs the "
                "'grpcio' package, which is not installed; install grpcio, "
                "or use the tcp, shm or ring lane"
            ) from e
        _module = module
    return _module


class _LazyGrpc:
    """``grpc``, imported when an attribute is first read."""

    __slots__ = ()

    def __getattr__(self, name: str) -> Any:
        return getattr(_module if _module is not None else load(), name)


grpc = _LazyGrpc()

"""Where the gRPC lane plugs in, until the port carries it.

The JAX package's gRPC service and client (``service/server.py``'s
``ArraysToArraysService``, ``service/client.py``) are not ported yet:
they are the port's next slice of the host-federation plane, with the
gateway (ROADMAP.md, Queue 1).  Every seam that would reach them —
a pool replica or probe on ``transport="grpc"``, a fleet collector's
GetLoad scrape — raises :class:`GrpcLaneUnavailable` instead, so a
caller that asks for gRPC is told so and never carried on quietly over
another lane.  ``grpc`` is never imported here.
"""

from __future__ import annotations

from typing import NoReturn

__all__ = ["GrpcLaneUnavailable", "grpc_lane_unavailable"]


class GrpcLaneUnavailable(NotImplementedError):
    """The gRPC lane was asked for; the port does not carry it yet.

    A ``NotImplementedError`` (so a ``RuntimeError``): the pool's
    failure classification treats it as the request's own fault and
    raises it at once instead of failing over."""


def grpc_lane_unavailable(what: str) -> NoReturn:
    raise GrpcLaneUnavailable(
        f"{what} needs the gRPC lane (service/client.py and the "
        "ArraysToArraysService of service/server.py), which "
        "pytensor_federated_torch does not carry yet: it is the next "
        "slice of the port, with the gateway. Use transport='tcp', "
        "'shm' or 'ring' (a collector: http_targets=)."
    )

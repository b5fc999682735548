"""The fused perform's scheduling core, under the bridge's name.

It lives in :mod:`pytensor_federated_torch.fanout_exec`, so that
importing it (e.g. from ops/fanout.py) does not execute this package's
``__init__``, which imports pytensor when it is installed."""

from ..fanout_exec import (  # noqa: F401
    CoalescingCaller,
    MemberExecutorPool,
    member_spans,
    run_members,
)

__all__ = [
    "CoalescingCaller",
    "MemberExecutorPool",
    "member_spans",
    "run_members",
]

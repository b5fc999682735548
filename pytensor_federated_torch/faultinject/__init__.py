"""Deterministic fault injection for every I/O boundary the system owns.

The correctness tooling behind the robustness claims of the recovery
machinery (watchdog, circuit breakers, hedged requests, mid-window
failover, elastic restart): a seeded, serializable :class:`FaultPlan`
of faults — delay, drop, disconnect, mid-frame truncation/stall, byte
corruption, duplicated replies, compute errors, GetLoad garbage,
process kills — threaded through the TCP socket path, the npwire /
npproto codec seams, the gRPC stream lane, the server compute path, the
pool probe lane, and (via ``--fault-plan``) the C++ node.

Usage::

    from pytensor_federated_torch import faultinject as fi

    plan = fi.FaultPlan(
        [fi.FaultRule("stall", point="tcp.send", nth=2, stall_s=3.0)],
        seed=7,
    )
    fi.install(plan)          # this process
    # ... or across a process boundary:
    env["PFTPU_FAULT_PLAN"] = plan.to_json()

``tools/chaos_run.py`` sweeps generated plans over a pooled driver and
asserts the system invariants (exactly-one-reply, watchdog-bounded,
breaker reconvergence, telemetry accounting); ``docs/robustness.md``
maps fault kind x layer x detection signal x recovery tier.

Importing this package activates ``$PFTPU_FAULT_PLAN`` when set (the
cross-process lane — subprocess nodes import the service stack, which
imports this).  With no plan installed every shim is one attribute
load (bench.py's ``faultinject_overhead`` gate).
"""

from .plan import FAULT_KINDS, FaultPlan, FaultRule
from .runtime import (
    FaultPlanError,
    decide,
    install,
    install_from_env,
    snapshot,
    uninstall,
)
from . import runtime

__all__ = [
    "FAULT_KINDS",
    "FaultPlan",
    "FaultPlanError",
    "FaultRule",
    "decide",
    "install",
    "install_from_env",
    "runtime",
    "snapshot",
    "uninstall",
]

# Cross-process activation: a subprocess node spawned with
# PFTPU_FAULT_PLAN set runs its half of the schedule the moment it
# imports the service stack.  Loudly — a chaos run whose plan failed to
# parse would otherwise "pass" by injecting nothing.
install_from_env()

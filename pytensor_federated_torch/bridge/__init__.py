"""The PyTensor/PyMC bridge: federated ops inside PyMC graphs.

The Op surface embeds remote or local logp/grad calls into PyMC models,
and every op registers a ``pytorch_funcify`` dispatch: when PyMC
compiles the model through PyTensor's PyTorch linker (``mode="PYTORCH"``)
the federated likelihood runs as the op's ``torch_fn`` inside the
compiled function (through the Hopper kernel where it calls it).  The
``FederatedFusionRewriter`` fans independent federated applies out at
once on every linker.

Import-gated: the rest of the framework is fully usable without PyTensor
installed.  :func:`.grouping.group_independent`, the rewrite's grouping
algorithm, needs no PyTensor and stays importable from
``bridge.grouping`` either way (the ``fed`` window planner uses it).
"""

from .grouping import group_independent  # noqa: F401

try:
    from .pytensor_ops import (
        FederatedArraysToArraysOp,
        FederatedLogpGradOp,
        FederatedLogpOp,
        federated_potential,
    )

    # Importing fusion registers the automatic fan-out rewrite in
    # PyTensor's optdb.
    from .fusion import FederatedFusionRewriter, ParallelFederatedOp

    HAS_PYTENSOR = True
    __all__ = [
        "HAS_PYTENSOR",
        "FederatedArraysToArraysOp",
        "FederatedFusionRewriter",
        "FederatedLogpGradOp",
        "FederatedLogpOp",
        "ParallelFederatedOp",
        "federated_potential",
    ]
except ModuleNotFoundError as e:
    # Only a missing THIRD-PARTY dep may soft-disable the bridge.  A
    # missing module of our own (e.g. a file dropped from a wheel) must
    # stay loud — swallowing it here would silently stub out every Op
    # in an environment where pytensor IS installed.
    if e.name is not None and e.name.split(".")[0] == "pytensor_federated_torch":
        raise
    HAS_PYTENSOR = False
    __all__ = ["HAS_PYTENSOR"]

    def __getattr__(name):
        if name in (
            "FederatedArraysToArraysOp",
            "FederatedFusionRewriter",
            "FederatedLogpGradOp",
            "FederatedLogpOp",
            "ParallelFederatedOp",
            "federated_potential",
        ):
            raise ImportError(
                f"{name} requires PyTensor; install the 'pytensor' extra "
                "(pip install pytensor-federated-tpu[pytensor])"
            )
        raise AttributeError(name)

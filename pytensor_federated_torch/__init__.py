"""pytensor-federated-torch: the PyTorch/CUDA port of pytensor-federated-tpu.

The flagship path of the JAX package, rewritten in PyTorch: heterogeneous
shards packed with a mask, the federated linear-regression posterior,
its fused logp+grad reduction as a hand-written Hopper kernel (one
launch for a whole batch of chains), and NUTS with warmup adaptation and
convergence diagnostics, every chain in lockstep.  ChEES-HMC
(``samplers.chees_sample``) adapts across such a batch.  Beside it, the
models of BASELINE.json configs 3-5 (the radon GLM, the Lotka-Volterra
ODE, the federated logistic regressions), ``find_map``, Metropolis and
the float32 precision policy; the Gaussian processes, the
linear-Gaussian state-space models with their parallel-in-time Kalman
filter, parallel tempering (``samplers.pt_sample``) and FLOP accounting
(:mod:`.flopcount`).  Variational inference, SMC, the ensemble
sampler, SGLD and SBC (:mod:`.samplers`), and checkpointed sampling
that resumes bit for bit (:func:`sample_checkpointed`).  The shards axis
spreads over a single-controller device mesh (:func:`make_mesh`), and
:mod:`.diagnostics` counts, times and profiles evaluations.  The
sharded optimizer (:mod:`.optim`) keeps Adam's state on the pool's
nodes, one shard each.  :mod:`.fed` runs one federated model over a
mesh, a node pool or both (``fed.program``).  Entry points run on
``cuda`` unless the caller passes ``device="cpu"``.

The federation wire: a node serves its logp+grad over npwire frames on
gRPC or TCP (:mod:`.service`), byte for byte the JAX package's frames,
and a driver fans out to its nodes with :class:`ParallelLogpGrad`; a
gateway (:mod:`.gateway`) fronts a replica pool for many tenants.  This
package imports neither JAX nor the JAX package, and it imports
``grpc`` only at the first gRPC call.
"""

from . import diagnostics, fed, flopcount, ppl, precision, samplers
from .checkpoint import load_pytree, sample_checkpointed, save_pytree
from .convert import params_from_jax, sharded_data_from_jax
from .diagnostics import instrument_logp, profile_trace
from .models import (
    FederatedExactGP,
    FederatedLGSSMPanel,
    FederatedLinearRegression,
    FederatedLogisticRegression,
    FederatedSparseGP,
    HierarchicalLogisticRegression,
    HierarchicalRadonGLM,
    LotkaVolterraModel,
    generate_gp_data,
    generate_hier_logistic_data,
    generate_lgssm_data,
    generate_logistic_data,
    generate_lv_data,
    generate_node_data,
    generate_radon_data,
    kalman_logp_parallel,
    kalman_logp_seq,
    linreg_suffstats,
    make_lv_model,
)
from .models.linear import linreg_prior_logp
from .ops import (
    ArraysToArraysOp,
    AsyncArraysToArraysOp,
    AsyncLogpGradOp,
    AsyncLogpOp,
    LogpGradOp,
    LogpOp,
    ParallelLogpGrad,
    blackbox_compute,
    blackbox_logp_grad,
    from_logp_fn,
    fuse,
    parallel_host_call,
)
from .ops.linreg_kernel import linreg_logp_grad_fn, linreg_reductions, linreg_reductions_ref
from .parallel import (
    CHAINS_AXIS,
    SEQ_AXIS,
    SHARDS_AXIS,
    FederatedLogp,
    NoFederatedShards,
    ShardedData,
    get_load,
    healthy_devices,
    make_mesh,
    pack_shards,
    sharded_compute,
    single_device_mesh,
)
from .precision import pdot, split_dot, wrap_policy
from .signatures import ArraysSpec, ComputeFn, LogpFn, LogpGradFn, ShapeDtypeStruct, spec_of
from .utils import LOG_2PI, resolve_device
from .version import __version__
from .wrappers import logp_grad_from_logp, wrap_logp_fn, wrap_logp_grad_fn

__all__ = [
    "CHAINS_AXIS",
    "LOG_2PI",
    "SEQ_AXIS",
    "SHARDS_AXIS",
    "ArraysSpec",
    "ArraysToArraysOp",
    "AsyncArraysToArraysOp",
    "AsyncLogpGradOp",
    "AsyncLogpOp",
    "ComputeFn",
    "FederatedExactGP",
    "FederatedLGSSMPanel",
    "FederatedLinearRegression",
    "FederatedLogisticRegression",
    "FederatedLogp",
    "FederatedSparseGP",
    "HierarchicalLogisticRegression",
    "HierarchicalRadonGLM",
    "LogpFn",
    "LogpGradFn",
    "LogpGradOp",
    "LogpOp",
    "LotkaVolterraModel",
    "NoFederatedShards",
    "ParallelLogpGrad",
    "ShapeDtypeStruct",
    "ShardedData",
    "blackbox_compute",
    "blackbox_logp_grad",
    "diagnostics",
    "fed",
    "flopcount",
    "from_logp_fn",
    "fuse",
    "generate_gp_data",
    "generate_hier_logistic_data",
    "generate_lgssm_data",
    "generate_logistic_data",
    "generate_lv_data",
    "generate_node_data",
    "generate_radon_data",
    "get_load",
    "healthy_devices",
    "instrument_logp",
    "kalman_logp_parallel",
    "kalman_logp_seq",
    "linreg_logp_grad_fn",
    "linreg_prior_logp",
    "linreg_reductions",
    "linreg_reductions_ref",
    "linreg_suffstats",
    "load_pytree",
    "logp_grad_from_logp",
    "make_lv_model",
    "make_mesh",
    "pack_shards",
    "parallel_host_call",
    "params_from_jax",
    "pdot",
    "ppl",
    "precision",
    "profile_trace",
    "resolve_device",
    "sample_checkpointed",
    "samplers",
    "save_pytree",
    "sharded_compute",
    "sharded_data_from_jax",
    "single_device_mesh",
    "spec_of",
    "split_dot",
    "wrap_logp_fn",
    "wrap_logp_grad_fn",
    "wrap_policy",
    "__version__",
]

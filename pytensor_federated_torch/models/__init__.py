"""Models: the flagship federated linear regression, BASELINE.json's
radon GLM, Lotka-Volterra ODE and federated logistic regressions, the
Gaussian processes and the linear-Gaussian state-space models."""

from .glm import HierarchicalRadonGLM, generate_radon_data
from .gp import (
    FederatedExactGP,
    FederatedSparseGP,
    dense_vfe_logp,
    generate_gp_data,
    get_kernel,
)
from .hierbase import HierarchicalGLMBase, linear_predictor, log_halfnormal_draw
from .linear import FederatedLinearRegression, generate_node_data, linreg_suffstats
from .logistic import (
    FederatedLogisticRegression,
    HierarchicalLogisticRegression,
    generate_hier_logistic_data,
    generate_logistic_data,
)
from .ode import (
    LotkaVolterraModel,
    generate_lv_data,
    make_lv_model,
    rk4_integrate,
)
from .statespace import (
    FederatedLGSSMPanel,
    ekf_logp,
    generate_lgssm_data,
    kalman_forecast,
    kalman_logp_parallel,
    kalman_logp_seq,
    kalman_smoother_parallel,
    kalman_smoother_seq,
    kalman_smoother_with_lag1,
    lgssm_em,
    panel_em,
    sample_latents,
)

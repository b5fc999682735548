"""Models: the flagship federated linear regression and BASELINE.json's
radon GLM, Lotka-Volterra ODE and federated logistic regressions."""

from .glm import HierarchicalRadonGLM, generate_radon_data
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

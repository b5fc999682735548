"""Models: the flagship federated linear regression."""

from .linear import FederatedLinearRegression, generate_node_data, linreg_suffstats

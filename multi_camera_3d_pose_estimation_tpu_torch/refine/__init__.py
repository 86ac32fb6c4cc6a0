"""Trajectory refinement of the port: interpolation and the Adam/MLE refiners."""

from .costs import body_length_cost, gaussian_log_likelihood, precompute_cov_inverse, smoothness_cost
from .extrinsics import ExtrinsicRefiner
from .interpolation import linear_interpolation
from .optimizer import PoseRefiner, RefineConfig

__all__ = [
    "linear_interpolation",
    "gaussian_log_likelihood",
    "smoothness_cost",
    "body_length_cost",
    "precompute_cov_inverse",
    "PoseRefiner",
    "RefineConfig",
    "ExtrinsicRefiner",
]

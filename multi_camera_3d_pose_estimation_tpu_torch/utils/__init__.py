"""Skeleton metadata, keypoint-schema conversion and profiling helpers of the
port (its own copies of the JAX package's tables and rules)."""

from .keypoint_convert import convert_keypoint_definition
from .profiling import StepTimer, profile_refinement_costs, trace
from .skeleton import (
    BODYPARTS,
    CONNECTIVITY_DICT,
    POINT_INFO,
    body_length_edges,
    change_origin,
    generate_connectivity_names,
    get_body_part_lengths,
    get_body_part_vects,
)

__all__ = [
    "CONNECTIVITY_DICT",
    "POINT_INFO",
    "BODYPARTS",
    "generate_connectivity_names",
    "get_body_part_vects",
    "get_body_part_lengths",
    "body_length_edges",
    "change_origin",
    "convert_keypoint_definition",
    "StepTimer",
    "trace",
    "profile_refinement_costs",
]

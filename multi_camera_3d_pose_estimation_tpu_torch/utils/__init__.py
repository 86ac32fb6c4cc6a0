"""Skeleton metadata of the port (its own copy of the JAX package's tables)."""

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
]

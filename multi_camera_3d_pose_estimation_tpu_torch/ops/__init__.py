"""Batched geometry, decode and kernel ops of the port (torch)."""

from .bottleneck import fused_bottleneck_block, fused_stage1_chain, make_fused_stage1
from .fused_decode import fused_heatmap_decode
from .geometry import projection_matrix
from .heatmap_decode import heatmap_argmax_decode
from .moments import heatmap_moments
from .triangulation import triangulate_dlt, triangulate_top2
from .undistort import normalize_pixels, undistort_points

__all__ = [
    "fused_bottleneck_block",
    "fused_heatmap_decode",
    "fused_stage1_chain",
    "heatmap_argmax_decode",
    "heatmap_moments",
    "make_fused_stage1",
    "normalize_pixels",
    "projection_matrix",
    "triangulate_dlt",
    "triangulate_top2",
    "undistort_points",
]

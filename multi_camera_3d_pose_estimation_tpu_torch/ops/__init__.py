"""Batched geometry, decode and kernel ops of the port (torch)."""

from .bottleneck import fused_bottleneck_block, fused_stage1_chain
from .fused_decode import fused_heatmap_decode
from .geometry import (distort_normalized, make_homogeneous_rep_matrix, project_points,
                       projection_matrix, rodrigues_matrix, rodrigues_vector, rotation_conversion)
from .heatmap_decode import heatmap_argmax_decode, heatmap_dark_decode
from .moments import heatmap_moments
from .simcc import simcc_decode
from .swin_block import fused_swin_block, swin_block_plain, swin_gemm
from .triangulation import (get_pose_3d, triangulate_dlt, triangulate_nview, triangulate_points,
                            triangulate_top2)
from .undistort import normalize_pixels, undistort_points
from .window_attention import fused_window_attention, packed_window_attention

__all__ = [
    "distort_normalized",
    "fused_bottleneck_block",
    "fused_heatmap_decode",
    "fused_stage1_chain",
    "fused_swin_block",
    "fused_window_attention",
    "get_pose_3d",
    "heatmap_argmax_decode",
    "heatmap_dark_decode",
    "heatmap_moments",
    "make_homogeneous_rep_matrix",
    "normalize_pixels",
    "packed_window_attention",
    "project_points",
    "projection_matrix",
    "rodrigues_matrix",
    "rodrigues_vector",
    "rotation_conversion",
    "simcc_decode",
    "swin_block_plain",
    "swin_gemm",
    "triangulate_dlt",
    "triangulate_nview",
    "triangulate_points",
    "triangulate_top2",
    "undistort_points",
]

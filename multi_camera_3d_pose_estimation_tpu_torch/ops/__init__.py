"""Batched geometry, decode and kernel ops of the port (torch)."""

from .bottleneck import fused_bottleneck_block, fused_stage1_chain, make_fused_stage1
from .fused_decode import fused_heatmap_decode
from .geometry import projection_matrix
from .heatmap_decode import heatmap_argmax_decode
from .moments import heatmap_moments
from .swin_block import fused_swin_block, swin_block_plain, swin_gemm
from .triangulation import triangulate_dlt, triangulate_top2
from .undistort import normalize_pixels, undistort_points
from .window_attention import fused_window_attention, packed_window_attention

__all__ = [
    "fused_bottleneck_block",
    "fused_heatmap_decode",
    "fused_stage1_chain",
    "fused_swin_block",
    "fused_window_attention",
    "heatmap_argmax_decode",
    "heatmap_moments",
    "make_fused_stage1",
    "normalize_pixels",
    "packed_window_attention",
    "projection_matrix",
    "swin_block_plain",
    "swin_gemm",
    "triangulate_dlt",
    "triangulate_top2",
    "undistort_points",
]

"""Visualization of the port: 3D pose / heatmap-ellipse / 2D animations and the
live preview writer (host side, matplotlib; a copy of the JAX package's
``viz``)."""

from .plots import (
    calculate_plot_lims,
    visualize_3d,
    overlay_heatmap,
    heatmap_animation,
    create_heatmap_animation,
    interactive_3d_pose_animation,
    visualize_2d,
    overlay_trackpoints,
    animate_trackpoints,
    make_preview_writer,
)

__all__ = [
    "calculate_plot_lims",
    "visualize_3d",
    "overlay_heatmap",
    "heatmap_animation",
    "create_heatmap_animation",
    "interactive_3d_pose_animation",
    "visualize_2d",
    "overlay_trackpoints",
    "animate_trackpoints",
    "make_preview_writer",
]

"""Checkerboard generation + board-coordinate helpers.

A copy of the JAX package's ``calib/checkerboard.py`` (host numpy).

Parity with the reference's calibration-target tooling:
- `create_checkerboard_image` ↔ `create_black_white_grid`
  (setup_camera_configuration.py:216-245): r×c black/white squares of side
  ``k`` centred on a white canvas of the display's pixel dimensions, square
  side derived as floor(min(W/c, H/r)) − border.
- `checkerboard_square_size_cm` ↔ the ppmm physical-scale conversion
  (setup_camera_configuration.py:322-330).
- `board_object_points` builds the (rows·cols, 3) Z=0 lattice the
  calibration solvers consume (the implicit board frame OpenCV uses).
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "create_checkerboard_image",
    "checkerboard_square_size_cm",
    "board_object_points",
]


def create_checkerboard_image(
    rows: int,
    columns: int,
    display_width_px: int,
    display_height_px: int,
    border_px: int = 10,
):
    """(H, W) uint8 image (255 canvas, 0/255 squares) + square size px."""
    k = int(min(display_width_px / columns, display_height_px / rows)) - border_px
    if k <= 0:
        raise ValueError("display too small for requested checkerboard")
    board_h, board_w = rows * k, columns * k
    canvas = np.full((display_height_px, display_width_px), 255, np.uint8)
    y0 = (display_height_px - board_h) // 2
    x0 = (display_width_px - board_w) // 2
    ys = np.arange(board_h) // k
    xs = np.arange(board_w) // k
    pattern = ((ys[:, None] + xs[None, :]) % 2 == 0).astype(np.uint8) * 255
    canvas[y0 : y0 + board_h, x0 : x0 + board_w] = pattern
    return canvas, k


def checkerboard_square_size_cm(square_px: int, pixels_per_mm: float) -> float:
    """Physical square side in cm from display pixel density."""
    return square_px / pixels_per_mm / 10.0


def board_object_points(rows: int, columns: int, square_size: float = 1.0):
    """Inner-corner lattice (rows·columns, 3) on the Z=0 plane."""
    rr, cc = np.meshgrid(np.arange(rows), np.arange(columns), indexing="ij")
    pts = np.zeros((rows * columns, 3))
    pts[:, 0] = cc.reshape(-1) * square_size  # x fastest (row-major)
    pts[:, 1] = rr.reshape(-1) * square_size
    return pts

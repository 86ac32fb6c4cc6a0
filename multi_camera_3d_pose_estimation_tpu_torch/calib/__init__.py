"""Camera calibration (torch): Zhang intrinsics, stereo extrinsics, PnP by
Levenberg-Marquardt on ``device`` (the card unless the caller asks for the
CPU), in the corners' dtype (float64 from the configure helpers); with the
checkerboard tools, manual extrinsics, corner detection and verification
overlays on the host, as in the JAX package's ``calib/``.
"""

from .checkerboard import (board_object_points, checkerboard_square_size_cm,
                           create_checkerboard_image)
from .corners import find_checkerboard_corners, refine_corners_subpixel
from .homography import find_homography
from .intrinsic import calibrate_camera, extrinsics_from_homography, zhang_intrinsics_init
from .lm import levenberg_marquardt
from .manual import compute_extrinsic_from_measurements
from .pnp import solve_pnp
from .stereo import mean_rotation, stereo_calibrate
from .verify import (check_calibration, draw_world_axes, get_cam1_to_world_transforms,
                     get_world_space_origin)

__all__ = [
    "levenberg_marquardt",
    "find_homography",
    "calibrate_camera",
    "zhang_intrinsics_init",
    "extrinsics_from_homography",
    "solve_pnp",
    "stereo_calibrate",
    "mean_rotation",
    "compute_extrinsic_from_measurements",
    "create_checkerboard_image",
    "checkerboard_square_size_cm",
    "board_object_points",
    "find_checkerboard_corners",
    "refine_corners_subpixel",
    "draw_world_axes",
    "check_calibration",
    "get_world_space_origin",
    "get_cam1_to_world_transforms",
]

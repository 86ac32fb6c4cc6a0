"""Camera configuration: numbered config dirs, checkerboard, calibration.

Counterpart of the JAX package's ``cli/configure.py`` (the reference's
`setup_camera_configuration.configure_cameras`,
setup_camera_configuration.py:254-412), headless through injectable
sources:

- camera naming → `acquisition.select_webcam_names` (callback or defaults)
- frame capture → ``capture_source(camera_name) -> [images]`` /
  ``stereo_capture_source(name0, name1) -> [(img0, img1)]`` callables
  (`acquisition.LiveCaptureSource` wraps real cameras; tests and offline
  runs pass prerecorded images)
- per-image accept → corner detection success is the acceptance test

The solves run on ``device`` (the card unless the caller asks for the CPU)
in float64.  The artifacts are the JAX package's: numbered
``configurations/<n>/``, ``checkerboard.jpg``, per-camera intrinsic
``.dat`` (skipped when present, setup:341-354), ``rot_trans_<name>.dat``
per non-origin camera (skipped when present, setup:358-360), the origin
camera at R = I, T = 0 (setup:369-371), ``camera_names.pkl``.
"""

from __future__ import annotations

import os

import numpy as np

from ..calib import (
    board_object_points,
    calibrate_camera,
    checkerboard_square_size_cm,
    compute_extrinsic_from_measurements,
    create_checkerboard_image,
    find_checkerboard_corners,
    stereo_calibrate,
)
from ..io.camera_params import (
    read_camera_parameters,
    save_camera_intrinsics,
    save_extrinsic_calibration_parameters,
)
from ..io.config import load_config
from ..io.manifest import create_new_numbered_folder, save_camera_names

__all__ = ["configure_cameras", "calibrate_intrinsics_from_images",
           "calibrate_stereo_from_images"]


def calibrate_intrinsics_from_images(images, rows: int, columns: int,
                                     square_size: float = 1.0, device="cuda"):
    """Detect corners in calibration ``images`` and run Zhang+LM.

    Returns ``(rmse, K, dist, n_used)``; images without a detected board
    are skipped (the reference's per-image accept/skip, utils.py:180-184,
    decided by detection instead of a keypress).  The solve runs on
    ``device`` in float64.
    """
    obj = board_object_points(rows, columns, square_size)
    objs, imgs = [], []
    for image in images:
        found, corners = find_checkerboard_corners(image, rows, columns)
        if found:
            objs.append(obj)
            imgs.append(corners.astype(np.float64))
    if len(objs) < 3:
        raise RuntimeError(
            f"checkerboard detected in only {len(objs)} image(s); "
            f"need ≥3 for calibration"
        )
    rmse, K, dist, _rv, _tv = calibrate_camera(np.stack(objs), np.stack(imgs), device=device)
    return rmse, K, dist, len(objs)


def calibrate_stereo_from_images(image_pairs, K0, dist0, K1, dist1,
                                 rows: int, columns: int,
                                 square_size: float = 1.0, device="cuda"):
    """Stereo calibration from simultaneous image pairs on ``device`` in
    float64; returns ``(rmse, R, T)``.  Pairs where either view misses the
    board are dropped (reference per-frame detectability check,
    utils.py:300-316)."""
    obj = board_object_points(rows, columns, square_size)
    objs, i0, i1 = [], [], []
    for a, b in image_pairs:
        fa, ca = find_checkerboard_corners(a, rows, columns)
        fb, cb = find_checkerboard_corners(b, rows, columns)
        if fa and fb:
            objs.append(obj)
            i0.append(ca.astype(np.float64))
            i1.append(cb.astype(np.float64))
    if len(objs) < 3:
        raise RuntimeError(f"stereo board visible in only {len(objs)} pair(s)")
    return stereo_calibrate(
        np.stack(objs), np.stack(i0), np.stack(i1), K0, dist0, K1, dist1, device=device
    )


def configure_cameras(
    camera_names=None,
    calibration_settings_yaml: str | None = None,
    project_dir: str = ".",
    origin_camera: str | None = None,
    checkerboard_display_parameter_yaml: str | None = None,
    capture_source=None,
    stereo_capture_source=None,
    manual_measurements: dict | None = None,
    namer=None,
    device="cuda",
) -> int:
    """Create ``configurations/<n>`` and calibrate all cameras into it.

    - ``camera_names``: {device_index: name} or None to probe+name
      (`select_webcam_names`).
    - ``calibration_settings_yaml``: reference schema
      (examples/calibration_settings.yaml — checkerboard rows/columns, …).
    - ``capture_source(name) -> [images]``: mono calibration frames per
      camera; ``stereo_capture_source(origin_name, name) -> [(img0, img1)]``.
    - ``manual_measurements``: {name: (xyz, adjacent, opposite)} bypasses
      stereo capture with tape-measure extrinsics (setup:377).
    - ``device``: where the calibration solves run.

    Returns the configuration number.
    """
    settings = load_config(calibration_settings_yaml)
    rows = int(settings.get("checkerboard_rows", 6))
    columns = int(settings.get("checkerboard_columns", 9))
    square_cm = settings.get("checkerboard_box_size_scale", None)

    config_root = os.path.join(project_dir, "configurations")
    config_num = create_new_numbered_folder(config_root)
    config_dir = os.path.join(config_root, str(config_num))

    # Checkerboard target image sized to the display — reference YAML schema
    # (examples/checkerboard_display_parameters.yaml: r, c, boarder(sic),
    # height, width, width_mm).
    disp = load_config(checkerboard_display_parameter_yaml)
    if disp:
        disp_w = int(disp.get("width", 1920))
        disp_h = int(disp.get("height", 1080))
        img, k = create_checkerboard_image(
            int(disp.get("r", rows + 1)),
            int(disp.get("c", columns + 1)),
            disp_w,
            disp_h,
            border_px=int(disp.get("boarder", disp.get("border", 10))),
        )
        try:
            import cv2
        except ImportError:  # no cv2: no checkerboard.jpg
            cv2 = None
        if cv2 is not None:
            cv2.imwrite(os.path.join(config_dir, "checkerboard.jpg"), img)
        width_mm = disp.get("width_mm")
        if square_cm is None and width_mm:
            ppmm = disp_w / float(width_mm)
            square_cm = checkerboard_square_size_cm(k, ppmm)
    square_cm = float(square_cm or 1.0)

    if camera_names is None:
        cameras, origin_camera = select_webcam_names_or_default(
            project_dir, namer, origin_camera
        )
    else:
        cameras = dict(camera_names)
        if origin_camera is None:
            origin_camera = next(iter(cameras.values()))
        save_camera_names(cameras, origin_camera, project_dir)

    intr_dir = os.path.join(project_dir, "intrinsic_camera_parameters")
    intr = {}
    for name in cameras.values():
        dat = os.path.join(intr_dir, name + ".dat")
        if os.path.exists(dat):  # skip-if-exists (setup:341-354)
            K, dist = read_camera_parameters(name, params_dir=intr_dir)
        else:
            if capture_source is None:
                raise RuntimeError(
                    f"no intrinsics for '{name}' and no capture_source provided"
                )
            rmse, K, dist, n_used = calibrate_intrinsics_from_images(
                capture_source(name), rows, columns, square_cm, device=device
            )
            print(f"[{name}] intrinsic RMSE: {rmse:.4f} px ({n_used} views)")
            save_camera_intrinsics(K, dist, name, root_path=project_dir)
        intr[name] = (K, dist)

    extr_dir = os.path.join(config_dir, "extrinsic_camera_parameters")
    os.makedirs(extr_dir, exist_ok=True)
    # Origin camera: identity pose (setup:369-371).
    save_extrinsic_calibration_parameters(
        np.eye(3), np.zeros((3, 1)), origin_camera, root_dir=config_dir
    )
    for name in cameras.values():
        if name == origin_camera:
            continue
        dat = os.path.join(extr_dir, f"rot_trans_{name}.dat")
        if os.path.exists(dat):  # skip-if-exists (setup:358-360)
            continue
        if manual_measurements and name in manual_measurements:
            xyz, adj, opp = manual_measurements[name]
            R, T = compute_extrinsic_from_measurements(xyz, adj, opp)
        else:
            if stereo_capture_source is None:
                raise RuntimeError(
                    f"no extrinsics for '{name}': provide stereo_capture_source "
                    f"or manual_measurements"
                )
            K0, d0 = intr[origin_camera]
            K1, d1 = intr[name]
            rmse, R, T = calibrate_stereo_from_images(
                stereo_capture_source(origin_camera, name),
                K0, d0, K1, d1, rows, columns, square_cm, device=device,
            )
            print(f"[{origin_camera}→{name}] stereo RMSE: {rmse:.4f} px")
        save_extrinsic_calibration_parameters(R, T, name, root_dir=config_dir)

    return config_num


def select_webcam_names_or_default(project_dir, namer, origin_camera):
    """`acquisition.select_webcam_names` for the project (probes cv2 devices
    unless ``camera_names.pkl`` exists)."""
    from ..acquisition import select_webcam_names

    return select_webcam_names(project_dir, namer=namer, origin_camera=origin_camera)

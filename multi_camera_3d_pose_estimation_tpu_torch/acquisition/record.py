"""Generic multi-webcam recorder (v4l2/any cv2 backend).

A copy of the JAX package's ``acquisition/record.py``: the reference's
macOS-only QuickTime recording stack (record_from_webcams_with_quicktime.py)
as cv2.VideoCapture threads, one per device, started together, each
writing ``<recordings_folder>/<camera>.mov``, for any number of cameras.

Camera identification (`select_webcam_names`) keeps the reference's probe
of device indices 0..9 (setup_camera_configuration.py:34-106) with the
interactive naming step injected as a callback; the ``camera_names.pkl``
it writes is the JAX package's (`io.save_camera_names`).  cv2 is imported
where a camera is opened.
"""

from __future__ import annotations

import os
import threading
import time

from ..io.manifest import load_camera_names, save_camera_names

__all__ = ["record_from_cameras", "identify_cameras", "select_webcam_names"]


def identify_cameras(max_index: int = 10):
    """Probe device indices [0, max_index); return those that deliver frames."""
    import cv2

    working = []
    for idx in range(max_index):
        cap = cv2.VideoCapture(idx)
        if cap.isOpened():
            ok, _ = cap.read()
            if ok:
                working.append(idx)
        cap.release()
    return working


def select_webcam_names(
    save_dir: str,
    namer=None,
    origin_camera: str | None = None,
    max_index: int = 10,
):
    """Map device indices to user names; persist ``camera_names.pkl``.

    - Loads the existing pickle if present (reference skip-if-exists
      behaviour, setup_camera_configuration.py:38-40).
    - ``namer(device_index, probe_frame) -> name`` supplies names (the
      reference's interactive prompt); default names are ``camera<i>``.
    Returns ``(cameras: {index: name}, origin_camera: name)``.
    """
    pkl_dir = os.path.join(save_dir, "extrinsic_camera_parameters")
    pkl = os.path.join(pkl_dir, "camera_names.pkl")
    if os.path.exists(pkl):
        return load_camera_names(pkl_dir)

    import cv2

    cameras = {}
    for idx in identify_cameras(max_index):
        frame = None
        cap = cv2.VideoCapture(idx)
        if cap.isOpened():
            ok, frame = cap.read()
            frame = frame if ok else None
        cap.release()
        name = namer(idx, frame) if namer is not None else f"camera{idx}"
        if name:
            cameras[idx] = name
    if not cameras:
        raise RuntimeError("no working cameras found")
    if origin_camera is None:
        origin_camera = next(iter(cameras.values()))
    save_camera_names(cameras, origin_camera, save_dir)
    return cameras, origin_camera


def _capture_one(device_index: int, save_path: str, seconds: float,
                 fps: float, barrier: threading.Barrier, errors: list):
    import cv2

    cap = cv2.VideoCapture(device_index)
    if not cap.isOpened():
        errors.append(f"camera {device_index}: cannot open")
        barrier.wait()
        return
    w = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)) or 640
    h = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)) or 480
    writer = cv2.VideoWriter(save_path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    barrier.wait()  # start all cameras together
    t_end = time.monotonic() + seconds
    while time.monotonic() < t_end:
        ok, frame = cap.read()
        if not ok:
            break
        writer.write(frame)
    writer.release()
    cap.release()


def record_from_cameras(
    recordings_folder: str,
    camera_names: dict[int, str],
    recording_time: float = 10.0,
    fps: float = 30.0,
):
    """Record all cameras simultaneously; returns per-camera save paths.

    Interface parity with `record_from_cameras`
    (record_from_webcams_with_quicktime.py:33-46): outputs
    ``<recordings_folder>/<name>.mov`` per camera.
    """
    os.makedirs(recordings_folder, exist_ok=True)
    save_paths = {
        idx: os.path.join(recordings_folder, f"{name}.mov")
        for idx, name in camera_names.items()
    }
    barrier = threading.Barrier(len(camera_names))
    errors: list[str] = []
    threads = [
        threading.Thread(
            target=_capture_one,
            args=(idx, save_paths[idx], recording_time, fps, barrier, errors),
        )
        for idx in camera_names
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise RuntimeError("; ".join(errors))
    return [save_paths[idx] for idx in camera_names]

"""Live capture sources for calibration and sync on a real rig.

A copy of the JAX package's ``acquisition/live.py``: the reference's
interactive capture loops (`save_frames_single_camera` utils.py:59-127,
`save_frames_two_cams` utils.py:256-342, and the ±5-frame sync pick
`display_and_select_frame` synchronize_videos.py:142-193) as the callables
`cli.configure.configure_cameras` takes (``capture_source(name) ->
[images]``).

- ``capture_factory`` is injectable (default cv2.VideoCapture, imported
  then), so the logic is testable without hardware;
- preview windows open only when a display exists (`_has_display`) and
  ``show=True``;
- per-frame checkerboard gating and the capture cooldown follow the
  reference (cooldown utils.py:79-106; detectability utils.py:300-320).
"""

from __future__ import annotations

import os
import time

import numpy as np

__all__ = [
    "LiveCaptureSource",
    "LiveStereoCaptureSource",
    "live_sync_frame_picker",
]


def _has_display() -> bool:
    return bool(os.environ.get("DISPLAY") or os.environ.get("WAYLAND_DISPLAY")
                or os.name == "nt" or os.uname().sysname == "Darwin")


def _open(capture_factory, device):
    cap = capture_factory(device)
    opened = cap.isOpened() if hasattr(cap, "isOpened") else True
    if not opened:
        raise RuntimeError(f"cannot open camera device {device!r}")
    return cap


class LiveCaptureSource:
    """``capture_source`` for `cli.configure.configure_cameras`.

    Calling the instance with a camera name grabs ``n_frames`` frames from
    its device, one every ``cooldown_s`` seconds (reference utils.py:79-106
    capture cadence), optionally keeping only frames where the
    checkerboard is detectable (reference accept/skip loop,
    utils.py:180-184, automated).
    """

    def __init__(
        self,
        device_map: dict[str, int],
        n_frames: int = 12,
        cooldown_s: float = 1.0,
        rows: int | None = None,
        columns: int | None = None,
        require_checkerboard: bool = False,
        show: bool = False,
        capture_factory=None,
        max_attempts_factor: int = 10,
    ):
        if capture_factory is None:
            import cv2

            capture_factory = cv2.VideoCapture
        self.device_map = dict(device_map)
        self.n_frames = int(n_frames)
        self.cooldown_s = float(cooldown_s)
        self.rows, self.columns = rows, columns
        self.require_checkerboard = bool(require_checkerboard)
        self.show = bool(show) and _has_display()
        self.capture_factory = capture_factory
        self.max_attempts = max_attempts_factor * self.n_frames

    def _detectable(self, frame) -> bool:
        if not self.require_checkerboard:
            return True
        from ..calib.corners import find_checkerboard_corners

        ok, _ = find_checkerboard_corners(frame, self.rows, self.columns,
                                          subpix=False)
        return bool(ok)

    def __call__(self, camera_name: str):
        device = self.device_map[camera_name]
        cap = _open(self.capture_factory, device)
        frames, attempts = [], 0
        last_keep = 0.0
        try:
            while len(frames) < self.n_frames and attempts < self.max_attempts:
                ok, frame = cap.read()
                if not ok:
                    break
                if self.show:
                    import cv2

                    cv2.imshow(f"calibration: {camera_name}", frame)
                    cv2.waitKey(1)
                now = time.monotonic()
                if now - last_keep < self.cooldown_s:
                    # Cooldown-skipped reads don't consume the attempt
                    # budget: a real camera streams ~30 fps, so counting
                    # every read would burn ~30·cooldown_s attempts per
                    # kept frame and exhaust max_attempts on hardware.
                    continue
                attempts += 1
                if self._detectable(frame):
                    frames.append(np.asarray(frame))
                    last_keep = now
        finally:
            cap.release()
            if self.show:
                import cv2

                cv2.destroyAllWindows()
        if len(frames) < self.n_frames:
            raise RuntimeError(
                f"camera '{camera_name}': captured {len(frames)}/"
                f"{self.n_frames} usable frames in {attempts} attempts"
            )
        return frames


class LiveStereoCaptureSource:
    """``stereo_capture_source``: paired simultaneous frames from 2 devices.

    Mirrors `save_frames_two_cams` (utils.py:256-342): grab both cameras
    back-to-back each tick and keep the pair only when the checkerboard is
    detectable in BOTH views (reference per-frame detectability check).
    """

    def __init__(
        self,
        device_map: dict[str, int],
        rows: int,
        columns: int,
        n_pairs: int = 12,
        cooldown_s: float = 1.0,
        require_checkerboard: bool = True,
        show: bool = False,
        capture_factory=None,
        max_attempts_factor: int = 10,
    ):
        if capture_factory is None:
            import cv2

            capture_factory = cv2.VideoCapture
        self.device_map = dict(device_map)
        self.rows, self.columns = int(rows), int(columns)
        self.n_pairs = int(n_pairs)
        self.cooldown_s = float(cooldown_s)
        self.require_checkerboard = bool(require_checkerboard)
        self.show = bool(show) and _has_display()
        self.capture_factory = capture_factory
        self.max_attempts = max_attempts_factor * self.n_pairs

    def _both_detectable(self, f0, f1) -> bool:
        if not self.require_checkerboard:
            return True
        from ..calib.corners import find_checkerboard_corners

        ok0, _ = find_checkerboard_corners(f0, self.rows, self.columns, subpix=False)
        ok1, _ = find_checkerboard_corners(f1, self.rows, self.columns, subpix=False)
        return bool(ok0) and bool(ok1)

    def __call__(self, name0: str, name1: str):
        cap0 = _open(self.capture_factory, self.device_map[name0])
        cap1 = _open(self.capture_factory, self.device_map[name1])
        pairs, attempts = [], 0
        last_keep = 0.0
        try:
            while len(pairs) < self.n_pairs and attempts < self.max_attempts:
                ok0, f0 = cap0.read()
                ok1, f1 = cap1.read()
                if not (ok0 and ok1):
                    break
                if self.show:
                    import cv2

                    cv2.imshow(f"stereo: {name0}", f0)
                    cv2.imshow(f"stereo: {name1}", f1)
                    cv2.waitKey(1)
                now = time.monotonic()
                if now - last_keep < self.cooldown_s:
                    # See LiveCaptureSource: only cooldown-eligible pairs
                    # consume the attempt budget.
                    continue
                attempts += 1
                if self._both_detectable(f0, f1):
                    pairs.append((np.asarray(f0), np.asarray(f1)))
                    last_keep = now
        finally:
            cap0.release()
            cap1.release()
            if self.show:
                import cv2

                cv2.destroyAllWindows()
        if len(pairs) < self.n_pairs:
            raise RuntimeError(
                f"stereo '{name0}'+'{name1}': captured {len(pairs)}/"
                f"{self.n_pairs} usable pairs in {attempts} attempts"
            )
        return pairs


def live_sync_frame_picker(video_paths, sync_indices, window: int = 5,
                           wait_ms: int = 0):
    """Interactive ±``window``-frame sync adjustment (reference
    display_and_select_frame, synchronize_videos.py:142-193).

    Shows each camera's candidate grid in a cv2 window; the operator
    presses a digit ``0``-``9`` or a letter ``a``-``z`` (``a`` = column
    10, ``b`` = 11, …) to pick the column — the default ``window=5``
    grid has 11 columns, one more than the digit keys cover (Enter keeps
    the audio-derived index).  Headless environments get the saved
    inspection grid instead (`sync.build_sync_inspection_grid`) and the
    indices pass through unchanged.  Returns the adjusted index list.
    """
    from ..sync.videos import build_sync_inspection_grid

    frame_range = tuple(range(-window, window + 1))
    if not _has_display():
        # Headless: keep the audio-derived picks (the saved inspection
        # grid path already covers offline review, sync.videos).
        return list(sync_indices)

    import cv2

    adjusted = []
    for path, idx in zip(video_paths, sync_indices):
        img = build_sync_inspection_grid([path], [idx], frame_range=frame_range)
        cv2.imshow(f"pick sync frame: {os.path.basename(path)}", img)
        key = cv2.waitKey(wait_ms) & 0xFF
        cv2.destroyAllWindows()
        col = None
        if ord("0") <= key <= ord("9"):
            col = key - ord("0")
        elif ord("a") <= key <= ord("z"):
            col = 10 + key - ord("a")
        if col is not None and col < len(frame_range):
            adjusted.append(idx + frame_range[col])
        else:
            adjusted.append(idx)
    return adjusted

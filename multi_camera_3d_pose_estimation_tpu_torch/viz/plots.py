"""Matplotlib animations: 3D pose, heatmap ellipses, 2D skeletons, and the
live preview's JPEG writer (host side).

A copy of the JAX package's ``viz/plots.py`` (the reference's
plot_utils.py), drawing the same figures from the same inputs; arrays may
be numpy arrays or tensors on any device (converted by
``.detach().cpu().numpy()``).  Videos are read through the port's
`io.frames`.

- `calculate_plot_lims`: robust 5/95-percentile ± IQR-margin axis limits,
  homogenized across axes (plot_utils.py:35-55).
- `visualize_3d`: synchronized orthographic views ('xy'/'zy'/'zx' via
  view_init) of the skeleton over time, optional camera-frame strips and
  time-series panels; the y-axis is flipped like the reference
  (plot_utils.py:98).
- `heatmap_animation` / `overlay_heatmap`: per-camera Gaussian-ellipse
  overlays (eigendecomposition of the 2×2 covariance → width/height/angle,
  plot_utils.py:308-353).
- `interactive_3d_pose_animation`: slider-controlled az/el/roll viewer
  (plot_utils.py:413-503); headless-safe (sliders no-op under Agg).
- `visualize_2d` / `animate_trackpoints`: scatter + skeleton per camera.
- `make_preview_writer`: the ``on_block`` hook of
  `cli.run_pipeline_on_blocks` that draws 2D skeletons with cv2 and shows
  or writes them while the pipeline runs.

NaN joints vanish from the plots (matplotlib drops non-finite points),
which is the reference's missing-data display behaviour.  matplotlib is
imported by this package only; nothing else of the port imports it.
"""

from __future__ import annotations

import numpy as np
import torch

import matplotlib

matplotlib.use("Agg")  # headless-safe default; callers may switch backends
import matplotlib.pyplot as plt
from matplotlib.animation import FuncAnimation
from matplotlib.patches import Ellipse

from ..utils.skeleton import BODYPARTS

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

_VIEW_ANGLES = {"xy": (90, -90), "zy": (0, -90), "zx": (0, 0)}


def _np(x):
    """A numpy array of ``x`` (a tensor is detached and moved to the host)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def calculate_plot_lims(dat, homogeneous_lims=True, axis=(0,), iqr_margin=0.5):
    """Per-column (lo, hi) plot limits: 5/95 percentiles ± margin·IQR,
    optionally widened so all columns share the same span."""
    dat = np.asarray(_np(dat), np.float64)
    p95 = np.nanpercentile(dat, 95, axis=axis)
    p5 = np.nanpercentile(dat, 5, axis=axis)
    iqr = np.nanpercentile(dat, 75, axis=axis) - np.nanpercentile(dat, 25, axis=axis)
    p5, p95, iqr = np.atleast_1d(p5), np.atleast_1d(p95), np.atleast_1d(iqr)
    lims = [(lo - iqr_margin * q, hi + iqr_margin * q) for lo, hi, q in zip(p5, p95, iqr)]
    if homogeneous_lims:
        spans = [hi - lo for lo, hi in lims]
        pads = [max(spans) - s for s in spans]
        lims = [(lo - p / 2, hi + p / 2) for (lo, hi), p in zip(lims, pads)]
    return lims


def _skeleton_segments(pose, body_parts):
    """pose (J, 3) + {part: [[a, b], ...]} -> list of (2, 3) segments."""
    segs = []
    for edges in body_parts.values():
        for a, b in edges:
            segs.append(np.stack([pose[a], pose[b]]))
    return segs


def visualize_3d(
    p3ds,
    body_parts=None,
    additional_metrics=(),
    additional_metric_names=(),
    point_labels=(),
    recording_paths=None,
    n_frames=None,
    camera_indices=None,
    starting_point=0,
    starting_frame=None,
    plane_views=("xy", "zy", "zx"),
    interval=100,
):
    """Animated orthographic 3D views of the trajectory; returns the
    FuncAnimation (caller saves with ``ani.save(path, fps=...)``)."""
    p3ds = np.array(_np(p3ds), np.float64, copy=True)
    p3ds[:, :, 1] *= -1  # y-flip (reference plot_utils.py:98)
    body_parts = body_parts or BODYPARTS["coco"]
    if starting_frame is None:
        starting_frame = starting_point
    if n_frames is None:
        n_frames = len(p3ds) - starting_frame
    n_views = len(plane_views)
    n_extra = len(additional_metrics)

    # Optional camera-frame strips (reference plot_utils.py:105-143): one
    # video panel per selected camera below the 3D views.
    readers = []
    if recording_paths:
        from ..io.frames import VideoReader

        paths = (
            list(recording_paths.values())
            if isinstance(recording_paths, dict)
            else list(recording_paths)
        )
        if camera_indices is None:
            camera_indices = list(range(min(2, len(paths))))
        for c in camera_indices:
            r = VideoReader(paths[c], bgr=False)
            for _ in range(starting_frame):  # skip to the animation start
                if r.read_block(1).shape[0] == 0:
                    break
            readers.append(r)

    n_rows = 1 + (n_extra > 0) + (len(readers) > 0)
    fig = plt.figure(figsize=(4 * n_views, 4 * n_rows))
    axes3d = [
        fig.add_subplot(n_rows, n_views, i + 1, projection="3d")
        for i in range(n_views)
    ]
    extra_axes = [
        fig.add_subplot(n_rows, max(n_extra, 1), max(n_extra, 1) + i + 1)
        for i in range(n_extra)
    ]
    cam_axes = [
        fig.add_subplot(
            n_rows, max(len(readers), 1),
            (n_rows - 1) * max(len(readers), 1) + i + 1,
        )
        for i in range(len(readers))
    ]
    lims = calculate_plot_lims(p3ds.reshape(-1, 3), axis=(0,))
    for ax, view in zip(axes3d, plane_views):
        elev, azim = _VIEW_ANGLES.get(view, (30, -60))
        ax.view_init(elev=elev, azim=azim)
        ax.set_xlim(*lims[0])
        ax.set_ylim(*lims[1])
        ax.set_zlim(*lims[2])
        ax.set_title(view)

    names = list(additional_metric_names) + [
        f"metric_{i}" for i in range(len(additional_metric_names), n_extra)
    ]

    def update(t):
        artists = []
        for ax, view in zip(axes3d, plane_views):
            for ln in list(ax.lines):
                ln.remove()
            pose = p3ds[starting_point + t]
            for seg in _skeleton_segments(pose, body_parts):
                (ln,) = ax.plot(seg[:, 0], seg[:, 1], seg[:, 2], "b-", lw=1.5)
                artists.append(ln)
            (pts,) = ax.plot(
                pose[:, 0], pose[:, 1], pose[:, 2], "r.", markersize=3
            )
            artists.append(pts)
        for ax, metric, name in zip(extra_axes, additional_metrics, names):
            ax.clear()
            m = _np(metric)
            ax.plot(m[: starting_point + t + 1])
            ax.set_title(name)
        for ax, reader in zip(cam_axes, readers):
            block = reader.read_block(1)
            if block.shape[0]:
                ax.clear()
                ax.imshow(block[0])
                ax.axis("off")
        return artists

    ani = FuncAnimation(fig, update, frames=n_frames, interval=interval, blit=False)
    return ani


def overlay_heatmap(ax, frame, heatmaps, n_points=None):
    """Draw per-joint Gaussian ellipses (1σ contour ×2) over a frame.

    ``heatmaps``: (K, 6) rows [mean_x, mean_y, var_x, cov, cov, var_y].
    Invalid (non-PD) covariances are skipped, like the reference
    (plot_utils.py:330-345).  Returns the artist list.
    """
    frame = _np(frame)
    ax.imshow(frame[..., ::-1] if frame.ndim == 3 else frame)
    ax.axis("off")
    heatmaps = _np(heatmaps)
    n_points = n_points or heatmaps.shape[0]
    artists = []
    for i in range(n_points):
        mean = heatmaps[i, :2]
        cov = heatmaps[i, 2:].reshape(2, 2)
        if not np.all(np.isfinite(cov)) or np.linalg.det(cov) <= 0:
            continue
        eigvals, eigvecs = np.linalg.eigh(cov)
        if np.any(eigvals <= 0):
            continue
        angle = np.degrees(np.arctan2(eigvecs[1, 0], eigvecs[0, 0]))
        width, height = 2 * np.sqrt(eigvals)
        ell = Ellipse(mean, width, height, angle=angle, edgecolor="red",
                      fill=False, lw=0.5)
        ax.add_patch(ell)
        artists.append(ell)
        artists.extend(ax.plot(mean[0], mean[1], "ro", markersize=2))
    return artists


def heatmap_animation(heatmaps, recording_paths, starting_frame=0,
                      n_frames=None, interval=100):
    """Per-camera Gaussian-ellipse overlay animation over video frames.

    ``heatmaps``: (T, C, K, 6); ``recording_paths``: C video paths.
    """
    from ..io.frames import frame_generator

    heatmaps = _np(heatmaps)
    T, C = heatmaps.shape[0], heatmaps.shape[1]
    if n_frames is None:
        n_frames = T - starting_frame

    gen = frame_generator(recording_paths)
    for _ in range(starting_frame):
        next(gen)

    fig, axes = plt.subplots(1, C, figsize=(6 * C, 5))
    axes = np.atleast_1d(axes)

    def frames():
        for t in range(n_frames):
            try:
                yield t, next(gen)
            except StopIteration:
                return

    def update(args):
        t, cam_frames = args
        artists = []
        for c, (ax, frame) in enumerate(zip(axes, cam_frames)):
            ax.clear()
            artists += overlay_heatmap(ax, frame, heatmaps[starting_frame + t, c])
        return artists

    return FuncAnimation(fig, update, frames=frames, interval=interval,
                         blit=False, save_count=n_frames)


def create_heatmap_animation(heatmaps, frames, out_path=None, fps=10,
                             interval=100):
    """Ellipse animation from in-memory frames (T lists of C images) —
    reference `create_heatmap_animation` (plot_utils.py:238-304)."""
    heatmaps = _np(heatmaps)
    C = heatmaps.shape[1]
    fig, axes = plt.subplots(1, C, figsize=(6 * C, 5))
    axes = np.atleast_1d(axes)

    def update(t):
        artists = []
        for c, ax in enumerate(axes):
            ax.clear()
            artists += overlay_heatmap(ax, frames[t][c], heatmaps[t, c])
        return artists

    ani = FuncAnimation(fig, update, frames=min(len(frames), heatmaps.shape[0]),
                        interval=interval, blit=False)
    if out_path:
        ani.save(out_path, fps=fps)
    return ani


def interactive_3d_pose_animation(p3ds, body_parts=None, interval=100):
    """Skeleton animation with azim/elev/roll sliders (no-ops headless)."""
    from matplotlib.widgets import Slider

    p3ds = np.array(_np(p3ds), np.float64, copy=True)
    p3ds[:, :, 1] *= -1
    body_parts = body_parts or BODYPARTS["coco"]
    fig = plt.figure(figsize=(7, 7))
    ax = fig.add_subplot(projection="3d")
    lims = calculate_plot_lims(p3ds.reshape(-1, 3), axis=(0,))
    sliders = []
    for i, (name, lo, hi, init) in enumerate(
        [("azim", -180, 180, -60), ("elev", -90, 90, 30), ("roll", -180, 180, 0)]
    ):
        sax = fig.add_axes([0.15, 0.02 + 0.03 * i, 0.6, 0.02])
        sliders.append(Slider(sax, name, lo, hi, valinit=init))

    def update(t):
        for ln in list(ax.lines):
            ln.remove()
        try:
            ax.view_init(
                elev=sliders[1].val, azim=sliders[0].val, roll=sliders[2].val
            )
        except TypeError:  # older matplotlib without roll
            ax.view_init(elev=sliders[1].val, azim=sliders[0].val)
        ax.set_xlim(*lims[0])
        ax.set_ylim(*lims[1])
        ax.set_zlim(*lims[2])
        pose = p3ds[t]
        arts = []
        for seg in _skeleton_segments(pose, body_parts):
            arts += ax.plot(seg[:, 0], seg[:, 1], seg[:, 2], "b-", lw=1.5)
        arts += ax.plot(pose[:, 0], pose[:, 1], pose[:, 2], "r.", markersize=3)
        return arts

    return FuncAnimation(fig, update, frames=len(p3ds), interval=interval,
                         blit=False)


def visualize_2d(kpts_2d, connectivity=None, camera_indices=None, interval=100):
    """Animated per-camera 2D skeletons.

    ``kpts_2d``: (T, K, 3, C) reference wire layout (x, y, conf, camera-last).
    """
    from ..utils.skeleton import CONNECTIVITY_DICT

    kpts_2d = _np(kpts_2d)
    T, K, _, C = kpts_2d.shape
    connectivity = connectivity or CONNECTIVITY_DICT["coco"]
    camera_indices = camera_indices if camera_indices is not None else list(range(C))

    fig, axes = plt.subplots(1, len(camera_indices), figsize=(5 * len(camera_indices), 5))
    axes = np.atleast_1d(axes)
    lims = [
        calculate_plot_lims(kpts_2d[:, :, :2, c].reshape(-1, 2), axis=(0,))
        for c in camera_indices
    ]

    def update(t):
        arts = []
        for ax, c, lim in zip(axes, camera_indices, lims):
            ax.clear()
            ax.set_xlim(*lim[0])
            ax.set_ylim(lim[1][1], lim[1][0])  # image y grows downward
            pts = kpts_2d[t, :, :2, c]
            arts += ax.plot(pts[:, 0], pts[:, 1], "r.", markersize=3)
            for a, b in connectivity:
                arts += ax.plot(
                    [pts[a, 0], pts[b, 0]], [pts[a, 1], pts[b, 1]], "b-", lw=1
                )
            ax.set_title(f"camera {c}")
        return arts

    return FuncAnimation(fig, update, frames=T, interval=interval, blit=False)


def overlay_trackpoints(ax, frame, points, labels=()):
    """Labelled point overlay on one frame (plot_utils.py:514-534)."""
    ax.imshow(_np(frame)[..., ::-1])
    ax.axis("off")
    arts = []
    points = _np(points)
    for i, (x, y) in enumerate(points[:, :2]):
        if not (np.isfinite(x) and np.isfinite(y)):
            continue
        arts += ax.plot(x, y, "go", markersize=3)
        if i < len(labels) and labels[i]:
            arts.append(ax.annotate(labels[i], (x, y), fontsize=6, color="yellow"))
    return arts


def animate_trackpoints(trackpoints, recording_path, labels=(), interval=100):
    """Labelled trackpoint animation over one camera's video."""
    from ..io.frames import VideoReader

    trackpoints = _np(trackpoints)
    reader = VideoReader(recording_path, bgr=True)
    fig, ax = plt.subplots(figsize=(7, 5))

    def frames():
        for t in range(trackpoints.shape[0]):
            block = reader.read_block(1)
            if block.shape[0] == 0:
                return
            yield t, block[0]

    def update(args):
        t, frame = args
        ax.clear()
        return overlay_trackpoints(ax, frame, trackpoints[t], labels)

    return FuncAnimation(fig, update, frames=frames, interval=interval,
                         blit=False, save_count=trackpoints.shape[0])


def make_preview_writer(save_dir=None, show=False, connectivity=None,
                        every: int = 8, conf_threshold: float = 0.3):
    """Build an `on_block` live-preview hook for `run_pipeline_on_videos`.

    The reference displays a cv.imshow keypoint overlay while inferring
    (pose_estimation.py:125,145-149); this is the headless-first
    equivalent: every ``every``-th frame gets its 2D skeleton drawn per
    camera (cv2 linework, cheap), then is shown in a window
    (``show=True``, the reference behavior) and/or written as
    ``preview_<frame>_cam<c>.jpg`` under ``save_dir``.  Runs at DRAIN
    time on the host thread, so it never stalls device dispatch.
    """
    import cv2

    from ..utils.skeleton import CONNECTIVITY_DICT

    edges = connectivity or CONNECTIVITY_DICT["coco"]
    if save_dir:
        import os

        os.makedirs(save_dir, exist_ok=True)

    def draw(frame, kp_cam):
        img = np.array(frame, copy=True)  # cv2 draws in place; decoder blocks are readonly
        # cv2 wants plain-int points; clip so a wild keypoint can't
        # overflow OpenCV's fixed-point line rasterizer.
        pts = np.clip(np.nan_to_num(kp_cam[:, :2], nan=-1e6), -32000, 32000)
        ipts = [(int(x), int(y)) for x, y in pts]
        ok = np.isfinite(kp_cam[:, :2]).all(axis=-1) & (
            kp_cam[:, 2] > conf_threshold)
        for a, b in edges:
            if ok[a] and ok[b]:
                cv2.line(img, ipts[a], ipts[b], (0, 255, 0), 1)
        for j in np.where(ok)[0]:
            cv2.circle(img, ipts[j], 2, (0, 0, 255), -1)
        return img

    def on_block(frames_block, kpts_2d_block, frame_offset):
        # frames (n, C, H, W, 3) uint8 BGR; kpts (n, K, 3, C) wire layout.
        frames_block, kpts_2d_block = _np(frames_block), _np(kpts_2d_block)
        n, C = frames_block.shape[0], frames_block.shape[1]
        for i in range(0, n, max(int(every), 1)):
            for c in range(C):
                img = draw(frames_block[i, c],
                           np.moveaxis(kpts_2d_block[i], -1, 0)[c])
                if save_dir:
                    import os

                    cv2.imwrite(os.path.join(
                        save_dir, f"preview_{frame_offset + i:06d}_cam{c}.jpg"
                    ), img)
                if show:  # pragma: no cover - needs a display
                    cv2.imshow(f"camera {c}", img)
        if show:  # pragma: no cover
            cv2.waitKey(1)

    return on_block

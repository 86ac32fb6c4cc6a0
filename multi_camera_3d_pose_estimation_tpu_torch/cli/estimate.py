"""End-to-end estimation: synchronized videos -> kpts_2d / heatmaps_2d / kpts_3d.

Counterpart of the JAX package's ``cli/estimate.py``, with its arguments,
defaults, file names and layouts: ``kpts_2d.npy`` (T, 17, 3, C),
``heatmaps_2d.npy`` (T, C, 17, 6), ``kpts_3d.npy`` (T, 17, 3); existing 2D
artifacts are reused (3D recomputed by triangulation alone when
``kpts_3d.npy`` is missing) unless ``overwrite=True``.

With a mesh (`parallel.make_mesh`) every rank decodes and stages the same
blocks, the pipeline shards each block's frames over the ranks and gathers
the results on every rank, the mesh's first rank writes the artifacts and
the others wait for them.

On the card three things overlap: the decode thread fills host blocks
(`io.BatchedFramePipeline`), `io.stage_blocks` copies the next block
through pinned memory on a copy stream while the card runs the current
one, and each block's results are copied back to pinned host memory behind
its compute and read ``inflight`` blocks later, by an event: no
``torch.cuda.synchronize()`` per block.
"""

from __future__ import annotations

import os
from collections import deque

import numpy as np
import torch

from ..io.camera_params import get_params_from_name, stack_camera_params
from ..io.frames import BatchedFramePipeline
from ..io.manifest import load_camera_names
from ..models.registry import build_detector, build_estimator
from ..ops.triangulation import get_pose_3d
from ..parallel.mesh import check_mesh, is_first_rank, mesh_barrier
from ..parallel.pipeline import ShardedPosePipeline
from ..utils.profiling import span

__all__ = ["estimate_pose_from_video", "run_pipeline_on_videos", "run_pipeline_on_blocks",
           "build_estimate_pipeline"]

_KEYS = ("kpts_2d", "heatmaps_2d", "kpts_3d")


def _fetch(out: dict, n_valid: int):
    """Start copying a block's valid results to the host: on the card, into
    pinned tensors ``non_blocking`` behind the block's compute, with an
    event that marks the copies done (None on the CPU)."""
    valid = {k: out[k][:n_valid] for k in _KEYS}
    if not valid["kpts_2d"].is_cuda:
        return valid, None
    host = {k: torch.empty(v.shape, dtype=v.dtype, pin_memory=True) for k, v in valid.items()}
    for k, v in valid.items():
        host[k].copy_(v, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return host, event


def run_pipeline_on_blocks(pipeline: ShardedPosePipeline, blocks, progress: bool = True,
                           inflight: int = 2, on_block=None):
    """Run ``(block, n_valid)`` items (device or host (B, C, H, W, 3) uint8
    blocks) through ``pipeline``; returns the stacked (kpts_2d, heatmaps_2d,
    kpts_3d) numpy arrays of the valid frames.

    Block N's results are read ``inflight`` blocks after its dispatch.
    ``on_block(frames_block, kpts_2d_block, frame_offset)`` is called when a
    block is read, with the block's valid frames and (n_valid, K, 3, C)
    keypoints.  ``progress`` shows a tqdm bar where tqdm is installed.

    Spans (`utils.profiling.span`; ``block``: the block's index in
    ``blocks``, as `io.stage_blocks` counts it): ``mc3d.estimate.dispatch``
    around ``pipeline.run`` and the start of the results' copy,
    ``mc3d.estimate.drain_wait`` while the host waits for a block's
    results, ``mc3d.estimate.drain_copy`` over their copy out and
    ``on_block``.
    """
    out = {k: [] for k in _KEYS}
    n_done = 0

    def drain(item):
        nonlocal n_done
        i, (host, event), n_valid, frames_block = item
        with span("mc3d.estimate.drain_wait", block=i):
            if event is not None:
                event.synchronize()
        with span("mc3d.estimate.drain_copy", block=i):
            for k in _KEYS:
                # A copy, so that the pinned buffer returns to the caching
                # host allocator: a new pinned allocation per block
                # (cudaHostAlloc) would stall the card.
                out[k].append(host[k].numpy().copy())
            if on_block is not None:
                on_block(frames_block[:n_valid], out["kpts_2d"][-1], n_done)
        n_done += n_valid

    iterator = blocks
    if progress:
        try:
            from tqdm import tqdm

            iterator = tqdm(blocks, desc="pose estimation", unit="block")
        except ImportError:
            pass
    pending: deque = deque()
    for i, (block, n_valid) in enumerate(iterator):
        # The frames are kept until the block is read only for ``on_block``.
        keep = block if on_block is not None else None
        with span("mc3d.estimate.dispatch", block=i):
            fetched = _fetch(pipeline.run(block), n_valid)
        pending.append((i, fetched, n_valid, keep))
        if len(pending) > max(int(inflight), 0):
            drain(pending.popleft())
    while pending:
        drain(pending.popleft())
    if not out["kpts_2d"]:
        raise RuntimeError("no frames to run: the block source was empty")
    return tuple(np.concatenate(out[k]) for k in _KEYS)


def run_pipeline_on_videos(pipeline: ShardedPosePipeline, video_paths, block_size: int = 64,
                           progress: bool = True, inflight: int = 2, on_block=None,
                           stage_blocks: bool = True):
    """Decode ``video_paths`` into blocks (`io.BatchedFramePipeline`, staged
    to the pipeline's device unless ``stage_blocks=False``) and run them
    through `run_pipeline_on_blocks`."""
    frames_src = BatchedFramePipeline(video_paths, block_size=block_size,
                                      device=pipeline.device, stage_to_device=stage_blocks)
    try:
        return run_pipeline_on_blocks(pipeline, frames_src, progress=progress,
                                      inflight=inflight, on_block=on_block)
    finally:
        frames_src.close()


def _load_camera_param_lists(camera_names, intrinsic_params_dir, extrinsic_params_dir,
                             project_dir):
    """Ordered [K, R, T, dist] per camera from the ``.dat`` files (names
    from ``camera_names.pkl`` when ``camera_names`` is None); a camera
    without extrinsics is the origin (R = I, T = 0)."""
    if camera_names is None:
        cameras, _origin = load_camera_names(extrinsic_params_dir)
        camera_names = [cameras[k] for k in sorted(cameras)]
    cam_lists = []
    for name in camera_names:
        _P, (K, R, T, dist) = get_params_from_name(
            name, intrinsic_params_dir=intrinsic_params_dir,
            extrinsic_params_dir=extrinsic_params_dir)
        if K is None:
            raise FileNotFoundError(f"missing intrinsics for camera '{name}' under {project_dir}")
        if R is None:
            R, T = np.eye(3), np.zeros(3)
        cam_lists.append([K, R, T, dist])
    return cam_lists


def _param_dirs(project_dir, intrinsic_params_dir, extrinsic_params_dir):
    return (intrinsic_params_dir or os.path.join(project_dir, "intrinsic_camera_parameters"),
            extrinsic_params_dir or os.path.join(project_dir, "extrinsic_camera_parameters"))


def build_estimate_pipeline(project_dir: str = "", camera_names=None,
                            pose_estimation_model: str = "coco_hrnet_w32",
                            checkpoint: str | None = None, detector_model: str = "full_frame",
                            detector_checkpoint: str | None = None,
                            detector_bbox_thr: float = 0.3, detector_select: str = "top1",
                            conf_threshold: float = 0.3, num_joints: int = 17,
                            estimator_kwargs: dict | None = None,
                            intrinsic_params_dir: str | None = None,
                            extrinsic_params_dir: str | None = None,
                            triangulation: str = "top2", mesh=None,
                            device="cuda") -> ShardedPosePipeline:
    """The pipeline `estimate_pose_from_video` runs: the project's cameras,
    the estimator (from ``checkpoint``, ``estimator_kwargs`` passed to
    `models.TopDownEstimator`), the person detector and the triangulation,
    on ``device``, over ``mesh`` where given."""
    intr, extr = _param_dirs(project_dir, intrinsic_params_dir, extrinsic_params_dir)
    cam_stack = stack_camera_params(_load_camera_param_lists(camera_names, intr, extr,
                                                             project_dir))
    estimator = build_estimator(pose_estimation_model, checkpoint=checkpoint,
                                num_joints=num_joints, device=device, **(estimator_kwargs or {}))
    detector = build_detector(detector_model, checkpoint=detector_checkpoint,
                              bbox_thr=detector_bbox_thr, select=detector_select, device=device)
    return ShardedPosePipeline(estimator, cam_stack, mesh=mesh, conf_threshold=conf_threshold,
                               detector=detector, triangulation=triangulation, device=device)


def estimate_pose_from_video(
    recording_paths,
    project_dir: str = "",
    camera_names=None,
    pose_estimation_model: str = "coco_hrnet_w32",
    checkpoint: str | None = None,
    detector_model: str = "full_frame",
    detector_checkpoint: str | None = None,
    detector_bbox_thr: float = 0.3,
    detector_select: str = "top1",
    save_dir: str | None = None,
    overwrite: bool = False,
    block_size: int = 64,
    conf_threshold: float = 0.3,
    mesh=None,
    num_joints: int = 17,
    estimator_kwargs: dict | None = None,
    intrinsic_params_dir: str | None = None,
    extrinsic_params_dir: str | None = None,
    live_preview_dir: str | None = None,
    live_preview_show: bool = False,
    triangulation: str = "top2",
    device="cuda",
):
    """Full 2D + 3D estimation over synchronized recordings, on ``device``.

    - ``camera_names``: ordered camera names matching ``recording_paths``;
      None loads ``camera_names.pkl`` from the extrinsic directory.
    - ``intrinsic_params_dir`` / ``extrinsic_params_dir`` override
      ``<project_dir>/{intrinsic,extrinsic}_camera_parameters``.
    - ``checkpoint`` / ``detector_checkpoint``: MMPose/MMDet ``.pth`` files
      (read through the strict name maps of `models.convert`) or the JAX
      package's ``.npz`` checkpoints; None draws random weights.
    - ``estimator_kwargs``: `models.TopDownEstimator` options, e.g.
      ``{"flip_test": True, "decode_mode": "dark"}``.  The kernels need no
      option: bf16 inference on the card runs them
      (`models.batchnorm.runs_kernels`).
    - ``triangulation``: "top2" or "nview".
    - ``mesh``: a mesh of `parallel.make_mesh`; every rank calls this with
      the same arguments and returns the same arrays (``block_size`` a
      multiple of the mesh size), and the mesh's first rank writes the
      files.  None runs on one device.
    - ``live_preview_dir`` / ``live_preview_show``: the reference's live
      2D overlay (pose_estimation.py:125,145-149), headless first: every
      8th frame of each camera with its skeleton drawn by cv2, written as
      ``preview_<frame>_cam<c>.jpg`` and/or shown in a window
      (`viz.make_preview_writer`, called as each block's results are read;
      with a mesh, by its first rank only).  Needs cv2 and matplotlib.

    Returns ``(kpts_2d, heatmaps_2d, kpts_3d)`` and writes the ``.npy``
    artifacts into ``save_dir`` (default: beside the recordings).
    """
    check_mesh(mesh, device)
    save_dir = save_dir or os.path.dirname(str(recording_paths[0]))
    k2_path, hm_path, k3_path = (os.path.join(save_dir, f"{k}.npy") for k in _KEYS)
    intr, extr = _param_dirs(project_dir, intrinsic_params_dir, extrinsic_params_dir)

    if not overwrite and os.path.exists(k2_path) and os.path.exists(hm_path):
        kpts_2d = np.load(k2_path)
        heatmaps = np.load(hm_path)
        if os.path.exists(k3_path):
            return kpts_2d, heatmaps, np.load(k3_path)
        # Keep the cached 2D keypoints; recompute 3D by triangulation alone:
        # no model is built and no video is read.
        cam_lists = _load_camera_param_lists(camera_names, intr, extr, project_dir)
        kpts_3d = get_pose_3d(kpts_2d, dict(enumerate(cam_lists)), method=triangulation,
                              device=device).cpu().numpy()
        _save(mesh, [(k3_path, kpts_3d)])
        return kpts_2d, heatmaps, kpts_3d

    pipeline = build_estimate_pipeline(
        project_dir, camera_names, pose_estimation_model, checkpoint=checkpoint,
        detector_model=detector_model, detector_checkpoint=detector_checkpoint,
        detector_bbox_thr=detector_bbox_thr, detector_select=detector_select,
        conf_threshold=conf_threshold, num_joints=num_joints, estimator_kwargs=estimator_kwargs,
        intrinsic_params_dir=intr, extrinsic_params_dir=extr, triangulation=triangulation,
        mesh=mesh, device=device)
    on_block = None
    if (live_preview_dir or live_preview_show) and (mesh is None or is_first_rank(mesh)):
        from ..viz import make_preview_writer  # matplotlib: imported only when asked for

        on_block = make_preview_writer(save_dir=live_preview_dir, show=live_preview_show)
    kpts_2d, heatmaps, kpts_3d = run_pipeline_on_videos(pipeline, recording_paths,
                                                        block_size=block_size, on_block=on_block)
    _save(mesh, [(k2_path, kpts_2d), (hm_path, heatmaps), (k3_path, kpts_3d)])
    return kpts_2d, heatmaps, kpts_3d


def _save(mesh, arrays) -> None:
    """``np.save`` each (path, array), by the mesh's first rank only; the
    other ranks wait until the files are written."""
    if mesh is None or is_first_rank(mesh):
        for path, arr in arrays:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            np.save(path, arr)
    if mesh is not None:
        mesh_barrier(mesh)

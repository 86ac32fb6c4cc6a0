"""Model-level accuracy harness: train -> deploy -> measure, end to end.

Counterpart of the JAX package's ``training/harness.py``: it trains the
CenterNet detector and a 2D pose model (HRNet or Swin heatmaps, or RTMPose
SimCC) on the synthetic COCO-17 scenes of `training.synthetic`, then runs
the whole block pipeline (detector -> crop -> model -> flip-TTA + DARK
decode -> top-2 triangulation) against the scene's geometry oracle and
reports pixel and 3-D errors of the trained weights.

The trainers run through `make_train_step` and `TrainState`, so with
``checkpoint_path`` they save every ``checkpoint_every`` steps and resume
from the file (the JAX package's TrainState format).  Everything runs on
``device``, the card unless the caller asks for the CPU.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..models.detector import CenterNetDetector, SinglePersonDetector
from ..models.registry import init_centernet_
from ..models.topdown import TopDownEstimator, preprocess_crops
from .loop import (ClipAdamW, TrainState, adam, build_train_model, make_train_step,
                   warmup_cosine_decay_schedule)
from .losses import centernet_focal_loss, heatmap_mse_loss, simcc_kl_loss
from .synthetic import SyntheticSceneConfig, person_bbox
from .targets import render_centernet_targets, render_heatmap_targets, render_simcc_targets

__all__ = ["train_synthetic_detector", "train_synthetic_pose", "train_synthetic_simcc",
           "run_accuracy_harness"]


def _sample_person_crops(scene, batch: int, input_size, device):
    """One training batch of jittered person crops and crop-space keypoints.

    The training box is jittered (scale 0.85-1.25, shift ±8 px) so the model
    is robust to the detector's box noise at deploy time.  Returns
    ``(crops (B, in_h, in_w, 3), kp_crop (B, 17, 2))`` on ``device``.
    """
    H, W = scene.height, scene.width
    frames, boxes, kps = [], [], []
    for _ in range(batch):
        pts = scene.sample_pose()
        cam = scene.cams[scene.rng.integers(len(scene.cams))]
        frame, proj = scene.render_training_view(pts, cam)
        frames.append(frame.astype(np.float32) / 255.0)
        bb = person_bbox(proj, W, H)
        c = np.array([(bb[0] + bb[2]) / 2, (bb[1] + bb[3]) / 2])
        half = np.array([(bb[2] - bb[0]) / 2, (bb[3] - bb[1]) / 2])
        half = half * scene.rng.uniform(0.85, 1.25)
        c = c + scene.rng.uniform(-8, 8, 2)
        boxes.append(np.array([c[0] - half[0], c[1] - half[1], c[0] + half[0], c[1] + half[1]],
                              np.float32))
        kps.append(proj)
    crops, scale, offset = preprocess_crops(
        torch.as_tensor(np.stack(frames), device=device),
        torch.as_tensor(np.stack(boxes), device=device), input_size)
    kp = torch.as_tensor(np.stack(kps), dtype=torch.float32, device=device)
    return crops, (kp - offset[:, None]) * scale[:, None]


def _run_train_loop(state: TrainState, step_fn, sample_batch, steps: int,
                    checkpoint_path: str | None = None, checkpoint_every: int = 500):
    """Drive ``step_fn`` to ``steps``; with ``checkpoint_path`` (an ``.npz``)
    save every ``checkpoint_every`` steps and at the end, and resume from an
    existing file first (the optimizer state rides along, so a schedule
    continues at the right step).  Returns (state, the last loss), the loss
    None when the file was already at ``steps`` and no step ran."""
    if checkpoint_path and os.path.exists(checkpoint_path):
        state = TrainState.load(checkpoint_path, state)
    loss = None
    while state.step < steps:
        state, loss = step_fn(state, sample_batch())
        if checkpoint_path and (state.step % checkpoint_every == 0 or state.step >= steps):
            state.save(checkpoint_path)
    return state, (None if loss is None else float(loss))


# Below this parameter count warmup+cosine at the shared peak lr measured
# unstable in the JAX package's runs (test_small_192x256 at 5000 steps:
# 10.96 mm constant against 146 mm cosine), while the big models need the
# decay tail (HRNet-W32: 9.8 mm cosine against 15.8 mm constant); "auto"
# picks by capacity.
_COSINE_MIN_PARAMS = 5_000_000


def _resolve_schedule(schedule: str, model: torch.nn.Module) -> str:
    """Map "auto" to the schedule measured safe for this model's capacity;
    warn about (but keep) an explicit cosine on a small model."""
    if schedule not in ("auto", "cosine", "constant"):
        raise ValueError(f"unknown schedule '{schedule}'")
    n_params = sum(p.numel() for p in model.parameters())
    small = n_params < _COSINE_MIN_PARAMS
    if schedule == "auto":
        return "constant" if small else "cosine"
    if schedule == "cosine" and small:
        print(f"WARNING: warmup+cosine at this peak lr measured UNSTABLE for small models "
              f"({n_params / 1e6:.1f}M params < {_COSINE_MIN_PARAMS / 1e6:.0f}M: 10.96 mm "
              f"constant vs 146 mm cosine, PARITY.md) — consider schedule='constant'/'auto'.")
    return schedule


def _make_tx(lr: float, steps: int, schedule: str, grad_clip: float = 1.0) -> ClipAdamW:
    """The synthetic trainers' optimizer: clip -> AdamW (weight decay 1e-4)
    at ``lr``, or with ``schedule="cosine"`` at a linear warm-up (5% of the
    steps) + cosine decay to lr/100."""
    if schedule == "cosine":
        lr = warmup_cosine_decay_schedule(0.0, lr, max(steps // 20, 1), max(steps, 2),
                                          end_value=lr * 1e-2)
    elif schedule != "constant":
        raise ValueError(f"unknown schedule '{schedule}'")
    return ClipAdamW(lr, weight_decay=1e-4, grad_clip=grad_clip)


def train_synthetic_detector(scene, steps: int = 200, batch: int = 16, width: int = 8,
                             lr: float = 3e-3, seed: int = 0, checkpoint_path: str | None = None,
                             checkpoint_every: int = 500, device="cuda"):
    """Train a f32 CenterNet on rendered frames (Adam at ``lr``); returns
    (`SinglePersonDetector` with bbox_thr 0.15, the last loss).  Weights
    from ``torch.Generator`` seed ``seed``."""
    H, W = scene.height, scene.width
    model = init_centernet_(CenterNetDetector(width, torch.float32, device),
                            torch.Generator().manual_seed(seed))

    def sample_batch():
        imgs, boxes = [], []
        for _ in range(batch):
            pts = scene.sample_pose()
            cam = scene.cams[scene.rng.integers(len(scene.cams))]
            frame, proj = scene.render_training_view(pts, cam)
            imgs.append(frame.astype(np.float32) / 255.0)
            boxes.append(person_bbox(proj, W, H))
        return {"images": torch.as_tensor(np.stack(imgs), device=device),
                "boxes": torch.as_tensor(np.stack(boxes), device=device)}

    def loss_fn(outputs, b):
        ct, wh, off, mask = render_centernet_targets(b["boxes"], (H // 16, W // 16),
                                                     device=device)
        return centernet_focal_loss(outputs, ct, wh, off, mask)

    init_fn, step_fn = make_train_step(model, loss_fn, tx=adam(lr))
    state, loss = _run_train_loop(init_fn(), step_fn, sample_batch, steps, checkpoint_path,
                                  checkpoint_every)
    return SinglePersonDetector(state.model, bbox_thr=0.15, device=device), loss


def _train_pose(scene, steps, batch, model_name, lr, seed, schedule, checkpoint_path,
                checkpoint_every, device, make_targets, loss_fn):
    model, spec = build_train_model(model_name, seed=seed, device=device)
    in_w, in_h = spec["input_size"]

    def sample_batch():
        crops, kp_crop = _sample_person_crops(scene, batch, (in_w, in_h), device)
        return {"images": crops, **make_targets(kp_crop, torch.ones((batch, 17), device=device),
                                                (in_w, in_h))}

    schedule = _resolve_schedule(schedule, model)
    init_fn, step_fn = make_train_step(model, loss_fn, tx=_make_tx(lr, steps, schedule))
    state, loss = _run_train_loop(init_fn(), step_fn, sample_batch, steps, checkpoint_path,
                                  checkpoint_every)
    return state.model, (in_w, in_h), loss


def train_synthetic_pose(scene, steps: int = 400, batch: int = 8,
                         model_name: str = "test_small_128", lr: float = 3e-3,
                         sigma: float = 1.5, seed: int = 0, schedule: str = "auto",
                         checkpoint_path: str | None = None, checkpoint_every: int = 500,
                         device="cuda"):
    """Train a heatmap model (HRNet or Swin, per the registry entry) in f32
    on person crops; returns (model, input_size, the last loss)."""

    def make_targets(kp_crop, vis, size):
        in_w, in_h = size
        targets, w = render_heatmap_targets(kp_crop / 4.0, vis, (in_h // 4, in_w // 4),
                                            sigma=sigma, device=device)
        return {"targets": targets, "weights": w}

    def loss_fn(outputs, b):
        return heatmap_mse_loss(outputs, b["targets"], b["weights"])

    return _train_pose(scene, steps, batch, model_name, lr, seed, schedule, checkpoint_path,
                       checkpoint_every, device, make_targets, loss_fn)


def train_synthetic_simcc(scene, steps: int = 400, batch: int = 8,
                          model_name: str = "coco_rtmpose-t", lr: float = 3e-3, seed: int = 0,
                          schedule: str = "auto", checkpoint_path: str | None = None,
                          checkpoint_every: int = 500, device="cuda"):
    """Train an RTMPose SimCC model in f32 on person crops; returns (model,
    input_size, the last loss)."""

    def make_targets(kp_crop, vis, size):
        lx, ly, w = render_simcc_targets(kp_crop, vis, size, device=device)
        return {"lx": lx, "ly": ly, "w": w}

    def loss_fn(outputs, b):
        px, py = outputs
        return simcc_kl_loss(px, py, b["lx"], b["ly"], b["w"])

    return _train_pose(scene, steps, batch, model_name, lr, seed, schedule, checkpoint_path,
                       checkpoint_every, device, make_targets, loss_fn)


def run_accuracy_harness(n_frames: int = 32, det_steps: int = 200, pose_steps: int = 400,
                         n_cams: int = 2, seed: int = 0, flip_test: bool = True,
                         decode_mode: str = "dark", pose_family: str = "heatmap",
                         pose_model_name: str | None = None, mesh=None, distortion=None,
                         hard: bool = False, sgd_refine: bool = False,
                         sgd_kwargs: dict | None = None,
                         sgd_variants: dict[str, dict] | None = None, schedule: str = "auto",
                         workdir: str | None = None, det_select: str = "top1",
                         device="cuda") -> dict:
    """Train the detector and the pose model, deploy both in the block
    pipeline and measure; returns a metrics dict:

    - ``mpjpe_3d`` (and ``_median``, ``_refined`` after the outlier-robust
      linear interpolation): mean per-joint 3-D error against the oracle
      trajectory, in the scene's units (cm);
    - ``px_err_2d``: mean pixel error of the 2D stage against the oracle
      projection;
    - ``px_err_flip_shift`` / ``px_err_flip_noshift`` (heatmap family): the
      flip-TTA shift convention, shifted against unshifted;
    - ``det_tight_frac``: the share of detector boxes under 60% of the frame;
    - ``mpjpe_3d_nview`` (more than two cameras): the robust n-view solve on
      the same 2D output;
    - ``mpjpe_3d_sgd`` (with ``sgd_refine``): after the MLE refinement
      (`refine.PoseRefiner`) of the trained model's Gaussians from the
      interpolated trajectory, body lengths from the oracle skeleton; each
      of ``sgd_variants`` (name -> `RefineConfig` overrides of
      ``sgd_kwargs``) adds ``mpjpe_3d_sgd_<name>``;
    - ``det_loss``, ``pose_loss``: the trainers' last losses.

    ``pose_family``: "heatmap" (HRNet or Swin) or "simcc" (RTMPose-t);
    ``distortion``, ``hard``: the scene (`synthetic.SyntheticSceneConfig`);
    ``det_select``: the pipeline's box selection ("top1" or "consistent");
    ``workdir``: where the trainers checkpoint and resume, the file names
    carrying the configuration; ``mesh``: a mesh of `parallel.make_mesh`
    to run the block pipeline over (every rank trains the same models from
    the seed, then takes the first rank's weights), or None (one device).
    """
    if pose_family not in ("heatmap", "simcc"):
        raise ValueError(f"unknown pose_family '{pose_family}'")
    if det_select not in ("top1", "consistent"):
        raise ValueError(f"unknown det_select '{det_select}'")
    scene, detector, det_loss, model, input_size, pose_loss = _train_models(
        n_cams, seed, det_steps, pose_steps, pose_family, pose_model_name, distortion, hard,
        schedule, workdir, device)
    detector.select = det_select
    if pose_family == "simcc":
        decode_mode = "default"  # DARK is a heatmap-space refinement
    metrics, _, _ = _deploy_and_score(model, input_size, detector, scene, n_frames, seed,
                                   pose_family, mesh=mesh, sgd_refine=sgd_refine,
                                   sgd_kwargs=sgd_kwargs, sgd_variants=sgd_variants,
                                   device=device, flip_test=flip_test, decode_mode=decode_mode)
    return {**metrics, "det_loss": det_loss, "pose_loss": pose_loss}


def _train_models(n_cams, seed, det_steps, pose_steps, pose_family, pose_model_name, distortion,
                  hard, schedule, workdir, device):
    """The harness's scene and its two trainers (resumed from ``workdir``'s
    files where they exist): (scene, detector, det_loss, pose model,
    input_size, pose_loss)."""
    scene = SyntheticSceneConfig(n_cams=n_cams, seed=seed, distortion=distortion, hard=hard)
    ckpt = det_ckpt = None
    if workdir:
        os.makedirs(workdir, exist_ok=True)
        tag = (f"{pose_family}_{pose_model_name or 'default'}_{pose_steps}_{schedule}"
               f"_{'hard' if hard else 'easy'}_{'dist' if distortion is not None else 'nodist'}"
               f"_s{seed}")
        ckpt = os.path.join(workdir, f"pose_{tag}.npz")
        det_ckpt = os.path.join(workdir, f"det_{tag}.npz")
    detector, det_loss = train_synthetic_detector(scene, steps=det_steps,
                                                  checkpoint_path=det_ckpt, device=device)
    named = {"model_name": pose_model_name} if pose_model_name else {}
    trainer = train_synthetic_pose if pose_family == "heatmap" else train_synthetic_simcc
    model, input_size, pose_loss = trainer(scene, steps=pose_steps, schedule=schedule,
                                           checkpoint_path=ckpt, device=device, **named)
    return scene, detector, det_loss, model, input_size, pose_loss


def _deploy_and_score(model, input_size, detector, scene, n_frames: int, seed: int,
                      pose_family: str, mesh=None, sgd_refine: bool = False,
                      sgd_kwargs: dict | None = None, sgd_variants: dict | None = None,
                      device="cuda", **estimator_kwargs):
    """Deploy ``model`` behind ``detector`` in the block pipeline on the
    scene's validation clip and measure: (the metrics of
    `run_accuracy_harness` but the losses, the pipeline's output dict, the
    clip's frames (T, C, H, W, 3) uint8).
    ``estimator_kwargs`` pass to every `TopDownEstimator` built here (the
    flip-shift pair sets its own ``flip_test`` and ``flip_shift``)."""
    from ..io.camera_params import stack_camera_params
    from ..ops.triangulation import triangulate_nview
    from ..parallel.pipeline import ShardedPosePipeline
    from ..refine.interpolation import linear_interpolation

    n_cams = len(scene.cams)
    # The validation clip has its own rng: training draws a data-dependent
    # number of times from scene.rng (none after a full resume).
    scene.rng = np.random.default_rng(seed + 1_000_003)
    traj = scene.trajectory(n_frames)
    frames = np.zeros((n_frames, n_cams, scene.height, scene.width, 3), np.uint8)
    proj_all = np.zeros((n_frames, n_cams, 17, 2))
    for i in range(n_frames):
        frames[i], proj_all[i], _ = scene.render_views(traj[i])

    if mesh is not None:
        from ..parallel.mesh import broadcast_from_first

        with torch.no_grad():
            broadcast_from_first([*model.state_dict().values(),
                                  *detector.model.state_dict().values()], mesh)
    decode = "heatmap" if pose_family == "heatmap" else "simcc"
    est = TopDownEstimator(model, input_size=input_size, decode=decode, device=device,
                           **estimator_kwargs)
    cam_stack = stack_camera_params(scene.cams)
    pipe = ShardedPosePipeline(est, cam_stack, mesh=mesh, conf_threshold=0.0,
                               detector=detector, device=device)
    out = pipe.run(frames)
    kpts_3d = out["kpts_3d"].double().cpu().numpy()
    kpts_2d = out["kpts_2d"].double().cpu().numpy()  # (T, K, 3, C)

    err3d = np.linalg.norm(kpts_3d - traj, axis=-1)
    xy2d = np.moveaxis(kpts_2d[:, :, :2, :], -1, 1)  # (T, C, K, 2)
    err2d = np.linalg.norm(xy2d - proj_all, axis=-1)
    refined = linear_interpolation(kpts_3d, device=device).double().cpu().numpy()
    err3d_ref = np.linalg.norm(refined - traj, axis=-1)

    metrics = {
        "mpjpe_3d": float(np.nanmean(err3d)),
        "mpjpe_3d_median": float(np.nanmedian(err3d)),
        "mpjpe_3d_refined": float(np.nanmean(err3d_ref)),
        "mpjpe_3d_refined_median": float(np.nanmedian(err3d_ref)),
        "px_err_2d": float(np.nanmean(err2d)),
        "pose_family": pose_family,
        "n_frames": n_frames,
        "n_cams": n_cams,
        "hard": scene.hard,
        "distortion": bool(np.any(np.asarray([c[3] for c in scene.cams]))),
    }
    if n_cams > 2:
        # The robust n-view solve on the same 2D output: with three or more
        # views a corrupted top-2 view has recourse.
        xy_nv = torch.as_tensor(np.swapaxes(kpts_2d[:, :, :2, :], -1, -2), device=device)
        conf_nv = torch.as_tensor(kpts_2d[:, :, 2, :], device=device)
        k3_nv = triangulate_nview(xy_nv.float(), conf_nv.float(),
                                  *(torch.as_tensor(cam_stack[k], device=device)
                                    for k in ("K", "dist", "R", "T")))
        k3_nv = k3_nv.double().cpu().numpy()
        metrics["mpjpe_3d_nview"] = float(np.nanmean(np.linalg.norm(k3_nv - traj, axis=-1)))
        metrics["mpjpe_3d_nview_median"] = float(np.nanmedian(
            np.linalg.norm(k3_nv - traj, axis=-1)))
        refined_nv = linear_interpolation(k3_nv, device=device).double().cpu().numpy()
        metrics["mpjpe_3d_nview_refined"] = float(np.nanmean(
            np.linalg.norm(refined_nv - traj, axis=-1)))

    if sgd_refine:
        metrics.update(_sgd_metrics(out["heatmaps_2d"], refined, traj, scene, n_frames,
                                    sgd_kwargs, sgd_variants, device))

    # Detector tightness on the validation frames.
    flat = frames.reshape(-1, scene.height, scene.width, 3)
    boxes = detector.detect(flat)
    areas = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    metrics["det_tight_frac"] = float((areas < 0.6 * scene.height * scene.width).float().mean())

    if pose_family == "heatmap":
        # The flip-shift convention: the same weights, shift on and off.
        flat_f32 = flat.astype(np.float32) / 255.0
        proj_flat = proj_all.reshape(-1, 17, 2)
        for name, shift in (("px_err_flip_shift", True), ("px_err_flip_noshift", False)):
            e = TopDownEstimator(model, input_size=input_size, decode="heatmap", device=device,
                                 **{**estimator_kwargs, "flip_test": True, "flip_shift": shift})
            k = e.predict_batch(flat_f32, boxes)["keypoints"][..., :2].double().cpu().numpy()
            metrics[name] = float(np.linalg.norm(k - proj_flat, axis=-1).mean())
    return metrics, out, frames


def _sgd_metrics(gaussians, refined, traj, scene, n_frames, sgd_kwargs, sgd_variants,
                 device) -> dict:
    """MPJPE after `refine.PoseRefiner` from the interpolated trajectory,
    with the JAX harness's settings (the reference README's lr 0.01,
    lambda_smooth 1e-6 and lambda_body_length 1; 3000 epochs at most)."""
    from ..refine.optimizer import PoseRefiner
    from ..utils.skeleton import get_body_part_lengths

    lengths = get_body_part_lengths(torch.as_tensor(traj, dtype=torch.float32))
    refiner = PoseRefiner(gaussians.double().cpu().numpy(), refined,
                          {i: list(c) for i, c in enumerate(scene.cams)},
                          body_lengths={k: float(v.mean()) for k, v in lengths.items()},
                          device=device)
    base = dict(lr=0.01, max_iter=3000, patience=200, lambda_smooth=1e-6,
                lambda_body_length=1.0, batch_size=min(100, n_frames), tolerance=0.0)
    base.update(sgd_kwargs or {})
    out = {}
    for name, overrides in {"": {}, **(sgd_variants or {})}.items():
        res = refiner.sgd_optimize(**{**base, **overrides})
        rt = torch.as_tensor(res.trajectory).double().cpu().numpy()
        err = np.linalg.norm(rt - traj[: rt.shape[0]], axis=-1)
        key = f"mpjpe_3d_sgd_{name}" if name else "mpjpe_3d_sgd"
        out[key], out[f"{key}_median"] = float(np.nanmean(err)), float(np.nanmedian(err))
    return out

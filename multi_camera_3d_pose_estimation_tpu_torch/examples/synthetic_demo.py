"""The whole system on synthetic data: no cameras, no downloads.

Simulates a 2-camera rig watching a moving 5-joint stick figure and runs
the system as a user would:

1. a 5-joint "person" trajectory in world space;
2. each camera's video (bright coloured blobs at the projected joints),
   written as ``.mp4`` through cv2;
3. the rig's calibration files, written through `io`;
4. a tiny heatmap model trained on frames of the rig (`training`);
5. the estimate command on the videos (videos -> 2D -> Gaussians -> 3D);
6. the refine command (linear interpolation, then SGD);
7. the refined trajectory as a GIF (`viz`, needs matplotlib).

The 3-D error against the simulated trajectory is printed after 5 and 6.

    python -m multi_camera_3d_pose_estimation_tpu_torch.examples.synthetic_demo \\
        [--outdir DIR] [--steps 400] [--frames 48] [--device cpu]

The flags are those of the JAX package's ``examples/synthetic_demo.py``,
with ``--device`` (default ``cuda``) in place of ``--cpu``; the artifacts
in DIR have that script's names.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

N_CAMS, N_JOINTS = 2, 5
HEIGHT, WIDTH = 120, 160
MODEL = "test_small_128"
# Joints must look different, or the 2D model cannot tell them apart (and
# triangulation pairs unlike joints across views).
JOINT_COLORS = [(255, 80, 80), (80, 255, 80), (80, 80, 255), (255, 255, 80), (255, 80, 255)]
BODY_PARTS = {"demo": [[0, 1], [0, 2], [1, 3], [2, 4]]}


def simulate_trajectory(n_frames: int) -> np.ndarray:
    """Step 1: (T, 5, 3) world trajectory of the stick figure."""
    t = np.linspace(0, 4 * np.pi, n_frames)[:, None, None]
    base = np.array([[[0, -20, 300], [-10, 0, 300], [10, 0, 300],
                      [-8, 22, 300], [8, 22, 300]]], np.float64)
    return base + 6 * np.stack([np.sin(t[..., 0]), np.cos(1.3 * t[..., 0]),
                                0.4 * np.sin(2 * t[..., 0])], -1)


def project(pts3d, K, R, T) -> np.ndarray:
    """Float64 pinhole projection (no distortion) of (N, 3) points."""
    cam = pts3d @ R.T + T
    x, y = cam[:, 0] / cam[:, 2], cam[:, 1] / cam[:, 2]
    return np.stack([K[0, 0] * x + K[0, 1] * y + K[0, 2], K[1, 1] * y + K[1, 2]], axis=-1)


def draw_frame(proj, rng, dtype=np.uint8) -> np.ndarray:
    """A noise frame with each joint's coloured blob at ``proj`` (J, 2)."""
    import cv2

    frame = (rng.integers(0, 50, (HEIGHT, WIDTH, 3), dtype=np.uint8) if dtype == np.uint8
             else rng.integers(0, 50, (HEIGHT, WIDTH, 3)).astype(dtype))
    for j, (x, y) in enumerate(proj):
        cv2.circle(frame, (int(x), int(y)), 3, JOINT_COLORS[j], -1)
    return frame


def write_rig(out: str, traj: np.ndarray, rng) -> tuple[dict, list, str]:
    """Steps 2-3: each camera's calibration files and ``<name>_synced.mp4``
    video under ``out``; returns (index -> [K, R, T], video paths, the
    recordings directory)."""
    import cv2

    from ..io import (save_camera_intrinsics, save_camera_names,
                      save_extrinsic_calibration_parameters)

    rec_dir = os.path.join(out, "recordings")
    os.makedirs(rec_dir, exist_ok=True)
    n_frames = traj.shape[0]
    cams, video_paths = {}, []
    for c in range(N_CAMS):
        K = np.array([[200.0, 0, WIDTH / 2], [0, 200.0, HEIGHT / 2], [0, 0, 1.0]])
        th = np.deg2rad(-25 + 50 * c)  # a wide rig (±25°): stereo depth well conditioned
        R = np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0], [-np.sin(th), 0, np.cos(th)]])
        Tv = -np.einsum("ij,j->i", R, np.array([-130.0 + 260.0 * c, 0.0, -20.0]))
        cams[c] = [K, R, Tv]
        name = f"cam{c}"
        save_camera_intrinsics(K, np.zeros((1, 5)), name, root_path=out)
        save_extrinsic_calibration_parameters(R, Tv.reshape(3, 1), name, root_dir=out)
        proj = project(traj.reshape(-1, 3), K, R, Tv).reshape(n_frames, N_JOINTS, 2)
        path = os.path.join(rec_dir, f"{name}_synced.mp4")
        vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 15.0, (WIDTH, HEIGHT))
        if not vw.isOpened():
            raise RuntimeError(f"cv2 {cv2.__version__} cannot write an mp4v video to {path}")
        for i in range(n_frames):
            vw.write(draw_frame(proj[i], rng))
        vw.release()
        video_paths.append(path)
    save_camera_names({0: "cam0", 1: "cam1"}, "cam0", out)
    print(f"rendered {N_CAMS} videos x {n_frames} frames -> {rec_dir}")
    return cams, video_paths, rec_dir


def train_model(out: str, traj: np.ndarray, cams: dict, rng, steps: int, device) -> str:
    """Step 4: test_small_128's HRNet at 5 joints, float32, trained on rig
    frames (Adam at 3e-3, batches of 8 full-frame crops); returns the path of
    its ``.npz`` checkpoint (the JAX package's format)."""
    from ..models.convert import save_checkpoint_npz
    from ..models.registry import MODEL_REGISTRY, build_model
    from ..models.topdown import preprocess_crops
    from ..training import heatmap_mse_loss, make_train_step, render_heatmap_targets

    spec = MODEL_REGISTRY[MODEL]
    in_w, in_h = spec["input_size"]
    model = build_model("hrnet", spec["cfg"], device, seed=0, input_size=(in_w, in_h),
                        num_joints=N_JOINTS, dtype=torch.float32)
    n_frames = traj.shape[0]

    def sample_batch(n=8):
        idx, cam_idx = rng.integers(0, n_frames, n), rng.integers(0, N_CAMS, n)
        frames, kps = [], []
        for i, c in zip(idx, cam_idx):
            proj = project(traj[i], *cams[c])
            frames.append(draw_frame(proj, rng, np.float32) / 255.0)
            kps.append(proj)
        boxes = torch.tensor([[0.0, 0.0, WIDTH, HEIGHT]] * n, device=device)
        crops, scale, offset = preprocess_crops(torch.as_tensor(np.stack(frames), device=device),
                                                boxes, (in_w, in_h))
        kp_crop = (torch.as_tensor(np.stack(kps), dtype=torch.float32, device=device)
                   - offset[:, None]) * scale[:, None]
        targets, w = render_heatmap_targets(kp_crop / 4.0, torch.ones((n, N_JOINTS), device=device),
                                            (in_h // 4, in_w // 4), sigma=1.0, device=device)
        return {"images": crops, "targets": targets, "weights": w}

    def loss_fn(outputs, batch):
        return heatmap_mse_loss(outputs, batch["targets"], batch["weights"])

    init_fn, step_fn = make_train_step(model, loss_fn, learning_rate=3e-3)
    state = init_fn()
    for i in range(steps):
        state, loss = step_fn(state, sample_batch())
        if i % 100 == 0:
            print(f"train step {i}: loss {float(loss):.5f}")
    ckpt = os.path.join(out, "demo_model.npz")
    save_checkpoint_npz(state.model, ckpt, "hrnet")
    print(f"trained demo model -> {ckpt}")
    return ckpt


def mpjpe(pred, traj) -> tuple[float, float]:
    """(mean, median) per-joint 3-D error, NaN joints left out."""
    err = np.linalg.norm(np.asarray(pred, np.float64) - traj, axis=-1)
    return float(np.nanmean(err)), float(np.nanmedian(err))


def estimate(out: str, video_paths: list, rec_dir: str, ckpt: str, traj: np.ndarray,
             device) -> tuple[float, float]:
    """Step 5: the estimate command on the videos (DARK decode, blocks of
    16) and the recording log; returns the raw triangulation's (mean,
    median) 3-D error."""
    from ..cli.estimate import estimate_pose_from_video
    from ..io import write_recording_log

    _, _, kpts_3d = estimate_pose_from_video(
        video_paths, project_dir=out, pose_estimation_model=MODEL, checkpoint=ckpt,
        save_dir=rec_dir, overwrite=True, conf_threshold=0.0, block_size=16,
        num_joints=N_JOINTS, estimator_kwargs={"decode_mode": "dark"}, device=device)
    mean, median = mpjpe(kpts_3d, traj)
    print(f"raw triangulation MPJPE: mean {mean:.2f} / median {median:.2f} world units "
          f"(subject distance ≈ 340; toy 2D model ≈ 3 px error dominates)")
    write_recording_log(rec_dir, video_paths, MODEL, "full_frame")
    return mean, median


def refine(out: str, rec_dir: str, traj: np.ndarray, device) -> tuple[np.ndarray, float, float]:
    """Step 6: the refine command (linear interpolation, then SGD at lr
    0.05, 300 epochs at most) on the run; returns (the SGD trajectory, its
    mean and median 3-D error)."""
    import yaml

    from ..cli.refine import build_parser, run_refinement

    params_yaml = os.path.join(out, "refine.yaml")
    with open(params_yaml, "w") as f:
        yaml.dump({"SGD": {"lr": 0.05, "max_iter": 300, "patience": 50,
                           "lambda_smooth": 0.001, "lambda_body_length": 0.0}}, f)
    args = build_parser().parse_args([
        "--run_path", rec_dir,
        "--refinement_types", "linear_interpolation", "SGD",
        "--extrinsic_params_dir", os.path.join(out, "extrinsic_camera_parameters"),
        "--intrinsic_params_dir", os.path.join(out, "intrinsic_camera_parameters"),
        "--refinement_params_yaml", params_yaml,
        "--ignore_body_lengths", "--device", str(device),
    ])
    sgd = np.asarray(run_refinement(args)["SGD"])
    mean, median = mpjpe(sgd, traj)
    print(f"refined MPJPE: mean {mean:.2f} / median {median:.2f} world units")
    return sgd, mean, median


def animate(out: str, trajectory: np.ndarray) -> str:
    """Step 7: ``pose3d.gif`` of ``trajectory`` (matplotlib)."""
    from ..viz import visualize_3d

    gif = os.path.join(out, "pose3d.gif")
    visualize_3d(trajectory, body_parts=BODY_PARTS).save(gif, fps=10)
    print(f"saved {gif}")
    return gif


def run_demo(outdir: str, steps: int = 400, n_frames: int = 48, device="cuda") -> dict:
    """Steps 1-7 in order; returns the 3-D errors after steps 5 and 6 (the
    scene's world units) and the artifacts' paths."""
    rng = np.random.default_rng(0)
    out = os.path.abspath(outdir)
    traj = simulate_trajectory(n_frames)
    cams, video_paths, rec_dir = write_rig(out, traj, rng)
    ckpt = train_model(out, traj, cams, rng, steps, device)
    raw_mean, raw_median = estimate(out, video_paths, rec_dir, ckpt, traj, device)
    sgd, sgd_mean, sgd_median = refine(out, rec_dir, traj, device)
    res = {"mpjpe_raw": raw_mean, "mpjpe_raw_median": raw_median, "mpjpe_refined": sgd_mean,
           "mpjpe_refined_median": sgd_median, "videos": video_paths, "checkpoint": ckpt,
           "recordings": rec_dir, "gif": animate(out, sgd)}
    print("DEMO COMPLETE")
    return res


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--outdir", default="./synthetic_demo_out")
    p.add_argument("--steps", type=int, default=400, help="training steps")
    p.add_argument("--frames", type=int, default=48)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    return run_demo(args.outdir, args.steps, args.frames, args.device)


if __name__ == "__main__":
    main()

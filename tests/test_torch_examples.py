"""The port's accuracy drills (``multi_camera_3d_pose_estimation_tpu_torch.examples``)
on the CPU, against the JAX package's harness and examples.

- The JAX harness trains at its smallest budget into a workdir; the port's
  harness resumes from the same files (trains nothing: both losses None)
  and scores the JAX-trained weights on the same clip: ``mpjpe_3d``,
  ``px_err_2d`` and ``det_tight_frac`` within ``HANDOFF_RTOL`` of JAX's.
- ``evaluate_px_error`` of the port against the JAX example's on the same
  ``.npz`` weights (float32 both sides), within 1e-4 px.
- The port's three commands at tiny budgets with ``--device cpu``: the
  JSON keys of the JAX scripts, the train drill's exit code on a missed
  threshold, and the JAX demo's artifact names, its GIF included.
"""

import json
import os

import numpy as np
import pytest
import torch

from multi_camera_3d_pose_estimation_tpu_torch.examples import (accuracy_harness,
                                                                 synthetic_demo,
                                                                 train_synthetic_coco)

# The port scores the JAX-trained weights through its own pipeline (f32 on
# both sides): the same boxes, crops, maps and decodes up to f32 rounding,
# which the barely peaked maps of two training steps amplify in the
# sub-pixel decodes.  Measured gaps: 3e-6 to 5e-6 relative.
HANDOFF_RTOL = 1e-4
PX_ATOL = 1e-4  # evaluate_px_error, port against JAX, on the same weights

# examples/train_synthetic_coco.py's JSON keys.
TRAIN_KEYS = {"px_err_trained", "px_err_random_init", "px_threshold", "passed", "steps", "model",
              "train_wall_s"}
# examples/synthetic_demo.py's artifacts.
DEMO_FILES = {"demo_model.npz", "pose3d.gif", "refine.yaml",
              "extrinsic_camera_parameters/camera_names.pkl",
              "extrinsic_camera_parameters/rot_trans_cam0.dat",
              "extrinsic_camera_parameters/rot_trans_cam1.dat",
              "intrinsic_camera_parameters/cam0.dat", "intrinsic_camera_parameters/cam1.dat",
              "recordings/cam0_synced.mp4", "recordings/cam1_synced.mp4",
              "recordings/heatmaps_2d.npy", "recordings/kpts_2d.npy", "recordings/kpts_3d.npy",
              "recordings/kpts_3d_SGD.npy", "recordings/kpts_3d_linear_interpolation.npy",
              "recordings/recording_log.yaml"}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the steps are small, and a thread per core
    oversubscribes the CPU when the test files run in parallel."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def test_port_harness_scores_the_jax_harness_checkpoints(tmp_path):
    from multi_camera_3d_pose_estimation_tpu.training import (
        run_accuracy_harness as jax_harness)

    kw = dict(n_frames=2, det_steps=2, pose_steps=2, pose_model_name="test_tiny",
              workdir=str(tmp_path))
    ref = jax_harness(**kw)
    assert sorted(os.listdir(tmp_path)) == [
        "det_heatmap_test_tiny_2_auto_easy_nodist_s0.npz",
        "pose_heatmap_test_tiny_2_auto_easy_nodist_s0.npz"]
    got = accuracy_harness.main(["--frames", "2", "--det_steps", "2", "--pose_steps", "2",
                                 "--model", "test_tiny", "--workdir", str(tmp_path),
                                 "--device", "cpu"])
    assert got["det_loss"] is None and got["pose_loss"] is None  # nothing trained
    assert set(got) == set(ref)
    for key in ("mpjpe_3d", "px_err_2d", "det_tight_frac", "mpjpe_3d_median",
                "mpjpe_3d_refined", "px_err_flip_shift", "px_err_flip_noshift"):
        assert np.isfinite(got[key]), (key, got)
        np.testing.assert_allclose(got[key], ref[key], rtol=HANDOFF_RTOL, err_msg=key)


def test_evaluate_px_error_matches_jax(tmp_path):
    import jax.numpy as jnp
    from examples.train_synthetic_coco import evaluate_px_error as jax_evaluate
    from multi_camera_3d_pose_estimation_tpu.models.registry import (
        build_estimator as jax_build, save_checkpoint_npz)

    from multi_camera_3d_pose_estimation_tpu_torch.models.registry import build_estimator

    path = str(tmp_path / "w.npz")
    jax_est = jax_build("test_tiny", seed=3, dtype=jnp.float32)
    save_checkpoint_npz(jax_est.variables, path)
    port_est = build_estimator("test_tiny", checkpoint=path, dtype=torch.float32, device="cpu")
    kw = dict(n_eval=8, width=96, height=96)
    ref = jax_evaluate(jax_est, **kw)
    got = train_synthetic_coco.evaluate_px_error(port_est, **kw)
    assert np.isfinite(got) and abs(got - ref) <= PX_ATOL, (got, ref)


def test_train_drill_keys_and_exit_code(tmp_path, capsys):
    out = str(tmp_path / "r.json")
    args = ["--steps", "2", "--model", "test_tiny", "--images", "4", "--size", "64",
            "--batch_size", "2", "--device", "cpu", "--out", out]
    with pytest.raises(SystemExit) as e:
        train_synthetic_coco.main(args + ["--px_threshold", "0"])  # no error is below 0 px
    assert e.value.code == 1
    printed = capsys.readouterr().out
    res = json.loads(printed[printed.rindex("{\n"):])
    assert set(res) == TRAIN_KEYS and res["passed"] is False and res["steps"] == 2
    with open(out) as f:
        assert json.load(f) == res
    assert np.isfinite(res["px_err_trained"]) and np.isfinite(res["px_err_random_init"])


def test_demo_writes_the_jax_demo_artifacts(tmp_path, capsys):
    res = synthetic_demo.main(["--outdir", str(tmp_path), "--steps", "4", "--frames", "8",
                               "--device", "cpu"])
    files = {os.path.relpath(os.path.join(d, f), tmp_path)
             for d, _, names in os.walk(tmp_path) for f in names}
    assert files == DEMO_FILES
    printed = capsys.readouterr().out
    for line in ("raw triangulation MPJPE: mean", "refined MPJPE: mean", "DEMO COMPLETE"):
        assert line in printed
    for key in ("mpjpe_raw", "mpjpe_refined"):
        assert np.isfinite(res[key]), res
    kpts_3d = np.load(tmp_path / "recordings" / "kpts_3d.npy")
    assert kpts_3d.shape == (8, 5, 3)

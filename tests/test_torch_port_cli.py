"""The port's estimate and refine CLIs against the JAX package's, on the CPU.

Estimate: the pattern of ``tests/test_e2e.py`` (two cameras with their
``.dat`` files and ``camera_names.pkl``, 8-frame mp4v videos, here of
160x128 so that RTMDet's stride 32 divides them), read in blocks of 3 so
that the last block is zero-padded, through both CLIs on the same
``test_tiny`` ``.npz`` checkpoint written by the JAX package.  Held in the
layers of ``tests/test_torch_port_pipeline.py``:

1. the models: the checkpoint gives the port exactly the converted flax
   weights (``tests/test_torch_port_checkpoint.py``), on which the two bf16
   models' heatmaps agree within 5e-2 of their largest value
   (``tests/test_torch_port_pipeline.py``); here the artifacts'
   confidences (the heatmap peaks) are held to the same 5e-2;
2. the decode and triangulation on equal heatmaps are held exactly there;
3. end to end, ``kpts_3d`` agrees (rtol 1e-3, atol 1e-2) wherever both
   sides picked the same peak in both views, with the share of such joints
   asserted.  The Gaussians' moments of random (flat) maps move with every
   pixel near the 0.01 threshold, so they are held for shape, dtype and
   finiteness only.

Files, shapes and dtypes are equal.  The cached-2D reuse path (3 cameras,
``top2`` and ``nview``) is held against JAX's in float64 at rtol = atol =
1e-8 with equal NaN patterns.  Refine: ``tests/test_cli_viz.py``'s
fixture, linear interpolation at 1e-9 and the SGD result within 1 unit
(mm, as ``tests/test_artifact_ab.py`` reads these coordinates) MPJPE.
"""

import os

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")
yaml = pytest.importorskip("yaml")

from multi_camera_3d_pose_estimation_tpu import io as jio  # noqa: E402
from multi_camera_3d_pose_estimation_tpu.cli import refine as j_refine  # noqa: E402
from multi_camera_3d_pose_estimation_tpu.cli.estimate import (  # noqa: E402
    estimate_pose_from_video as j_estimate)
from multi_camera_3d_pose_estimation_tpu.models import registry as jreg  # noqa: E402
from multi_camera_3d_pose_estimation_tpu.models.hrnet import HRNet as JHRNet  # noqa: E402
from multi_camera_3d_pose_estimation_tpu.models.rtmdet import RTMDet as JRTMDet  # noqa: E402
from multi_camera_3d_pose_estimation_tpu_torch import __main__ as port_main  # noqa: E402
from multi_camera_3d_pose_estimation_tpu_torch import io as pio  # noqa: E402
from multi_camera_3d_pose_estimation_tpu_torch.cli import refine as p_refine  # noqa: E402
from multi_camera_3d_pose_estimation_tpu_torch.cli.estimate import (  # noqa: E402
    estimate_pose_from_video as p_estimate)

from tests._torch_port_util import random_variables  # noqa: E402
from tests.conftest import project_np  # noqa: E402
from tests.test_cli_viz import make_refinement_artifacts  # noqa: E402

N_FRAMES, H, W, BLOCK = 8, 128, 160, 3
KEYS = ("kpts_2d", "heatmaps_2d", "kpts_3d")


def _write_cameras(root, n_cams):
    K = np.array([[300.0, 0, W / 2], [0, 300.0, H / 2], [0, 0, 1]])
    names = [f"cam{c}" for c in range(n_cams)]
    for c, name in enumerate(names):
        th = np.deg2rad(-10 + 20 * c / max(n_cams - 1, 1))
        R = np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0], [-np.sin(th), 0, np.cos(th)]])
        jio.save_camera_intrinsics(K, np.array([[-0.02 * c, 0.01, 0, 0, 0]]), name,
                                   root_path=str(root))
        jio.save_extrinsic_calibration_parameters(
            R, np.array([20.0 * c - 10, 0.5 * c, 5.0 * c]).reshape(3, 1), name, root_dir=str(root))
    jio.save_camera_names(dict(enumerate(names)), names[0], str(root))
    return names


@pytest.fixture(scope="module")
def project(tmp_path_factory):
    """2 cameras on disk, 8-frame synced videos, a JAX test_tiny checkpoint."""
    root = tmp_path_factory.mktemp("project")
    _write_cameras(root, 2)
    rng = np.random.default_rng(0)
    (root / "recordings").mkdir()
    paths = []
    for c in range(2):
        p = str(root / "recordings" / f"cam{c}_synced.mp4")
        vw = cv2.VideoWriter(p, cv2.VideoWriter_fourcc(*"mp4v"), 15.0, (W, H))
        for _ in range(N_FRAMES):
            vw.write(rng.integers(0, 256, (H, W, 3), dtype=np.uint8))
        vw.release()
        paths.append(p)
    spec = jreg.MODEL_REGISTRY["test_tiny"]
    in_w, in_h = spec["input_size"]
    variables = random_variables(JHRNet(num_joints=17, cfg=spec["cfg"]), (1, in_h, in_w, 3), 0)
    ckpt = str(root / "test_tiny.npz")
    jreg.save_checkpoint_npz(variables, ckpt)
    return root, paths, ckpt


@pytest.fixture(scope="module", autouse=True)
def _build_the_jax_estimator_once():
    """The JAX CLI builds its estimator with an unjitted ``model.init``
    (16 s for test_tiny on one CPU core) before loading the checkpoint over
    it; both of this file's runs load the same checkpoint, so the second
    gets the first's estimator."""
    import multi_camera_3d_pose_estimation_tpu.cli.estimate as j_cli

    built = {}

    def build_estimator(name, checkpoint=None, **kw):
        key = (name, checkpoint, tuple(sorted(kw.items())))
        if key not in built:
            built[key] = jreg.build_estimator(name, checkpoint=checkpoint, **kw)
        return built[key]

    mp = pytest.MonkeyPatch()
    mp.setattr(j_cli, "build_estimator", build_estimator)
    yield
    mp.undo()


def _run_both(project, sub, **kw):
    root, paths, ckpt = project
    out = {}
    for side, fn, extra in (("jax", j_estimate, {}), ("port", p_estimate, {"device": "cpu"})):
        out[side] = fn(paths, project_dir=str(root), pose_estimation_model="test_tiny",
                       checkpoint=ckpt, block_size=BLOCK, save_dir=str(root / sub / side),
                       **kw, **extra)
    return out


@pytest.fixture(scope="module")
def estimated(project):
    return _run_both(project, "full_frame")


def _same_peaks(a, b):
    """Joints whose decoded peak is the same pixel in every view (or NaN in
    every view on both sides)."""
    same = (np.abs(a[:, :, :2] - b[:, :, :2]) < 1e-2).all(axis=2).all(axis=-1)
    return same | (np.isnan(a[:, :, 0]).all(-1) & np.isnan(b[:, :, 0]).all(-1))


def _hold_end_to_end(ref, out, min_share):
    """Layer 3 and the artifacts' shapes and dtypes."""
    for r, o in zip(ref, out):
        assert o.shape == r.shape and o.dtype == r.dtype == np.float32
    k2r, k2o = ref[0], out[0]
    assert k2o.shape == (N_FRAMES, 17, 3, 2) and ref[1].shape == (N_FRAMES, 2, 17, 6)
    assert np.isfinite(out[1]).all() and np.isfinite(k2o[:, :, 2]).all()
    conf_scale = np.abs(k2r[:, :, 2]).max()
    np.testing.assert_allclose(k2o[:, :, 2], k2r[:, :, 2], rtol=0, atol=5e-2 * conf_scale)
    same = _same_peaks(k2o, k2r)
    print("share of joints with the same peaks:", same.mean())
    assert same.mean() >= min_share, same.mean()
    both = same & np.isfinite(out[2]).all(-1) & np.isfinite(ref[2]).all(-1)
    assert both.sum() >= 5
    np.testing.assert_allclose(out[2][both], ref[2][both], rtol=1e-3, atol=1e-2)


def test_estimate_matches_jax(project, estimated):
    root = project[0]
    _hold_end_to_end(estimated["jax"], estimated["port"], min_share=0.5)
    for side in ("jax", "port"):
        for key, arr in zip(KEYS, estimated[side]):
            on_disk = np.load(root / "full_frame" / side / f"{key}.npy")
            np.testing.assert_array_equal(on_disk, arr)
            assert on_disk.dtype == arr.dtype


def test_estimate_reuses_artifacts(project, estimated):
    root, paths, ckpt = project
    gone = [p + ".missing" for p in paths]  # the reuse paths must not read the videos
    save = str(root / "full_frame" / "port")
    again = p_estimate(gone, project_dir=str(root), checkpoint=ckpt, save_dir=save, device="cpu")
    for a, b in zip(again, estimated["port"]):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(FileNotFoundError):
        p_estimate(gone, project_dir=str(root), pose_estimation_model="test_tiny",
                   checkpoint=ckpt, save_dir=save, overwrite=True, device="cpu")
    redo = p_estimate(paths, project_dir=str(root), pose_estimation_model="test_tiny",
                      checkpoint=ckpt, block_size=4, save_dir=save, overwrite=True,
                      device="cpu")
    for a, b in zip(redo, estimated["port"]):  # another block size, the same frames
        np.testing.assert_array_equal(a, b)
    with pytest.raises(NotImplementedError, match="Queue A item 11"):
        p_estimate(paths, project_dir=str(root), save_dir=save, live_preview_dir="x",
                   device="cpu")
    with pytest.raises(NotImplementedError):
        p_estimate(paths, project_dir=str(root), save_dir=save, mesh=object(), device="cpu")


@pytest.mark.parametrize("triangulation", ["top2", "nview"])
def test_cached_2d_reuse_matches_jax(tmp_path, triangulation):
    """kpts_2d.npy and heatmaps_2d.npy present, kpts_3d.npy not: both CLIs
    triangulate the cached 2D keypoints (3 cameras, distortion on)."""
    names = _write_cameras(tmp_path, 3)
    rng = np.random.default_rng(4)
    X = rng.uniform(-30, 30, (6 * 17, 3)) + np.array([0, 0, 300.0])
    kpts_2d = np.zeros((6, 17, 3, 3))
    for c, name in enumerate(names):
        _, (K, R, T, dist) = jio.get_params_from_name(
            name, str(tmp_path / "intrinsic_camera_parameters"),
            str(tmp_path / "extrinsic_camera_parameters"))
        uv = project_np(X, K, R, T.reshape(3), dist.reshape(-1))
        kpts_2d[:, :, :2, c] = (uv + rng.normal(0, 0.5, uv.shape)).reshape(6, 17, 2)
        kpts_2d[:, :, 2, c] = rng.uniform(0.3, 1.0, (6, 17))
    kpts_2d[rng.uniform(size=kpts_2d.shape[:2] + (1, 3)).repeat(3, 2) < 0.3] = np.nan
    heat = rng.normal(size=(6, 3, 17, 6))
    out = {}
    for side, fn, extra in (("jax", j_estimate, {}), ("port", p_estimate, {"device": "cpu"})):
        d = tmp_path / side
        d.mkdir()
        np.save(d / "kpts_2d.npy", kpts_2d)
        np.save(d / "heatmaps_2d.npy", heat)
        res = fn([str(d / "no_video.mp4")], project_dir=str(tmp_path), save_dir=str(d),
                 triangulation=triangulation, **extra)
        np.testing.assert_array_equal(res[0], kpts_2d)
        np.testing.assert_array_equal(np.load(d / "kpts_3d.npy"), res[2])
        out[side] = res[2]
    a, b = np.asarray(out["jax"]), out["port"]
    assert a.shape == b.shape == (6, 17, 3) and a.dtype == b.dtype == np.float64
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    assert 0.3 < np.isfinite(b).all(-1).mean() < 1.0
    np.testing.assert_allclose(b, a, rtol=1e-8, atol=1e-8)


def test_estimate_behind_rtmdet_matches_jax(project, tmp_path):
    """Both CLIs behind test_rtmdet_micro (top-1) from one JAX checkpoint:
    layer 3 as above, on the boxes each side's bf16 detector selected."""
    variables = random_variables(JRTMDet(**jreg.DETECTOR_REGISTRY["test_rtmdet_micro"]["cfg"]),
                                 (1, H, W, 3), seed=1)
    det_ckpt = str(tmp_path / "rtmdet.npz")
    jreg.save_checkpoint_npz(variables, det_ckpt)
    out = _run_both(project, "rtmdet", detector_model="test_rtmdet_micro",
                    detector_checkpoint=det_ckpt, detector_bbox_thr=0.0)
    _hold_end_to_end(out["jax"], out["port"], min_share=0.3)


def _refine_args(parser, run, project, params_yaml, extra=()):
    return parser().parse_args([
        "--run_path", str(run), "--refinement_types", "linear_interpolation", "SGD",
        "--kpts_3d", str(run / "kpts_3d.npy"), "--heatmaps_2d", str(run / "heatmaps_2d.npy"),
        "--extrinsic_params_dir", str(project / "extrinsic_camera_parameters"),
        "--intrinsic_params_dir", str(project / "intrinsic_camera_parameters"),
        "--refinement_params_yaml", params_yaml, "--ignore_body_lengths", *extra])


@pytest.mark.parametrize("auto_gate", [True, False])
def test_refine_matches_jax(tmp_path, rng, monkeypatch, capsys, auto_gate):
    """With the auto-gate on, this fixture's window sits below the 2D noise
    floor and is frozen on both sides (the report lines are compared); with
    it off, SGD moves the trajectory and both sides land within 1 mm."""
    run, project, traj, noisy = make_refinement_artifacts(tmp_path, rng)
    params = {"linear_interpolation": {"k": 3},
              "SGD": {"lr": 0.05, "max_iter": 100, "patience": 100, "lambda_smooth": 0.0,
                      "lambda_body_length": 0.0, "auto_gate": auto_gate}}
    params_yaml = str(tmp_path / "refine.yaml")
    with open(params_yaml, "w") as f:
        yaml.dump(params, f)
    monkeypatch.chdir(tmp_path)
    (run / "jax").mkdir()
    (run / "port").mkdir()
    ref = j_refine.run_refinement(_refine_args(j_refine.build_parser, run, project, params_yaml,
                                        ["--save_path", str(run / "jax")]))
    jax_lines = capsys.readouterr().out.splitlines()
    out = p_refine.run_refinement(_refine_args(
        p_refine.build_parser, run, project, params_yaml,
        ["--save_path", str(run / "port"), "--device", "cpu"]))
    port_lines = capsys.readouterr().out.splitlines()
    li_j = np.load(run / "jax" / "kpts_3d_linear_interpolation.npy")
    li_p = np.load(run / "port" / "kpts_3d_linear_interpolation.npy")
    assert li_p.shape == li_j.shape and li_p.dtype == li_j.dtype == np.float64
    np.testing.assert_allclose(li_p, li_j, rtol=1e-9, atol=1e-9)
    sgd_j, sgd_p = (np.load(run / s / "kpts_3d_SGD.npy") for s in ("jax", "port"))
    assert sgd_p.shape == sgd_j.shape == noisy.shape
    mpjpe = np.linalg.norm(sgd_p - sgd_j, axis=-1).mean()
    moved = np.linalg.norm(sgd_j - noisy, axis=-1).mean()
    print("SGD MPJPE port vs JAX:", mpjpe, "moved:", moved)
    assert mpjpe < 1.0 and (moved > 1.0) != auto_gate
    assert out["SGD_result"].n_iter == ref["SGD_result"].n_iter
    gate = [ln for ln in jax_lines if ln.startswith("auto-gate")]
    assert gate == [ln for ln in port_lines if ln.startswith("auto-gate")]
    assert bool(gate) == auto_gate
    assert sum(ln.startswith("mean and std of") for ln in port_lines) == 2
    assert any(ln.startswith("saving SGD refinement at") for ln in port_lines)


def test_refine_backfills_from_the_recording_log(tmp_path, rng, monkeypatch, capsys):
    """The run folder under <project>/<recordings>/<n>: the extrinsics from
    ``run_path/../..``, the intrinsics from the working directory, and the
    artifact paths from recording_log.yaml; through the package's
    ``refine`` command.  The result equals the run with every path given."""
    _, project, _, _ = make_refinement_artifacts(tmp_path, rng)
    run = project / "recordings" / "0"
    run.mkdir(parents=True)
    for name in ("kpts_3d.npy", "heatmaps_2d.npy"):
        os.replace(project / "run" / name, run / name)
    pio.write_recording_log(str(run), ["a.mp4", "b.mp4"], "test_tiny", "full_frame")
    monkeypatch.chdir(project)
    common = ["--refinement_types", "SGD", "--ignore_body_lengths", "--device", "cpu"]
    port_main.main(["refine", "--run_path", str(run), *common])
    backfilled = np.load(run / "kpts_3d_SGD.npy")
    explicit = p_refine.run_refinement(p_refine.build_parser().parse_args([
        "--run_path", str(run), "--kpts_3d", str(run / "kpts_3d.npy"),
        "--heatmaps_2d", str(run / "heatmaps_2d.npy"),
        "--extrinsic_params_dir", str(project / "extrinsic_camera_parameters"),
        "--intrinsic_params_dir", str(project / "intrinsic_camera_parameters"), *common]))
    np.testing.assert_array_equal(backfilled, explicit["SGD"])
    capsys.readouterr()
    for argv in (["plot"], ["nope"]):
        with pytest.raises(SystemExit) as exc:
            port_main.main(argv)
        assert exc.value.code == 2
    assert "not ported yet" in capsys.readouterr().err

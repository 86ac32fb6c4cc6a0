"""The port's block pipeline over a 2-rank mesh, against the JAX package's
`make_mesh(8)` pipeline and the port's own one-device run.

One gloo group of two CPU processes for the module (`run_ranks`): each rank
is given the whole block, runs its half and returns the whole block's
outputs; the JAX side runs in this process on its 8 virtual devices.

- ``tests/test_parallel.py``'s SMALL HRNet in float32 (frames (8, 2, 120,
  160, 3)): the mesh run against the port's ``mesh=None`` at rtol 5e-4 /
  atol 1e-4 (JAX's own limit there; kpts_3d at atol 2e-5 of its largest
  coordinate, below).  The same for RTMPose's SimCC path,
  the n-view path and Swin with the block kernels' plain versions (bf16).
- Against JAX: HRNet (top-2 and n-view) and Swin in float64 (frames and
  models; the pipelines cast float32 frames to bf16 before the crop
  resample, whose roundings differ between the two implementations), on a
  rig of two cameras converging at 300: 2D outputs and covariances at rtol
  5e-4 / atol 1e-4, kpts_3d at rtol 5e-4 / atol 2e-5 of the largest
  coordinate (both sides solve the DLT in float32, whose error grows with
  the point's distance, not with each coordinate).  Swin at the rtol of
  JAX's own sharded Swin test, 5e-3, and atol 1e-3 (the f32 raw moments of
  its flat maps cancel in the covariances).
- Consistent selection (RTMDet micro, top-4, window 9 over T=8) across the
  shard boundary equals ``mesh=None``; each half selected alone differs.
- `run_clips_batched`, split and unsplit, against ``mesh=None``.
- The estimate CLI with a mesh: rank 0's artifacts equal ``mesh=None``'s.
- The synthetic accuracy harness with a mesh: both ranks report the metrics
  of the one-device run.
"""

import os

import numpy as np
import pytest
import torch

from multi_camera_3d_pose_estimation_tpu_torch.parallel import (ShardedPosePipeline,
                                                                run_clips_batched)

from tests._torch_port_util import run_ranks

KEYS = ("kpts_2d", "heatmaps_2d", "kpts_3d")
SMALL = {"widths": (8, 16, 32, 64), "modules": (1, 1, 1, 1), "stem": 16}
RTM = {"widen": 0.125, "deepen": 0.167, "embed": 32}
SWIN = {"embed": 24, "depths": (1, 1), "heads": (2, 4), "window": 4, "mlp_ratio": 2,
        "deconv": (16,)}
INPUT = (32, 64)
C = 2


def _parallel_rig():
    """``tests/test_parallel.py``'s cameras: parallel, 30 apart."""
    return {"K": np.tile(np.array([[300.0, 0, 80.0], [0, 300.0, 60.0], [0, 0, 1]]), (C, 1, 1)),
            "R": np.stack([np.eye(3)] * C),
            "T": np.stack([np.zeros(3), np.array([-30.0, 0, 0])]), "dist": np.zeros((C, 5))}


def _converging_rig():
    """Two cameras yawed ±15° looking at the origin from 300."""
    th = np.deg2rad([-15.0, 15.0])
    R = [[[np.cos(t), 0, np.sin(t)], [0, 1, 0], [-np.sin(t), 0, np.cos(t)]] for t in th]
    return {"K": np.tile(np.array([[300.0, 0, 80.0], [0, 300.0, 60.0], [0, 0, 1]]), (C, 1, 1)),
            "R": np.asarray(R), "T": np.tile([0.0, 0, 300.0], (C, 1)), "dist": np.zeros((C, 5))}


def _frames(seed, shape=(8, C, 120, 160, 3)):
    return np.random.default_rng(seed).uniform(size=shape)


def _est(family, cfg, out_dir, dtype, decode="heatmap", **kw):
    from multi_camera_3d_pose_estimation_tpu_torch.models import TopDownEstimator
    from multi_camera_3d_pose_estimation_tpu_torch.models.registry import build_model

    model = build_model(family, cfg, "cpu", checkpoint=os.path.join(out_dir, f"{family}.npz"),
                        input_size=INPUT, dtype=dtype).to(dtype)
    return TopDownEstimator(model, input_size=INPUT, decode=decode, device="cpu", **kw)


def _numpy(out):
    return {k: v.numpy() for k, v in out.items()}


def _write_project(root):
    """Two cameras with their files and 8-frame videos (cv2), as
    ``tests/test_torch_port_cli.py`` writes them."""
    import cv2

    from multi_camera_3d_pose_estimation_tpu_torch import io as pio

    K = np.array([[300.0, 0, 80.0], [0, 300.0, 64.0], [0, 0, 1]])
    names = ["cam0", "cam1"]
    for c, name in enumerate(names):
        th = np.deg2rad(-10 + 20 * c)
        R = np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0], [-np.sin(th), 0, np.cos(th)]])
        pio.save_camera_intrinsics(K, np.zeros((1, 5)), name, root_path=root)
        pio.save_extrinsic_calibration_parameters(R, np.array([[20.0 * c - 10], [0.0], [0.0]]),
                                                  name, root_dir=root)
    pio.save_camera_names(dict(enumerate(names)), names[0], root)
    rng = np.random.default_rng(0)
    paths = []
    for c in range(2):
        p = os.path.join(root, f"cam{c}_synced.mp4")
        vw = cv2.VideoWriter(p, cv2.VideoWriter_fourcc(*"mp4v"), 15.0, (160, 128))
        for _ in range(8):
            vw.write(rng.integers(0, 256, (128, 160, 3), dtype=np.uint8))
        vw.release()
        paths.append(p)
    return paths


def _rank_main(rank, world, address, out_dir):
    """One rank: every pipeline on the mesh, and on one device beside it."""
    from multi_camera_3d_pose_estimation_tpu_torch.cli.estimate import estimate_pose_from_video
    from multi_camera_3d_pose_estimation_tpu_torch.entry import build_pipeline
    from multi_camera_3d_pose_estimation_tpu_torch.parallel import init_distributed, make_mesh
    from multi_camera_3d_pose_estimation_tpu_torch.training import run_accuracy_harness

    init_distributed(address, world, rank, device="cpu")
    mesh = make_mesh(device="cpu")
    res = {}

    def both(name, est, rig, frames, **kw):
        for tag, m in (("mesh", mesh), ("none", None)):
            pipe = ShardedPosePipeline(est, rig, mesh=m, device="cpu", **kw)
            res[f"{name}_{tag}"] = _numpy(pipe.run(frames))

    f32 = _frames(0).astype(np.float32)
    both("hrnet", _est("hrnet", SMALL, out_dir, torch.float32), _parallel_rig(), f32)
    both("simcc", _est("rtmpose", RTM, out_dir, torch.float32, decode="simcc"),
         _parallel_rig(), _frames(1, (8, C, 96, 96, 3)).astype(np.float32), conf_threshold=-1.0)
    both("nview", _est("hrnet", SMALL, out_dir, torch.float32), _converging_rig(), f32,
         triangulation="nview")
    both("swin", _est("swin", SWIN, out_dir, torch.bfloat16), _converging_rig(), f32)
    f64 = _frames(2)
    for name, family, cfg, kw in (("hrnet64", "hrnet", SMALL, {}),
                                  ("nview64", "hrnet", SMALL, {"triangulation": "nview"}),
                                  ("swin64", "swin", SWIN, {})):
        pipe = ShardedPosePipeline(_est(family, cfg, out_dir, torch.float64), _converging_rig(),
                                   mesh=mesh, device="cpu", **kw)
        res[name] = _numpy(pipe.run(f64))

    # Consistent selection across the shard boundary.
    shape = (8, C, 64, 96, 3)
    frames = np.random.default_rng(3).integers(0, 256, shape, dtype=np.uint8)
    pipes = {m: build_pipeline(SMALL, INPUT, shape, device="cpu", seed=0,
                               detector="test_rtmdet_micro", detector_select="consistent")
             for m in ("mesh", "none")}
    pipes["mesh"] = ShardedPosePipeline(pipes["mesh"].estimator, pipes["mesh"].cam_stack,
                                        mesh=mesh, detector=pipes["mesh"].detector, device="cpu")
    for tag, pipe in pipes.items():
        boxes, score, kept = pipe.detect(frames)
        res[f"select_{tag}"] = {"boxes": boxes.numpy(), "score": score.numpy(),
                                "kept": kept.numpy()}
        res[f"select_run_{tag}"] = _numpy(pipe.run(frames))
    halves = [pipes["none"].detect(frames[:4]), pipes["none"].detect(frames[4:])]
    res["select_halves"] = {"boxes": torch.cat([h[0] for h in halves]).numpy(),
                            "score": torch.cat([h[1] for h in halves]).numpy()}

    # Clips folded into time.
    clips = _frames(4, (2, 4, C, 64, 64, 3)).astype(np.float32)
    est = _est("hrnet", SMALL, out_dir, torch.float32)
    for tag, m in (("mesh", mesh), ("none", None)):
        pipe = ShardedPosePipeline(est, _parallel_rig(), mesh=m, device="cpu")
        res[f"clips_stacked_{tag}"] = _numpy(run_clips_batched(pipe, clips, split=False))
        res[f"clips_split_{tag}"] = [_numpy(r) for r in run_clips_batched(pipe, clips)]

    # The estimate CLI: every rank reads the videos, rank 0 writes.
    project = os.path.join(out_dir, "project")
    paths = [os.path.join(project, f"cam{c}_synced.mp4") for c in range(2)]
    kw = dict(project_dir=project, pose_estimation_model="test_tiny", block_size=4,
              device="cpu")
    res["cli_mesh"] = estimate_pose_from_video(paths, save_dir=os.path.join(out_dir, "cli_mesh"),
                                               mesh=mesh, **kw)
    if rank == 0:
        res["cli_none"] = estimate_pose_from_video(
            paths, save_dir=os.path.join(out_dir, "cli_none"), **kw)

    # The harness deploys over the mesh.
    hk = dict(n_frames=2, det_steps=2, pose_steps=2, pose_model_name="test_tiny", device="cpu")
    res["harness_mesh"] = run_accuracy_harness(mesh=mesh, **hk)
    res["harness_none"] = run_accuracy_harness(**hk)
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Write the checkpoints (the JAX package's random variables) and the
    project, run the two ranks, and return their results."""
    pytest.importorskip("cv2")
    from multi_camera_3d_pose_estimation_tpu.models import HRNet as JHRNet
    from multi_camera_3d_pose_estimation_tpu.models import RTMPose as JRTMPose
    from multi_camera_3d_pose_estimation_tpu.models import SwinPose as JSwin
    from multi_camera_3d_pose_estimation_tpu.models import registry as jreg

    from tests._torch_port_util import random_variables

    out = tmp_path_factory.mktemp("parallel_pipeline")
    variables = {}
    for family, module in (("hrnet", JHRNet(num_joints=17, cfg=SMALL)),
                           ("rtmpose", JRTMPose(num_joints=17, input_size=INPUT, cfg=RTM)),
                           ("swin", JSwin(num_joints=17, cfg=SWIN))):
        variables[family] = random_variables(module, (1, INPUT[1], INPUT[0], 3), seed=0)
        jreg.save_checkpoint_npz(variables[family], str(out / f"{family}.npz"))
    os.makedirs(out / "project")
    _write_project(str(out / "project"))
    run_ranks(__file__, "_rank_main", 2, out)
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(2)], variables, out


def _close(a, b, rtol=5e-4, atol=1e-4, what=""):
    """Equal within rtol / atol; kpts_3d's atol is 2e-5 of its largest
    coordinate where atol is not 0 (the float32 DLT)."""
    for k in KEYS:
        assert a[k].shape == b[k].shape, (what, k)
        tol = atol if k != "kpts_3d" or atol == 0 else 2e-5 * np.nanmax(np.abs(b[k]))
        np.testing.assert_allclose(a[k], b[k], rtol=rtol, atol=tol, equal_nan=True,
                                   err_msg=f"{what} {k}")


@pytest.mark.parametrize("name", ["hrnet", "simcc", "nview", "swin"])
def test_mesh_pipeline_matches_one_device(ranks, name):
    res, _, _ = ranks
    for r in res:
        _close(r[f"{name}_mesh"], r[f"{name}_none"], what=name)
        _close(r[f"{name}_mesh"], res[0][f"{name}_mesh"], rtol=0, atol=0, what=name)
    assert res[0][f"{name}_mesh"]["kpts_2d"].shape == (8, 17, 3, C)


@pytest.mark.parametrize("name,family,kw,tol", [("hrnet64", "hrnet", {}, 5e-4),
                                                ("nview64", "hrnet", {"triangulation": "nview"},
                                                 5e-4),
                                                ("swin64", "swin", {}, 5e-3)])
def test_mesh_pipeline_matches_jax_mesh(ranks, name, family, kw, tol):
    import jax
    import jax.numpy as jnp

    from multi_camera_3d_pose_estimation_tpu.models import HRNet as JHRNet
    from multi_camera_3d_pose_estimation_tpu.models import SwinPose as JSwin
    from multi_camera_3d_pose_estimation_tpu.models import TopDownEstimator as JEstimator
    from multi_camera_3d_pose_estimation_tpu.parallel import ShardedPosePipeline as JPipeline
    from multi_camera_3d_pose_estimation_tpu.parallel import make_mesh as j_make_mesh

    res, variables, _ = ranks
    module = (JHRNet(num_joints=17, cfg=SMALL, dtype=jnp.float64) if family == "hrnet"
              else JSwin(num_joints=17, cfg=SWIN, dtype=jnp.float64))
    v = jax.tree.map(lambda a: np.asarray(a, np.float64), variables[family])
    pipe = JPipeline(JEstimator(module, v, input_size=INPUT), _converging_rig(),
                     mesh=j_make_mesh(8), **kw)
    ref = {k: np.asarray(x) for k, x in pipe.run(_frames(2)).items()}
    out = res[0][name]
    assert np.isfinite(ref["kpts_3d"]).any()
    _close(out, ref, rtol=tol, atol=tol / 5, what=name)
    _close(res[1][name], out, rtol=0, atol=0)


def test_consistent_selection_across_the_shard_boundary(ranks):
    res, _, _ = ranks
    for r in res:
        for k in ("boxes", "score", "kept"):
            np.testing.assert_array_equal(r["select_mesh"][k], r["select_none"][k], err_msg=k)
        _close(r["select_run_mesh"], r["select_run_none"], rtol=0, atol=0, what="run")
    kept = res[0]["select_none"]["kept"]
    assert kept.any()
    # The control: each half selected alone picks other candidates.
    halves, whole = res[0]["select_halves"], res[0]["select_none"]
    differ = np.any(halves["boxes"] != whole["boxes"], axis=-1)
    print("frames x cameras whose box differs when each half is selected alone:", differ.sum())
    assert differ.any()


def test_run_clips_batched_on_a_mesh(ranks):
    res, _, _ = ranks
    for r in res:
        mesh, none = r["clips_stacked_mesh"], r["clips_stacked_none"]
        assert mesh["kpts_3d"].shape == (2, 4, 17, 3)
        _close(mesh, none, what="stacked")
        for i in range(2):
            _close(r["clips_split_mesh"][i], {k: v[i] for k, v in mesh.items()}, rtol=0, atol=0)
            _close(r["clips_split_none"][i], {k: v[i] for k, v in none.items()}, rtol=0, atol=0)


def test_estimate_cli_on_a_mesh(ranks):
    res, _, out = ranks
    none = res[0]["cli_none"]
    for r in res:
        for a, b in zip(r["cli_mesh"], none):
            np.testing.assert_allclose(a, b, rtol=5e-4, atol=1e-4, equal_nan=True)
    for k, ref in zip(KEYS, none):
        on_disk = np.load(out / "cli_mesh" / f"{k}.npy")
        np.testing.assert_array_equal(on_disk, res[0]["cli_mesh"][KEYS.index(k)])
        np.testing.assert_allclose(on_disk, np.load(out / "cli_none" / f"{k}.npy"), rtol=5e-4,
                                   atol=1e-4, equal_nan=True)
        assert on_disk.shape[0] == 8 and ref.shape == on_disk.shape


def test_accuracy_harness_on_a_mesh(ranks):
    res, _, _ = ranks
    for r in res:
        mesh, none = r["harness_mesh"], r["harness_none"]
        for k in ("mpjpe_3d", "px_err_2d", "det_tight_frac"):
            np.testing.assert_allclose(mesh[k], none[k], rtol=5e-4, equal_nan=True, err_msg=k)
        assert mesh["mpjpe_3d"] == res[0]["harness_mesh"]["mpjpe_3d"]


def test_donate_frames_is_accepted():
    """JAX's ``donate_frames`` keyword: accepted, nothing changes."""
    from multi_camera_3d_pose_estimation_tpu_torch.entry import build_pipeline

    pipe = build_pipeline(SMALL, INPUT, (2, C, 64, 64, 3), device="cpu")
    donated = ShardedPosePipeline(pipe.estimator, pipe.cam_stack, donate_frames=True,
                                  device="cpu")
    assert donated.donate_frames
    frames = np.random.default_rng(6).integers(0, 256, (2, C, 64, 64, 3), dtype=np.uint8)
    _close(_numpy(donated.run(frames)), _numpy(pipe.run(frames)), rtol=0, atol=0)

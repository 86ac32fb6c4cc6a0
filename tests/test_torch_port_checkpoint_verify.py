"""The port's checkpoint drill and its copy of the MMPose/MMDet mirrors.

- The mirrors' copy (``models/mirrors``, the three pose families and the
  RTMDet and YOLOX detectors): for the same config, the JAX package's
  mirror's ``state_dict`` keys, order and shapes, and, with the same
  ``randomize_`` seed, the same values and forward bit for bit (float32,
  CPU; the detectors' decoded boxes and scores).
- The drill (`models.checkpoint_verify`) on the CPU, as
  ``tests/test_torch_parity.py`` holds the JAX drill: it passes at every
  stage on a random checkpoint of each family (at the JAX drill's 2e-3,
  with the JAX drill's cut points), localises a planted converter bug (the
  square attention ``proj`` imported untransposed) at ``stage0``, and
  refuses a drifted ``qkv`` shape without loading.
"""

import importlib

import numpy as np
import pytest
import torch

from multi_camera_3d_pose_estimation_tpu_torch.models import checkpoint_verify as pcv_verify
from multi_camera_3d_pose_estimation_tpu_torch.models import convert

from tests._torch_port_util import SMALL_PTH, jax_mirror, port_detector_mirror, write_pth

POSE = ["hrnet", "swin", "rtmpose"]
CLASSES = {"hrnet": "MMPoseHRNet", "swin": "MMPoseSwin", "rtmpose": "MMPoseRTMPose"}


def _port_mirror(family, cfg):
    if family in ("yolox", "rtmdet"):
        return port_detector_mirror(family, cfg)
    mod = importlib.import_module(
        f"multi_camera_3d_pose_estimation_tpu_torch.models.mirrors.{family}")
    kw = {"input_size": (32, 64)} if family == "rtmpose" else {}
    return getattr(mod, CLASSES[family])(cfg, num_joints=17, **kw), mod.randomize_


@pytest.mark.parametrize("family", POSE + ["rtmdet", "yolox"])
def test_mirror_copy_equals_the_jax_mirror(family):
    cfg, shape = SMALL_PTH[family]
    jm, jrand = jax_mirror(family, cfg)
    pm, prand = _port_mirror(family, cfg)
    jrand(jm, seed=11)
    prand(pm, seed=11)
    a, b = jm.state_dict(), pm.state_dict()
    assert list(a) == list(b)
    assert all(a[k].shape == b[k].shape and torch.equal(a[k], b[k]) for k in a)
    x = np.random.default_rng(0).uniform(size=(2, 3) + shape[1:3]).astype(np.float32)
    with torch.no_grad():
        ja, pa = jm.eval()(torch.from_numpy(x)), pm.eval()(torch.from_numpy(x))
    ja, pa = (ja, pa) if family not in POSE[:2] else ((ja,), (pa,))
    assert len(ja) == len(pa) and all(torch.equal(u, v) for u, v in zip(ja, pa))


@pytest.mark.parametrize("family", POSE)
def test_drill_passes_per_stage(family, tmp_path):
    cfg = SMALL_PTH[family][0]
    path = write_pth(tmp_path / f"{family}.pth", family, cfg, seed=7)
    report = pcv_verify.verify_checkpoint(path, family, cfg=cfg, input_size=(32, 64),
                                          device="cpu")
    text = pcv_verify.format_report(report)
    assert report["converted"] and report["ok"], text
    assert set(report) == {"family", "path", "converted", "n_values", "stages", "ok"}
    n_stages = {"hrnet": 5, "swin": 3, "rtmpose": 5}[family]
    assert len(report["stages"]) == n_stages + 1, text  # the cut points, then the outputs
    assert all(np.isfinite(s["rel"]) and s["rel"] <= pcv_verify._REL_TOL
               for s in report["stages"]), text
    model = convert.TORCH_LOADERS[family](
        pcv_verify.new_model(family, cfg, "cpu", (32, 64), 17, torch.float32), path, cfg)
    assert report["n_values"] == sum(p.numel() for p in model.parameters()) + sum(
        b.numel() for k, b in model.named_buffers() if k.endswith(("running_mean", "running_var")))
    assert "VERIFY: PASS" in text


def test_drill_localises_a_planted_converter_bug(tmp_path, monkeypatch):
    """The square ``proj`` weight imported untransposed passes every shape
    check; only the forwards can catch it, first at stage 0."""
    cfg = SMALL_PTH["swin"][0]
    path = write_pth(tmp_path / "swin.pth", "swin", cfg, seed=8)
    monkeypatch.setattr(convert, "_linear_w",
                        lambda a: a if a.shape[0] == a.shape[1] else np.transpose(a))
    report = pcv_verify.verify_checkpoint(path, "swin", cfg=cfg, input_size=(32, 64),
                                          device="cpu")
    assert report["converted"] and not report["ok"]
    first_bad = next(s for s in report["stages"] if not s["ok"])
    assert first_bad["stage"].startswith("stage0"), report["stages"]
    assert "VERIFY: FAIL" in pcv_verify.format_report(report)


def test_drill_refuses_shape_drift(tmp_path):
    cfg = SMALL_PTH["swin"][0]

    def drift(state):
        k = next(k for k in state if k.endswith("qkv.weight"))
        state[k] = torch.zeros(state[k].shape[0] * 2, state[k].shape[1])
        return state

    path = write_pth(tmp_path / "swin.pth", "swin", cfg, seed=9, edit=drift)
    report = pcv_verify.verify_checkpoint(path, "swin", cfg=cfg, input_size=(32, 64),
                                          device="cpu")
    assert not report["converted"] and not report["ok"]
    assert "mismatch" in report["error"]
    assert "CONVERSION REFUSED" in pcv_verify.format_report(report)

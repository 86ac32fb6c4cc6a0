"""The port's builders take the JAX builders' keywords.

``build_estimator(dtype=, use_pallas_attention=, use_pallas_stage1=)`` and
``build_detector(dtype=, input_hw=)``: both packages' builders are called
with the same keywords on the same JAX ``.npz`` checkpoint (seeded by
``tests/_torch_port_util.py``'s ``random_variables``), and the float32
forwards agree within 1e-4 (the boxes at atol 2e-3, as in
``tests/test_torch_parity.py``); with ``use_pallas_stage1`` the stage-1
chain runs through each package's kernel path (JAX's Pallas kernel in
interpret mode, the port's plain version on the CPU).
``use_pallas_attention`` on a non-Swin model raises ``ValueError`` in both,
and a CenterNet ``.pth`` does too (neither package converts CenterNet).
The JAX side's variables come from ``jax.eval_shape`` (`fast_flax_init`):
the checkpoint overwrites every leaf.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_camera_3d_pose_estimation_tpu.models import detector as jdet
from multi_camera_3d_pose_estimation_tpu.models import registry as jreg
from multi_camera_3d_pose_estimation_tpu.models.hrnet import HRNet as JHRNet
from multi_camera_3d_pose_estimation_tpu.models.rtmdet import RTMDet as JRTMDet
from multi_camera_3d_pose_estimation_tpu.models.rtmpose import RTMPose as JRTMPose
from multi_camera_3d_pose_estimation_tpu.models.swin import SwinPose as JSwinPose
from multi_camera_3d_pose_estimation_tpu.models.yolox import YOLOX as JYOLOX
from multi_camera_3d_pose_estimation_tpu_torch.models import registry

from tests._torch_port_util import fast_flax_init, random_variables

JAX_CLASSES = (JHRNet, JSwinPose, JRTMPose, JRTMDet, JYOLOX, jdet.CenterNetDetector)


@pytest.fixture
def fast_init(monkeypatch):
    fast_flax_init(monkeypatch, *JAX_CLASSES)


def _estimator_ckpt(name, path):
    spec = jreg.MODEL_REGISTRY[name]
    w, h = spec["input_size"]
    cls = JHRNet if spec["family"] == "hrnet" else JSwinPose
    jreg.save_checkpoint_npz(random_variables(cls(num_joints=17, cfg=spec["cfg"]), (1, h, w, 3),
                                              seed=3), path)
    return str(path), (w, h)


@pytest.mark.parametrize("name,kw", [
    ("test_tiny", {}),
    ("test_tiny", {"use_pallas_stage1": True}),
    ("test_swin_128", {"use_pallas_attention": False}),
])
def test_build_estimator_keywords_match_jax(name, kw, tmp_path, fast_init):
    path, (w, h) = _estimator_ckpt(name, tmp_path / "m.npz")
    j = jreg.build_estimator(name, checkpoint=path, dtype=jnp.float32, **kw)
    p = registry.build_estimator(name, checkpoint=path, dtype=torch.float32, device="cpu", **kw)
    assert p.model.dtype == torch.float32
    x = np.random.default_rng(0).uniform(-1, 1, (2, h, w, 3)).astype(np.float32)
    if name == "test_swin_128":
        assert p.model.backbone.mode is False
        ref = jax.jit(j.model.apply)(j.variables, jnp.asarray(x))
        with torch.no_grad():
            out = p.model(torch.from_numpy(x))
    else:
        fused = kw.get("use_pallas_stage1", False)
        assert (j._fused_stage1 is not None) == (p.fused_stage1 is not None) == fused
        extra = {"fused_stage1": j._fused_stage1} if fused else {}
        ref = jax.jit(partial(j.model.apply, **extra))(j.variables, jnp.asarray(x))
        with torch.no_grad():
            out = p.model(torch.from_numpy(x).permute(0, 3, 1, 2), fused_stage1=p.fused_stage1)
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(), np.asarray(ref),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", ["test_tiny", "coco_rtmpose-t"])
def test_pallas_attention_off_swin_raises_in_both(name):
    for build in (jreg.build_estimator, lambda n, **k: registry.build_estimator(n, device="cpu",
                                                                               **k)):
        with pytest.raises(ValueError, match="swin"):
            build(name, use_pallas_attention=True)


@pytest.mark.parametrize("name", ["test_rtmdet_micro", "test_yolox_micro", "test_centernet_w8"])
def test_build_detector_keywords_match_jax(name, tmp_path, fast_init):
    spec = jreg.DETECTOR_REGISTRY[name]
    module = (jdet.CenterNetDetector(width=spec["width"]) if "width" in spec
              else (JRTMDet if spec["family"] == "rtmdet" else JYOLOX)(**spec["cfg"]))
    path = str(tmp_path / "det.npz")
    jreg.save_checkpoint_npz(random_variables(module, (1, 64, 96, 3), seed=4), path)
    j = jreg.build_detector(name, checkpoint=path, dtype=jnp.float32, input_hw=(64, 96))
    p = registry.build_detector(name, checkpoint=path, dtype=torch.float32, input_hw=(64, 96),
                                device="cpu")
    assert p.model.dtype == torch.float32
    x = np.random.default_rng(1).uniform(0, 1, (2, 64, 96, 3)).astype(np.float32)
    ref = jax.jit(j.model.apply)(j.variables, jnp.asarray(x))
    with torch.no_grad():
        out = p.model(torch.from_numpy(x).permute(0, 3, 1, 2))
    keys = [k for k in ref if k in out and k != "raw"]
    assert keys
    for k in keys:
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), rtol=1e-4,
                                   atol=2e-3 if k.startswith("box") else 1e-4)


def test_centernet_pth_raises_in_both(tmp_path, fast_init):
    path = tmp_path / "centernet.pth"
    torch.save({"state_dict": {}}, str(path))
    for build in (jreg.build_detector, lambda n, **k: registry.build_detector(n, device="cpu",
                                                                             **k)):
        with pytest.raises(ValueError, match="not implemented for centernet"):
            build("test_centernet_w8", checkpoint=str(path))

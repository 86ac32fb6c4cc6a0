"""HRNet-W48 and Swin-L, the registry's other two heatmap models, against
the JAX package at their published widths (depth cut, small input).

- HRNet with W48's widths and stem (48, 96, 192, 384; 64), one module per
  stage, in float32 at 1e-4 (the converters' tolerance), stage 1 as the
  Bottleneck modules and as the BN-folded plain chain that the stage-1
  kernel computes on the card (`HRNet.stage1_blocks`, reached by patching
  the kernel rule, `runs_kernels`, to hold in f32).
- Swin with Swin-L's embed and heads (192; 6, 12, 24, 48: head dim 32) at
  depths (2, 2, 2, 2), input (w, h) = (64, 96): float32 at 1e-4 on the
  plain path and on the block kernels' path (the rule patched as above),
  and bf16 inference (the port's swin_gemm and window-attention kernels as
  their plain versions) against the JAX
  package's Pallas ``"block"`` in interpret mode at 2e-2 of the maps'
  largest value, as ``tests/test_torch_port_swin_model.py`` holds Swin-B's.
- The converters' keys and shapes at the full W48 and Swin-L trees (on
  the abstract flax tree: no weights are drawn), and the registry's
  configurations equal to the JAX package's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_camera_3d_pose_estimation_tpu.models import registry as jreg
from multi_camera_3d_pose_estimation_tpu.models.hrnet import HRNet as JHRNet
from multi_camera_3d_pose_estimation_tpu.models.swin import SwinPose as JSwinPose
from multi_camera_3d_pose_estimation_tpu_torch.models import hrnet as port_hrnet
from multi_camera_3d_pose_estimation_tpu_torch.models import registry
from multi_camera_3d_pose_estimation_tpu_torch.models import swin as port_swin
from multi_camera_3d_pose_estimation_tpu_torch.models.convert import (hrnet_state_dict_from_flax,
                                                                     load_hrnet_from_flax,
                                                                     load_swin_from_flax,
                                                                     swin_state_dict_from_flax)
from multi_camera_3d_pose_estimation_tpu_torch.models.hrnet import HRNET_W48, HRNet
from multi_camera_3d_pose_estimation_tpu_torch.models.swin import SWIN_L, SwinPose

from tests._torch_port_util import random_variables

W48_CUT = dict(HRNET_W48, modules=(1, 1, 1, 1))
SWIN_L_CUT = dict(SWIN_L, depths=(2, 2, 2, 2))
SWIN_INPUT = (64, 96)  # (w, h): stage maps 24x16, 12x8, 6x4, 3x2, each padded to window 7


@pytest.fixture(scope="module")
def w48():
    model = JHRNet(num_joints=17, cfg=W48_CUT, dtype=jnp.float32)
    v = random_variables(model, (1, 64, 64, 3), seed=1)
    x = np.random.default_rng(4).normal(size=(2, 64, 64, 3)).astype(np.float32)
    ref = np.moveaxis(np.asarray(jax.jit(model.apply)(v, x)), -1, 1)  # (B, K, h, w)
    return v, x, ref


@pytest.mark.parametrize("stage1", ["modules", "plain_chain"])
def test_hrnet_w48_widths_match_flax_f32(w48, stage1, monkeypatch):
    v, x, ref = w48
    model = load_hrnet_from_flax(HRNet(17, W48_CUT, dtype=torch.float32, device="cpu"), v).eval()
    if stage1 == "plain_chain":
        monkeypatch.setattr(port_hrnet, "runs_kernels", lambda *a, **k: True)
    with torch.no_grad():
        out = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert out.dtype == torch.float32 and out.shape == ref.shape == (2, 17, 16, 16)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def swin_l():
    v = random_variables(JSwinPose(num_joints=17, cfg=SWIN_L_CUT),
                         (1, SWIN_INPUT[1], SWIN_INPUT[0], 3), seed=1)
    x = np.random.default_rng(4).normal(size=(2, SWIN_INPUT[1], SWIN_INPUT[0], 3)).astype(
        np.float32)
    ref = jax.jit(JSwinPose(num_joints=17, cfg=SWIN_L_CUT, dtype=jnp.float32).apply)(
        v, jnp.asarray(x))
    return v, x, np.moveaxis(np.asarray(ref), -1, 1)


def _swin_port(v, dtype=torch.float32):
    model = SwinPose(17, SWIN_L_CUT, dtype=dtype, device="cpu")
    return load_swin_from_flax(model, v).eval()


@pytest.mark.parametrize("mode", ["block", False])
def test_swin_l_widths_match_flax_f32(swin_l, mode, monkeypatch):
    v, x, ref = swin_l
    if mode == "block":  # the block kernels' plain versions, in f32
        monkeypatch.setattr(port_swin, "runs_kernels", lambda *a, **k: True)
    with torch.no_grad():
        out = _swin_port(v)(torch.from_numpy(x))
    assert out.dtype == torch.float32 and out.shape == ref.shape == (2, 17, 24, 16)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4, atol=1e-4)


def test_swin_l_widths_bf16_block_match_pallas_block(swin_l):
    v, x, _ = swin_l
    ref = jax.jit(JSwinPose(num_joints=17, cfg=SWIN_L_CUT, use_pallas_attention="block").apply)(
        v, jnp.asarray(x))
    ref = np.moveaxis(np.asarray(ref), -1, 1)
    with torch.no_grad():
        out = _swin_port(v, torch.bfloat16)(torch.from_numpy(x))
    err = np.abs(out.numpy() - ref).max() / np.abs(ref).max()
    print("bf16 block heatmap error / scale:", err)
    assert err <= 2e-2


@pytest.mark.parametrize("name", ["coco_hrnet_w48", "coco_swin-l"])
def test_state_dict_covers_flax_tree_at_published_width(name):
    """At the full published width and depth the converter's keys and shapes
    are exactly the model's (on the abstract flax tree; no weights are
    drawn), and the registry's entry is the JAX package's."""
    spec, jspec = registry.MODEL_REGISTRY[name], jreg.MODEL_REGISTRY[name]
    assert spec["cfg"] == jspec["cfg"] and spec["input_size"] == jspec["input_size"]
    w, h = spec["input_size"]
    if spec["family"] == "hrnet":
        module, convert = JHRNet(num_joints=17, cfg=spec["cfg"]), hrnet_state_dict_from_flax
        want = HRNet(17, spec["cfg"], device="meta").state_dict()
    else:
        module, convert = JSwinPose(num_joints=17, cfg=spec["cfg"]), swin_state_dict_from_flax
        want = SwinPose(17, spec["cfg"], device="meta").state_dict()
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), jnp.zeros((1, h, w, 3))))
    sd = convert(jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes))
    assert set(sd) == set(want)
    assert all(tuple(sd[k].shape) == tuple(want[k].shape) for k in sd)

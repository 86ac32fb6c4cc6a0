"""The port's SwinPose, loaded through the flax converter, against flax SwinPose.

A small config with window 7, head dim 32 and both stages padded and
shifted: embed 64, depths (2, 2), heads (2, 4), input (w, h) = (64, 96)
(stage maps 24x16 -> 28x21 and 12x8 -> 14x14 after padding).

- float32, the plain path and the block kernels' plain versions (reached
  by patching the kernel rule, `runs_kernels`, to hold in f32) against the
  flax einsum path at 1e-4 (the converters' tolerance: the same
  arithmetic, sums in another order);
- bf16 inference, the block kernels' path, against flax
  ``use_pallas_attention="block"`` (Pallas interpret mode) at 2e-2 of the
  maps' largest value, as
  the JAX package holds its own block path against its einsum path: bf16
  roundings in other places compound through 4 blocks and the head;
- the converter's keys and shapes at Swin-B width, and its strictness.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_camera_3d_pose_estimation_tpu.models.swin import SWIN_B as J_SWIN_B
from multi_camera_3d_pose_estimation_tpu.models.swin import SwinPose as JSwinPose
from multi_camera_3d_pose_estimation_tpu_torch.models import registry
from multi_camera_3d_pose_estimation_tpu_torch.models import swin as port_swin
from multi_camera_3d_pose_estimation_tpu_torch.models.convert import (load_swin_from_flax,
                                                                     swin_state_dict_from_flax)
from multi_camera_3d_pose_estimation_tpu_torch.models.swin import SWIN_B, SwinPose

from tests._torch_port_util import random_variables

SMALL = {"embed": 64, "depths": (2, 2), "heads": (2, 4), "window": 7, "mlp_ratio": 4,
         "deconv": (32,)}
INPUT = (64, 96)


@pytest.fixture(scope="module")
def small():
    v = random_variables(JSwinPose(num_joints=17, cfg=SMALL), (1, INPUT[1], INPUT[0], 3), seed=1)
    x = np.random.default_rng(4).normal(size=(2, INPUT[1], INPUT[0], 3)).astype(np.float32)
    ref = jax.jit(JSwinPose(num_joints=17, cfg=SMALL, dtype=jnp.float32).apply)(
        v, jnp.asarray(x))
    return v, x, np.moveaxis(np.asarray(ref), -1, 1)


def _port(v, dtype=torch.float32):
    model = SwinPose(17, SMALL, dtype=dtype, device="cpu")
    return load_swin_from_flax(model, v).eval()


@pytest.mark.parametrize("mode", ["block", False])
def test_swinpose_matches_flax_f32(small, mode, monkeypatch):
    v, x, ref = small
    if mode == "block":  # the block kernels' plain versions, in f32
        monkeypatch.setattr(port_swin, "runs_kernels", lambda *a, **k: True)
    with torch.no_grad():
        out = _port(v)(torch.from_numpy(x))
    assert out.dtype == torch.float32 and out.shape == ref.shape == (2, 17, 24, 16)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4, atol=1e-4)


def test_swinpose_bf16_block_matches_pallas_block(small):
    v, x, _ = small
    ref = jax.jit(JSwinPose(num_joints=17, cfg=SMALL, use_pallas_attention="block").apply)(
        v, jnp.asarray(x))
    ref = np.moveaxis(np.asarray(ref), -1, 1)
    with torch.no_grad():
        out = _port(v, torch.bfloat16)(torch.from_numpy(x))
    assert out.dtype == torch.float32
    err = np.abs(out.numpy() - ref).max() / np.abs(ref).max()
    print("bf16 block heatmap error / scale:", err)
    assert err <= 2e-2


def test_swin_b_state_dict_covers_flax_tree():
    """At Swin-B width the converter's keys and shapes are exactly the
    model's (on the abstract flax tree; no weights are drawn)."""
    assert SWIN_B == J_SWIN_B
    shapes = jax.eval_shape(lambda: JSwinPose(num_joints=17, cfg=J_SWIN_B).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 256, 192, 3))))
    v = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    sd = swin_state_dict_from_flax(v)
    want = SwinPose(17, SWIN_B, device="meta").state_dict()
    assert set(sd) == set(want)
    assert all(tuple(sd[k].shape) == tuple(want[k].shape) for k in sd)


def test_converter_is_strict(small):
    v = small[0]
    missing = jax.tree_util.tree_map(lambda a: a, v)
    del missing["params"]["backbone"]["stage_1_block_1"]["ffn_fc2"]
    with pytest.raises(KeyError, match="missing"):
        _port(missing)
    extra = jax.tree_util.tree_map(lambda a: a, v)
    extra["params"]["backbone"]["stage_1_block_2"] = extra["params"]["backbone"][
        "stage_1_block_1"]
    with pytest.raises(KeyError, match="leftover"):
        _port(extra)
    wrong = jax.tree_util.tree_map(lambda a: a, v)
    wrong["params"]["backbone"]["stage_0_block_0"]["attn"]["bias_table"] = np.zeros(
        (169, 3), np.float32)
    with pytest.raises(ValueError, match="bias_table"):
        _port(wrong)
    unknown = jax.tree_util.tree_map(lambda a: a, v)
    unknown["params"]["final_layer"]["gain"] = np.ones(17, np.float32)
    with pytest.raises(KeyError, match="unmapped"):
        swin_state_dict_from_flax(unknown)
    odd = jax.tree_util.tree_map(lambda a: a, v)
    odd["params"]["backbone"]["out_norm"]["kernel"] = np.ones((2, 2, 2), np.float32)
    with pytest.raises(ValueError, match="2-d or 4-d"):
        swin_state_dict_from_flax(odd)


def test_registry_builds_a_swin_estimator():
    assert registry.resolve_model_name("coco_swin_b") == "coco_swin-b"
    rtm = registry.build_estimator("coco_rtmpose-t", device="cpu")
    assert rtm.family == "rtmpose" and rtm.decode == "simcc"
    with pytest.raises(KeyError):
        registry.resolve_model_name("coco_swin-x")
    est = registry.build_estimator("test_swin_128", device="cpu", seed=2)
    assert est.family == "swin" and isinstance(est.model, SwinPose)
    frames = np.random.default_rng(0).integers(0, 256, (2, 100, 90, 3), dtype=np.uint8)
    out = est.predict_batch(frames)
    assert out["keypoints"].shape == (2, 17, 3) and out["gaussians"].shape == (2, 17, 6)
    assert torch.isfinite(out["gaussians"]).all()

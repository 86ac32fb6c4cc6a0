"""The port's Swin block pipeline against the JAX one, at a small Swin size.

T=4 frames x C=2 cameras of 96x80, the small window-7 Swin (both stages
padded and shifted) at input (64, 96); the JAX pipeline runs flax's einsum
path, the port its default "block" path (on the CPU: the kernels' plain
versions).  Random-weight heatmaps are flat, so a bf16 rounding difference
can move an argmax; the result is held in the layers of
``test_torch_port_pipeline.py``:

1. the pixel path and model: heatmaps at 2e-2 of the maps' largest value
   (the bf16 model tolerance);
2. given the same heatmaps, the Swin estimator (NHWC crops in) gives the JAX
   estimator's kpts_2d / heatmaps_2d / kpts_3d to 1e-4;
3. end to end, kpts_3d agreeing wherever both sides picked the same argmax
   in both views, with the share of such joints asserted.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_camera_3d_pose_estimation_tpu.models import SwinPose as JSwinPose
from multi_camera_3d_pose_estimation_tpu.models import TopDownEstimator as JEstimator
from multi_camera_3d_pose_estimation_tpu.parallel import ShardedPosePipeline as JPipeline
from multi_camera_3d_pose_estimation_tpu_torch.entry import build_pipeline, synthetic_rig
from multi_camera_3d_pose_estimation_tpu_torch.models import SwinPose, TopDownEstimator
from multi_camera_3d_pose_estimation_tpu_torch.parallel import ShardedPosePipeline

from tests._torch_port_util import random_variables

SMALL = {"embed": 64, "depths": (2, 2), "heads": (2, 4), "window": 7, "mlp_ratio": 4,
         "deconv": (32,)}
SHAPE = (4, 2, 96, 80, 3)
INPUT = (64, 96)


@pytest.fixture(scope="module")
def jax_pipe():
    model = JSwinPose(num_joints=17, cfg=SMALL)
    variables = random_variables(model, (1, INPUT[1], INPUT[0], 3), seed=0)
    rig = synthetic_rig(2, 96, 80)
    return JPipeline(JEstimator(model, variables, input_size=INPUT), rig), variables, rig


@pytest.fixture(scope="module")
def frames():
    return np.random.default_rng(0).integers(0, 256, SHAPE, dtype=np.uint8)


def test_model_heatmaps_match_bf16(jax_pipe, frames):
    """Layer 1: the same crops through both models, bf16 end to end."""
    pipe, variables, _ = jax_pipe
    from multi_camera_3d_pose_estimation_tpu.models.topdown import preprocess_crops

    flat = jnp.asarray(frames.reshape(-1, 96, 80, 3), jnp.bfloat16) / 255.0
    boxes = jnp.tile(jnp.float32([0, 0, 80, 96]), (8, 1))
    crops, _, _ = preprocess_crops(flat, boxes, INPUT)
    ref = np.moveaxis(np.asarray(jax.jit(pipe.estimator.model.apply)(variables, crops)), -1, 1)
    port = build_pipeline(SMALL, INPUT, SHAPE, device="cpu", variables=variables, family="swin")
    assert port.estimator.family == "swin"
    x = torch.from_numpy(np.array(crops.astype(jnp.float32))).to(torch.bfloat16)
    with torch.no_grad():
        out = port.estimator.model(x)
    assert out.dtype == torch.float32 and out.shape == ref.shape == (8, 17, 24, 16)
    err = np.abs(out.numpy() - ref).max() / np.abs(ref).max()
    print("heatmap error / scale:", err)
    assert err <= 2e-2


class _FixedHeatmaps:
    """Stands in for the model: returns given heatmaps (B, K, h, w)."""

    def __init__(self, heat):
        self.heat = heat
        self.crops = None

    def apply(self, variables, crops, **kw):  # the JAX side's call
        return jnp.asarray(np.moveaxis(self.heat, 1, -1))

    def __call__(self, crops):  # the port's Swin call: NHWC crops
        self.crops = tuple(crops.shape)
        return torch.from_numpy(self.heat)


@pytest.mark.parametrize("decode_mode", ["dark", "default"])
def test_same_heatmaps_give_same_outputs(jax_pipe, frames, decode_mode):
    """Layer 2: the Swin estimator's decode, gate, pushforward and
    triangulation, given the same heatmaps: the default decode (the port's
    single-pass decode against the JAX package's fused decode) and DARK."""
    _, variables, rig = jax_pipe
    rng = np.random.default_rng(5)
    ys, xs = np.mgrid[0:24, 0:16]
    peaks = rng.uniform([2, 2], [14, 22], (8, 17, 2))
    amp = rng.uniform(0.1, 1.5, (8, 17))
    heat = (amp[..., None, None] * np.exp(-((xs - peaks[..., 0:1, None]) ** 2
                                            + (ys - peaks[..., 1:2, None]) ** 2) / 2.0))
    heat = heat.astype(np.float32)
    fake = _FixedHeatmaps(heat)
    fused_decode = decode_mode == "default"
    ref = JPipeline(JEstimator(fake, variables, input_size=INPUT, use_fused_decode=fused_decode,
                               decode_mode=decode_mode), rig).run(frames)
    est = TopDownEstimator(SwinPose(17, SMALL, device="cpu"), INPUT, decode_mode=decode_mode,
                           device="cpu")
    est.model = fake
    out = ShardedPosePipeline(est, rig, device="cpu").run(frames)
    assert fake.crops == (8, 96, 64, 3)
    for key in ("kpts_2d", "heatmaps_2d", "kpts_3d"):
        r, o = np.asarray(ref[key]), out[key].numpy()
        assert o.shape == r.shape and o.dtype == np.float32
        np.testing.assert_array_equal(np.isnan(o), np.isnan(r))
        if key == "heatmaps_2d" and fused_decode:
            # raw-moment covariances cancel in f32 (test_torch_port_pipeline.py)
            cov_atol = 8 * float(np.finfo(np.float32).eps) * 23 ** 2 * (4.0 / 0.64) ** 2
            np.testing.assert_allclose(o[..., 2:], r[..., 2:], rtol=0, atol=cov_atol)
            o, r = o[..., :2], r[..., :2]
        np.testing.assert_allclose(o, r, rtol=1e-4, atol=1e-4, err_msg=key)
    finite = np.isfinite(out["kpts_3d"].numpy()).all(-1)
    assert 0.2 < finite.mean() < 1.0  # the gate dropped some joints, not all


def test_pipeline_end_to_end_matches_jax(jax_pipe, frames):
    """Layer 3: both whole pipelines on the same uint8 block and weights."""
    pipe, variables, _ = jax_pipe
    ref = {k: np.asarray(v) for k, v in pipe.run(frames).items()}
    port = build_pipeline(SMALL, INPUT, SHAPE, device="cpu", variables=variables, family="swin")
    out = {k: v.numpy() for k, v in port.run(frames).items()}
    for key in ref:
        assert out[key].shape == ref[key].shape and out[key].dtype == np.float32
    same = np.abs(out["kpts_2d"][:, :, :2] - ref["kpts_2d"][:, :, :2]) < 1e-2  # (T, K, 2, C)
    same = same.all(axis=2).all(axis=-1) | (np.isnan(out["kpts_2d"][:, :, 0]).all(-1)
                                           & np.isnan(ref["kpts_2d"][:, :, 0]).all(-1))
    print("share of joints with the same peaks:", same.mean())
    assert same.mean() >= 0.5, same.mean()
    both = same & np.isfinite(out["kpts_3d"]).all(-1) & np.isfinite(ref["kpts_3d"]).all(-1)
    assert both.sum() >= 5
    np.testing.assert_allclose(out["kpts_3d"][both], ref["kpts_3d"][both], rtol=1e-3, atol=1e-2)


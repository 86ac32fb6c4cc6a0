"""The port's block pipeline against the JAX one, at tiny HRNet size.

T=4 frames x C=2 cameras of 96x80, HRNet test_tiny widths at input (32, 64),
the JAX pipeline with ``use_pallas_stage1=False``.  Random-weight heatmaps
are flat, so a bf16 rounding difference can move an argmax; the result is
held in layers:

1. the pixel path and model: heatmaps at the bf16 tolerance;
2. given the same heatmaps, kpts_2d / heatmaps_2d / kpts_3d to 1e-4 (f32
   decode, pushforward and triangulation on both sides, sums in another
   order), except the covariances of the raw-moment (fused) decode, which
   cancel in f32: 8 ulps of (h-1)² heatmap px², times (stride/scale)² to
   image px²;
3. end to end, kpts_3d agreeing wherever both sides picked the same argmax
   in both views, with the share of such joints asserted.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_camera_3d_pose_estimation_tpu.models import HRNet as JHRNet
from multi_camera_3d_pose_estimation_tpu.models import TopDownEstimator as JEstimator
from multi_camera_3d_pose_estimation_tpu.parallel import ShardedPosePipeline as JPipeline
from multi_camera_3d_pose_estimation_tpu_torch.entry import build_pipeline, synthetic_rig
from multi_camera_3d_pose_estimation_tpu_torch.models import HRNet, TopDownEstimator
from multi_camera_3d_pose_estimation_tpu_torch.parallel import ShardedPosePipeline

from tests._torch_port_util import random_variables
from tests.conftest import project_np

TINY = {"widths": (8, 16, 32, 64), "modules": (1, 1, 1, 1), "stem": 16}
SHAPE = (4, 2, 96, 80, 3)
INPUT = (32, 64)


def _converging_rig():
    """Two cameras yawed ±15° about the origin at distance 300, f = 100 px,
    mild distortion: points near the origin are seen by both."""
    Ks, Rs = [], []
    for th in np.deg2rad([-15.0, 15.0]):
        Ks.append([[100.0, 0, 40.0], [0, 100.0, 48.0], [0, 0, 1]])
        Rs.append([[np.cos(th), 0, np.sin(th)], [0, 1, 0], [-np.sin(th), 0, np.cos(th)]])
    return {"K": np.asarray(Ks, np.float32), "R": np.asarray(Rs, np.float32),
            "T": np.tile(np.float32([0, 0, 300]), (2, 1)),
            "dist": np.float32([[-0.05, 0.01, 0, 0, 0], [0.04, 0, 0, 0, 0]])}


@pytest.fixture(scope="module")
def jax_pipe():
    model = JHRNet(num_joints=17, cfg=TINY)
    variables = random_variables(model, (1, INPUT[1], INPUT[0], 3), seed=0)
    rig = synthetic_rig(2, 96, 80)
    return JPipeline(JEstimator(model, variables, input_size=INPUT), rig), variables, rig


@pytest.fixture(scope="module")
def frames():
    return np.random.default_rng(0).integers(0, 256, SHAPE, dtype=np.uint8)


def test_model_heatmaps_match_bf16(jax_pipe, frames):
    """Layer 1: the same crops through both models, bf16 end to end.  Held
    to 5e-2 of the maps' largest value: a few bf16 roundings (2^-8 each)
    in other places compound through ~40 convs."""
    pipe, variables, rig = jax_pipe
    from multi_camera_3d_pose_estimation_tpu.models.topdown import preprocess_crops

    flat = jnp.asarray(frames.reshape(-1, 96, 80, 3), jnp.bfloat16) / 255.0
    boxes = jnp.tile(jnp.float32([0, 0, 80, 96]), (8, 1))
    crops, _, _ = preprocess_crops(flat, boxes, INPUT)
    ref = np.moveaxis(np.asarray(jax.jit(pipe.estimator.model.apply)(variables, crops)), -1, 1)
    port = build_pipeline(TINY, INPUT, SHAPE, device="cpu", variables=variables)
    model = port.estimator.model
    x = torch.from_numpy(np.array(crops.astype(jnp.float32))).to(torch.bfloat16)
    with torch.no_grad():
        plain = model(x.permute(0, 3, 1, 2))
        fused = model(x.permute(0, 3, 1, 2), fused_stage1=port.estimator.fused_stage1)
    scale = np.abs(ref).max()
    for out in (plain, fused):
        assert out.dtype == torch.float32 and out.shape == ref.shape == (8, 17, 16, 8)
        print("heatmap error / scale:", np.abs(out.numpy() - ref).max() / scale)
        assert np.abs(out.numpy() - ref).max() <= 5e-2 * scale


class _FixedHeatmaps:
    """Stands in for the model: returns given heatmaps (B, K, h, w)."""

    def __init__(self, heat):
        self.heat = heat

    def apply(self, variables, crops, **kw):  # the JAX side's call
        return jnp.asarray(np.moveaxis(self.heat, 1, -1))

    def __call__(self, crops, fused_stage1=None):  # the port's call
        return torch.from_numpy(self.heat)


def _peaked_heatmaps(rig, rng):
    """Heatmaps whose peaks are the projections of random 3D joints, with
    amplitudes on both sides of the 0.3 confidence gate."""
    T, C = SHAPE[:2]
    X = rng.uniform(-40, 40, (T * 17, 3))
    # Crop geometry of a full-frame box at INPUT: the 80x96 frame padded
    # 1.25x and fitted to w/h = 0.5 is a 100x200 box centred on (40, 48).
    scale, offset, stride = 32 / 100.0, np.array([-10.0, -52.0]), 4.0
    ys, xs = np.mgrid[0:16, 0:8]
    heat = np.zeros((T, C, 17, 16, 8), np.float32)
    for c in range(C):
        uv = project_np(X, rig["K"][c].astype(float), rig["R"][c].astype(float),
                        rig["T"][c].astype(float), rig["dist"][c].astype(float))
        hm = ((uv - offset) * scale / stride).reshape(T, 17, 2)
        amp = rng.uniform(0.1, 1.5, (T, 17))
        heat[:, c] = amp[..., None, None] * np.exp(
            -((xs - hm[..., 0:1, None]) ** 2 + (ys - hm[..., 1:2, None]) ** 2) / 2.0)
    return heat.reshape(T * C, 17, 16, 8), X.reshape(T, 17, 3)


@pytest.mark.parametrize("fused_decode", [False, True])
def test_same_heatmaps_give_same_outputs(jax_pipe, frames, fused_decode):
    """Layer 2: the decode, gate, pushforward and triangulation, exactly."""
    _, variables, _ = jax_pipe
    rig = _converging_rig()
    heat, X = _peaked_heatmaps(rig, np.random.default_rng(5))
    fake = _FixedHeatmaps(heat)
    ref = JPipeline(JEstimator(fake, variables, input_size=INPUT,
                               use_fused_decode=fused_decode), rig).run(frames)
    model = HRNet(17, TINY, device="cpu")
    est = TopDownEstimator(model, INPUT, use_fused_decode=fused_decode, device="cpu")
    est.model = fake
    out = ShardedPosePipeline(est, rig, device="cpu").run(frames)
    for key in ("kpts_2d", "heatmaps_2d", "kpts_3d"):
        r, o = np.asarray(ref[key]), out[key].numpy()
        assert o.shape == r.shape and o.dtype == np.float32
        np.testing.assert_array_equal(np.isnan(o), np.isnan(r))
        if key == "heatmaps_2d" and fused_decode:
            cov_atol = 8 * float(np.finfo(np.float32).eps) * 15 ** 2 * (4.0 / 0.32) ** 2
            np.testing.assert_allclose(o[..., 2:], r[..., 2:], rtol=0, atol=cov_atol)
            o, r = o[..., :2], r[..., :2]
        np.testing.assert_allclose(o, r, rtol=1e-4, atol=1e-4, err_msg=key)
    finite = np.isfinite(out["kpts_3d"].numpy()).all(-1)
    assert 0.2 < finite.mean() < 1.0  # the gate dropped some joints, not all
    # The peaks were placed at projections of X, so triangulation finds X
    # to the decode's quantisation: a heatmap pixel is 12.5 image px, about
    # 37 units at this depth, and the ±0.25 step leaves up to ~half of it.
    err = np.linalg.norm(out["kpts_3d"].numpy()[finite] - X[finite], axis=-1)
    assert np.median(err) < 20.0


def test_predict_batch_matches_jax(jax_pipe, frames):
    """`TopDownEstimator.predict_batch` (f32 frames, given boxes) on the same
    heatmaps: keypoints and Gaussians in image pixels to 1e-4."""
    _, variables, _ = jax_pipe
    heat, _ = _peaked_heatmaps(_converging_rig(), np.random.default_rng(6))
    boxes = np.float32([[0, 0, 80, 96], [8, 4, 72, 92], [-10, 20, 60, 110], [30, 0, 95, 70],
                        [0, 0, 80, 96], [5, 5, 50, 90], [20, 30, 70, 96], [0, 10, 80, 80]])
    fake = _FixedHeatmaps(heat)
    ref = JEstimator(fake, variables, input_size=INPUT).predict_batch(
        frames.reshape(-1, 96, 80, 3), boxes)
    est = TopDownEstimator(HRNet(17, TINY, device="cpu"), INPUT, device="cpu")
    est.model = fake
    out = est.predict_batch(frames.reshape(-1, 96, 80, 3), boxes)
    for key in ("keypoints", "gaussians"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]), rtol=1e-4, atol=1e-4)


def test_pipeline_end_to_end_matches_jax(jax_pipe, frames):
    """Layer 3: both whole pipelines on the same uint8 block and weights."""
    pipe, variables, rig = jax_pipe
    ref = {k: np.asarray(v) for k, v in pipe.run(frames).items()}
    port = build_pipeline(TINY, INPUT, SHAPE, device="cpu", variables=variables)
    out = {k: v.numpy() for k, v in port.run(frames).items()}
    for key in ref:
        assert out[key].shape == ref[key].shape and out[key].dtype == np.float32
    # Joints whose decoded peak (before the gate) is the same pixel in both views.
    same = np.abs(out["kpts_2d"][:, :, :2] - ref["kpts_2d"][:, :, :2]) < 1e-2  # (T, K, 2, C)
    same = same.all(axis=2).all(axis=-1) | (np.isnan(out["kpts_2d"][:, :, 0]).all(-1)
                                           & np.isnan(ref["kpts_2d"][:, :, 0]).all(-1))
    print("share of joints with the same peaks:", same.mean())
    assert same.mean() >= 0.5, same.mean()
    both = same & np.isfinite(out["kpts_3d"]).all(-1) & np.isfinite(ref["kpts_3d"]).all(-1)
    assert both.sum() >= 5
    np.testing.assert_allclose(out["kpts_3d"][both], ref["kpts_3d"][both], rtol=1e-3, atol=1e-2)


def test_pipeline_refuses_a_mesh():
    est = TopDownEstimator(HRNet(17, TINY, device="cpu"), INPUT, device="cpu")
    with pytest.raises(NotImplementedError):
        ShardedPosePipeline(est, synthetic_rig(2, 96, 80), mesh=object(), device="cpu")

"""The port's DARK decode, flip-TTA and n-view pipeline against the JAX package.

- `heatmap_dark_decode` in f32 at 3e-6 plus two f32 steps of the
  coordinate (its blur sums in another order; each f32 decode is itself up
  to 4.5e-6 from the float64 decode), and as close to the float64 decode as
  JAX's f32 decode is.
- Flip-TTA's logic (mirror back, left/right swap, the one-pixel shift, the
  average, then each decode) exactly, on a stand-in model that returns given
  peaked heatmaps for the direct and for the mirrored crops: f32 to 1e-4.
- A tiny HRNet with flax weights in f32 (the 1e-4 of
  test_torch_port_hrnet.py): scores and means at 1e-4, covariance terms
  at 1e-4 of the joint's largest variance, keypoints at
  1e-4 wherever both sides chose the same peak (random weights make flat
  maps, whose argmax a 1e-6 difference can move).
- The pipeline with ``triangulation="nview"`` (4 cameras, one of them
  occluded) on given heatmaps, decoded by DARK (sub-pixel peaks, so the
  views agree and the solve's keep/reject decisions are far from their
  thresholds): the 2-D outputs at 1e-4, kpts_3d at 1e-3 (f32 on both
  sides: C + 2 weighted 4x4 solves of 12 squarings each, whose rounding
  the ring's conditioning amplifies to ~1.4e-4 relative).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_camera_3d_pose_estimation_tpu.models import HRNet as JHRNet
from multi_camera_3d_pose_estimation_tpu.models import TopDownEstimator as JEstimator
from multi_camera_3d_pose_estimation_tpu.ops.heatmap_decode import heatmap_dark_decode as j_dark
from multi_camera_3d_pose_estimation_tpu.parallel import ShardedPosePipeline as JPipeline
from multi_camera_3d_pose_estimation_tpu_torch.entry import build_pipeline
from multi_camera_3d_pose_estimation_tpu_torch.models import HRNet, TopDownEstimator
from multi_camera_3d_pose_estimation_tpu_torch.models.convert import load_hrnet_from_flax
from multi_camera_3d_pose_estimation_tpu_torch.ops.heatmap_decode import heatmap_dark_decode
from multi_camera_3d_pose_estimation_tpu_torch.parallel import ShardedPosePipeline

from tests._torch_port_util import random_variables
from tests.conftest import project_np

TINY = {"widths": (8, 16, 32, 64), "modules": (1, 1, 1, 1), "stem": 16}
INPUT = (32, 64)


def _peaked(shape, seed, sigma=1.5):
    rng = np.random.default_rng(seed)
    *b, H, W = shape
    ys, xs = np.mgrid[0:H, 0:W]
    cy = rng.uniform(-1, H, b)[..., None, None]  # some peaks at the edge
    cx = rng.uniform(-1, W, b)[..., None, None]
    amp = rng.uniform(0.2, 1.5, b)[..., None, None]
    g = amp * np.exp(-((ys - cy) ** 2 + (xs - cx) ** 2) / (2 * sigma ** 2))
    return (g + rng.uniform(0, 0.01, shape)).astype(np.float32)


@pytest.mark.parametrize("shape,kernel", [((3, 17, 64, 48), 11), ((2, 5, 16, 8), 11),
                                          ((4, 16, 12), 5)])
def test_dark_decode_matches_jax(shape, kernel):
    hm = _peaked(shape, seed=len(shape) + kernel)
    xy_ref, s_ref = (np.asarray(a) for a in jax.jit(j_dark, static_argnums=1)(hm, kernel))
    xy, s = heatmap_dark_decode(torch.from_numpy(hm), kernel)
    assert xy.dtype == torch.float32 and xy.shape == xy_ref.shape
    # Each f32 decode's offset is up to ~4.5e-6 from the float64 decode's
    # (its log-differences of blurred sums), and x0 + offset is rounded to
    # the coordinate's f32 spacing (3.8e-6 at 32-64 px): 3e-6 plus two such
    # steps between the two f32 decodes.
    atol = 3e-6 + 2 * np.spacing(np.abs(xy_ref))
    np.testing.assert_array_less(np.abs(xy.numpy() - xy_ref), atol)
    np.testing.assert_array_equal(s.numpy(), s_ref)
    # Both f32 decodes are as far from the float64 one.
    xy64 = np.asarray(jax.jit(j_dark, static_argnums=1)(hm.astype(np.float64), kernel)[0])
    err, err_ref = np.abs(xy.numpy() - xy64).max(), np.abs(xy_ref - xy64).max()
    print("max |f32 - f64|: port", err, "JAX", err_ref)
    assert err <= 2 * err_ref + 1e-6
    # Sub-pixel: the refinement moved most points off the integer grid.
    assert (np.abs(xy_ref - np.round(xy_ref)) > 1e-3).mean() > 0.5


class _TwoMaps:
    """Stands in for the model: returns ``maps[0]`` for the first call and
    ``maps[1]`` for the second (the mirrored crops), and so on."""

    num_joints = 17

    def __init__(self, maps):
        self.maps, self.calls = maps, 0

    def _next(self):
        m = self.maps[self.calls % 2]
        self.calls += 1
        return m

    def apply(self, variables, crops, **kw):  # the JAX side: (B, h, w, K)
        return jnp.asarray(np.moveaxis(self._next(), 1, -1))

    def __call__(self, crops):  # the port: (B, K, h, w)
        return torch.from_numpy(self._next())

    def to(self, device):
        return self

    def eval(self):
        return self


BOXES = np.float32([[0, 0, 80, 96], [8, 4, 72, 92], [-10, 20, 60, 110], [30, 0, 95, 70]])


@pytest.mark.parametrize("flip_shift", [True, False])
@pytest.mark.parametrize("decode_mode", ["default", "dark"])
def test_flip_tta_on_given_maps_matches_jax(flip_shift, decode_mode):
    """The port's default decode is the single-pass one: the JAX side's
    fused decode is its reference."""
    maps = [_peaked((4, 17, 16, 8), 20), _peaked((4, 17, 16, 8), 21)]
    frames = np.random.default_rng(0).uniform(0, 1, (4, 96, 80, 3)).astype(np.float32)
    kw = dict(input_size=INPUT, flip_test=True, flip_shift=flip_shift, decode_mode=decode_mode)
    fused = decode_mode == "default"
    ref = JEstimator(_TwoMaps(maps), {}, use_fused_decode=fused, **kw).predict_batch(frames,
                                                                                       BOXES)
    out = TopDownEstimator(_TwoMaps(maps), device="cpu", **kw).predict_batch(frames, BOXES)
    for key in ("keypoints", "gaussians"):
        r, o = np.asarray(ref[key]), out[key].numpy()
        if key == "gaussians" and fused:  # raw f32 moments cancel: the decode tests' bound
            atol = 8 * float(np.finfo(np.float32).eps) * 15 ** 2 * (4.0 / 0.32) ** 2
            np.testing.assert_allclose(o[..., 2:], r[..., 2:], rtol=0, atol=atol)
            o, r = o[..., :2], r[..., :2]
        np.testing.assert_allclose(o, r, rtol=1e-4, atol=1e-4, err_msg=key)
    # Without the flip the answer differs: the mirrored maps were used.
    plain = TopDownEstimator(_TwoMaps(maps), device="cpu", input_size=INPUT,
                             decode_mode=decode_mode).predict_batch(frames, BOXES)
    assert np.abs(plain["keypoints"].numpy() - out["keypoints"].numpy()).max() > 0.5


def test_flip_needs_a_matching_swap_table():
    model = _TwoMaps(None)
    model.num_joints = 16
    with pytest.raises(ValueError, match="swap table"):
        TopDownEstimator(model, device="cpu", flip_test=True)
    with pytest.raises(ValueError, match="decode_mode"):
        TopDownEstimator(model, device="cpu", decode_mode="udp")


@pytest.fixture(scope="module")
def tiny_hrnet():
    model = JHRNet(num_joints=17, cfg=TINY, dtype=jnp.float32)
    return model, random_variables(model, (1, INPUT[1], INPUT[0], 3), seed=1)


@pytest.mark.parametrize("flip_shift,decode_mode", [(True, "dark"), (False, "default")])
def test_tiny_hrnet_flip_matches_jax_f32(tiny_hrnet, flip_shift, decode_mode):
    jmodel, v = tiny_hrnet
    frames = np.random.default_rng(5).uniform(0, 1, (4, 96, 80, 3)).astype(np.float32)
    kw = dict(input_size=INPUT, flip_test=True, flip_shift=flip_shift, decode_mode=decode_mode)
    ref = {k: np.asarray(a) for k, a in JEstimator(jmodel, v, **kw).predict_batch(
        frames, BOXES).items()}
    model = load_hrnet_from_flax(HRNet(17, TINY, dtype=torch.float32, device="cpu"), v)
    out = {k: a.numpy() for k, a in TopDownEstimator(model, device="cpu", **kw).predict_batch(
        frames, BOXES).items()}
    np.testing.assert_allclose(out["keypoints"][..., 2], ref["keypoints"][..., 2], rtol=1e-4,
                               atol=1e-4)
    # The centred moments sum terms up to the variances' size, so their f32
    # noise scales with the joint's largest variance.
    g, g_ref = out["gaussians"], ref["gaussians"]
    np.testing.assert_allclose(g[..., :2], g_ref[..., :2], rtol=1e-4, atol=1e-4)
    scale = np.maximum(g_ref[..., 2], g_ref[..., 5])[..., None]
    err = np.abs(g[..., 2:] - g_ref[..., 2:])
    np.testing.assert_array_less(err, np.broadcast_to(1e-4 * scale + 1e-4, err.shape))
    same = (np.abs(out["keypoints"][..., :2] - ref["keypoints"][..., :2]) < 0.5).all(-1)
    print("share of joints with the same peak:", same.mean())
    assert same.mean() >= 0.9
    np.testing.assert_allclose(out["keypoints"][same], ref["keypoints"][same], rtol=1e-4,
                               atol=1e-4)


def _ring_rig(n_cams=4):
    """Cameras on a ring about the origin at distance 300, f = 100 px."""
    Ks, Rs = [], []
    for th in np.deg2rad(np.linspace(-40.0, 40.0, n_cams)):
        Ks.append([[100.0, 0, 40.0], [0, 100.0, 48.0], [0, 0, 1]])
        Rs.append([[np.cos(th), 0, np.sin(th)], [0, 1, 0], [-np.sin(th), 0, np.cos(th)]])
    return {"K": np.asarray(Ks, np.float32), "R": np.asarray(Rs, np.float32),
            "T": np.tile(np.float32([0, 0, 300]), (n_cams, 1)),
            "dist": np.tile(np.float32([-0.03, 0.01, 0, 0, 0]), (n_cams, 1))}


def _rig_heatmaps(rig, T, rng):
    """(T·C, 17, 16, 8) maps peaked at the projections of random joints, at
    amplitudes on both sides of the 0.3 gate; camera 3 sees joint 5 at a
    wrong place with a high confidence (an occluder)."""
    C = rig["K"].shape[0]
    X = rng.uniform(-30, 30, (T * 17, 3))
    scale, offset, stride = 32 / 100.0, np.array([-10.0, -52.0]), 4.0
    ys, xs = np.mgrid[0:16, 0:8]
    heat = np.zeros((T, C, 17, 16, 8), np.float32)
    for c in range(C):
        uv = project_np(X, rig["K"][c].astype(float), rig["R"][c].astype(float),
                        rig["T"][c].astype(float), rig["dist"][c].astype(float))
        hm = ((uv - offset) * scale / stride).reshape(T, 17, 2)
        if c == 3:
            hm[:, 5] += 2.0
        amp = rng.uniform(0.1, 1.5, (T, 17))
        amp[:, 5] = 1.4 if c == 3 else amp[:, 5]
        heat[:, c] = amp[..., None, None] * np.exp(
            -((xs - hm[..., 0:1, None]) ** 2 + (ys - hm[..., 1:2, None]) ** 2) / 2.0)
    return heat.reshape(T * C, 17, 16, 8), X.reshape(T, 17, 3)


@pytest.mark.parametrize("flip", [False, True])
def test_nview_pipeline_on_given_maps_matches_jax(flip):
    rig = _ring_rig()
    rng = np.random.default_rng(7)
    maps = [_rig_heatmaps(rig, 3, rng)[0], _rig_heatmaps(rig, 3, rng)[0]]
    frames = np.random.default_rng(1).integers(0, 256, (3, 4, 96, 80, 3), dtype=np.uint8)
    kw = dict(input_size=INPUT, flip_test=flip, decode_mode="dark")
    ref = JPipeline(JEstimator(_TwoMaps(maps), {}, **kw), rig, triangulation="nview").run(frames)
    est = TopDownEstimator(_TwoMaps(maps), device="cpu", **kw)
    out = ShardedPosePipeline(est, rig, triangulation="nview", device="cpu").run(frames)
    for key, tol in (("kpts_2d", 1e-4), ("heatmaps_2d", 1e-4), ("kpts_3d", 1e-3)):
        r, o = np.asarray(ref[key]), out[key].numpy()
        assert o.shape == r.shape
        np.testing.assert_array_equal(np.isnan(o), np.isnan(r))
        np.testing.assert_allclose(o, r, rtol=tol, atol=tol, err_msg=key)
    views = np.isfinite(out["kpts_2d"].numpy()[:, :, 0]).sum(-1)  # (T, K) views past the gate
    assert (views < 4).any()
    np.testing.assert_array_equal(np.isfinite(out["kpts_3d"].numpy()).all(-1), views >= 2)
    with pytest.raises(ValueError, match="triangulation"):
        ShardedPosePipeline(est, rig, triangulation="svd", device="cpu")


def test_build_pipeline_plumbs_the_options():
    pipe = build_pipeline(TINY, INPUT, (2, 4, 96, 80, 3), device="cpu", triangulation="nview",
                          flip_test=True, flip_shift=False, decode_mode="dark")
    est = pipe.estimator
    assert pipe.triangulation == "nview" and est.flip_perm is not None
    assert (est.flip_shift, est.decode_mode) == (False, "dark")
    out = pipe.run(np.random.default_rng(2).integers(0, 256, (2, 4, 96, 80, 3), dtype=np.uint8))
    assert out["kpts_3d"].shape == (2, 17, 3) and out["kpts_2d"].shape == (2, 17, 3, 4)

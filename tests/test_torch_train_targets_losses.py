"""The port's training targets and losses against the JAX package's.

- Targets: in float32 within 2 f32 ulps of 1.0 (every target lies in
  [0, 1]; ``exp`` is the only transcendental), in float64 within 1e-12;
  keypoints inside, on and outside the map edges, and unlabeled joints.
- Losses: values within 1e-6 relative, and their autograd gradients against
  ``jax.grad`` within 1e-5 of the gradient's largest magnitude, in float32.
"""

import jax
import numpy as np
import pytest
import torch

from multi_camera_3d_pose_estimation_tpu.training import losses as jl
from multi_camera_3d_pose_estimation_tpu.training import targets as jt
from multi_camera_3d_pose_estimation_tpu_torch.training import losses as tl
from multi_camera_3d_pose_estimation_tpu_torch.training import targets as tt

ULP2 = 2 * 2.0 ** -23  # two f32 ulps of 1.0
TOL = {np.float32: ULP2, np.float64: 1e-12}
DTYPES = [np.float32, np.float64]


def _keypoints(dtype, B=3, K=17, lo=-4.0, hi=40.0):
    rng = np.random.default_rng(0)
    kp = rng.uniform(lo, hi, (B, K, 2)).astype(dtype)
    kp[0, 0] = [0.0, 0.0]  # on the low edges: inside
    kp[0, 1] = [-1e-3, 3.0]  # just outside
    vis = (rng.uniform(size=(B, K)) > 0.2).astype(dtype) * 2
    return kp, vis


@pytest.mark.parametrize("dtype", DTYPES)
def test_heatmap_targets_match_jax(dtype):
    kp, vis = _keypoints(dtype, hi=20.0)
    kp[0, 2] = [8.0, 10.0]  # x = W: outside
    ref_t, ref_w = (np.asarray(a) for a in jt.render_heatmap_targets(kp, vis, (16, 8), 2.0))
    t, w = tt.render_heatmap_targets(torch.from_numpy(kp), torch.from_numpy(vis), (16, 8), 2.0,
                                     device="cpu")
    assert t.dtype == torch.from_numpy(kp).dtype and t.shape == ref_t.shape == (3, 17, 16, 8)
    np.testing.assert_array_equal(w.numpy(), ref_w)
    assert 0 < ref_w.sum() < ref_w.size
    np.testing.assert_allclose(t.numpy(), ref_t, rtol=0, atol=TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
def test_simcc_targets_match_jax(dtype):
    kp, vis = _keypoints(dtype, hi=36.0)
    ref = [np.asarray(a) for a in jt.render_simcc_targets(kp, vis, (32, 40), 2.0, 6.0)]
    out = tt.render_simcc_targets(torch.from_numpy(kp), torch.from_numpy(vis), (32, 40), 2.0, 6.0,
                                  device="cpu")
    assert [o.shape for o in out] == [r.shape for r in ref] == [(3, 17, 64), (3, 17, 80), (3, 17)]
    np.testing.assert_array_equal(out[2].numpy(), ref[2])
    for o, r in zip(out[:2], ref[:2]):
        np.testing.assert_allclose(o.numpy(), r, rtol=0, atol=TOL[dtype])


def test_centernet_targets_match_jax():
    rng = np.random.default_rng(1)
    x0 = rng.uniform(0, 150, (5, 2))
    boxes = np.concatenate([x0, x0 + rng.uniform(8, 100, (5, 2))], -1).astype(np.float32)
    boxes[0] = [250.0, 250.0, 256.0, 256.0]  # a tiny box at the corner: min_radius
    ref = [np.asarray(a) for a in jt.render_centernet_targets(boxes, (16, 16))]
    out = tt.render_centernet_targets(torch.from_numpy(boxes), (16, 16), device="cpu")
    for o, r in zip(out, ref):
        assert o.dtype == torch.float32 and tuple(o.shape) == r.shape
        np.testing.assert_allclose(o.numpy(), r, rtol=0, atol=ULP2 * max(np.abs(r).max(), 1.0))


def _grad_check(jfn, tfn, args):
    """Value and gradient w.r.t. the first argument, JAX against the port."""
    ref_v, ref_g = jax.value_and_grad(jfn)(*args)
    targs = [torch.tensor(np.asarray(a), requires_grad=(i == 0)) for i, a in enumerate(args)]
    v = tfn(*targs)
    (g,) = torch.autograd.grad(v, targs[0])
    np.testing.assert_allclose(v.item(), float(ref_v), rtol=1e-6)
    ref_g = np.asarray(ref_g)
    assert np.abs(ref_g).max() > 0
    np.testing.assert_allclose(g.numpy(), ref_g, rtol=0, atol=1e-5 * np.abs(ref_g).max())


def test_heatmap_mse_loss_and_grad_match_jax():
    rng = np.random.default_rng(2)
    pred = rng.normal(size=(3, 17, 16, 8)).astype(np.float32)
    target = rng.uniform(size=(3, 17, 16, 8)).astype(np.float32)
    w = (rng.uniform(size=(3, 17)) > 0.3).astype(np.float32)
    _grad_check(jl.heatmap_mse_loss, tl.heatmap_mse_loss, (pred, target, w))


def test_simcc_kl_loss_and_grad_match_jax():
    rng = np.random.default_rng(3)
    kp = rng.uniform(0, 30, (2, 17, 2)).astype(np.float32)
    vis = np.ones((2, 17), np.float32)
    vis[0, 3] = 0
    lx, ly, w = (np.asarray(a) for a in jt.render_simcc_targets(kp, vis, (32, 40)))
    px = (3 * rng.normal(size=lx.shape)).astype(np.float32)
    py = (3 * rng.normal(size=ly.shape)).astype(np.float32)
    assert (lx == 0).any()  # the entropy's labels > 0 mask is exercised

    def jfn(px, py, lx, ly, w):
        return jl.simcc_kl_loss(px, py, lx, ly, w)

    def tfn(px, py, lx, ly, w):
        return tl.simcc_kl_loss(px, py, lx, ly, w)

    _grad_check(jfn, tfn, (px, py, lx, ly, w))
    _grad_check(lambda py, px, lx, ly, w: jfn(px, py, lx, ly, w),
                lambda py, px, lx, ly, w: tfn(px, py, lx, ly, w), (py, px, lx, ly, w))
    # The true KL: 0 at a perfect match (logits = log labels where labels > 0).
    lab = torch.tensor(lx[1])
    perfect = torch.where(lab > 0, torch.log(lab.clamp(min=1e-30)), torch.full_like(lab, -1e4))
    kl = tl.simcc_kl_loss(perfect[None], perfect[None], lab[None], lab[None],
                          torch.ones(1, 17))
    assert abs(kl.item()) < 1e-4


@pytest.mark.parametrize("part", ["center", "wh", "offset"])
def test_centernet_focal_loss_and_grad_match_jax(part):
    rng = np.random.default_rng(4)
    boxes = np.array([[20, 30, 120, 200], [100, 40, 180, 90]], np.float32)
    ct, wh, off, mask = (np.asarray(a) for a in jt.render_centernet_targets(boxes, (16, 16)))
    outs = {"center": rng.normal(size=(2, 16, 16)).astype(np.float32),
            "wh": rng.uniform(10, 150, (2, 16, 16, 2)).astype(np.float32),
            "offset": rng.uniform(0, 1, (2, 16, 16, 2)).astype(np.float32)}
    rest = [k for k in outs if k != part]

    def jfn(x, *others):
        return jl.centernet_focal_loss({part: x, **dict(zip(rest, others))}, ct, wh, off, mask)

    def tfn(x, *others):
        return tl.centernet_focal_loss({part: x, **dict(zip(rest, others))},
                                       *(torch.tensor(a) for a in (ct, wh, off, mask)))

    _grad_check(jfn, tfn, (outs[part], *(outs[k] for k in rest)))

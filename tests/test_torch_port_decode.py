"""The port's heatmap decode against the JAX package.

- `heatmap_argmax_decode`: integer argmax and ±0.25 steps, exact to 1e-6.
- `heatmap_moments`: float64 on both sides, 1e-6 (sums in another order).
- The plain `fused_heatmap_decode` (the CUDA kernel's CPU version) against
  the Pallas kernel in interpret mode: means, xy and score to 1e-5; the
  covariance terms to `COV_ATOL` = 8 f32 ulps of (H-1)² (3.8e-3 at 64x48),
  because var = Σvy²/Σv − mean² cancels in f32 (terms up to 63² = 3969)
  and so amplifies the other summation order (measured up to 1.2e-3).  Its raw f32 sums are held to 1e-5 relative
  against float64.  Against the jnp pair (centred moments): 1e-3 absolute
  on the covariance terms, as the JAX kernel documents.
"""

import numpy as np
import pytest
import torch

from multi_camera_3d_pose_estimation_tpu.ops.heatmap_decode import heatmap_argmax_decode as j_argmax
from multi_camera_3d_pose_estimation_tpu.ops.moments import heatmap_moments as j_moments
from multi_camera_3d_pose_estimation_tpu.ops.pallas.fused_decode import fused_heatmap_decode as j_fused
from multi_camera_3d_pose_estimation_tpu_torch.ops import fused_decode as tfd
from multi_camera_3d_pose_estimation_tpu_torch.ops.heatmap_decode import heatmap_argmax_decode
from multi_camera_3d_pose_estimation_tpu_torch.ops.moments import heatmap_moments


def _maps(kind, shape=(2, 5, 64, 48), seed=0):
    rng = np.random.default_rng(seed)
    *b, H, W = shape
    if kind == "random":
        return rng.uniform(0, 1, shape).astype(np.float32)
    if kind == "peaked":
        ys, xs = np.mgrid[0:H, 0:W]
        cy = rng.uniform(-2, H + 1, b)[..., None, None]  # some peaks off the edge
        cx = rng.uniform(-2, W + 1, b)[..., None, None]
        amp = rng.uniform(0.05, 1.5, b)[..., None, None]
        g = amp * np.exp(-((ys - cy) ** 2 + (xs - cx) ** 2) / (2 * 2.0 ** 2))
        return (g + rng.uniform(0, 0.005, shape)).astype(np.float32)
    if kind == "tied":
        m = np.round(rng.uniform(0, 1, shape) * 3) / 3  # many exact ties, incl. the peak
        m[..., 0, 0] = m.max()
        return m.astype(np.float32)
    if kind == "zero":
        m = np.zeros(shape, np.float32)
        m[0, 1] = 0.005  # under the threshold everywhere: zero moments
        return m
    raise ValueError(kind)


KINDS = ["random", "peaked", "tied", "zero"]
COV_ATOL = 8 * float(np.finfo(np.float32).eps) * 63 ** 2


@pytest.mark.parametrize("kind", KINDS)
def test_argmax_decode_matches_jax(kind):
    hm = _maps(kind)
    xy_ref, s_ref = (np.asarray(a) for a in j_argmax(hm))
    xy, s = heatmap_argmax_decode(torch.from_numpy(hm))
    np.testing.assert_allclose(xy.numpy(), xy_ref, rtol=0, atol=1e-6)
    np.testing.assert_allclose(s.numpy(), s_ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("kind", KINDS)
def test_moments_match_jax(kind):
    hm = _maps(kind).astype(np.float64)
    ref = np.asarray(j_moments(hm))
    out = heatmap_moments(torch.from_numpy(hm)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("kind", KINDS)
def test_plain_fused_decode_matches_pallas_interpret(kind):
    hm = _maps(kind, shape=(2, 5, 64, 48))
    m_ref, xy_ref, s_ref = (np.asarray(a) for a in j_fused(hm, interpret=True))
    m, xy, s = tfd.fused_heatmap_decode(torch.from_numpy(hm))
    np.testing.assert_allclose(m.numpy()[..., :2], m_ref[..., :2], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(m.numpy()[..., 2:], m_ref[..., 2:], rtol=0, atol=COV_ATOL)
    np.testing.assert_allclose(xy.numpy(), xy_ref, rtol=0, atol=1e-6)
    np.testing.assert_allclose(s.numpy(), s_ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("kind", KINDS)
def test_plain_fused_decode_matches_jnp_pair(kind):
    hm = _maps(kind, seed=3)
    m_ref = np.asarray(j_moments(hm))
    xy_ref, s_ref = (np.asarray(a) for a in j_argmax(hm))
    m, xy, s = tfd.fused_heatmap_decode(torch.from_numpy(hm))
    np.testing.assert_allclose(m.numpy()[..., :2], m_ref[..., :2], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(m.numpy()[..., 2:], m_ref[..., 2:], rtol=0, atol=1e-3)
    np.testing.assert_allclose(xy.numpy(), xy_ref, rtol=0, atol=1e-6)
    np.testing.assert_allclose(s.numpy(), s_ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("kind", ["random", "peaked"])
def test_decode_raw_sums_match_float64(kind):
    hm = _maps(kind).reshape(-1, 64 * 48)
    raw = tfd.heatmap_decode_raw(torch.from_numpy(hm), 48, 0.01).numpy()
    v = np.where(hm < 0.01, 0.0, hm.astype(np.float64))
    lin = np.arange(64 * 48)
    x, y = lin % 48, lin // 48
    ref = np.stack([v.sum(-1), (v * x).sum(-1), (v * y).sum(-1), (v * x * x).sum(-1),
                    (v * x * y).sum(-1), (v * y * y).sum(-1)], -1)
    np.testing.assert_allclose(raw[:, :6], ref, rtol=1e-5, atol=1e-6)


def test_decode_raw_plain_layout():
    """The (N, 12) result the kernel also writes: raw sums, peak, first argmax, neighbours."""
    hm = np.zeros((1, 4, 8), np.float32)
    hm[0, 1, 2] = hm[0, 2, 5] = 2.0  # tie: the first in row-major order wins
    hm[0, 1, 3] = 0.5
    hm[0, 0, 2] = 0.25
    raw = tfd.heatmap_decode_raw(torch.from_numpy(hm.reshape(1, -1)), 8, 0.01)[0].numpy()
    assert raw[0] == pytest.approx(4.75)
    assert raw[6] == 2.0 and raw[7] == 1 * 8 + 2
    np.testing.assert_array_equal(raw[8:], [0.5, 0.0, 0.0, 0.25])


def test_decode_wrapper_refuses_other_devices():
    with pytest.raises(ValueError, match="unsupported device"):
        tfd.heatmap_decode_raw(torch.zeros(1, 8, device="meta"), 4)

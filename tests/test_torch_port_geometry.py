"""The port's geometry ops against the JAX package, in float64.

Both sides run the same unrolled arithmetic (10 undistort steps, 12
squarings of the 4x4 power solve) in float64, so the only differences are
summation order inside the small matmuls: held to 1e-9 relative.
"""

import jax
import numpy as np
import pytest
import torch

from multi_camera_3d_pose_estimation_tpu.ops import triangulation as jtri
from multi_camera_3d_pose_estimation_tpu.ops.undistort import undistort_points as j_undistort
from multi_camera_3d_pose_estimation_tpu_torch.ops import triangulation as ttri
from multi_camera_3d_pose_estimation_tpu_torch.ops.undistort import undistort_points as t_undistort

from tests.conftest import project_np

RTOL = 1e-9  # float64 on both sides; only the order of a few sums differs


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float64))


def _rig(rng, n_cams):
    """n_cams cameras yawed around a volume at z ~ 350, mild distortion."""
    Ks, Rs, Ts, ds = [], [], [], []
    for c in range(n_cams):
        th = np.deg2rad(-30.0 + 60.0 * c / max(n_cams - 1, 1))
        Rs.append(np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0], [-np.sin(th), 0, np.cos(th)]]))
        Ts.append(np.array([-150.0 * np.sin(th), 3.0 * c, 20.0 * c]))
        f = rng.uniform(850, 950)
        Ks.append(np.array([[f, 0.5 * c, rng.uniform(600, 660)], [0, f * 1.01, rng.uniform(340, 380)],
                            [0, 0, 1.0]]))
        ds.append(rng.normal(0, [0.1, 0.03, 5e-4, 5e-4, 5e-3]))
    return np.stack(Ks), np.stack(Rs), np.stack(Ts), np.stack(ds)


@pytest.mark.parametrize("p_shape", ["none", "3x3", "3x4"])
def test_undistort_matches_jax(camera_pair, p_shape):
    cp = camera_pair
    pts = project_np(cp["pts3d"], cp["K1"], cp["R1"], cp["T1"], cp["d1"])
    P = {"none": None, "3x3": cp["K1"],
         "3x4": cp["K1"] @ np.concatenate([cp["R2"], cp["T2"][:, None]], axis=1)}[p_shape]
    ref = np.asarray(j_undistort(np.asarray(pts, np.float64), cp["K1"], cp["d1"], P=P))
    out = t_undistort(_t(pts), _t(cp["K1"]), _t(cp["d1"]), P=None if P is None else _t(P))
    np.testing.assert_allclose(out.numpy(), ref, rtol=RTOL, atol=0)


def test_triangulate_dlt_matches_jax(camera_pair):
    cp = camera_pair
    Pa = cp["K1"] @ np.concatenate([cp["R1"], cp["T1"][:, None]], axis=1)
    Pb = cp["K2"] @ np.concatenate([cp["R2"], cp["T2"][:, None]], axis=1)
    pa = project_np(cp["pts3d"], cp["K1"], cp["R1"], cp["T1"])
    pb = project_np(cp["pts3d"], cp["K2"], cp["R2"], cp["T2"])
    pa = pa + np.random.default_rng(1).normal(0, 2.0, pa.shape)  # noisy systems
    pa[3] = np.nan
    pb[7, 1] = np.inf
    ref = np.asarray(jax.jit(jtri.triangulate_dlt)(pa, pb, Pa, Pb))
    out = ttri.triangulate_dlt(_t(pa), _t(pb), _t(Pa), _t(Pb)).numpy()
    assert np.isnan(out[3]).all() and np.isnan(out[7]).all()
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=0)
    # and the triangulation is right: noise-free points come back exactly
    good = np.ones(len(pa), bool)
    good[[3, 7]] = False
    clean = ttri.triangulate_dlt(_t(project_np(cp["pts3d"], cp["K1"], cp["R1"], cp["T1"])),
                                 _t(pb), _t(Pa), _t(Pb)).numpy()
    np.testing.assert_allclose(clean[good], cp["pts3d"][good], rtol=1e-7)


@pytest.mark.parametrize("n_cams", [2, 3, 4])
def test_triangulate_top2_matches_jax(n_cams):
    rng = np.random.default_rng(10 + n_cams)
    Ks, Rs, Ts, ds = _rig(rng, n_cams)
    X = rng.uniform([-60, -60, 300], [60, 60, 420], size=(5, 17, 3))
    kpts = np.stack([project_np(X.reshape(-1, 3), Ks[c], Rs[c], Ts[c], ds[c]).reshape(5, 17, 2)
                     for c in range(n_cams)], axis=-2)  # (5, 17, C, 2)
    kpts = kpts + rng.normal(0, 0.5, kpts.shape)
    conf = rng.uniform(0.2, 1.0, (5, 17, n_cams))
    kpts[0, 0, 0] = np.nan  # a NaN keypoint (selected view -> NaN point)
    conf[0, 1, :] = 0.5  # all views tied
    conf[0, 2, 0] = np.nan  # NaN confidence never wins
    conf[0, 3, :] = np.nan
    conf[1, :, :2] = 0.7  # ties between two views on every joint
    ref = np.asarray(jax.jit(jtri.triangulate_top2)(kpts, conf, Ks, ds, Rs, Ts))
    out = ttri.triangulate_top2(_t(kpts), _t(conf), _t(Ks), _t(ds), _t(Rs), _t(Ts)).numpy()
    np.testing.assert_array_equal(np.isnan(out), np.isnan(ref))
    assert np.isfinite(out).mean() > 0.9
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=0)

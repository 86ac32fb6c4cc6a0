"""The port's calibration (`calib/`) against the JAX package's, on the CPU.

Both packages run in float64 (the JAX side with ``jax_enable_x64``, which
``tests/conftest.py`` turns on) on inputs made from numpy seeds, in the
manner of ``tests/test_calibration.py``; the port with ``device="cpu"``.
``rel`` is the largest difference over the largest reference entry.

- `levenberg_marquardt`: x, the final cost and the whole cost history at
  1e-9, one problem with rejected steps, a batch of four problems whose λ
  paths differ (against ``jax.vmap`` of the JAX solver), and a step that
  leaves the finite numbers (rejected on both sides).
- `find_homography`, `zhang_intrinsics_init`: 1e-9; a flipped SVD sign
  (every ``torch.linalg.svd`` returning -U, S, -Vh) changes nothing beyond
  1e-12, through the whole of `calibrate_camera`.
- `calibrate_camera` (12 views of a 6x9 board, noiseless and at 0.2 px):
  the cost converges within 15 steps, after which both solvers wander along
  a valley where the cost is flat to 1e-15: the rmse at 1e-12, K at 1e-8
  (measured 1.3e-9), and every corner reprojected through the two
  solutions within 1e-6 px; against truth as ``tests/test_calibration.py``
  holds the JAX solver.
- `solve_pnp` (planar board and a general cloud, one and batched),
  `stereo_calibrate` (4 views), `mean_rotation`: 1e-9.
- The board tools, manual extrinsics and corner detection (with cv2, and
  with both packages' ``_cv2`` set to None): bit for bit; `verify`'s
  overlays bit for bit, its points and poses at 1e-9.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multi_camera_3d_pose_estimation_tpu import calib as jcal
from multi_camera_3d_pose_estimation_tpu.calib import corners as jcorners
from multi_camera_3d_pose_estimation_tpu_torch import calib as pcal
from multi_camera_3d_pose_estimation_tpu_torch.calib import corners as pcorners
from tests.conftest import project_np

K_TRUE = np.array([[800.0, 0.0, 320.0], [0.0, 790.0, 240.0], [0.0, 0.0, 1.0]])
DIST_TRUE = np.array([-0.12, 0.03, 0.001, -0.0008, 0.0])
K1_TRUE = np.array([[760.0, 0.0, 310.0], [0.0, 765.0, 250.0], [0.0, 0.0, 1.0]])
DIST1_TRUE = np.array([0.05, -0.01, -0.0005, 0.0006, 0.0])
N_VIEWS = 12


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def rodrigues_np(r):
    th = np.linalg.norm(r)
    if th < 1e-12:
        return np.eye(3)
    k = r / th
    Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * Kx @ Kx


def synth_views(seed, noise, n_views=N_VIEWS):
    """``tests/test_calibration.py::synth_views`` with a numpy Rodrigues."""
    rng = np.random.default_rng(seed)
    obj = pcal.board_object_points(6, 9, 3.0)
    imgs = []
    for _ in range(n_views):
        R = rodrigues_np(rng.uniform(-0.4, 0.4, 3))
        t = np.array([rng.uniform(-8, 8), rng.uniform(-6, 6), rng.uniform(40, 90)])
        img = project_np(obj, K_TRUE, R, t, DIST_TRUE)
        imgs.append(img + rng.normal(0, noise, img.shape))
    return np.stack([obj] * n_views), np.stack(imgs)


# ----------------------------------------------------------------------------- LM

T_FIT = np.linspace(0.0, 2.0, 40)


def fit_data(seed):
    rng = np.random.default_rng(seed)
    truth = np.array([2.5, -1.3, 0.5, 3.0]) * rng.uniform(0.8, 1.2, 4)
    y = truth[0] * np.exp(truth[1] * T_FIT) + truth[2] * np.sin(truth[3] * T_FIT)
    return y + rng.normal(0, 0.02, T_FIT.shape)


def j_residual(y):
    def fn(x):
        return x[0] * jnp.exp(x[1] * T_FIT) + x[2] * jnp.sin(x[3] * T_FIT) - y
    return fn


def p_residual(y):
    t, y = torch.as_tensor(T_FIT), torch.as_tensor(y)

    def fn(x):  # x (n,) or (B, n) with y (B, 40)
        x = x[..., None]
        return x[..., 0, :] * torch.exp(x[..., 1, :] * t) + x[..., 2, :] * torch.sin(
            x[..., 3, :] * t) - y
    return fn


X0S = np.array([[1.0, -0.5, 0.2, 2.5], [3.0, -2.0, 1.0, 3.5], [0.5, 0.1, -0.3, 2.0],
                [2.0, -1.0, 0.6, 4.5]])


def test_lm_matches_jax():
    y = fit_data(0)
    xj, fj, hj = jcal.levenberg_marquardt(j_residual(y), jnp.asarray(X0S[0]), n_iter=30)
    xp, fp, hp = pcal.levenberg_marquardt(p_residual(y), torch.as_tensor(X0S[0]), n_iter=30)
    assert xp.shape == (4,) and fp.shape == () and hp.shape == (30,)
    hj = np.asarray(hj)
    assert (np.diff(hj) == 0).any() and hj[-1] < hj[0]  # some steps were rejected
    assert rel(xp, xj) < 1e-9 and rel(fp, fj) < 1e-9 and rel(hp, hj) < 1e-9


def test_lm_batched_keeps_its_own_lambda_per_problem():
    ys = np.stack([fit_data(s) for s in range(4)])
    xj, fj, hj = jax.vmap(
        lambda x0, y: jcal.levenberg_marquardt(
            lambda x: x[0] * jnp.exp(x[1] * T_FIT) + x[2] * jnp.sin(x[3] * T_FIT) - y,
            x0, n_iter=30))(jnp.asarray(X0S), jnp.asarray(ys))
    xp, fp, hp = pcal.levenberg_marquardt(p_residual(ys), torch.as_tensor(X0S), n_iter=30)
    assert xp.shape == (4, 4) and fp.shape == (4,) and hp.shape == (4, 30)
    rejected = np.diff(np.asarray(hj), axis=1) == 0
    assert len({r.tobytes() for r in rejected}) > 1  # the rows' accept paths differ
    assert rel(xp, xj) < 1e-9 and rel(fp, fj) < 1e-9 and rel(hp, hj) < 1e-9
    for b in range(4):  # each row as its own problem
        x1, _, h1 = pcal.levenberg_marquardt(p_residual(ys[b]), torch.as_tensor(X0S[b]),
                                             n_iter=30)
        assert rel(x1, xp[b]) < 1e-12 and rel(h1, hp[b]) < 1e-12


def test_lm_rejects_a_non_finite_step():
    """At x = 0, sqrt's Jacobian is infinite: the step is NaN, rejected."""
    xj, fj, hj = jcal.levenberg_marquardt(lambda x: jnp.sqrt(x) + 1.0, jnp.zeros(1), n_iter=5)
    xp, fp, hp = pcal.levenberg_marquardt(lambda x: torch.sqrt(x) + 1.0,
                                          torch.zeros(1, dtype=torch.float64), n_iter=5)
    np.testing.assert_array_equal(np.asarray(xj), 0.0)
    np.testing.assert_array_equal(xp.numpy(), 0.0)
    np.testing.assert_array_equal(hp.numpy(), np.asarray(hj))
    assert float(fp) == float(fj) == 1.0


# -------------------------------------------------------------- closed forms


def test_find_homography_matches_jax():
    rng = np.random.default_rng(1)
    H_true = np.array([[1.2, 0.1, 5.0], [-0.05, 0.9, -3.0], [1e-4, -2e-4, 1.0]])
    src = rng.uniform(-10, 10, (3, 40, 2))
    dst_h = np.concatenate([src, np.ones((3, 40, 1))], -1) @ H_true.T
    dst = dst_h[..., :2] / dst_h[..., 2:] + rng.normal(0, 0.01, (3, 40, 2))
    Hp = pcal.find_homography(src, dst, device="cpu")  # batched over 3 point sets
    assert Hp.shape == (3, 3, 3) and Hp.dtype == torch.float64
    for v in range(3):
        Hj = np.asarray(jcal.find_homography(src[v], dst[v]))
        assert rel(Hp[v], Hj) < 1e-9
        assert rel(pcal.find_homography(torch.as_tensor(src[v]), dst[v]), Hj) < 1e-9
    assert rel(Hp[0], H_true) < 1e-2


@pytest.fixture
def flipped_svd(monkeypatch):
    """Every ``torch.linalg.svd`` returns the other valid sign: -U, S, -Vh."""
    svd = torch.linalg.svd

    def flipped(A, full_matrices=True):
        U, S, Vh = svd(A, full_matrices=full_matrices)
        return -U, S, -Vh

    def flip():
        monkeypatch.setattr(torch.linalg, "svd", flipped)
    return flip


def test_zhang_init_matches_jax_and_ignores_the_svd_sign(flipped_svd):
    obj, img = synth_views(2, 0.0)
    Hs = np.stack([np.asarray(jcal.find_homography(o[:, :2], i)) for o, i in zip(obj, img)])
    Kj = np.asarray(jcal.zhang_intrinsics_init(Hs))
    Kp = pcal.zhang_intrinsics_init(Hs, device="cpu").numpy()
    assert rel(Kp, Kj) < 1e-9 and rel(Kp, K_TRUE) < 0.1  # the closed form ignores distortion
    rj, tj = jcal.extrinsics_from_homography(Hs[0], Kj)
    rp, tp = pcal.extrinsics_from_homography(Hs, Kp, device="cpu")
    assert rel(rp[0], rj) < 1e-9 and rel(tp[0], tj) < 1e-9
    flipped_svd()
    assert rel(pcal.zhang_intrinsics_init(Hs, device="cpu"), Kp) < 1e-12
    rf, tf = pcal.extrinsics_from_homography(Hs, Kp, device="cpu")
    assert rel(rf, rp) < 1e-12 and rel(tf, tp) < 1e-12


def test_calibration_ignores_the_svd_sign(flipped_svd):
    obj, img = synth_views(3, 0.2, n_views=6)
    ref = pcal.calibrate_camera(obj, img, device="cpu")
    flipped_svd()
    out = pcal.calibrate_camera(obj, img, device="cpu")
    assert abs(out[0] - ref[0]) <= 1e-12 * ref[0]
    for a, b in zip(out[1:], ref[1:]):
        assert rel(a, b) < 1e-9


# ------------------------------------------------------------- calibrate_camera


def reproject(obj, K, dist, rvecs, tvecs):
    return np.stack([project_np(o, K, rodrigues_np(r), t, dist.reshape(-1))
                     for o, r, t in zip(obj, rvecs, tvecs)])


@pytest.mark.parametrize("noise", [0.0, 0.2])
def test_calibrate_camera_matches_jax(noise):
    obj, img = synth_views(4, noise)
    rmse_j, *out_j = jcal.calibrate_camera(obj, img)
    out_j = [np.asarray(a) for a in out_j]
    rmse_p, K, dist, rvecs, tvecs = pcal.calibrate_camera(obj, img, device="cpu")
    assert isinstance(rmse_p, float)
    assert K.shape == (3, 3) and dist.shape == (1, 5) and rvecs.shape == tvecs.shape == (12, 3)
    assert all(a.dtype == np.float64 for a in (K, dist, rvecs, tvecs))
    if noise:
        assert abs(rmse_p - rmse_j) <= 1e-12 * rmse_j and rmse_p < 0.5
        np.testing.assert_allclose(np.diag(K)[:2], np.diag(K_TRUE)[:2], rtol=0.02)
    else:
        assert rmse_p < 1e-6 and rmse_j < 1e-6
        np.testing.assert_allclose(K, K_TRUE, rtol=5e-3)
        np.testing.assert_allclose(dist.ravel(), DIST_TRUE, atol=5e-3)
    assert rel(K, out_j[0]) < 1e-8
    gap = np.abs(reproject(obj, K, dist, rvecs, tvecs) - reproject(obj, *out_j)).max()
    assert gap < 1e-6, gap


# ------------------------------------------------------------------------ PnP


def test_solve_pnp_matches_jax_planar_and_general():
    rng = np.random.default_rng(5)
    obj, img = synth_views(5, 0.2, n_views=3)
    cloud = rng.uniform([-20, -20, 0], [20, 20, 15], (54, 3))  # the board's N: one JAX compile
    R_true = rodrigues_np(np.array([0.2, -0.3, 0.1]))
    cloud_img = project_np(cloud, K_TRUE, R_true, np.array([2.0, -1.0, 60.0]), DIST_TRUE)
    for o, i in ((obj[0], img[0]), (cloud, cloud_img)):
        rj, tj = jcal.solve_pnp(o, i, K_TRUE, DIST_TRUE)
        rp, tp = pcal.solve_pnp(o, i, K_TRUE, DIST_TRUE, device="cpu")
        assert rp.shape == tp.shape == (3,) and rp.dtype == torch.float64
        assert rel(rp, rj) < 1e-9 and rel(tp, tj) < 1e-9
    np.testing.assert_allclose(rp.numpy(), [0.2, -0.3, 0.1], atol=1e-6)
    # A batch of views, each its own problem.
    rb, tb = pcal.solve_pnp(obj, img, K_TRUE, DIST_TRUE, device="cpu")
    assert rb.shape == tb.shape == (3, 3)
    for v in range(3):
        rv, tv = pcal.solve_pnp(obj[v], img[v], K_TRUE, DIST_TRUE, device="cpu")
        assert rel(rb[v], rv) < 1e-12 and rel(tb[v], tv) < 1e-12


# --------------------------------------------------------------------- stereo


def stereo_views(seed, n_views=4):
    """``tests/test_calibration.py::test_stereo_calibrate``'s rig."""
    rng = np.random.default_rng(seed)
    R_rel = rodrigues_np(np.array([0.05, 0.5, -0.02]))
    t_rel = np.array([-25.0, 1.0, 6.0])
    obj = pcal.board_object_points(6, 9, 3.0)
    i0, i1 = [], []
    for _ in range(n_views):
        Rb = rodrigues_np(rng.uniform(-0.3, 0.3, 3))
        tb = np.array([rng.uniform(-5, 5), rng.uniform(-4, 4), rng.uniform(50, 80)])
        i0.append(project_np(obj, K_TRUE, Rb, tb, DIST_TRUE) + rng.normal(0, 0.1, (54, 2)))
        i1.append(project_np(obj, K1_TRUE, R_rel @ Rb, R_rel @ tb + t_rel, DIST1_TRUE)
                  + rng.normal(0, 0.1, (54, 2)))
    return (np.stack([obj] * n_views), np.stack(i0), np.stack(i1)), R_rel, t_rel


@pytest.fixture(scope="module")
def stereo_both():
    """One stereo solve per side (the JAX one is mostly compile, ~15 s)."""
    views, R_rel, t_rel = stereo_views(6)
    args = (*views, K_TRUE, DIST_TRUE, K1_TRUE, DIST1_TRUE)
    return (jcal.stereo_calibrate(*args), pcal.stereo_calibrate(*args, device="cpu"),
            R_rel, t_rel)


def test_stereo_calibrate_matches_jax(stereo_both):
    (rmse_j, R_j, T_j), (rmse_p, R_p, T_p), R_rel, t_rel = stereo_both
    assert isinstance(rmse_p, float) and R_p.shape == (3, 3) and T_p.shape == (3, 1)
    assert abs(rmse_p - rmse_j) <= 1e-12 * rmse_j and rmse_p < 0.2
    assert rel(R_p, np.asarray(R_j)) < 1e-9 and rel(T_p, np.asarray(T_j)) < 1e-9
    np.testing.assert_allclose(R_p, R_rel, atol=5e-3)
    np.testing.assert_allclose(T_p.ravel(), t_rel, atol=0.5)


def test_mean_rotation_matches_jax():
    rng = np.random.default_rng(7)
    base = rng.uniform(-1, 1, 3)
    Rs = np.stack([rodrigues_np(base + rng.normal(0, 0.05, 3)) for _ in range(5)])
    Rj = np.asarray(jcal.mean_rotation(Rs))
    Rp = pcal.mean_rotation(Rs, device="cpu")
    assert rel(Rp, Rj) < 1e-12
    np.testing.assert_allclose(Rp.numpy() @ Rp.numpy().T, np.eye(3), atol=1e-12)
    assert abs(np.linalg.det(Rp.numpy()) - 1.0) < 1e-12


# ---------------------------------------------------------------- host tools


def test_board_tools_and_manual_extrinsics_equal_jax():
    for a, b in ((jcal.create_checkerboard_image(6, 9, 1920, 1080, border_px=10),
                  pcal.create_checkerboard_image(6, 9, 1920, 1080, border_px=10)),
                 (jcal.create_checkerboard_image(5, 7, 800, 600, 4),
                  pcal.create_checkerboard_image(5, 7, 800, 600, 4))):
        np.testing.assert_array_equal(a[0], b[0])
        assert a[1] == b[1]
    assert pcal.checkerboard_square_size_cm(97, 5.0) == jcal.checkerboard_square_size_cm(97, 5.0)
    np.testing.assert_array_equal(pcal.board_object_points(4, 6, 2.5),
                                  jcal.board_object_points(4, 6, 2.5))
    for args in (([100.0, 0.0, 50.0], 3.0, 4.0), ([-20.0, 1.0, 7.0], 5.0, -2.0)):
        for a, b in zip(pcal.compute_extrinsic_from_measurements(*args),
                        jcal.compute_extrinsic_from_measurements(*args)):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        pcal.create_checkerboard_image(6, 9, 50, 40, border_px=10)


def board_images():
    """A clean board (one the numpy fallback finds), ``tests/test_cli_viz.py``'s
    warped renders (found by cv2 only), and noise."""
    cv2 = pytest.importorskip("cv2")
    from tests.test_cli_viz import render_board_views

    K = np.array([[620.0, 0, 320.0], [0, 620.0, 240.0], [0, 0, 1]])
    warped, k = render_board_views(np.random.default_rng(8), K, n_views=2)
    clean, _ = pcal.create_checkerboard_image(4, 5, 200, 160)
    noise = np.random.default_rng(9).integers(0, 255, (120, 160, 3), dtype=np.uint8)
    return [(clean, 3, 4), (cv2.cvtColor(warped[0], cv2.COLOR_GRAY2BGR), 5, 7),
            (warped[1], 5, 7), (noise, 4, 6)], K, k


@pytest.mark.parametrize("with_cv2", [True, False])
def test_corners_equal_jax(monkeypatch, with_cv2):
    images, _, _ = board_images()
    if not with_cv2:
        monkeypatch.setattr(jcorners, "_cv2", None)
        monkeypatch.setattr(pcorners, "_cv2", None)
    found = []
    for img, rows, cols in images:
        fj, cj = jcorners.find_checkerboard_corners(img, rows, cols)
        fp, cp = pcorners.find_checkerboard_corners(img, rows, cols)
        assert fp == fj
        found.append(fp)
        if fp:
            assert cp.dtype == cj.dtype == np.float32
            np.testing.assert_array_equal(cp, cj)
            gray = img if img.ndim == 2 else img[..., 0]
            np.testing.assert_array_equal(pcorners.refine_corners_subpixel(gray, cp + 0.4),
                                          jcorners.refine_corners_subpixel(gray, cj + 0.4))
    assert found[0] and not found[-1]
    if with_cv2:
        assert all(found[:3])


def test_verify_matches_jax(tmp_path):
    pytest.importorskip("cv2")
    images, K, k = board_images()
    frame = np.zeros((240, 320, 3), np.uint8)
    R = rodrigues_np(np.array([0.1, -0.2, 0.05]))
    T = np.array([1.0, -2.0, 40.0])
    for Rin in (R, np.array([0.1, -0.2, 0.05])):
        oj, pj = jcal.draw_world_axes(frame, K, Rin, T, DIST_TRUE)
        op, pp = pcal.draw_world_axes(frame, K, Rin, T, DIST_TRUE)
        assert rel(pp, np.asarray(pj)) < 1e-12 and op.any()
        np.testing.assert_array_equal(op, oj)
    cam0 = [K, DIST_TRUE, np.eye(3), np.zeros(3)]
    cam1 = [K, DIST_TRUE.reshape(1, 5), R, T]
    (jdir := tmp_path / "jax").mkdir()
    (pdir := tmp_path / "port").mkdir()
    (oj, pj) = jcal.check_calibration("a", cam0, "b", cam1, save_dir=str(jdir))
    (op, pp) = pcal.check_calibration("a", cam0, "b", cam1, save_dir=str(pdir))
    for a, b in zip(op + pp, oj + pj):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-12, atol=1e-9)
    for name in sorted(os.listdir(jdir)):
        assert (pdir / name).read_bytes() == (jdir / name).read_bytes()
    # The world origin from a photographed board (planar PnP), and the
    # composition with a stereo pose.
    img = images[2][0]
    Rj, Tj = jcal.get_world_space_origin(K, None, img, 5, 7, square_size=float(k))
    Rp, Tp = pcal.get_world_space_origin(K, None, img, 5, 7, square_size=float(k), device="cpu")
    assert Rp.shape == (3, 3) and Tp.shape == (3, 1)
    assert rel(Rp, np.asarray(Rj)) < 1e-9 and rel(Tp, np.asarray(Tj)) < 1e-9
    with pytest.raises(RuntimeError, match="not found"):
        pcal.get_world_space_origin(K, None, images[3][0], 4, 6, device="cpu")
    outj = jcal.get_cam1_to_world_transforms(K, None, Rp, Tp, K, DIST_TRUE, R, T,
                                             save_dir=str(jdir))
    outp = pcal.get_cam1_to_world_transforms(K, None, Rp, Tp, K, DIST_TRUE, R, T,
                                             save_dir=str(pdir))
    np.testing.assert_array_equal(outp[0], outj[0])
    np.testing.assert_array_equal(outp[1], outj[1])
    for a, b in zip(outp[2], outj[2]):
        np.testing.assert_array_equal(a, b)
    for name in ("world_axes_cam0.png", "world_axes_cam1.png"):
        assert (pdir / name).read_bytes() == (jdir / name).read_bytes()

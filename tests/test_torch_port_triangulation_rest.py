"""The port's geometry, skeleton tables and the rest of triangulation against
the JAX package, in float64 on the CPU.

Tolerances: rotations, distortion and the rvec gradient are a few float64
operations apart (1e-12, gradient 1e-10); `triangulate_points` runs 12
matrix squarings on 4x4 systems summed in another order (1e-9 relative);
`triangulate_nview` adds C + 2 such solves and a residual gate (1e-8).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_camera_3d_pose_estimation_tpu import ops as jops
from multi_camera_3d_pose_estimation_tpu.ops import triangulation as jtri
from multi_camera_3d_pose_estimation_tpu.training.augment import flip_permutation as j_flip
from multi_camera_3d_pose_estimation_tpu.utils import skeleton as jsk
from multi_camera_3d_pose_estimation_tpu_torch import ops
from multi_camera_3d_pose_estimation_tpu_torch.training import flip_permutation
from multi_camera_3d_pose_estimation_tpu_torch.utils import skeleton as sk

from tests.conftest import project_np


# Jitted: one XLA compile per shape instead of one per primitive.
J_NVIEW = jax.jit(jops.triangulate_nview, static_argnames=("conf_weighted",))
J_TOP2 = jax.jit(jops.triangulate_top2)


def t64(a):
    return torch.as_tensor(np.array(a, np.float64))


def _rvecs():
    """Axis-angle vectors at θ = 0, small θ, generic θ and θ near π (and π
    itself), on axes with components of both signs and a dominant one."""
    rng = np.random.default_rng(0)
    axes = rng.normal(size=(6, 3))
    axes[3] = [0.0, 0.0, 1.0]
    axes[4] = [-0.6, 0.8, 0.0]
    axes /= np.linalg.norm(axes, axis=-1, keepdims=True)
    thetas = [0.0, 1e-9, 1e-5, 0.3, 2.0, np.pi - 1e-3, np.pi - 1e-6, np.pi]
    return np.array([a * th for a in axes for th in thetas])


def test_rodrigues_matrix_and_vector_match_jax():
    rv = _rvecs()
    R_ref = np.asarray(jops.rodrigues_matrix(jnp.asarray(rv)))
    R = ops.rodrigues_matrix(t64(rv)).numpy()
    np.testing.assert_allclose(R, R_ref, rtol=0, atol=1e-12)
    back_ref = np.asarray(jops.rodrigues_vector(jnp.asarray(R_ref)))
    back = ops.rodrigues_vector(t64(R_ref)).numpy()
    np.testing.assert_allclose(back, back_ref, rtol=0, atol=1e-12)
    # Unbatched, as the JAX package's lax.switch path takes it.
    for i in (5, 14, 47):
        np.testing.assert_allclose(ops.rodrigues_vector(t64(R_ref[i])).numpy(),
                                   np.asarray(jops.rodrigues_vector(jnp.asarray(R_ref[i]))),
                                   rtol=0, atol=1e-12)
    # The round trip recovers the vectors (away from π, where ±axis agree).
    ok = np.linalg.norm(rv, axis=-1) < 3.0
    np.testing.assert_allclose(back[ok], rv[ok], atol=1e-9)


def test_rotation_conversion_and_homogeneous_match_jax():
    rv = _rvecs()[10]
    R = np.asarray(jops.rodrigues_matrix(jnp.asarray(rv)))
    np.testing.assert_allclose(ops.rotation_conversion(t64(R)).numpy(),
                               np.asarray(jops.rotation_conversion(jnp.asarray(R))), atol=1e-12)
    np.testing.assert_allclose(ops.rotation_conversion(t64(rv), to_vector=False).numpy(),
                               np.asarray(jops.rotation_conversion(jnp.asarray(rv), False)),
                               atol=1e-12)
    np.testing.assert_array_equal(ops.rotation_conversion(t64(rv)).numpy(), rv)
    t = np.array([[1.0], [-2.0], [3.5]])
    np.testing.assert_array_equal(ops.make_homogeneous_rep_matrix(t64(R), t64(t)).numpy(),
                                  np.asarray(jops.make_homogeneous_rep_matrix(R, t)))


def test_distort_normalized_matches_jax():
    rng = np.random.default_rng(1)
    xy = rng.uniform(-0.8, 0.8, (50, 2))
    dist = np.array([-0.21, 0.05, 0.0008, -0.0011, 0.01])
    ref = np.asarray(jops.distort_normalized(jnp.asarray(xy), jnp.asarray(dist)))
    np.testing.assert_allclose(ops.distort_normalized(t64(xy), t64(dist)).numpy(), ref,
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(ops.distort_normalized(t64(xy), t64(dist[None])).numpy(), ref,
                               rtol=0, atol=1e-12)


@pytest.mark.parametrize("rvec", [np.zeros(3), np.array([0.1, -0.2, 0.05])])
def test_project_points_and_rvec_gradient_match_jax(camera_pair, rvec):
    """At the origin camera's exact-zero rvec the gradient must be finite and
    equal JAX's (the clamped θ); also at a generic rvec."""
    c = camera_pair
    pts = c["pts3d"][:20]
    w = np.random.default_rng(2).normal(size=(20, 2))

    def jloss(r):
        return jnp.sum(jops.project_points(jnp.asarray(pts), c["K1"], r, c["T2"], c["d1"])
                       * w)

    val_ref, g_ref = jax.value_and_grad(jloss)(jnp.asarray(rvec))
    r = t64(rvec).requires_grad_(True)
    val = (ops.project_points(t64(pts), t64(c["K1"]), r, t64(c["T2"]), t64(c["d1"]))
           * t64(w)).sum()
    (g,) = torch.autograd.grad(val, r)
    assert np.isfinite(g.numpy()).all()
    np.testing.assert_allclose(val.item(), float(val_ref), rtol=1e-12)
    np.testing.assert_allclose(g.numpy(), np.asarray(g_ref), rtol=1e-10, atol=1e-10)
    # Against the float64 oracle too, with the matrix form.
    R = ops.rodrigues_matrix(t64(rvec))
    proj = ops.project_points(t64(pts), t64(c["K1"]), R, t64(c["T2"]), t64(c["d1"])).numpy()
    np.testing.assert_allclose(proj, project_np(pts, c["K1"], R.numpy(), c["T2"], c["d1"]),
                               rtol=1e-12)


def test_skeleton_tables_and_helpers_match_jax():
    assert sk.CONNECTIVITY_DICT == jsk.CONNECTIVITY_DICT
    assert sk.POINT_INFO == jsk.POINT_INFO
    assert sk.BODYPARTS == jsk.BODYPARTS
    np.testing.assert_array_equal(flip_permutation("coco"), j_flip("coco"))
    pose = np.random.default_rng(3).normal(size=(4, 17, 3))
    ref = jsk.get_body_part_lengths(jnp.asarray(pose))
    out = sk.get_body_part_lengths(t64(pose))
    assert list(out) == list(ref)
    for k in ref:
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), rtol=1e-12)
    vec = sk.get_body_part_vects(t64(pose))
    for k, v in jsk.get_body_part_vects(jnp.asarray(pose)).items():
        np.testing.assert_array_equal(vec[k].numpy(), np.asarray(v))
    body = {"left_hip_left_knee": 51.0, "left_shoulder_left_elbow": 38.0}
    for a, b in zip(sk.body_length_edges(body), jsk.body_length_edges(body)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(KeyError):
        sk.body_length_edges({"left_hand": 1.0})
    pts = pose[..., :2]
    np.testing.assert_array_equal(sk.change_origin(t64(pts), 480).numpy(),
                                  np.asarray(jsk.change_origin(jnp.asarray(pts), 480)))


def test_triangulate_points_matches_jax(camera_pair):
    c = camera_pair
    uv = np.stack([project_np(c["pts3d"], c["K1"], c["R1"], c["T1"], c["d1"]),
                   project_np(c["pts3d"], c["K2"], c["R2"], c["T2"], c["d2"])], axis=1)
    uv = uv + np.random.default_rng(4).normal(0, 0.7, uv.shape)
    args = (c["K1"], c["d1"], c["R1"], c["T1"], c["K2"], c["d2"], c["R2"], c["T2"])
    ref = np.asarray(jax.jit(jops.triangulate_points)(jnp.asarray(uv), *args))
    out = ops.triangulate_points(t64(uv), *args).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-9)
    np.testing.assert_allclose(out, c["pts3d"], atol=5.0)


def _nview_rig(n_cams=4, n_pts=80, seed=3, dist=False):
    """The n-camera ring of tests/test_triangulation.py."""
    rng = np.random.default_rng(seed)
    Ks, Rs, Ts, ds = [], [], [], []
    for c in range(n_cams):
        Ks.append(np.array([[900.0 + 5 * c, 0, 640.0], [0, 905.0 - 4 * c, 360.0], [0, 0, 1.0]]))
        th = np.deg2rad(-30.0 + 60.0 * c / max(n_cams - 1, 1))
        Rs.append(np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0],
                            [-np.sin(th), 0, np.cos(th)]]))
        Ts.append(np.array([60.0 * c - 30.0 * (n_cams - 1), 3.0 * c, 15.0 * c]))
        ds.append(np.array([-0.1 + 0.04 * c, 0.02, 0.0004, -0.0006, 0.002])
                  if dist else np.zeros(5))
    pts3d = rng.uniform([-100, -100, 2800], [100, 100, 3400], (n_pts, 3))
    kpts = np.stack([project_np(pts3d, Ks[c], Rs[c], Ts[c], ds[c] if dist else None)
                     for c in range(n_cams)], axis=1)
    return [np.stack(a) for a in (Ks, ds, Rs, Ts)], pts3d, kpts, rng


def _nview_case(name):
    """(cameras, kpts, conf, kwargs) of each fixture of
    tests/test_triangulation.py's n-view tests, plus a hypothesis tie."""
    if name == "clean":
        cams, _, kpts, rng = _nview_rig(4, dist=True)
        return cams, kpts, rng.uniform(0.5, 1.0, kpts.shape[:-1]), {}
    if name == "corrupted":
        cams, pts, kpts, rng = _nview_rig(4)
        kpts = kpts + rng.normal(0, 0.5, kpts.shape)
        conf = rng.uniform(0.5, 0.8, kpts.shape[:-1])
        bad = rng.integers(0, 4, len(pts))
        idx = np.arange(len(pts))
        kpts[idx, bad] += rng.normal(0, 5.0, (len(pts), 2)) + 60.0
        conf[idx, bad] = 0.99
        return cams, kpts, conf, {}
    if name == "noisy":  # 2 px noise, a 6 px corrupted view: the lower median decides
        cams, pts, kpts, rng = _nview_rig(4, seed=11)
        kpts = kpts + rng.normal(0, 2.0, kpts.shape)
        conf = rng.uniform(0.5, 0.9, kpts.shape[:-1])
        bad = rng.integers(0, 4, len(pts))
        kpts[np.arange(len(pts)), bad] += rng.normal(0, 2.0, (len(pts), 2)) + 6.0
        return cams, kpts, conf, {}
    if name == "nan":
        cams, _, kpts, _ = _nview_rig(4, n_pts=6)
        conf = np.full(kpts.shape[:-1], 0.9)
        kpts[0, 1:] = np.nan
        kpts[1, :] = np.nan
        kpts[2, 2:] = np.nan
        conf[3, 0] = np.nan
        return cams, kpts, conf, {}
    if name == "two_cams":
        cams, _, kpts, _ = _nview_rig(2, n_pts=10)
        kpts[:, 0] += 80.0
        return cams, kpts, np.full(kpts.shape[:-1], 0.9), {}
    # A tie: view 2 is NaN, so leaving it out weighs the views exactly as
    # the all-view hypothesis does, and their scores are equal; unweighted.
    cams, _, kpts, rng = _nview_rig(3, n_pts=12)
    kpts = kpts + rng.normal(0, 1.0, kpts.shape)
    kpts[:, 2] = np.nan
    return cams, kpts, np.full(kpts.shape[:-1], 0.7), {"conf_weighted": False}


@pytest.mark.parametrize("name", ["clean", "corrupted", "noisy", "nan", "two_cams", "tie"])
def test_triangulate_nview_matches_jax(name):
    (Ks, ds, Rs, Ts), kpts, conf, kw = _nview_case(name)
    ref = np.asarray(J_NVIEW(kpts, conf, Ks, ds, Rs, Ts, **kw))
    out = ops.triangulate_nview(t64(kpts), t64(conf), t64(Ks), t64(ds), t64(Rs), t64(Ts),
                                **kw).numpy()
    np.testing.assert_array_equal(np.isnan(out), np.isnan(ref))
    np.testing.assert_allclose(out, ref, rtol=1e-8, atol=1e-8)
    if name in ("nan", "two_cams", "tie"):
        assert np.isfinite(out[2:]).all()


def test_triangulate_nview_refuses_one_view():
    with pytest.raises(ValueError, match=">= 2 camera"):
        ops.triangulate_nview(torch.zeros(3, 1, 2), torch.ones(3, 1), torch.eye(3)[None],
                              torch.zeros(1, 5), torch.eye(3)[None], torch.zeros(1, 3))


@pytest.mark.parametrize("method", ["top2", "nview"])
def test_get_pose_3d_matches_jax(method, monkeypatch):
    """Camera IDs that are not 0..C-1, a subset of them, the world rotation."""
    monkeypatch.setattr(jtri, "triangulate_nview", J_NVIEW)
    monkeypatch.setattr(jtri, "triangulate_top2", J_TOP2)
    (Ks, ds, Rs, Ts), pts, kpts, rng = _nview_rig(4, n_pts=34, dist=True)
    kpts = kpts + rng.normal(0, 0.5, kpts.shape)
    conf = rng.uniform(0.3, 1.0, kpts.shape[:-1])
    kpts[3, 1] = np.nan
    wire = np.concatenate([kpts, conf[..., None]], axis=-1).transpose(0, 2, 1)  # (N, 3, C)
    wire = wire.reshape(2, 17, 3, 4)
    cams = {f"cam{c}": [Ks[c], Rs[c], Ts[c], ds[c]] for c in (3, 0, 2, 1)}
    wire = wire[..., [3, 0, 2, 1]]  # the dict's order
    R_w = np.asarray(jops.rodrigues_matrix(jnp.asarray([0.2, -0.1, 0.4])))
    for subset, wtr in ((None, None), (["cam2", "cam0", "cam1"], (R_w, np.zeros(3)))):
        ref = np.asarray(jops.get_pose_3d(wire, cams, camera_indices=subset,
                                          world_trans_rot=wtr, method=method))
        out = ops.get_pose_3d(wire, cams, camera_indices=subset, world_trans_rot=wtr,
                              method=method, device="cpu")
        assert out.dtype == torch.float64 and out.shape == (2, 17, 3)
        np.testing.assert_array_equal(np.isnan(out.numpy()), np.isnan(ref))
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-8, atol=1e-8)
    with pytest.raises(ValueError, match="unknown triangulation method"):
        ops.get_pose_3d(wire, cams, method="svd", device="cpu")

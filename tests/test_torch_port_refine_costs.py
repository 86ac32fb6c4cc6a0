"""The port's refinement costs and interpolation against the JAX package,
in float64 on the CPU.

- `linear_interpolation` over every flag combination, with outliers, NaN
  windows and windows cut by the sequence ends: 1e-12.
- Each cost's value and its autograd gradient against
  ``jax.value_and_grad``, with missing observations, Huber, temperature and
  coincident joints (the clamped square roots): 1e-10.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_camera_3d_pose_estimation_tpu.ops import rodrigues_matrix as j_rodrigues
from multi_camera_3d_pose_estimation_tpu.refine import costs as jc
from multi_camera_3d_pose_estimation_tpu.refine import linear_interpolation as j_interp
from multi_camera_3d_pose_estimation_tpu_torch.refine import costs as tc
from multi_camera_3d_pose_estimation_tpu_torch.refine import linear_interpolation

from tests.conftest import project_np


def t64(a):
    return torch.as_tensor(np.array(a, np.float64))


def _track(seed, T=40, P=3, D=2):
    rng = np.random.default_rng(seed)
    t = np.arange(T)[:, None, None]
    x = np.sin(t / 7.0 + np.arange(P)[None, :, None]) * 50 + np.arange(D) * 10
    x = x + rng.normal(0, 0.5, (T, P, D))
    x[5, 0, 0] += 80.0
    x[20, 1, 1] -= 120.0
    x[21, 1, 1] += 95.0
    x[10, 2, 0] = np.nan
    x[33, 0, 1] = np.nan
    x[0, 1, 0] += 40.0  # an outlier in a window cut by the start
    return x


@pytest.mark.parametrize("rolling,median,zero", list(itertools.product([False, True], repeat=3)))
def test_linear_interpolation_matches_jax(rolling, median, zero):
    x = _track(0)
    kw = dict(use_rolling_average=rolling, filter_distance_from_median=median,
              strict_zero_fallback=zero)
    ref = np.asarray(j_interp(x, **kw))
    out = linear_interpolation(x, device="cpu", **kw)
    assert out.dtype == torch.float64 and out.shape == x.shape
    np.testing.assert_array_equal(np.isnan(out.numpy()), np.isnan(ref))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-12, atol=1e-12)
    assert np.isnan(ref).any() == (not zero)  # NaN windows fall back: to NaN, or to 0


def test_linear_interpolation_other_window_and_2d():
    x = _track(1, P=4)[..., 0]  # (T, P)
    for kw in (dict(k=7, k_std=1.5, median_std=3), dict(k=3)):
        ref = np.asarray(j_interp(x, **kw))
        out = linear_interpolation(x, device="cpu", **kw)
        assert out.shape == x.shape
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-12, atol=1e-12)
    f32 = linear_interpolation(x.astype(np.float32), device="cpu")
    assert f32.dtype == torch.float32


def _scene(seed=0, B=6, J=5, C=3):
    rng = np.random.default_rng(seed)
    traj = rng.uniform([-30, -30, 280], [30, 30, 360], (B, J, 3))
    Ks, rv, tv, ds = [], [], [], []
    means = np.zeros((B, C, J, 2))
    for c in range(C):
        Ks.append(np.array([[900.0 + 10 * c, 2.0, 640.0], [0, 905.0, 360.0], [0, 0, 1]]))
        rv.append(np.array([0.0, np.deg2rad(-20 + 25 * c), 0.0]) if c else np.zeros(3))
        tv.append(np.array([40.0 * c - 20, 2.0 * c, 25.0 * c]))
        ds.append(np.array([-0.05 * c, 0.01, 0.001, -0.0005, 0.0]))
        R = np.asarray(j_rodrigues(jnp.asarray(rv[-1])))
        means[:, c] = project_np(traj.reshape(-1, 3), Ks[-1], R, tv[-1], ds[-1]).reshape(B, J, 2)
    means += rng.normal(0, 6.0, means.shape)
    means[2, 1, 3] = np.nan  # a missing observation
    g = np.zeros((B, C, J, 6))
    g[..., :2] = means
    g[..., 2] = rng.uniform(4, 30, (B, C, J))
    g[..., 5] = rng.uniform(4, 30, (B, C, J))
    g[..., 3] = g[..., 4] = rng.uniform(-2, 2, (B, C, J))
    g[4, 2, 0, 2:] = np.nan  # a missing covariance
    return traj, g, [np.stack(a) for a in (Ks, rv, tv, ds)]


@pytest.mark.parametrize("compat", [False, True])
def test_precompute_cov_inverse_and_nan_mean_match_jax(compat):
    _, g, _ = _scene()
    ref = np.asarray(jc.precompute_cov_inverse(jnp.asarray(g), camera0_gaussians_compat=compat))
    out = tc.precompute_cov_inverse(t64(g), camera0_gaussians_compat=compat)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-12, atol=1e-15)
    x = np.array([1.0, np.nan, 3.0, np.inf, -2.0])
    assert tc.nan_mean(t64(x)).item() == float(jc.nan_mean(jnp.asarray(x)))
    assert tc.nan_mean(t64([np.nan])).item() == 0.0


@pytest.mark.parametrize("huber,temperature,ignore", [(None, 1.0, False), (1.5, 1.0, False),
                                                      (None, 2.5, True), (0.8, 3.0, False)])
def test_likelihood_cost_value_and_grad_match_jax(huber, temperature, ignore):
    traj, g, (Ks, rv, tv, ds) = _scene()
    ci = np.asarray(jc.precompute_cov_inverse(jnp.asarray(g)))
    means = g[..., :2]
    kw = dict(ignore_distortions=ignore, huber_delta=huber, temperature=temperature)

    def jf(tr, r, t):
        return jc.likelihood_cost(tr, jnp.asarray(means), jnp.asarray(ci), jnp.asarray(Ks), r, t,
                                  jnp.asarray(ds), **kw)

    val_ref, grads_ref = jax.value_and_grad(jf, argnums=(0, 1, 2))(
        jnp.asarray(traj), jnp.asarray(rv), jnp.asarray(tv))
    args = [t64(a).requires_grad_(True) for a in (traj, rv, tv)]
    val = tc.likelihood_cost(args[0], t64(means), t64(ci), t64(Ks), args[1], args[2], t64(ds),
                             **kw)
    grads = torch.autograd.grad(val, args)
    np.testing.assert_allclose(val.item(), float(val_ref), rtol=1e-10)
    for a, b in zip(grads, grads_ref):
        assert np.isfinite(a.numpy()).all()  # camera 0's exact-zero rvec included
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-10, atol=1e-12)
    if huber is not None:  # the Huber branch was taken somewhere
        full = tc.likelihood_cost(t64(traj), t64(means), t64(ci), t64(Ks), t64(rv), t64(tv),
                                  t64(ds), ignore_distortions=ignore, temperature=temperature)
        assert full.item() > val.item()


def test_full_covariance_log_likelihood_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.normal(0, 3, (4, 5, 2))
    mean = rng.normal(0, 3, (4, 5, 2))
    mean[1, 2] = np.nan
    a = rng.uniform(1, 5, (4, 5))
    cov = np.stack([np.stack([a, 0.3 * a], -1), np.stack([0.3 * a, 2 * a], -1)], -2)

    def jf(xx):
        return jnp.nansum(jc.gaussian_log_likelihood(xx, jnp.asarray(mean), cov=jnp.asarray(cov)))

    val_ref, g_ref = jax.value_and_grad(jf)(jnp.asarray(x))
    xx = t64(x).requires_grad_(True)
    ll = tc.gaussian_log_likelihood(xx, t64(mean), cov=t64(cov))
    assert torch.isnan(ll[1, 2]) and torch.isfinite(ll[0]).all()
    val = torch.nansum(ll)
    (g,) = torch.autograd.grad(val, xx)
    np.testing.assert_allclose(val.item(), float(val_ref), rtol=1e-10)
    np.testing.assert_allclose(g.numpy(), np.asarray(g_ref), rtol=1e-10, atol=1e-12)


def test_smoothness_and_body_length_value_and_grad_match_jax():
    traj, _, _ = _scene(seed=5, B=7, J=5)
    traj[3, 2] = np.nan  # a NaN row drops out of the smoothness mean
    traj[:, 4] = traj[:, 3]  # coincident joints: a zero-length segment
    edges = (np.array([0, 1, 3]), np.array([1, 3, 4]), np.array([4.0, 6.0, 2.0]))

    def jf(tr):
        ok = jnp.isfinite(tr)
        clean = jnp.where(ok, tr, 0.0)
        return (jc.smoothness_cost(tr) + jc.body_length_cost(clean, *map(jnp.asarray, edges)))

    val_ref, g_ref = jax.value_and_grad(jf)(jnp.asarray(traj))
    tr = t64(traj).requires_grad_(True)
    clean = torch.where(torch.isfinite(tr), tr, torch.zeros_like(tr))
    val = tc.smoothness_cost(tr) + tc.body_length_cost(
        clean, torch.as_tensor(edges[0]), torch.as_tensor(edges[1]), t64(edges[2]))
    (g,) = torch.autograd.grad(val, tr)
    np.testing.assert_allclose(val.item(), float(val_ref), rtol=1e-10)
    assert np.isfinite(val.item())
    np.testing.assert_array_equal(np.isnan(g.numpy()), np.isnan(np.asarray(g_ref)))
    np.testing.assert_allclose(g.numpy(), np.asarray(g_ref), rtol=1e-10, atol=1e-12)

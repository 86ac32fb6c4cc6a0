"""The port's refiners against the JAX package's, in float64 on the CPU:
extrinsics learned beside the trajectory and from samples, the MLP, random
inits, the `ExtrinsicRefiner`, and the port's own draws.  How each case is
held, and its tolerances: tests/test_torch_port_refine.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_camera_3d_pose_estimation_tpu.refine import ExtrinsicRefiner as JExtrinsicRefiner
from multi_camera_3d_pose_estimation_tpu_torch.refine import ExtrinsicRefiner, PoseRefiner

from tests.test_torch_port_refine import check_pose_refiner_case, make_scene, perturbed
from tests.conftest import project_np


@pytest.mark.parametrize("name", ["extrinsics", "from_samples", "use_nn", "randomized"])
def test_pose_refiner_matches_jax(name):
    check_pose_refiner_case(name)


def test_sgd_optimize_draws_from_a_torch_generator():
    """The public entry: the same seed gives the same run, another seed other
    draws; the from-samples path learns camera 2 back toward the truth."""
    traj, cams, gauss, _ = make_scene(6, T=12, J=4, n_cams=3, sigma=2.0)
    bad = perturbed(cams, 2)
    kw = dict(extrinsic_optimization_IDs=[2], GT_camera_IDs=[0, 1], optimize_trajectory=False,
              lr=0.01, max_iter=150, patience=60, lambda_smooth=0.0, lambda_body_length=0.0,
              N_sample_points=10)
    runs = [PoseRefiner(gauss, traj, {k: [p.copy() for p in v] for k, v in bad.items()},
                        dtype=torch.float64, device="cpu").sgd_optimize(seed=s, **kw)
            for s in (0, 0, 1)]
    np.testing.assert_array_equal(runs[0].cost_history["total_cost"],
                                  runs[1].cost_history["total_cost"])
    assert not np.array_equal(runs[0].cost_history["total_cost"][:5],
                              runs[2].cost_history["total_cost"][:5])
    K = cams[2][0]
    obs = gauss[:, 2, :, :2].reshape(-1, 2)

    def reproj(R, Tv):
        return np.linalg.norm(project_np(traj.reshape(-1, 3), K, R, Tv, cams[2][3]) - obs,
                              axis=-1).mean()

    assert reproj(runs[0].cam_params[2][1], runs[0].cam_params[2][2]) < 0.6 * reproj(
        bad[2][1], bad[2][2])


def test_extrinsic_refiner_matches_jax():
    """The same samples (JAX's draws passed in): best (R, T), the step count
    and the best cost; and the port's own draws recover the pose."""
    traj, cams, gauss, _ = make_scene(12, T=8, J=4, n_cams=3, sigma=2.0)
    bad = perturbed(cams, 2, dth=3.0, dT=(4.0, -3.0, 5.0))
    jr = JExtrinsicRefiner(gauss, bad, N_sample_points=6, dtype=jnp.float64)
    R_ref, T_ref = jr.optimize(learning_rate=0.01, max_iter=60, patience=8)
    z = jax.random.normal(jax.random.PRNGKey(0), (8, 2, 4, 6, 2), jnp.float64)
    er = ExtrinsicRefiner(gauss, bad, N_sample_points=6, dtype=torch.float64, device="cpu")
    R, Tv = er._optimize(np.array(z), 0.01, 60, 8, False, None)
    assert er.n_iter == jr.n_iter
    np.testing.assert_allclose(er.best_cost, jr.best_cost, rtol=1e-9)
    np.testing.assert_allclose(R, R_ref, rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(Tv, T_ref, rtol=1e-8, atol=1e-8)
    R2, T2 = ExtrinsicRefiner(gauss, bad, N_sample_points=20, dtype=torch.float64,
                              device="cpu").optimize(learning_rate=0.01, max_iter=300,
                                                     patience=40)
    np.testing.assert_allclose(R2 @ R2.T, np.eye(3), atol=1e-9)
    assert np.linalg.norm(R2 - cams[2][1]) < np.linalg.norm(bad[2][1] - cams[2][1])

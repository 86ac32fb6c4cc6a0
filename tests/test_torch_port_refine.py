"""The port's `PoseRefiner` against the JAX package's, in float64 on the
CPU: the trajectory cases, checkpoint/resume and progress lines; and the
scenes, replayed draws and comparisons that
tests/test_torch_port_refine_extrinsics.py shares.

Each case runs the JAX `PoseRefiner.sgd_optimize` once, recording what its
epoch loop (``_run_refinement``) was given and returned, and then:

- the port's epoch loop, `run_refinement`, on the same inputs, against what
  JAX's returned;
- the port's whole `PoseRefiner` with the JAX package's random draws passed
  in (the port draws from a ``torch.Generator``: other numbers), against
  JAX's result, its preparation (window starts, gate weights, samples)
  included.

Tolerances: per-epoch costs and the best total at 1e-9 relative, the
stopping epoch exactly, trajectories and extrinsics at 1e-8 (both sides
sum in float64 in other orders; Adam's normalised steps keep the
difference at that level over these runs).  Scenes are small (T ≤ 24,
J ≤ 5, C ≤ 3, ≤ 60 epochs) because every distinct config is a new XLA
compile on the JAX side.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_camera_3d_pose_estimation_tpu.refine import PoseRefiner as JPoseRefiner
from multi_camera_3d_pose_estimation_tpu.refine import optimizer as jopt
from multi_camera_3d_pose_estimation_tpu_torch.refine import PoseRefiner
from multi_camera_3d_pose_estimation_tpu_torch.refine import optimizer as opt

from tests.conftest import project_np

BODY = {"nose_left_eye": 4.0, "left_eye_left_ear": 6.0}  # COCO edges (0, 1), (1, 3)


def t64(a):
    return torch.as_tensor(np.array(a, np.float64))


def make_scene(seed, T=24, J=5, n_cams=2, sigma=4.0, depth=0.0):
    """A smooth trajectory seen by ``n_cams`` cameras, Gaussians on the true
    projections; ``depth`` moves the cameras so the world origin is in
    front of them (for random inits near 0)."""
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 2 * np.pi, T)[:, None]
    base = rng.uniform([-30, -30, 280 - depth], [30, 30, 360 - depth], size=(1, J, 3))
    traj = base + 10.0 * np.stack([np.sin(t), np.cos(t), 0.5 * np.sin(2 * t)], axis=-1)
    cams, gauss = {}, np.zeros((T, n_cams, J, 6))
    for c in range(n_cams):
        K = np.array([[900.0 + 10 * c, 0, 640.0], [0, 905.0 - 5 * c, 360.0], [0, 0, 1]])
        th = np.deg2rad(-20.0 + 25.0 * c)
        R = np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0], [-np.sin(th), 0, np.cos(th)]])
        Tv = np.array([40.0 * c - 20.0, 2.0 * c, 25.0 * c + depth])
        dist = np.array([-0.05 * c, 0.01, 0.0, 0.0, 0.0])
        cams[c] = [K, R, Tv, dist]
        gauss[:, c, :, :2] = project_np(traj.reshape(-1, 3), K, R, Tv, dist).reshape(T, J, 2)
        gauss[:, c, :, 2] = gauss[:, c, :, 5] = sigma ** 2
        gauss[:, c, :, 3] = gauss[:, c, :, 4] = 0.3 * sigma ** 2
    return traj, cams, gauss, rng


class ListDraws:
    """Given draws, handed out in order (the port's draws interface)."""

    def __init__(self, arrays):
        self.arrays = [np.array(a, np.float64) for a in arrays]

    def _next(self, shape):
        a = self.arrays.pop(0)
        assert a.shape == tuple(shape), (a.shape, shape)
        return torch.from_numpy(a)

    def uniform(self, shape, low=0.0, high=1.0):
        return self._next(shape)

    def normal(self, shape):
        return self._next(shape)


def jax_draws(cfg, n_cams, Tw, J, learn_extr, from_samples, seed=0):
    """The JAX refiner's random draws for ``seed``, in its order of keys."""
    dt = jnp.float64
    split, normal = jax.random.split, jax.random.normal
    key = jax.random.PRNGKey(seed)
    out, nn = [], None
    if learn_extr:
        key, kj = split(key)
        out.append(jax.random.uniform(kj, (n_cams, 3, 2)))
    if from_samples:
        key, ks = split(key)
        out.append(normal(ks, (Tw, 2, J, cfg.N_sample_points, 2), dt))
    if cfg.use_NN:
        key, kn = split(key)
        nn = jopt._mlp_init(kn, n_cams * 6, dt)
        out += [a for layer in nn for a in layer]
    if cfg.randomize_params:
        key, kr = split(key)
        if cfg.optimize_trajectory and not cfg.use_NN:
            kr, k = split(kr)
            out.append(normal(k, (Tw, J, 3), dt))
        if cfg.use_NN:
            for W, b in nn:
                kr, k1, k2 = split(kr, 3)
                out += [normal(k1, W.shape, dt), normal(k2, b.shape, dt)]
        if learn_extr and not cfg.reset_camera_params:
            kr, k1, k2 = split(kr, 3)
            out += [normal(k1, (n_cams, 3), dt), normal(k2, (n_cams, 3), dt)]
    return ListDraws(out)


@contextlib.contextmanager
def record_jax_loop():
    """Record (args, result) of every call of JAX's ``_run_refinement``."""
    calls, original = [], jopt._run_refinement

    def record(*args):
        out = original(*args)
        calls.append((args, out))
        return out

    jopt._run_refinement = record
    try:
        yield calls
    finally:
        jopt._run_refinement = original


def _params(tree):
    return {k: (opt.mlp_params_from_jax(v, device="cpu") if k == "nn" else t64(v))
            for k, v in tree.items()}


def state_from_jax(carry) -> opt.RefineState:
    params, opt_state, best, best_total, no_imp, it, hist = carry
    adam = opt_state[1]
    return opt.RefineState(
        params=_params(params), count=int(adam.count),
        mu=[t64(a) for a in jax.tree.leaves(adam.mu)],
        nu=[t64(a) for a in jax.tree.leaves(adam.nu)], best_params=_params(best),
        best_total=t64(best_total), no_improve=torch.tensor(int(no_imp)), epoch=int(it),
        history=t64(hist))


def data_from_jax(data) -> opt.RefineData:
    (starts, gate_w, means, cov_inv, gauss, samples, Ks, dists, learn_mask, e_start, e_end,
     e_target) = data
    return opt.RefineData(
        starts=np.asarray(starts), gate_w=t64(gate_w), means=t64(means), cov_inv=t64(cov_inv),
        gaussians=t64(gauss), samples_3d=t64(samples), Ks=t64(Ks), dists=t64(dists),
        learn_mask=torch.as_tensor(np.array(learn_mask)),
        e_start=torch.as_tensor(np.array(e_start), dtype=torch.long),
        e_end=torch.as_tensor(np.array(e_end), dtype=torch.long), e_target=t64(e_target))


def assert_states_match(state: opt.RefineState, carry):
    params, _, best, best_total, no_imp, it, hist = carry
    assert state.epoch == int(it)
    assert int(state.no_improve) == int(no_imp)
    n = state.epoch
    np.testing.assert_allclose(state.history[:n].numpy(), np.asarray(hist)[:n], rtol=1e-9,
                               atol=1e-12)
    np.testing.assert_allclose(float(state.best_total), float(best_total), rtol=1e-9)
    for mine, ref in ((state.params, params), (state.best_params, best)):
        for a, b in zip(opt._leaves(mine), jax.tree.leaves(ref)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-8, atol=1e-8)


def assert_results_match(res, ref):
    assert res.n_iter == ref.n_iter
    assert list(res.cost_history) == list(ref.cost_history)
    for k, v in ref.cost_history.items():
        np.testing.assert_allclose(res.cost_history[k], v, rtol=1e-9, atol=1e-12, err_msg=k)
    np.testing.assert_allclose(res.best_total_cost, ref.best_total_cost, rtol=1e-9)
    np.testing.assert_allclose(res.trajectory, ref.trajectory, rtol=1e-8, atol=1e-8)
    for cid, (K, R, Tv, d) in ref.cam_params.items():
        np.testing.assert_allclose(res.cam_params[cid][1], R, rtol=1e-8, atol=1e-8)
        np.testing.assert_allclose(res.cam_params[cid][2], Tv, rtol=1e-8, atol=1e-8)
    if ref.gate_weights is None:
        assert res.gate_weights is None
    else:
        np.testing.assert_array_equal(res.gate_weights, ref.gate_weights)


def perturbed(cams, cid, dth=2.0, dT=(3.0, -2.0, 3.0)):
    th = np.deg2rad(dth)
    dR = np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0], [0, 0, 1]])
    out = {k: [p.copy() for p in v] for k, v in cams.items()}
    out[cid][1] = dR @ out[cid][1]
    out[cid][2] = out[cid][2] + np.array(dT)
    return out


def _case(name):
    """(scene inputs, sgd_optimize kwargs, constructor kwargs) of each case."""
    base = dict(lr=0.05, max_iter=59, patience=10 ** 6, lambda_smooth=0.01,
                lambda_body_length=1.0)
    if name == "default":  # gate on (it does not fire), one window, body lengths
        traj, cams, gauss, rng = make_scene(0)
        return (gauss, traj + rng.normal(0, 3.0, traj.shape), cams), base, {"body_lengths": BODY}
    if name == "windows":  # batch_size < T: 5 overlapping half-stride windows
        traj, cams, gauss, rng = make_scene(1)
        return ((gauss, traj + rng.normal(0, 2.0, traj.shape), cams),
                dict(base, batch_size=8, max_iter=39), {})
    if name == "gated":  # the first windows already sit at the noise floor
        traj, cams, gauss, rng = make_scene(2, sigma=4.0)
        gauss[..., :2] += rng.normal(0, 2.0, gauss[..., :2].shape)
        init = traj.copy()
        init[12:] += rng.normal(0, 3.0, init[12:].shape)
        return (gauss, init, cams), dict(base, batch_size=8, max_iter=29), {}
    if name == "all_gated":  # every window skipped: a flat total, stopped by patience
        traj, cams, gauss, rng = make_scene(2, T=12, J=4, sigma=4.0)
        gauss[..., :2] += rng.normal(0, 2.0, gauss[..., :2].shape)
        return (gauss, traj, cams), dict(base, batch_size=4, patience=5, tolerance=0.0), {}
    if name == "gate_median":  # squared radii 1.9 and 2.2, half each: nanmedian 2.05
        traj, cams, gauss, rng = make_scene(13, T=12, J=4, sigma=4.0)
        gauss[..., 3:5] = 0.0
        m2 = np.where(np.arange(gauss[..., 0].size).reshape(gauss.shape[:-1]) % 2, 1.9, 2.2)
        gauss[..., 0] += 4.0 * np.sqrt(m2)
        return (gauss, traj, cams), dict(base, max_iter=19), {}
    if name == "camera0_compat":
        traj, cams, gauss, rng = make_scene(3)
        gauss[:, 1, :, 2:] *= 2.5
        return ((gauss, traj + rng.normal(0, 2.0, traj.shape), cams),
                dict(base, camera0_gaussians_compat=True, max_iter=29), {})
    if name == "huber_temperature":
        traj, cams, gauss, rng = make_scene(4)
        gauss[5, 0, 2, :2] += 80.0  # one confidently wrong observation
        gauss[7, 1, 1, :2] = np.nan  # and a missing one
        return ((gauss, traj + rng.normal(0, 3.0, traj.shape), cams),
                dict(base, huber_delta=1.5, likelihood_temperature=2.0, max_iter=39), {})
    if name == "extrinsics":  # camera 1's extrinsics learned beside the trajectory
        traj, cams, gauss, rng = make_scene(5, n_cams=3)
        return ((gauss, traj + rng.normal(0, 1.0, traj.shape), perturbed(cams, 1)),
                dict(base, lr=0.01, max_iter=39, extrinsic_optimization_IDs=[1],
                     ignore_distortions=True), {})
    if name == "from_samples":  # camera 2's extrinsics from samples of cameras 0, 1
        traj, cams, gauss, rng = make_scene(6, T=12, J=4, n_cams=3, sigma=2.0)
        return ((gauss, traj, perturbed(cams, 2)),
                dict(base, lr=0.01, max_iter=39, extrinsic_optimization_IDs=[2],
                     GT_camera_IDs=[0, 1], optimize_trajectory=False, N_sample_points=6,
                     lambda_smooth=0.0), {})
    if name == "use_nn":  # the MLP from the JAX draws, randomised, 3 cameras
        traj, cams, gauss, rng = make_scene(7, T=10, J=4, n_cams=3)
        return ((gauss, traj, cams),
                dict(base, use_NN=True, lr=0.01, max_iter=19, lambda_smooth=0.1,
                     randomize_params=True), {})
    if name == "randomized":  # random trajectory init, reset cameras, a time interval
        traj, cams, gauss, rng = make_scene(8, T=24, J=3, depth=300.0)
        return ((gauss, traj, cams),
                dict(base, randomize_params=True, reset_camera_params=True, max_iter=29,
                     time_interval=(2, 22), lr=0.5), {})
    assert name == "early_stop"  # patience: stops well before max_iter
    traj, cams, gauss, rng = make_scene(9, T=12, J=3)
    return (gauss, traj.copy(), cams), dict(base, lr=1e-4, max_iter=5000, patience=5,
                                            lambda_smooth=0.0, lambda_body_length=0.0), {}


def check_pose_refiner_case(name):
    """One case of `_case` through both refiners (see the module docstring)."""
    (gauss, init, cams), kw, ctor = _case(name)
    call = {k: kw.pop(k) for k in ("extrinsic_optimization_IDs", "GT_camera_IDs",
                                   "time_interval") if k in kw}
    with record_jax_loop() as calls:
        jref = JPoseRefiner(gauss, init, {k: [p.copy() for p in v] for k, v in cams.items()},
                            dtype=jnp.float64, **ctor)
        ref = jref.sgd_optimize(**call, **kw)
    assert len(calls) == 1
    args, out = calls[0]
    statics, carry_in, block_end, data = args[:5], args[5], int(args[6]), args[7:]

    # 1. The epoch loop on JAX's own inputs.
    state = opt.run_refinement(*statics, state_from_jax(carry_in), block_end,
                               data_from_jax(data))
    assert_states_match(state, out)

    # 2. The whole refiner with JAX's draws.
    cfg = opt.RefineConfig(**kw)
    extr = call.get("extrinsic_optimization_IDs", ())
    t0, t1 = call.get("time_interval", (0, -1))
    Tw = (gauss.shape[0] if t1 == -1 else t1) - t0
    def draws():
        return jax_draws(cfg, gauss.shape[1], Tw, gauss.shape[2], len(extr) > 0,
                         len(extr) > 0 and not cfg.optimize_trajectory)

    port = PoseRefiner(gauss, init, {k: [p.copy() for p in v] for k, v in cams.items()},
                       dtype=torch.float64, device="cpu", **ctor)
    _, state0, pdata, _, _ = port._setup(cfg, extr, call.get("GT_camera_IDs"), (t0, t1), draws())
    ref_data = data_from_jax(data)
    np.testing.assert_array_equal(pdata.starts, ref_data.starts)
    np.testing.assert_array_equal(pdata.gate_w.numpy(), ref_data.gate_w.numpy())
    np.testing.assert_allclose(pdata.samples_3d.numpy(), ref_data.samples_3d.numpy(),
                               rtol=1e-9, atol=1e-9)
    for a, b in zip(opt._leaves(state0.params), opt._leaves(state_from_jax(carry_in).params)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12, atol=1e-15)
    res = port._optimize(cfg, extr, call.get("GT_camera_IDs"), (t0, t1), draws())
    assert_results_match(res, ref)
    if name == "gated":
        assert 0 < (ref.gate_weights == 0).sum() < len(ref.gate_weights)
    if name == "all_gated":
        assert not ref.gate_weights.any() and ref.n_iter == 6
    if name == "gate_median":
        assert ref.gate_weights.all()
    if name == "early_stop":
        assert res.n_iter < 100


@pytest.mark.parametrize("name", ["default", "windows", "gated", "all_gated", "gate_median",
                                  "camera0_compat", "huber_temperature", "early_stop"])
def test_pose_refiner_matches_jax(name):
    check_pose_refiner_case(name)


def test_resume_from_a_jax_checkpoint(tmp_path, capsys):
    """JAX refines 30 epochs with checkpoint_every=10; the port resumes its
    refine_state.npz to 60 epochs and matches JAX's uninterrupted 60."""
    traj, cams, gauss, rng = make_scene(10, T=16, J=4)
    noisy = traj + rng.normal(0, 2.0, traj.shape)
    kw = dict(lr=0.05, patience=10 ** 6, lambda_smooth=0.01, lambda_body_length=0.0,
              checkpoint_every=10)

    def cams_copy():
        return {k: [p.copy() for p in v] for k, v in cams.items()}

    ref = JPoseRefiner(gauss, noisy, cams_copy(), dtype=jnp.float64).sgd_optimize(
        max_iter=59, **kw)
    JPoseRefiner(gauss, noisy, cams_copy(), dtype=jnp.float64).sgd_optimize(
        max_iter=29, checkpoint_dir=str(tmp_path), **kw)
    port = PoseRefiner(gauss, noisy, cams_copy(), dtype=torch.float64, device="cpu")
    res = port.sgd_optimize(max_iter=59, checkpoint_dir=str(tmp_path), resume=True, **kw)
    assert "resumed refinement at epoch 30" in capsys.readouterr().out
    assert_results_match(res, ref)
    # A checkpoint of another problem is refused: other leaves, other shapes.
    path = str(tmp_path / "refine_state.npz")
    for kw_other, what in ((dict(use_NN=True), "leaves"), (dict(batch_size=8), "shape")):
        cfg = opt.RefineConfig(**dict(kw, max_iter=59, **kw_other))
        template = port._setup(cfg, (), None, (0, 12 if "batch_size" in kw_other else -1),
                               opt.TorchDraws(0))[1]
        with pytest.raises(ValueError, match=what):
            opt.load_jax_refine_state(path, template)
    # The port's own checkpoint is the same format: JAX resumes it.
    jres = JPoseRefiner(gauss, noisy, cams_copy(), dtype=jnp.float64).sgd_optimize(
        max_iter=59, checkpoint_dir=str(tmp_path), resume=True, **kw)
    assert jres.n_iter == ref.n_iter


def test_verbose_progress_prints(capsys):
    traj, cams, gauss, rng = make_scene(11, T=10, J=3)
    PoseRefiner(gauss, traj + rng.normal(0, 1, traj.shape), cams, dtype=torch.float64,
                device="cpu").sgd_optimize(lr=0.01, max_iter=25, patience=10 ** 6, verbose=True,
                                           print_frequency=10, lambda_smooth=0.0,
                                           lambda_body_length=0.0)
    out = capsys.readouterr().out
    assert out.count("Iteration") == 3 and "total_cost" in out

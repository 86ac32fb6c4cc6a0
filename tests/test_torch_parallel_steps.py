"""The port's data-parallel refinement and train steps on a 2-rank mesh,
against the JAX package's steps on ``make_mesh(8)``, in float64.

One gloo group of two CPU processes for the module (`run_ranks`); the JAX
side runs in this process on its 8 virtual devices.

- `sharded_refine_step` on ``tests/test_parallel.py``'s scene (16 windows
  of 4 frames x 5 joints, 2 cameras), 30 steps, with and without the
  smoothness term: every loss within 1e-9 relative of JAX's, the final
  parameters within 1e-9 of their scale, and the extrinsics equal on both
  ranks.
- `make_train_step(mesh=)` on ``tests/test_training.py``'s DP setup (SMALL
  HRNet, 2 joints, batch 8 of 32x32) with plain SGD, the visibility
  weights unequal between the ranks' halves: the loss within 1e-9 relative
  of JAX's, every parameter's update within 1e-9 of the largest update of
  its leaf, the running statistics within 1e-9 of their scale; the port's
  ``mesh=None`` step the same.  Three controls must fail those limits: the
  gradients summed instead of averaged over the ranks, each rank's own
  BatchNorm statistics, and each rank's own loss averaged (plain DDP).
- Three `ClipAdamW` steps on the mesh against ``mesh=None``: losses,
  parameters and running statistics within 1e-9, the statistics equal on
  both ranks.  `TrainState` saved by the first rank and loaded on both.
"""

import contextlib
import os

import numpy as np
import pytest
import torch

from multi_camera_3d_pose_estimation_tpu_torch.models.convert import flax_leaves
from multi_camera_3d_pose_estimation_tpu_torch.models.registry import build_model
from multi_camera_3d_pose_estimation_tpu_torch.training import loop as tloop
from multi_camera_3d_pose_estimation_tpu_torch.training.losses import heatmap_mse_loss

from tests._torch_port_util import run_ranks

SMALL = {"widths": (8, 16, 32, 64), "modules": (1, 1, 1, 1), "stem": 16}
N, B, C, J = 16, 4, 2, 5
LR = 1e-3
CONTROLS = ("sum", "local_stats", "local_loss")


def _refine_scene():
    """``tests/test_parallel.py``'s refinement scene, in float64."""
    rng = np.random.default_rng(0)
    traj = rng.normal(0, 1, (N, B, J, 3)) + np.array([0, 0, 300.0])
    means = rng.uniform(20, 140, (N, B, C, J, 2))
    params = {"traj": traj, "rvecs": np.full((C, 3), 1e-4),
              "tvecs": np.stack([np.zeros(3), [-30.0, 0, 0]])}
    batch = {"means": means, "cov_inv": np.broadcast_to(np.eye(2) / 25.0, (N, B, C, J, 2, 2)),
             "Ks": np.broadcast_to([[300.0, 0, 80.0], [0, 300.0, 60.0], [0, 0, 1.0]], (C, 3, 3)),
             "dists": np.zeros((C, 5))}
    return params, batch


class _SGD:
    """Plain SGD with `make_train_step`'s optimizer interface (optax.sgd)."""

    has_schedule = False

    def __init__(self, lr):
        self.lr = lr

    def init(self, params):
        return tloop.AdamState(0, [], [])

    @torch.no_grad()
    def update(self, grads, state, params):
        for p, g in zip(params, grads):
            p.add_(g, alpha=-self.lr)
        return tloop.AdamState(state.count + 1, [], [])


def _loss(outputs, batch):
    return heatmap_mse_loss(outputs, batch["targets"], batch["weights"])


def _model(out_dir):
    return build_model("hrnet", SMALL, "cpu", checkpoint=os.path.join(out_dir, "hrnet.npz"),
                       input_size=(32, 32), num_joints=2, dtype=torch.float64).to(torch.float64)


def _local_loss(model, loss_fn, batch, mesh):
    """Plain DDP's loss: this rank's rows of everything, its own statistics."""
    local = {k: tloop.local_rows(v, mesh) for k, v in batch.items()}
    return loss_fn(tloop.apply_model(model, local["images"]), local)


@contextlib.contextmanager
def _control(name):
    """Swap in one wrong variant of the data-parallel step."""
    saved = {k: getattr(tloop, k) for k in ("_mean_over_ranks", "synced_batch_norm",
                                            "_global_loss")}
    if name == "sum":
        tloop._mean_over_ranks = lambda grads, mesh: [tloop.all_reduce_sum(g, mesh)
                                                      for g in grads]
    elif name == "local_stats":
        tloop.synced_batch_norm = lambda reduce, share: contextlib.nullcontext()
    elif name == "local_loss":
        tloop._global_loss = _local_loss
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(tloop, k, v)


def _copy(state):
    return {k: v.clone() for k, v in state.items()}


def _rank_main(rank, world, address, out_dir):
    from multi_camera_3d_pose_estimation_tpu_torch.parallel import (init_distributed, make_mesh,
                                                                    sharded_refine_step)

    init_distributed(address, world, rank, device="cpu")
    mesh = make_mesh(device="cpu")
    res = {}
    params0, batch = _refine_scene()
    batch = {k: torch.tensor(v) for k, v in batch.items()}
    for lam in (0.0, 1.0):
        step, tx = sharded_refine_step(mesh, lr=0.05, lambda_smooth=lam)
        params = {k: torch.tensor(v) for k, v in params0.items()}
        state, losses = tx.init(params), []
        for _ in range(30):
            params, state, loss = step(params, state, batch)
            losses.append(loss.item())
        res[f"refine_{lam}"] = {"losses": losses, **{k: v.numpy() for k, v in params.items()}}

    with np.load(os.path.join(out_dir, "batch.npz")) as f:
        tbatch = {k: torch.tensor(f[k]) for k in f.files}
    for name in ("mesh", "none") + CONTROLS:
        model = _model(out_dir)
        with _control(name):
            init_fn, step_fn = tloop.make_train_step(model, _loss, tx=_SGD(LR),
                                                     mesh=None if name == "none" else mesh)
            _, loss = step_fn(init_fn(), tbatch)
        res[f"sgd_{name}"] = {"loss": loss.item(), "state": _copy(model.state_dict())}

    for name in ("mesh", "none"):
        model = _model(out_dir)
        init_fn, step_fn = tloop.make_train_step(model, _loss, learning_rate=5e-4,
                                                 mesh=None if name == "none" else mesh)
        state, losses = init_fn(), []
        for _ in range(3):
            state, loss = step_fn(state, tbatch)
            losses.append(loss.item())
        res[f"adam_{name}"] = {"losses": losses, "state": _copy(model.state_dict())}
    path = os.path.join(out_dir, "train_state.npz")
    state.mesh = mesh
    state.save(path)
    res["saved_exists"] = os.path.exists(path)
    if rank == 1:
        with torch.no_grad():
            for p in model.parameters():
                p.add_(1.0)
    loaded = tloop.TrainState.load(path, state)
    res["loaded"] = {"step": loaded.step, "count": loaded.opt_state.count,
                     "state": _copy(model.state_dict()), "mu0": loaded.opt_state.mu[0]}
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Write the weights (the JAX package's random variables) and the batch,
    run the two ranks; returns their results, the variables and the batch."""
    from multi_camera_3d_pose_estimation_tpu.models.hrnet import HRNet as JHRNet
    from multi_camera_3d_pose_estimation_tpu.models import registry as jreg
    from multi_camera_3d_pose_estimation_tpu.training import render_heatmap_targets

    from tests._torch_port_util import random_variables

    out = tmp_path_factory.mktemp("parallel_steps")
    variables = random_variables(JHRNet(num_joints=2, cfg=SMALL), (1, 32, 32, 3), seed=0)
    jreg.save_checkpoint_npz(variables, str(out / "hrnet.npz"))
    rng = np.random.default_rng(0)
    kp = rng.uniform(2, 6, (8, 2, 2))
    vis = np.ones((8, 2))
    vis[4:, 1] = 0.0  # the second rank's half sees one joint less
    vis[6, 0] = 0.0
    targets, weights = render_heatmap_targets(kp, vis, (8, 8), sigma=1.0)
    batch = {"images": rng.uniform(size=(8, 32, 32, 3)), "targets": np.asarray(targets),
             "weights": np.asarray(weights)}
    np.savez(out / "batch.npz", **batch)
    run_ranks(__file__, "_rank_main", 2, out)
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(2)], variables, \
        batch, out


@pytest.mark.parametrize("lam", [0.0, 1.0])
def test_sharded_refine_step_matches_jax(ranks, lam):
    import jax.numpy as jnp

    from multi_camera_3d_pose_estimation_tpu.parallel import make_mesh, sharded_refine_step

    res = ranks[0]
    step, tx = sharded_refine_step(make_mesh(8), lr=0.05, lambda_smooth=lam)
    params, batch = _refine_scene()
    params = {k: jnp.asarray(v) for k, v in params.items()}
    batch = {k: jnp.asarray(v) for k, v in batch.items()}
    state, losses = tx.init(params), []
    for _ in range(30):
        params, state, loss = step(params, state, batch)
        losses.append(float(loss))
    assert losses[-1] < losses[0]
    for r in res:
        got = r[f"refine_{lam}"]
        np.testing.assert_allclose(got["losses"], losses, rtol=1e-9)
        for k, v in params.items():
            v = np.asarray(v)
            assert v.dtype == np.float64
            np.testing.assert_allclose(got[k], v, rtol=0, atol=1e-9 * np.abs(v).max(), err_msg=k)
        for k in ("rvecs", "tvecs", "traj"):
            np.testing.assert_array_equal(got[k], res[0][f"refine_{lam}"][k])


def _leaves(state):
    """The port model's state_dict as flax leaves: {("params" | "batch_stats", ...): array}."""
    model = build_model("hrnet", SMALL, "cpu", input_size=(32, 32), num_joints=2,
                        dtype=torch.float64).to(torch.float64)
    model.load_state_dict(state)
    sd = model.state_dict()
    return {path: (sd[key] if order is None else sd[key].permute(order)).numpy()
            for path, key, order in flax_leaves(model, "hrnet")}


def _flat(tree, prefix):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _flat(tree[k], prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(tree[k])


@pytest.fixture(scope="module")
def jax_sgd_step(ranks):
    """JAX's data-parallel SGD step on ``make_mesh(8)``: (loss, the leaves
    before and after)."""
    import jax
    import jax.numpy as jnp
    import optax

    from multi_camera_3d_pose_estimation_tpu.models.hrnet import HRNet as JHRNet
    from multi_camera_3d_pose_estimation_tpu.parallel import make_mesh
    from multi_camera_3d_pose_estimation_tpu.training import heatmap_mse_loss as j_mse
    from multi_camera_3d_pose_estimation_tpu.training.loop import TrainState, make_train_step

    _, variables, batch, _ = ranks
    v = jax.tree.map(lambda a: np.asarray(a, np.float64), variables)

    def loss_fn(outputs, b):
        return j_mse(jnp.moveaxis(outputs, -1, 1), b["targets"], b["weights"])

    tx = optax.sgd(LR)
    _, step = make_train_step(JHRNet(num_joints=2, cfg=SMALL, dtype=jnp.float64), loss_fn, tx=tx,
                              mesh=make_mesh(8))
    state = TrainState(v["params"], v["batch_stats"], tx.init(v["params"]), 0)
    new, loss = step(state, {k: jnp.asarray(x) for k, x in batch.items()})
    before = dict(_flat(v["params"], ("params",)))
    after = dict(_flat(new.params, ("params",)))
    after.update(_flat(new.batch_stats, ("batch_stats",)))
    return float(loss), before, after


def _sgd_gap(got, jax_step):
    """(the loss's relative gap, the largest parameter-update gap over its
    leaf's largest update, the largest statistics gap over its scale)."""
    loss, before, after = jax_step
    leaves = _leaves(got["state"])
    upd = max(np.abs(leaves[p] - after[p]).max() / np.abs(after[p] - before[p]).max()
              for p in before)
    stats = max(np.abs(leaves[p] - a).max() / np.abs(a).max()
                for p, a in after.items() if p[0] == "batch_stats")
    return abs(got["loss"] - loss) / loss, upd, stats


def test_dp_train_step_matches_jax_global_batch(ranks, jax_sgd_step):
    res = ranks[0]
    for r in res:
        for name in ("mesh", "none"):
            gaps = _sgd_gap(r[f"sgd_{name}"], jax_sgd_step)
            print(name, "loss, update, statistics gaps:", gaps)
            assert max(gaps) <= 1e-9, (name, gaps)
    for k, v in res[0]["sgd_mesh"]["state"].items():
        assert torch.equal(v, res[1]["sgd_mesh"]["state"][k]), k


@pytest.mark.parametrize("control", CONTROLS)
def test_dp_train_step_controls_fail(ranks, jax_sgd_step, control):
    """A summed gradient (twice the update), each rank's own statistics, and
    plain DDP's averaged per-rank losses each miss JAX's step."""
    gaps = _sgd_gap(ranks[0][0][f"sgd_{control}"], jax_sgd_step)
    print(control, "loss, update, statistics gaps:", gaps)
    assert max(gaps) > 1e-3, gaps


def test_dp_clip_adamw_steps_match_one_device(ranks):
    res = ranks[0]
    for r in res:
        np.testing.assert_allclose(r["adam_mesh"]["losses"], r["adam_none"]["losses"], rtol=1e-9)
        for k, ref in r["adam_none"]["state"].items():
            got = r["adam_mesh"]["state"][k]
            np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0,
                                       atol=1e-9 * max(ref.abs().max().item(), 1e-300),
                                       err_msg=k)
            if "running" in k:
                assert torch.equal(got, res[0]["adam_mesh"]["state"][k]), k
    assert any("running_var" in k for k in res[0]["adam_mesh"]["state"])


def test_train_state_saved_by_the_first_rank_loads_on_every_rank(ranks):
    res, _, _, out = ranks
    assert all(r["saved_exists"] for r in res) and (out / "train_state.npz").exists()
    for r in res:
        assert r["loaded"]["step"] == 3 and r["loaded"]["count"] == 3
        for k, v in res[0]["adam_none"]["state"].items():
            assert torch.equal(r["loaded"]["state"][k], v), k
    assert torch.equal(res[1]["loaded"]["mu0"], res[0]["loaded"]["mu0"])

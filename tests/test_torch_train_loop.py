"""The port's train step, optimizer and TrainState files against the JAX package's.

- The optimizer (`ClipAdamW`) against optax's ``chain(clip_by_global_norm(1),
  adamw(lr, weight_decay=1e-4))`` for 25 updates in float64, with a constant
  lr and with ``warmup_cosine_decay_schedule``, and against ``optax.adam``:
  parameters within 1e-12 relative.  The gradients are drawn large enough
  that the clip is active on some updates and not on others.  optax
  evaluates a schedule on its int32 update counter, in float32 even with
  x64 on, so the port's optimizer is given those values here.
- The schedule against optax's at every count: 1e-12 relative for Python
  counts (float64), 1e-6 (its float32 arithmetic) on optax's int32 counter.
- TrainState files: a JAX save loads in the port and a port save loads in
  JAX's ``TrainState.load``, leaves equal.
- Three composed steps (train-mode forward, loss, backward, clip -> AdamW,
  BatchNorm update) on ``test_tiny`` from the same variables and batch, in
  float64 (parameters, statistics and activations): each step's loss within
  1e-4 relative; every parameter element within 1e-3·lr per step (none
  needs leaving out: the largest gap after three steps is 1e-5·lr);
  batch_stats within 1e-5 relative.  Not in f32: the steps agree in loss
  there at the first step only (the train CLI's test holds the first at
  1e-4 and the later ones at limits measured there).
  Train-mode BatchNorm over the 2x1 maps of stage 4 at batch 2 leaves many
  gradients at rounding level (up to 2e-3 of a leaf's largest element), and
  Adam's first steps move every weight by about ±lr whatever its gradient's
  size, so rounding decides many steps' direction; with f64 activations but
  f32 parameters the parameters' own rounding moves elements 3.3e-3·lr
  apart by the third step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from multi_camera_3d_pose_estimation_tpu.models.hrnet import HRNet as JHRNet
from multi_camera_3d_pose_estimation_tpu.training import heatmap_mse_loss as j_mse
from multi_camera_3d_pose_estimation_tpu.training import render_heatmap_targets
from multi_camera_3d_pose_estimation_tpu.training.loop import TrainState as JTrainState
from multi_camera_3d_pose_estimation_tpu.training.loop import make_train_step as j_make_step
from multi_camera_3d_pose_estimation_tpu_torch.models.convert import (flax_leaves,
                                                                     load_hrnet_from_flax)
from multi_camera_3d_pose_estimation_tpu_torch.models.hrnet import HRNet
from multi_camera_3d_pose_estimation_tpu_torch.models.registry import MODEL_REGISTRY
from multi_camera_3d_pose_estimation_tpu_torch.training import loop as tloop
from multi_camera_3d_pose_estimation_tpu_torch.training.losses import heatmap_mse_loss

from tests._torch_port_util import random_variables

TINY = MODEL_REGISTRY["test_tiny"]["cfg"]
SHAPES = [(3, 3, 4, 5), (5,), (2, 7)]


def _tx(kind):
    if kind == "adamw_constant":
        return (optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(3e-3, weight_decay=1e-4)),
                tloop.ClipAdamW(3e-3))
    if kind == "adamw_cosine":
        j = optax.warmup_cosine_decay_schedule(0.0, 3e-3, 3, 20, end_value=3e-5)
        return (optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(j, weight_decay=1e-4)),
                tloop.ClipAdamW(lambda count: float(j(jnp.int32(count)))))
    return optax.adam(1e-2), tloop.adam(1e-2)


@pytest.mark.parametrize("kind", ["adamw_constant", "adamw_cosine", "adam"])
def test_optimizer_matches_optax_float64(kind):
    rng = np.random.default_rng(0)
    params = {f"p{i}": rng.normal(size=s) for i, s in enumerate(SHAPES)}
    jtx, ttx = _tx(kind)
    jp, js = params, jtx.init(params)
    tp = [torch.tensor(params[f"p{i}"]) for i in range(len(SHAPES))]
    ts = ttx.init(tp)
    clipped = 0
    for step in range(25):
        scale = 0.05 if step % 3 else 2.0  # global norm under and over the clip
        g = {k: scale * rng.normal(size=v.shape) for k, v in params.items()}
        clipped += optax.global_norm(g) >= 1.0
        upd, js = jtx.update(g, js, jp)
        jp = optax.apply_updates(jp, upd)
        ts = ttx.update([torch.tensor(g[f"p{i}"]) for i in range(len(SHAPES))], ts, tp)
        for i, t in enumerate(tp):
            ref = np.asarray(jp[f"p{i}"])
            assert t.dtype == torch.float64
            np.testing.assert_allclose(t.numpy(), ref, rtol=1e-12, atol=1e-12 * np.abs(ref).max())
    assert ts.count == 25 and 0 < clipped < 25


@pytest.mark.parametrize("warmup,decay,end", [(3, 20, 3e-5), (1, 2, 0.0), (10, 100, 1e-5)])
def test_warmup_cosine_schedule_matches_optax(warmup, decay, end):
    j = optax.warmup_cosine_decay_schedule(0.0, 3e-3, warmup, decay, end_value=end)
    t = tloop.warmup_cosine_decay_schedule(0.0, 3e-3, warmup, decay, end_value=end)
    assert t(0) == 0.0  # the first update uses lr(0)
    for count in range(decay + 5):
        np.testing.assert_allclose(t(count), float(j(count)), rtol=1e-12, atol=1e-18)
        np.testing.assert_allclose(t(count), float(j(jnp.int32(count))), rtol=1e-6)


@pytest.fixture(scope="module")
def tiny():
    """test_tiny's flax variables, a batch of 2 and JAX's three steps."""
    jm = JHRNet(num_joints=17, cfg=TINY, dtype=jnp.float64)
    v32 = random_variables(jm, (1, 64, 32, 3), seed=0, jitter=False)
    v = jax.tree.map(lambda a: np.asarray(a, np.float64), v32)
    rng = np.random.default_rng(1)
    images = rng.normal(size=(2, 64, 32, 3))
    kp = rng.uniform(2, 14, (2, 17, 2)) * [0.5, 1.0]
    targets, w = render_heatmap_targets(kp, np.ones((2, 17)), (16, 8), 2.0)
    batch = {"images": jnp.asarray(images), "targets": targets, "weights": w}
    lr = 5e-4

    def loss_fn(outputs, b):
        return j_mse(jnp.moveaxis(outputs, -1, 1), b["targets"], b["weights"])

    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(lr, weight_decay=1e-4))
    _, step_fn = j_make_step(jm, loss_fn, tx=tx)

    state = JTrainState(v["params"], v["batch_stats"], tx.init(v["params"]), 0)
    states, losses = [state], []
    for _ in range(3):
        state, loss = step_fn(state, batch)
        states.append(state)
        losses.append(float(loss))
    return {"v": v, "v32": v32, "batch": batch, "lr": lr, "states": states, "losses": losses,
            "tx": tx, "jm": jm}


def _port_tiny(v, dtype=torch.float64):
    """The port's test_tiny from the (f32) variables, parameters and
    activations in ``dtype``."""
    return load_hrnet_from_flax(HRNet(17, TINY, dtype, "cpu"), v).to(dtype)


def _flat(tree, prefix=()):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _flat(tree[k], prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(tree[k])


def _port_leaf(model, path):
    """The port's value of flax leaf ``path`` (("params" | "batch_stats", ...)),
    in the flax layout."""
    sd = model.state_dict()
    for fpath, key, order in flax_leaves(model, "hrnet"):
        if fpath == path:
            t = sd[key]
            return (t if order is None else t.permute(order)).numpy()
    raise KeyError(path)


def test_three_composed_steps_match_jax(tiny):
    model = _port_tiny(tiny["v32"])

    def loss_fn(outputs, b):
        return heatmap_mse_loss(outputs, b["targets"], b["weights"])

    init_fn, step_fn = tloop.make_train_step(model, loss_fn, learning_rate=tiny["lr"])
    state = init_fn()
    batch = {k: torch.tensor(np.asarray(x)) for k, x in tiny["batch"].items()}
    for k in range(3):
        state, loss = step_fn(state, batch)
        np.testing.assert_allclose(loss.item(), tiny["losses"][k], rtol=1e-4)
        ref = tiny["states"][k + 1]
        tol = 1e-3 * tiny["lr"] * (k + 1)
        for path, want in _flat(ref.params):
            got = _port_leaf(model, ("params",) + path)
            assert np.abs(got - want).max() <= tol, path
        for path, want in _flat(ref.batch_stats):
            got = _port_leaf(model, ("batch_stats",) + path)
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    assert state.step == 3 and state.opt_state.count == 3


def test_jax_train_state_file_loads_in_the_port(tiny, tmp_path):
    jstate = tiny["states"][2]  # float64 leaves, read into the port's float32 model
    path = str(tmp_path / "jax_state.npz")
    jstate.save(path)
    model = _port_tiny(tiny["v32"], torch.float32)
    init_fn, _ = tloop.make_train_step(model, lambda o, b: o.sum(), learning_rate=tiny["lr"])
    state = tloop.TrainState.load(path, init_fn())
    assert state.step == 2 and state.opt_state.count == 2
    for path_, want in _flat(jstate.params):
        np.testing.assert_array_equal(_port_leaf(model, ("params",) + path_),
                                      want.astype(np.float32))
    for path_, want in _flat(jstate.batch_stats):
        np.testing.assert_array_equal(_port_leaf(model, ("batch_stats",) + path_),
                                      want.astype(np.float32))
    # Adam's moments, in the port's layout, back to flax's for the comparison.
    adam = jstate.opt_state[1][0]
    names = [n for n, _ in model.named_parameters()]
    by_key = {key: (fpath, order) for fpath, key, order in flax_leaves(model, "hrnet")}
    for moments, ref in ((state.opt_state.mu, adam.mu), (state.opt_state.nu, adam.nu)):
        flat = dict(_flat(ref))
        for name, m in zip(names, moments):
            fpath, order = by_key[name]
            got = (m if order is None else m.permute(order)).numpy()
            np.testing.assert_array_equal(got, flat[fpath[1:]].astype(np.float32))


@pytest.mark.parametrize("schedule", [False, True], ids=["constant", "cosine"])
def test_port_train_state_file_loads_in_jax(tiny, tmp_path, schedule):
    model = _port_tiny(tiny["v32"], torch.float32)
    lr = tloop.warmup_cosine_decay_schedule(0.0, 1e-3, 2, 10) if schedule else 1e-3
    jlr = optax.warmup_cosine_decay_schedule(0.0, 1e-3, 2, 10) if schedule else 1e-3
    init_fn, step_fn = tloop.make_train_step(
        model, lambda o, b: heatmap_mse_loss(o, b["targets"], b["weights"]),
        tx=tloop.ClipAdamW(lr))
    batch = {k: torch.tensor(np.asarray(x), dtype=torch.float32)
             for k, x in tiny["batch"].items()}
    state = init_fn()
    for _ in range(2):
        state, _ = step_fn(state, batch)
    path = str(tmp_path / "port_state.npz")
    state.save(path)
    jtx = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(jlr, weight_decay=1e-4))
    v = tiny["v32"]
    template = JTrainState(v["params"], v["batch_stats"], jtx.init(v["params"]), 0)
    loaded = JTrainState.load(path, template)
    assert loaded.step == 2
    for path_, want in _flat(loaded.params):
        np.testing.assert_array_equal(_port_leaf(model, ("params",) + path_), want)
    for path_, want in _flat(loaded.batch_stats):
        np.testing.assert_array_equal(_port_leaf(model, ("batch_stats",) + path_), want)
    counts = [int(x) for x in jax.tree.leaves(loaded.opt_state) if np.ndim(x) == 0]
    assert counts == [2] * (2 if schedule else 1)
    # And back: the port reloads its own file to the same weights and moments.
    again = tloop.TrainState.load(path, init_fn())
    assert again.step == 2 and again.opt_state.count == 2
    assert all(torch.equal(a, b) for a, b in zip(again.opt_state.nu, state.opt_state.nu))


def test_train_state_rejects_another_model(tiny, tmp_path):
    model = _port_tiny(tiny["v32"], torch.float32)
    init_fn, _ = tloop.make_train_step(model, lambda o, b: o.sum())
    path = str(tmp_path / "s.npz")
    init_fn().save(path)
    other = HRNet(17, {"widths": (8, 16, 32, 64), "modules": (1, 1, 1, 2), "stem": 16},
                  torch.float32, "cpu")
    init_other, _ = tloop.make_train_step(other, lambda o, b: o.sum())
    with pytest.raises(ValueError, match="leaves"):
        tloop.TrainState.load(path, init_other())


def test_data_parallel_step_is_not_ported():
    """The data-parallel step takes a DeviceMesh of `parallel.make_mesh`
    (held in tests/test_torch_parallel_steps.py); anything else is refused."""
    model = HRNet(17, TINY, torch.float32, "cpu")
    with pytest.raises(TypeError, match="DeviceMesh"):
        tloop.make_train_step(model, lambda o, b: o.sum(), mesh=object())

"""Shared inputs of the port's parity tests (tests/test_torch_port_*.py)."""

import jax
import jax.numpy as jnp
import numpy as np


def random_variables(module, x_shape, seed, jitter=True):
    """A flax module's variables tree as numpy arrays drawn from ``seed``.

    The tree's shapes come from ``jax.eval_shape`` (no flax init runs):
    conv kernels N(0, 1/fan_in), and, with ``jitter``, non-trivial
    BatchNorm statistics and affines so that BN folding is exercised;
    without it, BatchNorm at identity and zero biases (flax's defaults).
    RTMPose's own leaves: ScaleNorm gains ``g`` and the GAU's ``res_scale``
    as BatchNorm scales, its ``beta`` as a bias, and its ``gamma`` N(0, 1)
    with ``jitter`` (so that the attention's q·k is of order one) or
    N(0, 0.02²) without (flax's initialiser).
    """
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), jnp.zeros(x_shape, jnp.float32))
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = str(path[-1].key)
        if name == "kernel":
            v = rng.normal(size=s.shape) / np.sqrt(np.prod(s.shape[:-1]))
        elif name == "gamma":
            v = rng.normal(0, 1.0 if jitter else 0.02, s.shape)
        elif not jitter:
            v = np.ones(s.shape) if name in ("scale", "var", "g", "res_scale") else np.zeros(s.shape)
        elif name == "mean":
            v = rng.normal(0, 0.1, s.shape)
        elif name == "var":
            v = 1.0 + rng.uniform(0, 1, s.shape)
        elif name in ("scale", "g", "res_scale"):
            v = 1.0 + 0.2 * rng.normal(size=s.shape)
        else:  # bias
            v = 0.1 * rng.normal(size=s.shape)
        return np.asarray(v, np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def zero_variables(module, x_shape):
    """A flax module's variables tree of float32 zeros, its shapes from
    ``jax.eval_shape`` (no flax init runs: an unjitted ``init`` of a small
    HRNet takes about 20 s on one CPU core).  For the JAX package's
    ``load_torch_*``, which overwrite every leaf."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), jnp.zeros(x_shape, jnp.float32))
    return jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)


def fast_flax_init(monkeypatch, *classes):
    """Give each flax module class an ``init`` that returns `zero_variables`'s
    zeros, for the JAX package's builders and CLIs that initialise a model
    and then load a checkpoint over every leaf of it."""
    import flax.linen as nn

    def init(self, rngs, *args, **kwargs):
        shapes = jax.eval_shape(lambda r, *a: nn.Module.init(self, r, *a, **kwargs), rngs, *args)
        return jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), shapes)

    for cls in classes:
        monkeypatch.setattr(cls, "init", init)


# The small configurations of the `.pth` tests (tests/test_torch_parity.py's
# and the registry's test models): family -> (cfg, flax input shape NHWC).
SMALL_PTH = {
    "hrnet": ({"widths": (8, 16, 32, 64), "modules": (1, 1, 1, 1), "stem": 16}, (1, 64, 32, 3)),
    "swin": ({"embed": 24, "depths": (1, 1), "heads": (2, 4), "window": 4, "mlp_ratio": 2,
              "deconv": (16,)}, (1, 64, 32, 3)),
    "rtmpose": ({"widen": 0.125, "deepen": 0.167, "embed": 32}, (1, 64, 32, 3)),
    "yolox": ({"widen": 0.125, "deepen": 0.33, "num_classes": 80}, (1, 64, 96, 3)),
    "rtmdet": ({"widen": 0.125, "deepen": 0.167, "num_classes": 1, "neck_out": 32,
                "num_csp_blocks": 1}, (1, 64, 96, 3)),
}


def jax_mirror(family, cfg, input_size=(32, 64)):
    """The JAX package's MMPose/MMDet mirror of ``family`` and its
    ``randomize_``."""
    import importlib

    mod = importlib.import_module(f"multi_camera_3d_pose_estimation_tpu.models.mirrors.{family}")
    if family == "hrnet":
        return mod.MMPoseHRNet(cfg, num_joints=17), mod.randomize_
    if family == "swin":
        return mod.MMPoseSwin(cfg, num_joints=17), mod.randomize_
    if family == "rtmpose":
        return mod.MMPoseRTMPose(cfg, input_size=input_size, num_joints=17), mod.randomize_
    if family == "yolox":
        return mod.MMDetYOLOX(cfg), mod.randomize_
    return mod.MMDetRTMDet(cfg), mod.randomize_


def write_pth(path, family, cfg, seed=0, edit=None, input_size=(32, 64)):
    """A random MMPose/MMDet ``{"state_dict": ...}`` checkpoint of ``family``
    written by the JAX package's mirror (``randomize_(seed)``), the state
    dict first passed to ``edit`` where given; returns ``str(path)``."""
    import torch

    mirror, randomize_ = jax_mirror(family, cfg, input_size)
    randomize_(mirror, seed=seed)
    state = dict(mirror.state_dict())
    if edit is not None:
        state = edit(state)
    torch.save({"state_dict": state}, str(path))
    return str(path)

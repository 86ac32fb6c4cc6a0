"""Shared inputs of the port's parity tests (tests/test_torch_*.py).

JAX is imported inside the functions that use it: the rank processes of the
multi-rank tests (`run_ranks`) import this module and must not import JAX.
"""

import os
import socket
import subprocess
import sys

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
    import jax
    import jax.numpy as jnp

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
    import jax
    import jax.numpy as jnp

    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), jnp.zeros(x_shape, jnp.float32))
    return jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)


def fast_flax_init(monkeypatch, *classes):
    """Give each flax module class an ``init`` that returns `zero_variables`'s
    zeros, for the JAX package's builders and CLIs that initialise a model
    and then load a checkpoint over every leaf of it."""
    import flax.linen as nn
    import jax
    import jax.numpy as jnp

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


def port_detector_mirror(family, cfg):
    """The port's own MMDet mirror of ``family`` ("yolox" or "rtmdet") and
    its ``randomize_``."""
    import importlib

    mod = importlib.import_module(
        f"multi_camera_3d_pose_estimation_tpu_torch.models.mirrors.{family}")
    return (mod.MMDetYOLOX if family == "yolox" else mod.MMDetRTMDet)(cfg), mod.randomize_


def write_pth(path, family, cfg, seed=0, edit=None, input_size=(32, 64)):
    """A random MMPose/MMDet ``{"state_dict": ...}`` checkpoint of ``family``
    written by a mirror (``randomize_(seed)``): the JAX package's for the
    pose models, the port's own for the detectors (which hold them equal to
    the JAX package's, tests/test_torch_port_checkpoint_verify.py); the
    state dict first passed to ``edit`` where given; returns ``str(path)``."""
    import torch

    if family in ("yolox", "rtmdet"):
        mirror, randomize_ = port_detector_mirror(family, cfg)
    else:
        mirror, randomize_ = jax_mirror(family, cfg, input_size)
    randomize_(mirror, seed=seed)
    state = dict(mirror.state_dict())
    if edit is not None:
        state = edit(state)
    torch.save({"state_dict": state}, str(path))
    return str(path)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# A rank process: JAX blocked, one thread, the test file loaded by its path
# and its rank function called.
_RANK_CODE = """
import importlib.util, sys
sys.modules["jax"] = None
sys.modules["multi_camera_3d_pose_estimation_tpu"] = None
sys.path.insert(0, sys.argv[1])
import torch
torch.set_num_threads(1)
spec = importlib.util.spec_from_file_location("rank_module", sys.argv[2])
module = importlib.util.module_from_spec(spec)
spec.loader.exec_module(module)
getattr(module, sys.argv[3])(int(sys.argv[4]), int(sys.argv[5]), sys.argv[6], sys.argv[7])
"""


def run_ranks(test_file, fn_name, world, out_dir, timeout=240):
    """Run ``fn_name(rank, world, "127.0.0.1:<port>", out_dir)`` of
    ``test_file`` in ``world`` processes (a gloo group's ranks: the function
    calls ``init_distributed``), none of which imports JAX; each writes its
    results under ``out_dir``.  Raises with the output of a rank that
    failed."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        address = f"127.0.0.1:{s.getsockname()[1]}"
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", _RANK_CODE, REPO, str(test_file), fn_name,
                               str(rank), str(world), address, str(out_dir)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=env, cwd=str(out_dir))
             for rank in range(world)]
    try:
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(f"rank {rank} of {fn_name} failed:\n{out[-4000:]}")
    return outs

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

"""The port's flip and affine augmentation against the JAX package's.

The draws cannot be ``jax.random``'s: the port draws from a CPU
``torch.Generator``.  So each JAX function's own draw is replayed into the
port's deterministic apply, which must give the same bits:

- the flip mask ``jax.random.bernoulli(key, p, (B,))`` (what
  ``random_flip_pose`` draws with that key) into `apply_flip_pose`;
- the three [0, 1) uniforms of ``random_affine_params``'s split keys into
  `affine_params_from_uniform`.

The port's draws are held by their seed determinism and their rate.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_camera_3d_pose_estimation_tpu.training import augment as ja
from multi_camera_3d_pose_estimation_tpu_torch.training import augment as ta


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_apply_flip_matches_random_flip_pose(seed):
    rng = np.random.default_rng(seed)
    B, H, W = 8, 12, 10
    images = rng.uniform(size=(B, H, W, 3)).astype(np.float32)
    kp = rng.uniform(0, W, (B, 17, 2)).astype(np.float32)
    vis = rng.integers(0, 3, (B, 17)).astype(np.float32)
    perm = ja.flip_permutation("coco")
    key = jax.random.PRNGKey(seed)
    ref = [np.asarray(a) for a in ja.random_flip_pose(key, *map(jnp.asarray, (images, kp, vis)),
                                                      perm)]
    mask = np.asarray(jax.random.bernoulli(key, 0.5, (B,)))
    assert 0 < mask.sum() < B or seed != 0
    out = ta.apply_flip_pose(torch.tensor(mask), torch.from_numpy(images),
                             torch.from_numpy(kp), torch.from_numpy(vis), perm)
    for o, r in zip(out, ref):
        np.testing.assert_array_equal(o.numpy(), r)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("x64", [False, True], ids=["f32", "f64"])
def test_affine_apply_matches_random_affine_params(seed, x64):
    """In f32 (the JAX package's setting) and in f64 (x64 on)."""
    B = 16
    key = jax.random.PRNGKey(seed)
    with jax.enable_x64(x64):
        ref = [np.asarray(a) for a in ja.random_affine_params(key, B)]
        k1, k2, k3 = jax.random.split(key, 3)
        u = [np.asarray(jax.random.uniform(k, s))
             for k, s in ((k1, (B,)), (k2, (B,)), (k3, (B, 2)))]
    out = ta.affine_params_from_uniform(*(torch.tensor(a) for a in u))
    for o, r in zip(out, ref):
        assert o.dtype == (torch.float64 if x64 else torch.float32)
        np.testing.assert_array_equal(o.numpy(), r)


def test_flip_draws_are_seeded_and_fair():
    a = ta.draw_flip_mask(torch.Generator().manual_seed(7), 4000, device="cpu")
    b = ta.draw_flip_mask(torch.Generator().manual_seed(7), 4000, device="cpu")
    c = ta.draw_flip_mask(torch.Generator().manual_seed(8), 4000, device="cpu")
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert abs(a.float().mean().item() - 0.5) < 0.03  # 4000 draws: 4 standard deviations
    r = ta.draw_flip_mask(torch.Generator().manual_seed(7), 4000, prob=0.2, device="cpu")
    assert abs(r.float().mean().item() - 0.2) < 0.03


def test_random_flip_pose_uses_the_drawn_mask():
    rng = np.random.default_rng(3)
    images = torch.from_numpy(rng.uniform(size=(6, 4, 5, 3)).astype(np.float32))
    kp = torch.from_numpy(rng.uniform(0, 5, (6, 17, 2)).astype(np.float32))
    vis = torch.ones(6, 17)
    perm = ta.flip_permutation()
    out = ta.random_flip_pose(torch.Generator().manual_seed(5), images, kp, vis, perm)
    mask = ta.draw_flip_mask(torch.Generator().manual_seed(5), 6, device="cpu")
    ref = ta.apply_flip_pose(mask, images, kp, vis, perm)
    assert all(torch.equal(o, r) for o, r in zip(out, ref))


def test_affine_draws_are_seeded_and_in_range():
    s, r, t = ta.random_affine_params(torch.Generator().manual_seed(0), 2000, device="cpu")
    s2, _, _ = ta.random_affine_params(torch.Generator().manual_seed(0), 2000, device="cpu")
    assert torch.equal(s, s2)
    assert s.shape == r.shape == (2000,) and t.shape == (2000, 2)
    assert 0.75 <= s.min() and s.max() < 1.25 and abs(s.mean().item() - 1.0) < 0.02
    assert r.abs().max() <= np.pi / 6 and t.abs().max() <= 0.1

"""The port's Swin window geometry against the JAX package's, exactly.

Integer tables (relative-position index, shift regions, window origins and
roll permutations) and the float masks must be equal bit for bit; the
window layouts of random maps must be equal exactly (they only move data).
Geometries cover window 4 and 7, padding in one or both dims, shift 0 and
win // 2.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_camera_3d_pose_estimation_tpu.models import swin as jswin
from multi_camera_3d_pose_estimation_tpu.ops.pallas import swin_block as jsb
from multi_camera_3d_pose_estimation_tpu_torch.ops import swin_geometry as geo

# (H, W, win, shift): Swin-B stage 0 and 3 at input 192x256, and small cases.
GEOMS = [(64, 48, 7, 3), (8, 6, 7, 3), (24, 16, 7, 0), (12, 8, 7, 3), (10, 9, 4, 2),
         (16, 16, 4, 0)]


@pytest.mark.parametrize("w", [2, 4, 7])
def test_rel_position_index(w):
    got = geo.rel_position_index(w)
    want = jswin._rel_position_index(w)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("H,W,win,shift", GEOMS)
def test_tables_equal(H, W, win, shift):
    Hp, Wp = geo.padded_dims(H, W, win)
    assert (Hp, Wp) == (-(-H // win) * win, -(-W // win) * win)
    if shift:
        np.testing.assert_array_equal(geo.shift_regions(Hp, Wp, win, shift),
                                      jswin._shift_regions(Hp, Wp, win, shift))
        got, want = geo.shift_mask(Hp, Wp, win, shift), jswin._shift_mask(Hp, Wp, win, shift)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(geo.window_origin_index(Hp, Wp, win, shift),
                                  jsb._window_origin_index(Hp, Wp, win, shift))
    np.testing.assert_array_equal(geo.valid_mask(H, W, Hp, Wp, win, shift),
                                  jsb._valid_mask(H, W, Hp, Wp, win, shift))
    for s_from, s_to in ((0, shift), (shift, 0), (win // 2, 0)):
        np.testing.assert_array_equal(geo.window_roll_perm(H, W, win, s_from, s_to),
                                      jsb.window_roll_perm(H, W, win, s_from, s_to))


@pytest.mark.parametrize("H,W,win,shift", GEOMS)
def test_layouts_equal(H, W, win, shift):
    rng = np.random.default_rng(H * W + shift)
    B, C = 2, 6
    x = rng.normal(size=(B, H, W, C)).astype(np.float32)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    tok = geo.window_partition(xt, win, shift)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jsb.window_partition(xj, win, shift)))
    back = geo.window_reverse(tok, B, H, W, win, shift)
    np.testing.assert_array_equal(back.numpy(), x)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jsb.window_reverse(jnp.asarray(tok.numpy()), B, H, W, win,
                                                    shift)))
    Hp, Wp = geo.padded_dims(H, W, win)
    xp = rng.normal(size=(B, Hp, Wp, C)).astype(np.float32)
    part = geo.partition_windows(torch.from_numpy(xp), win)
    np.testing.assert_array_equal(part.numpy(),
                                  np.asarray(jswin._window_partition(jnp.asarray(xp), win)))
    np.testing.assert_array_equal(geo.reverse_windows(part, win, B, Hp, Wp).numpy(), xp)


def test_roll_perm_chains_layouts():
    """perm applied to one block's emitted layout gives the next block's."""
    B, H, W, C, win = 2, 10, 9, 3, 4
    img = torch.from_numpy(np.random.default_rng(0).normal(size=(B, H, W, C)).astype(np.float32))
    a = geo.window_partition(img, win, 0).view(B, -1, C)
    b = geo.window_partition(img, win, 2).view(B, -1, C)
    valid = torch.from_numpy(geo.valid_mask(H, W, 12, 12, win, 0).reshape(-1))
    perm = torch.from_numpy(geo.window_roll_perm(H, W, win, 0, 2))
    # Pads are zero in both layouts, so the gather reproduces the re-pad.
    torch.testing.assert_close((a * valid[None, :, None])[:, perm], b, rtol=0, atol=0)

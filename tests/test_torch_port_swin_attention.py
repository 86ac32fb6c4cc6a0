"""The port's window attention (plain version) against the JAX package's
Pallas kernels in interpret mode.

``fused_window_attention`` (TPU kernel #7) and ``packed_window_attention``
(#8) compute the same function; the port's `window_attention` runs its
plain version on the CPU.  float32, held at 2e-5 as the JAX package holds
its kernel against the einsum oracle (f32 sums in another order, f32 exp).
bf16 is held to one bf16 step (2^-8) of the largest output: both sides
round p and the context to bf16 at the same points.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_camera_3d_pose_estimation_tpu.models.swin import _shift_mask, _shift_regions
from multi_camera_3d_pose_estimation_tpu.ops.pallas import window_attention as jwa
from multi_camera_3d_pose_estimation_tpu_torch.ops import window_attention as wa


# The padded maps (Hp, Wp) of the Swin-B stages at 192x256 input (real maps
# 64x48, 32x24, 16x12, 8x6), by their count of 7x7 windows: heads 4, 8, 16
# and 32 attend over nW = 70, 20, 6 and 2 windows per crop.
SWIN_B_MAPS = {70: (70, 49), 20: (35, 28), 6: (21, 14), 2: (14, 7)}


def _inputs(win, heads, nW, B, seed, shift, hw=None):
    """qkv (B·nW, n, 3C), bias, regions and mask of a padded (Hp, Wp) map
    (``hw``; square when None) holding nW windows."""
    rng = np.random.default_rng(seed)
    n, C = win * win, 32 * heads
    qkv = rng.normal(size=(B * nW, n, 3 * C)).astype(np.float32)
    bias = rng.normal(size=(heads, n, n)).astype(np.float32)
    hp, wp = hw if hw is not None else (int(np.sqrt(nW)) * win,) * 2
    assert (hp // win) * (wp // win) == nW
    regions = _shift_regions(hp, wp, win, win // 2) if shift else None
    mask = _shift_mask(hp, wp, win, win // 2) if shift else None
    return qkv, bias, regions, mask


@pytest.mark.parametrize("shift", [False, True])
@pytest.mark.parametrize("win,heads,nW", [(7, 2, 4), (4, 3, 9),
                                          (7, 4, 70), (7, 8, 20), (7, 16, 6), (7, 32, 2)])
def test_plain_matches_fused_window_attention(win, heads, nW, shift):
    """Square maps of 3 crops, and each Swin-B stage's geometry on its own
    padded map (1 crop at stages 0-1, 2 at stages 2-3)."""
    hw = SWIN_B_MAPS.get(nW) if heads >= 4 else None
    B = 3 if hw is None else (1 if nW >= 20 else 2)
    qkv, bias, _, mask = _inputs(win, heads, nW, B, win + heads, shift, hw)
    want = np.asarray(jwa.fused_window_attention(
        jnp.asarray(qkv), jnp.asarray(bias), None if mask is None else jnp.asarray(mask),
        heads=heads, interpret=True))
    t = torch.from_numpy
    got = wa.fused_window_attention(t(qkv), t(bias), None if mask is None else t(mask), heads)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("shift", [False, True])
@pytest.mark.parametrize("wb", [None, 2])
def test_plain_matches_packed_window_attention(shift, wb):
    win, heads, nW = 7, 2, 4
    qkv, bias, regions, _ = _inputs(win, heads, nW, 2, 11, shift)
    want = np.asarray(jwa.packed_window_attention(
        jnp.asarray(qkv), jnp.asarray(bias), regions, heads=heads, wb=wb, interpret=True))
    got = wa.packed_window_attention(torch.from_numpy(qkv), torch.from_numpy(bias), regions,
                                     heads, wb=wb)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


def test_plain_matches_bf16():
    win, heads, nW = 7, 4, 4
    qkv, bias, _, mask = _inputs(win, heads, nW, 2, 5, True)
    want = np.asarray(jwa.fused_window_attention(
        jnp.asarray(qkv, jnp.bfloat16), jnp.asarray(bias), jnp.asarray(mask), heads=heads,
        interpret=True)).astype(np.float32)
    got = wa.window_attention(torch.from_numpy(qkv).to(torch.bfloat16), torch.from_numpy(bias),
                              torch.from_numpy(mask), heads)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=2.0 ** -8 * np.abs(want).max())


def test_cpu_runs_plain_and_counts_no_launch():
    qkv, bias, _, mask = _inputs(7, 2, 4, 1, 0, True)
    n = wa.window_attention.launches
    out = wa.window_attention(torch.from_numpy(qkv), torch.from_numpy(bias),
                              torch.from_numpy(mask), 2)
    assert wa.window_attention.launches == n
    torch.testing.assert_close(out, wa.window_attention_plain(
        torch.from_numpy(qkv), torch.from_numpy(bias), torch.from_numpy(mask), 2),
        rtol=0, atol=0)


def test_shapes_are_checked():
    qkv = torch.zeros(6, 49, 192)
    with pytest.raises(ValueError, match="bias"):
        wa.window_attention(qkv, torch.zeros(2, 16, 16), None, 2)
    with pytest.raises(ValueError, match="multiple"):
        wa.window_attention(qkv, torch.zeros(2, 49, 49), torch.zeros(4, 49, 49), 2)

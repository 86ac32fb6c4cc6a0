"""The port's whole-SwinBlock op against the JAX package's Pallas kernel.

`swin_block_plain` (the five-launch block's arithmetic in plain PyTorch:
``ops/swin_block.py``) against ``ops/pallas/swin_block.py::fused_swin_block``
in interpret mode, in float32, held at 2e-4 as the JAX package holds its
kernel against the flax einsum path (f32 sums in another order; the Pallas
kernel's GELU uses a 1.5e-7 erf approximation).  Window 7 with head dim
32; shifted and unshifted, padded and unpadded maps, image in and out or
window-order tokens in and out (``pre_partitioned`` / ``emit_partitioned``,
pad tokens zeroed on emit).  Weights go through the port's flax converter.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_camera_3d_pose_estimation_tpu.models.swin import SwinBlock as JSwinBlock
from multi_camera_3d_pose_estimation_tpu.ops.pallas import swin_block as jsb
from multi_camera_3d_pose_estimation_tpu_torch.models.convert import load_swin_from_flax
from multi_camera_3d_pose_estimation_tpu_torch.models.swin import SwinBlock
from multi_camera_3d_pose_estimation_tpu_torch.ops import swin_block as sb
from multi_camera_3d_pose_estimation_tpu_torch.ops import window_attention as wa
from multi_camera_3d_pose_estimation_tpu_torch.ops.swin_geometry import window_partition

from tests._torch_port_util import random_variables

C, HEADS, WIN, RATIO, B = 64, 2, 7, 4, 2


def _pair(H, W, shift, seed):
    jm = JSwinBlock(heads=HEADS, window=WIN, shift=shift, mlp_ratio=RATIO, dtype=jnp.float32)
    params = random_variables(jm, (1, H, W, C), seed=seed)["params"]
    port = SwinBlock(C, HEADS, WIN, shift, RATIO, dtype=torch.float32)
    load_swin_from_flax(port, {"params": params})
    x = np.random.default_rng(seed).normal(size=(B, H, W, C)).astype(np.float32)
    return params, sb.prepare_swin_block(port, torch.float32), x


@pytest.mark.parametrize("H,W", [(14, 14), (12, 10)], ids=["unpadded", "padded"])
@pytest.mark.parametrize("shift", [0, 3])
@pytest.mark.parametrize("part", [False, True], ids=["image", "tokens"])
def test_block_matches_pallas_block_f32(H, W, shift, part):
    params, p, x = _pair(H, W, shift, seed=H + shift)
    kw = dict(heads=HEADS, window=WIN, shift=shift, mlp_ratio=RATIO)
    xin = jnp.asarray(x)
    if part:
        xin = jsb.window_partition(xin, WIN, shift)
        kw.update(pre_partitioned=(B, H, W), emit_partitioned=True)
    want = np.asarray(jsb.fused_swin_block(xin, params, interpret=True, **kw))
    got = sb.swin_block_plain(torch.from_numpy(np.array(xin)), p, **kw)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-4)
    if part and (H, W) != (14, 14):  # pad tokens leave as exact zeros
        pads = np.abs(want).sum(-1) == 0
        assert pads.sum() == B * (14 * 14 - H * W)
        assert (got.numpy()[pads] == 0).all()


def test_fused_block_on_cpu_is_the_plain_block():
    _, p, x = _pair(12, 10, 3, seed=9)
    xt = torch.from_numpy(x)
    launches = (sb.swin_gemm.launches, sb.swin_gemm.ln_launches, wa.window_attention.launches)
    got = sb.fused_swin_block(xt, p, heads=HEADS, window=WIN, shift=3, mlp_ratio=RATIO, wb=8)
    assert (sb.swin_gemm.launches, sb.swin_gemm.ln_launches,
            wa.window_attention.launches) == launches
    want = sb.swin_block_plain(xt, p, heads=HEADS, window=WIN, shift=3, mlp_ratio=RATIO)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("mode", ["qkv", "resid", "gelu"])
def test_swin_gemm_on_cpu_is_plain_and_counts_nothing(mode):
    """A CPU tensor runs `swin_gemm_plain` and counts no product launch and
    no LayerNorm row-kernel launch."""
    rng = np.random.default_rng(5)
    M, K, N = 2 * 49, 64, 96
    a = torch.from_numpy(rng.normal(size=(M, K)).astype(np.float32)).to(torch.bfloat16)
    w = torch.from_numpy(rng.normal(size=(N, K)).astype(np.float32) / 8).to(torch.bfloat16)
    b = torch.from_numpy(rng.normal(size=N).astype(np.float32) / 10)
    ln = res = valid = None
    if mode == "resid":
        res = torch.from_numpy(rng.normal(size=(M, N)).astype(np.float32)).to(torch.bfloat16)
    else:
        ln = (torch.from_numpy(1 + rng.normal(size=K).astype(np.float32) / 5),
              torch.from_numpy(rng.normal(size=K).astype(np.float32) / 10))
    if mode != "gelu":
        valid = torch.from_numpy((rng.random(49) > 0.3).astype(np.float32))
    counts = (sb.swin_gemm.launches, sb.swin_gemm.ln_launches)
    got = sb.swin_gemm(mode, a, w, b, res=res, ln=ln, valid=valid)
    assert (sb.swin_gemm.launches, sb.swin_gemm.ln_launches) == counts
    want = sb.swin_gemm_plain(mode, a, w, b, res=res, ln=ln, valid=valid)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (M, N)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_block_layouts_agree():
    """Tokens in and out equal image in and out through the window layout."""
    _, p, x = _pair(12, 10, 3, seed=4)
    xt = torch.from_numpy(x)
    kw = dict(heads=HEADS, window=WIN, shift=3, mlp_ratio=RATIO)
    img = sb.swin_block_plain(xt, p, **kw)
    tok = sb.swin_block_plain(window_partition(xt, WIN, 3), p, pre_partitioned=(B, 12, 10),
                              emit_partitioned=True, **kw)
    torch.testing.assert_close(tok, window_partition(img, WIN, 3), rtol=0, atol=0)


def test_gemm_modes_bf16_cast_points():
    """swin_gemm_plain's bf16 cast points: bf16(acc) + bf16(b) for qkv,
    res + that for the residual, f32 bias and GELU before one bf16 cast."""
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.normal(size=(98, 64)).astype(np.float32)).to(torch.bfloat16)
    w = torch.from_numpy(rng.normal(size=(32, 64)).astype(np.float32) / 8).to(torch.bfloat16)
    b = torch.from_numpy(rng.normal(size=32).astype(np.float32))
    acc = a.float() @ w.float().t()
    res = torch.from_numpy(rng.normal(size=(98, 32)).astype(np.float32)).to(torch.bfloat16)
    valid = torch.from_numpy((rng.random(49) > 0.2).astype(np.float32))
    q = sb.swin_gemm("resid", a, w, b, res=res, valid=valid)
    want = (res + (acc.to(torch.bfloat16) + b.to(torch.bfloat16))) * valid.repeat(2)[:, None].to(
        torch.bfloat16)
    torch.testing.assert_close(q, want, rtol=0, atol=0)
    g = sb.swin_gemm("gelu", a, w, b, ln=(torch.ones(64), torch.zeros(64)))
    assert g.dtype == torch.bfloat16 and g.shape == (98, 32)
    with pytest.raises(ValueError, match="mode"):
        sb.swin_gemm("fc", a, w, b)


def test_block_prepares_its_weights_once():
    """SwinBlock.prepared() is made once and made again only after its
    weights change: reloaded, or written in place."""
    jm = JSwinBlock(heads=HEADS, window=WIN, shift=3, mlp_ratio=RATIO, dtype=jnp.float32)
    params = random_variables(jm, (1, 12, 10, C), seed=5)["params"]
    port = SwinBlock(C, HEADS, WIN, 3, RATIO, dtype=torch.float32)
    load_swin_from_flax(port, {"params": params})
    first = port.prepared()
    assert port.prepared() is first
    for key in ("wqkv", "bias"):
        torch.testing.assert_close(first[key], sb.prepare_swin_block(port, torch.float32)[key],
                                   rtol=0, atol=0)
    with torch.no_grad():
        port.attn.bias_table.add_(1.0)
    second = port.prepared()
    assert second is not first
    torch.testing.assert_close(second["bias"], first["bias"] + 1.0, rtol=0, atol=0)
    load_swin_from_flax(port, {"params": params})
    torch.testing.assert_close(port.prepared()["bias"], first["bias"], rtol=0, atol=0)

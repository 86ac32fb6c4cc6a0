"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips where ``torch.cuda.is_available()`` is
false (no card, or a CPU build of PyTorch).  On a machine with a card:

    python -m pytest tests/test_torch_port_cuda.py -m cuda -p no:cacheprovider --noconftest

(``--noconftest``: ``tests/conftest.py`` imports JAX, which this file does
not need.)

Tolerances: the Bottleneck kernel sums bf16 products in f32 in another
order than the plain version, so an output may round to the neighbouring
bf16 value (2^-8 relative): held at 8e-3 of the largest output, with under
1% of outputs off by more than one bf16 step.  The decode kernel's f32 sums
are held to 1e-5 relative to |value| + 1; its peak and argmax exactly.
The Swin kernels (`swin_gemm`, `window_attention`) sum bf16 products in f32
in another order than their plain versions; an output may land on the
neighbouring bf16 value, and through a whole block (five launches) such
flips propagate: each launch is held at 2 bf16 steps (2^-7) of its largest
output, the block at 4 steps, and under 1% of outputs more than one step
of their own binade apart.
"""

import pytest
import torch

from multi_camera_3d_pose_estimation_tpu_torch.ops import bottleneck as bn
from multi_camera_3d_pose_estimation_tpu_torch.ops import fused_decode as fd
from multi_camera_3d_pose_estimation_tpu_torch.ops import swin_block as sb
from multi_camera_3d_pose_estimation_tpu_torch.ops import window_attention as wa
from multi_camera_3d_pose_estimation_tpu_torch.ops.swin_geometry import shift_mask

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _block(gen, cin, down, device):
    f = {"W1": torch.randn(1, 1, cin, 64, generator=gen) / cin ** 0.5,
         "b1": 0.1 * torch.randn(64, generator=gen),
         "W2": torch.randn(3, 3, 64, 64, generator=gen) / 24.0,
         "b2": 0.1 * torch.randn(64, generator=gen),
         "W3": torch.randn(1, 1, 64, 256, generator=gen) / 8.0,
         "b3": 0.1 * torch.randn(256, generator=gen)}
    if down:
        f["Wd"] = torch.randn(1, 1, cin, 256, generator=gen) / cin ** 0.5
        f["bd"] = 0.1 * torch.randn(256, generator=gen)
    return bn.prepare_block(f, torch.bfloat16, device)


@pytest.mark.parametrize("B,H,W,cin,down", [(2, 64, 48, 64, True), (2, 64, 48, 256, False),
                                            (3, 16, 8, 16, True), (1, 13, 12, 256, False)])
def test_bottleneck_kernel_matches_plain(card, B, H, W, cin, down):
    gen = torch.Generator().manual_seed(cin + H)
    p = _block(gen, cin, down, card)
    x = torch.randn(B, H, W, cin, generator=gen).to(card, torch.bfloat16)
    n = bn.fused_bottleneck_block.launches
    out = bn.fused_bottleneck_block(x, p)
    torch.cuda.synchronize()
    assert bn.fused_bottleneck_block.launches == n + 1
    ref = bn.bottleneck_block_plain(x, p).float()
    d = (out.float() - ref).abs()
    assert d.max() <= 8e-3 * ref.abs().max()
    assert (d > ref.abs() * 2 ** -7 + 1e-6).float().mean() < 0.01


def test_bottleneck_kernel_refuses_f32(card):
    p = _block(torch.Generator().manual_seed(0), 64, True, card)
    with pytest.raises(TypeError):
        bn.fused_bottleneck_block(torch.zeros(1, 4, 4, 64, device=card), p)


def test_decode_kernel_matches_plain(card):
    gen = torch.Generator().manual_seed(0)
    hm = torch.rand(300, 64 * 48, generator=gen)
    hm[0] = 0.0  # empty map
    hm[1, 5] = hm[1, 100] = 2.0  # tied peak: the first wins
    hm[2] = torch.round(hm[2] * 4) / 4  # many ties
    hm = hm.to(card)
    out = fd.heatmap_decode_raw(hm, 48, 0.01)
    torch.cuda.synchronize()
    ref = fd.heatmap_decode_raw_plain(hm, 48, 0.01)
    assert ((out - ref).abs() / (ref.abs() + 1)).max() <= 1e-5
    assert torch.equal(out[:, 6:8], ref[:, 6:8]) and out[1, 7] == 5


def _close_bf16(out, ref, steps):
    out, ref = out.float(), ref.float()
    d = (out - ref).abs()
    assert d.max() <= steps * 2 ** -8 * ref.abs().max(), d.max()
    step = torch.ldexp(torch.ones_like(ref), torch.frexp(ref).exponent - 8)
    assert (d > step).float().mean() < 0.01


def _swin_params(gen, C, heads, ratio, device):
    def lin(o, i):
        return (torch.randn(o, i, generator=gen) / i ** 0.5).to(device, torch.bfloat16), \
            (0.1 * torch.randn(o, generator=gen)).to(device)

    def norm():
        return ((1 + 0.2 * torch.randn(C, generator=gen)).to(device),
                (0.1 * torch.randn(C, generator=gen)).to(device))

    p = {"norm1": norm(), "norm2": norm(),
         "bias": (0.1 * torch.randn(heads, 49, 49, generator=gen)).to(device)}
    p["wqkv"], p["bqkv"] = lin(3 * C, C)
    p["wproj"], p["bproj"] = lin(C, C)
    p["wfc1"], p["bfc1"] = lin(ratio * C, C)
    p["wfc2"], p["bfc2"] = lin(C, ratio * C)
    return p


@pytest.mark.parametrize("mode,M,K,N", [("qkv", 4 * 49 * 6, 128, 384), ("resid", 999, 256, 256),
                                        ("gelu", 1000, 64, 256), ("resid", 130, 1024, 96)])
def test_swin_gemm_matches_plain(card, mode, M, K, N):
    gen = torch.Generator().manual_seed(M + K)
    a = torch.randn(M, K, generator=gen).to(card, torch.bfloat16)
    w = (torch.randn(N, K, generator=gen) / K ** 0.5).to(card, torch.bfloat16)
    b = (0.1 * torch.randn(N, generator=gen)).to(card)
    ln = res = valid = None
    if mode != "resid":
        ln = ((1 + 0.2 * torch.randn(K, generator=gen)).to(card),
              (0.1 * torch.randn(K, generator=gen)).to(card))
    else:
        res = torch.randn(M, N, generator=gen).to(card, torch.bfloat16)
    if mode != "gelu" and M % 49 == 0:
        valid = (torch.rand(49 * 6, generator=gen) > 0.3).float().to(card)
    n = sb.swin_gemm.launches
    out = sb.swin_gemm(mode, a, w, b, res=res, ln=ln, valid=valid)
    torch.cuda.synchronize()
    assert sb.swin_gemm.launches == n + 1
    _close_bf16(out, sb.swin_gemm_plain(mode, a, w, b, res=res, ln=ln, valid=valid), 2)


@pytest.mark.parametrize("win,heads,nW,shifted", [(7, 4, 6, True), (7, 32, 2, False),
                                                  (4, 2, 4, True)])
def test_window_attention_matches_plain(card, win, heads, nW, shifted):
    gen = torch.Generator().manual_seed(win * heads)
    n, Bw = win * win, 3 * nW
    qkv = torch.randn(Bw, n, 3 * 32 * heads, generator=gen).to(card, torch.bfloat16)
    bias = (0.1 * torch.randn(heads, n, n, generator=gen)).to(card)
    mask = None
    if shifted:
        mask = torch.as_tensor(shift_mask(2 * win, nW // 2 * win, win, win // 2)).to(card)
    n0 = wa.window_attention.launches
    out = wa.window_attention(qkv, bias, mask, heads)
    torch.cuda.synchronize()
    assert wa.window_attention.launches == n0 + 1
    _close_bf16(out, wa.window_attention_plain(qkv, bias, mask, heads), 2)


def test_window_attention_refuses_head_dim_16(card):
    qkv = torch.zeros(2, 49, 3 * 64, device=card, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        wa.window_attention(qkv, torch.zeros(4, 49, 49, device=card), None, 4)


@pytest.mark.parametrize("H,W,shift,part", [(16, 12, 3, False), (14, 14, 0, False),
                                            (16, 12, 3, True)])
def test_fused_swin_block_matches_plain(card, H, W, shift, part):
    gen = torch.Generator().manual_seed(H * W + shift)
    C, heads = 128, 4
    p = _swin_params(gen, C, heads, 4, card)
    x = torch.randn(3, H, W, C, generator=gen).to(card, torch.bfloat16)
    kw = dict(heads=heads, window=7, shift=shift, mlp_ratio=4)
    if part:
        from multi_camera_3d_pose_estimation_tpu_torch.ops.swin_geometry import window_partition
        x = window_partition(x, 7, shift).contiguous()
        kw.update(pre_partitioned=(3, H, W), emit_partitioned=True)
    g0, a0 = sb.swin_gemm.launches, wa.window_attention.launches
    out = sb.fused_swin_block(x, p, **kw)
    torch.cuda.synchronize()
    assert (sb.swin_gemm.launches - g0, wa.window_attention.launches - a0) == (4, 1)
    ref = sb.swin_block_plain(x, p, **kw)
    _close_bf16(out, ref, 4)
    if part:  # pad tokens leave as exact zeros
        assert torch.equal(out[ref.abs().sum(-1) == 0], ref[ref.abs().sum(-1) == 0])


def test_swin_gemm_refuses_f32(card):
    a = torch.zeros(64, 64, device=card)
    with pytest.raises(TypeError):
        sb.swin_gemm("resid", a, a, torch.zeros(64, device=card), res=a)

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
of their own binade apart.  The attention's row mode (the fixed-order
layout) and the fixed-order block are held the same way, on a padded map
whose crops carry alignment rows (12x10, window 7: 196 tokens, P = 200);
the attention also at every Swin-B stage in both modes, row mode bit for
bit equal to the chained mode on the same windows.
"""

import pytest
import torch

from multi_camera_3d_pose_estimation_tpu_torch.ops import bottleneck as bn
from multi_camera_3d_pose_estimation_tpu_torch.ops import fused_decode as fd
from multi_camera_3d_pose_estimation_tpu_torch.ops import swin_block as sb
from multi_camera_3d_pose_estimation_tpu_torch.ops import window_attention as wa
from multi_camera_3d_pose_estimation_tpu_torch.ops.swin_geometry import fixed_rows, shift_mask

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


# The kernel's edges: tiles of 64 pixels in image order, one run of
# consecutive tiles per CTA, y1 kept in a ring of (W + 64) // 64 units
# either side.  B above the SM count at 16x8 (2 tiles per image: runs cross
# images and start mid-image), H x W not a multiple of the tile (13x12,
# 37x20), B = 1 at 64x48, W = 72 (HRNet-W48 at 384x288: two units of
# lookahead), and every cin of HRNet's stage 1: 16 and 64 with the
# downsample, 256 identity.
@pytest.mark.parametrize("B,H,W,cin,down", [(2, 64, 48, 64, True), (2, 64, 48, 256, False),
                                            (3, 16, 8, 16, True), (1, 13, 12, 256, False),
                                            (133, 16, 8, 16, True), (263, 16, 8, 256, False),
                                            (3, 37, 20, 256, False), (5, 13, 12, 64, True),
                                            (1, 64, 48, 64, True), (1, 64, 48, 256, False),
                                            (2, 96, 72, 256, False), (137, 64, 48, 256, False)])
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


def test_bottleneck_chain_matches_plain(card):
    """Four launches (block 0 with the downsample, three identity blocks)
    against `stage1_chain_plain`: 4 bf16 steps of the largest output, as
    chip_smoke.py holds the main path's chain (a flip in one block moves the
    next block's input, so the share of flipped outputs compounds)."""
    gen = torch.Generator().manual_seed(11)
    blocks = [_block(gen, 64, True, card)] + [_block(gen, 256, False, card) for _ in range(3)]
    x = torch.rand(140, 64, 48, 64, generator=gen).to(card, torch.bfloat16)
    n = bn.fused_bottleneck_block.launches
    out = bn.fused_stage1_chain(x, blocks)
    torch.cuda.synchronize()
    assert bn.fused_bottleneck_block.launches == n + 4
    ref = bn.stage1_chain_plain(x, blocks).float()
    d = (out.float() - ref).abs()
    assert d.max() <= 4 * 2 ** -8 * ref.abs().max()


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


# The kernel's edges: K = 96 (Swin-T, not a multiple of the 64-deep stage),
# K = 4096 (Swin-B stage-3 fc2), N not a multiple of the 128-column tile (and
# under one 64-column half), M not a multiple of the 128-row tile, and the
# fixed-order valid period (P = 200 rows of a 12x10 map, window 7).
@pytest.mark.parametrize("mode,M,K,N", [("qkv", 4 * 49 * 6, 128, 384), ("resid", 999, 256, 256),
                                        ("gelu", 1000, 64, 256), ("resid", 130, 1024, 96),
                                        ("qkv", 3 * 200, 96, 288), ("gelu", 777, 96, 384),
                                        ("resid", 3000, 4096, 1024), ("gelu", 513, 256, 200),
                                        ("resid", 4 * 200, 128, 72), ("qkv", 2 * 200, 64, 40)])
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
    elif mode != "gelu" and M % 200 == 0:
        valid = sb.fixed_tables(12, 10, 7, 0, card)[0]
    n, n_ln = sb.swin_gemm.launches, sb.swin_gemm.ln_launches
    out = sb.swin_gemm(mode, a, w, b, res=res, ln=ln, valid=valid)
    torch.cuda.synchronize()
    assert (sb.swin_gemm.launches, sb.swin_gemm.ln_launches) == (n + 1, n_ln + (ln is not None))
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


def test_swin_gemm_qkv_pad_rows_are_bias(card):
    """Rows with valid == 0 enter qkv as exact zeros: their output is bf16(b)."""
    gen = torch.Generator().manual_seed(7)
    valid = sb.fixed_tables(12, 10, 7, 3, card)[0]  # P = 200: 120 real rows, 80 padding
    a = torch.randn(3 * 200, 128, generator=gen).to(card, torch.bfloat16)
    w = (torch.randn(384, 128, generator=gen) / 128 ** 0.5).to(card, torch.bfloat16)
    b = (0.1 * torch.randn(384, generator=gen)).to(card)
    ln = ((1 + 0.2 * torch.randn(128, generator=gen)).to(card),
          (0.1 * torch.randn(128, generator=gen)).to(card))
    out = sb.swin_gemm("qkv", a, w, b, ln=ln, valid=valid)
    torch.cuda.synchronize()
    pad = valid.repeat(3) == 0
    assert int(pad.sum()) == 3 * 80
    assert torch.equal(out[pad], b.to(torch.bfloat16).expand(int(pad.sum()), -1))


def test_swin_gemm_refuses_f32(card):
    a = torch.zeros(64, 64, device=card)
    with pytest.raises(TypeError):
        sb.swin_gemm("resid", a, a, torch.zeros(64, device=card), res=a)


@pytest.mark.parametrize("shift", [3, 0])
def test_window_attention_rows_matches_plain(card, shift):
    """Row mode on a shifted, padded map with 4 alignment rows per crop."""
    gen = torch.Generator().manual_seed(40 + shift)
    B, H, W, heads, n = 3, 12, 10, 4, 49
    P = fixed_rows(H, W, 7)
    _, rows, mask = sb.fixed_tables(H, W, 7, shift, card)
    qkv = torch.randn(B * P, 3 * 32 * heads, generator=gen).to(card, torch.bfloat16)
    bias = torch.randn(heads, n, n, generator=gen).to(card)
    n0 = wa.window_attention_rows.launches
    out = wa.window_attention_rows(qkv, bias, mask, heads, rows, P)
    torch.cuda.synchronize()
    assert wa.window_attention_rows.launches == n0 + 1
    _close_bf16(out, wa.window_attention_rows_plain(qkv, bias, mask, heads, rows, P), 2)
    C = 32 * heads  # alignment rows: exactly their own v
    assert torch.equal(out.view(B, P, C)[:, 196:], qkv.view(B, P, 3 * C)[:, 196:, 2 * C:])
    with pytest.raises(TypeError, match="int32"):
        wa.window_attention_rows(qkv, bias, mask, heads, rows.long(), P)


def _attention_both_modes(card, B, heads, H, W, win, shift, seed):
    """The attention of B crops of an (H, W) map in both modes on the same
    windows: fixed-order qkv (B·P, 3C) through the row table, and the same
    windows gathered to (Bw, n, 3C) through the chained mode.  Each against
    its plain version within 2 bf16 steps; row mode bit for bit equal to
    the chained mode on every window token; alignment rows exactly their v;
    one launch each."""
    gen = torch.Generator().manual_seed(seed)
    n, C, P = win * win, 32 * heads, fixed_rows(H, W, win)
    _, rows, mask = sb.fixed_tables(H, W, win, shift, card)
    qkv = torch.randn(B * P, 3 * C, generator=gen).to(card, torch.bfloat16)
    bias = torch.randn(heads, n, n, generator=gen).to(card)
    idx = (torch.arange(B, device=card)[:, None] * P + rows.long()[None, :]).reshape(-1)
    qkv_w = qkv[idx].view(-1, n, 3 * C)
    n0, r0 = wa.window_attention.launches, wa.window_attention_rows.launches
    chained = wa.window_attention(qkv_w, bias, mask, heads)
    fixed = wa.window_attention_rows(qkv, bias, mask, heads, rows, P)
    torch.cuda.synchronize()
    assert (wa.window_attention.launches - n0, wa.window_attention_rows.launches - r0) == (1, 1)
    _close_bf16(chained, wa.window_attention_plain(qkv_w, bias, mask, heads), 2)
    _close_bf16(fixed, wa.window_attention_rows_plain(qkv, bias, mask, heads, rows, P), 2)
    assert torch.equal(fixed[idx], chained.view(-1, C))
    nWn = rows.numel()
    assert torch.equal(fixed.view(B, P, C)[:, nWn:], qkv.view(B, P, 3 * C)[:, nWn:, 2 * C:])


# The Swin-B stages at 192x256 input: heads and the real map (padded to nW =
# 70, 20, 6 and 2 windows of 7x7).  64 crops give every CTA a run of 2-9
# crops on a 132-SM card, so the cp.async ring turns over.
@pytest.mark.parametrize("shift", [3, 0])
@pytest.mark.parametrize("heads,H,W", [(4, 64, 48), (8, 32, 24), (16, 16, 12), (32, 8, 6)])
def test_window_attention_swin_b_stages(card, heads, H, W, shift):
    _attention_both_modes(card, 64, heads, H, W, 7, shift, heads + shift)


# n = 16, 49 and 64 (NT = 2, 7 and 8 score tiles), shifted; the window-7
# map's crops carry alignment rows (P = 200 for 196 tokens).
@pytest.mark.parametrize("win,H,W", [(4, 10, 9), (7, 12, 10), (8, 20, 13)])
def test_window_attention_window_sizes(card, win, H, W):
    _attention_both_modes(card, 48, 4, H, W, win, win // 2, win)


@pytest.mark.parametrize("shift", [3, 0])
def test_window_attention_ragged_run(card, shift):
    """127 crops (a prime) at the Swin-B stage-0 geometry: whatever run the
    launcher picks (2 .. 126 crops), the last run of each (head, window) is
    shorter."""
    _attention_both_modes(card, 127, 4, 64, 48, 7, shift, 127 + shift)


@pytest.mark.parametrize("shift", [3, 0])
def test_fused_swin_block_fixed_matches_plain(card, shift):
    from multi_camera_3d_pose_estimation_tpu_torch.ops.swin_geometry import fixed_partition
    gen = torch.Generator().manual_seed(50 + shift)
    C, heads = 128, 4
    p = _swin_params(gen, C, heads, 4, card)
    x = fixed_partition(torch.randn(3, 12, 10, C, generator=gen), 7).to(card, torch.bfloat16)
    kw = dict(heads=heads, window=7, shift=shift, mlp_ratio=4, geom=(3, 12, 10))
    g0, a0 = sb.swin_gemm.launches, wa.window_attention_rows.launches
    out = sb.fused_swin_block_fixed(x, p, **kw)
    torch.cuda.synchronize()
    assert (sb.swin_gemm.launches - g0, wa.window_attention_rows.launches - a0) == (4, 1)
    _close_bf16(out, sb.swin_block_fixed_plain(x, p, **kw), 4)


# The 3-D half: plain PyTorch on both sides, held card against CPU.  The
# refinement in float64: per-epoch costs at 1e-9 relative, the trajectory at
# 1e-7 (cuBLAS/cuSOLVER and the CPU sum in other orders).
def _refine_scene(T=24, J=5, n_cams=3, seed=0):
    import numpy as np

    rng = np.random.default_rng(seed)
    t = np.linspace(0, 2 * np.pi, T)[:, None]
    traj = rng.uniform([-30, -30, 280], [30, 30, 360], (1, J, 3)) + 10.0 * np.stack(
        [np.sin(t), np.cos(t), 0.5 * np.sin(2 * t)], axis=-1)
    cams, gauss = {}, np.zeros((T, n_cams, J, 6))
    for c in range(n_cams):
        K = np.array([[900.0 + 10 * c, 0, 640.0], [0, 905.0 - 5 * c, 360.0], [0, 0, 1]])
        th = np.deg2rad(-20.0 + 25.0 * c)
        R = np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0], [-np.sin(th), 0, np.cos(th)]])
        Tv = np.array([40.0 * c - 20.0, 2.0 * c, 25.0 * c])
        cams[c] = [K, R, Tv, np.array([-0.05 * c, 0.01, 0, 0, 0])]
        cam = traj.reshape(-1, 3) @ R.T + Tv
        gauss[:, c, :, :2] = (cam[:, :2] / cam[:, 2:] * [K[0, 0], K[1, 1]]
                              + [K[0, 2], K[1, 2]]).reshape(T, J, 2)
        gauss[:, c, :, 2] = gauss[:, c, :, 5] = 16.0
    return gauss, traj + rng.normal(0, 3.0, traj.shape), cams


@pytest.mark.parametrize("kw", [dict(), dict(batch_size=8), dict(use_NN=True, lr=0.01)],
                         ids=["one_window", "overlapping_windows", "use_nn"])
def test_refinement_float64_matches_cpu(card, kw):
    import numpy as np

    from multi_camera_3d_pose_estimation_tpu_torch.refine import PoseRefiner

    gauss, init, cams = _refine_scene()
    args = dict(dict(lr=0.05, max_iter=39, patience=10 ** 6, lambda_smooth=0.01), **kw)
    body = {"nose_left_eye": 4.0, "left_eye_left_ear": 6.0}
    res = {d: PoseRefiner(gauss, init, cams, body_lengths=body, dtype=torch.float64,
                          device=d).sgd_optimize(**args) for d in (card, "cpu")}
    a, b = res[card], res["cpu"]
    assert a.n_iter == b.n_iter == 40
    for k, v in b.cost_history.items():
        np.testing.assert_allclose(a.cost_history[k], v, rtol=1e-9, atol=0, err_msg=k)
    np.testing.assert_allclose(a.trajectory, b.trajectory, rtol=0, atol=1e-7)


def test_triangulate_nview_matches_cpu(card):
    """At the n-view path's shape: 128 frames x 17 joints x 4 views, f32,
    some views gated (NaN); held at 1e-3 relative (f32 4x4 solves)."""
    from multi_camera_3d_pose_estimation_tpu_torch.entry import synthetic_rig
    from multi_camera_3d_pose_estimation_tpu_torch.ops import triangulate_nview

    gen = torch.Generator().manual_seed(9)
    rig = {k: torch.as_tensor(v) for k, v in synthetic_rig(4, 256, 256).items()}
    X = torch.rand(128, 17, 3, generator=gen) * 60 - 30 + torch.tensor([0.0, 0.0, 400.0])
    cam = torch.einsum("cij,tkj->tkci", rig["R"], X) + rig["T"]
    kpts = cam[..., :2] / cam[..., 2:] * 600.0 + 128.0 + torch.randn(128, 17, 4, 2, generator=gen)
    conf = torch.rand(128, 17, 4, generator=gen)
    kpts[conf < 0.3] = float("nan")
    args = (kpts, conf, rig["K"], rig["dist"], rig["R"], rig["T"])
    out = triangulate_nview(*(a.to(card) for a in args)).cpu()
    ref = triangulate_nview(*args)
    assert torch.equal(torch.isnan(out), torch.isnan(ref)) and torch.isnan(ref).any()
    ok = torch.isfinite(ref)
    torch.testing.assert_close(out[ok], ref[ok], rtol=1e-3, atol=1e-2)


def test_dark_decode_matches_cpu(card):
    """Heatmaps of the HRNet path's size: the card's f32 decode no further
    from the float64 decode than twice the CPU's f32 decode is, plus 1e-5
    px (the f32 offsets come from logs of blurred sums: up to 6e-4 px off
    float64 on the CPU where a peak sits at the map's edge), the score
    exactly."""
    from multi_camera_3d_pose_estimation_tpu_torch.ops import heatmap_dark_decode

    gen = torch.Generator().manual_seed(10)
    ys, xs = torch.meshgrid(torch.arange(64.0), torch.arange(48.0), indexing="ij")
    c = torch.rand(512, 17, 2, 1, 1, generator=gen) * torch.tensor([64.0, 48.0])[:, None, None]
    hm = torch.exp(-((ys - c[:, :, 0]) ** 2 + (xs - c[:, :, 1]) ** 2) / 4.5)
    hm = hm + 0.01 * torch.rand(hm.shape, generator=gen)
    xy, s = heatmap_dark_decode(hm.to(card))
    xy_ref, s_ref = heatmap_dark_decode(hm)
    xy64 = heatmap_dark_decode(hm.double())[0]
    err = (xy.cpu().double() - xy64).abs().max().item()
    err_ref = (xy_ref.double() - xy64).abs().max().item()
    assert err <= 2 * err_ref + 1e-5, (err, err_ref)
    assert torch.equal(s.cpu(), s_ref)


# The detector and SimCC pipelines (plain PyTorch in front of the kernels),
# small, card against CPU: the CPU path on the card's own detector outputs or
# SimCC logits replayed gives the card's boxes and scores exactly and its
# outputs where both decoded the same peaks (kpts_2d within 1e-2 px,
# kpts_3d within 1e-2 + 1e-3·|x|); end to end with the detector in float32
# (TF32 off), the same boxes within 1e-2 px.  The SimCC replay also decodes
# at least 0.95 of the joints alike on both sides (gated ones included).
DET_SHAPE = (4, 2, 64, 96, 3)
TINY_HRNET = ({"widths": (8, 16, 32, 64), "modules": (1, 1, 1, 1), "stem": 16}, (32, 64))


def _same_outputs(a, b):
    same = ((a["kpts_2d"][:, :, :2] - b["kpts_2d"][:, :, :2]).abs() < 1e-2).all(2).all(-1)
    both = same & torch.isfinite(a["kpts_3d"]).all(-1) & torch.isfinite(b["kpts_3d"]).all(-1)
    assert same.float().mean() >= 0.5 and both.sum() >= 5
    d = (a["kpts_3d"][both] - b["kpts_3d"][both]).abs()
    assert (d <= 1e-2 + 1e-3 * b["kpts_3d"][both].abs()).all()


def _record(owner, outs):
    """Wraps ``owner.model`` so that its outputs are appended to ``outs``."""
    model = owner.model

    def record(x):
        outs.append(model(x))
        return outs[-1]

    owner.model = record


@pytest.mark.parametrize("select", ["top1", "consistent"])
def test_detector_pipeline_matches_cpu(card, select):
    from multi_camera_3d_pose_estimation_tpu_torch.entry import build_pipeline
    from multi_camera_3d_pose_estimation_tpu_torch.models import RTMDet, SinglePersonDetector
    from multi_camera_3d_pose_estimation_tpu_torch.models.registry import (DETECTOR_REGISTRY,
                                                                           init_rtmdet_)

    cfg, size = TINY_HRNET
    frames = torch.randint(0, 256, DET_SHAPE, generator=torch.Generator().manual_seed(5),
                           dtype=torch.uint8)
    card_p, cpu_p = (build_pipeline(cfg, size, DET_SHAPE, device=d, seed=3,
                                    detector="test_rtmdet_micro", detector_select=select)
                     for d in (card, "cpu"))
    outs = []
    _record(card_p.detector, outs)
    det_a = [t.cpu() for t in card_p.detect(frames)]
    a = {k: v.float().cpu() for k, v in card_p.run(frames).items()}
    replay = iter([{k: v.cpu() for k, v in o.items() if k != "raw"} for o in outs])
    cpu_p.detector.model = lambda x: next(replay)
    det_b = list(cpu_p.detect(frames))
    b = {k: v.float().cpu() for k, v in cpu_p.run(frames).items()}
    assert all(torch.equal(x, y) for x, y in zip(det_a, det_b))  # boxes, scores, kept
    _same_outputs(a, b)
    # End to end, the detector in float32 on both sides.
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    res = {}
    for d in (card, "cpu"):
        m = RTMDet(**DETECTOR_REGISTRY["test_rtmdet_micro"]["cfg"], dtype=torch.float32, device=d)
        det = SinglePersonDetector(init_rtmdet_(m, torch.Generator().manual_seed(3)),
                                   select=select, device=d)
        p = build_pipeline(cfg, size, DET_SHAPE, device=d, seed=3, detector=det)
        res[d] = ({k: v.float().cpu() for k, v in p.run(frames).items()}, p.detect(frames)[0].cpu())
    torch.backends.cudnn.allow_tf32 = prev
    (a, ba), (b, bb) = res[card], res["cpu"]
    ok = ((ba - bb).abs() < 1e-2).all(-1).all(-1)
    assert ok.float().mean() >= 0.5
    _same_outputs({k: v[ok] for k, v in a.items()}, {k: v[ok] for k, v in b.items()})


def test_simcc_flip_pipeline_matches_cpu(card):
    from multi_camera_3d_pose_estimation_tpu_torch.entry import build_pipeline

    shape = (4, 2, 96, 80, 3)
    frames = torch.randint(0, 256, shape, generator=torch.Generator().manual_seed(6),
                           dtype=torch.uint8)
    cfg = {"widen": 0.125, "deepen": 0.167, "embed": 32}
    card_p, cpu_p = (build_pipeline(cfg, (64, 96), shape, device=d, seed=3, family="rtmpose",
                                    flip_test=True) for d in (card, "cpu"))
    outs = []
    _record(card_p.estimator, outs)
    a = {k: v.float().cpu() for k, v in card_p.run(frames).items()}
    replay = iter([tuple(t.cpu() for t in o) for o in outs])
    cpu_p.estimator.model = lambda x: next(replay)
    b = {k: v.float().cpu() for k, v in cpu_p.run(frames).items()}
    assert len(outs) == 2  # the direct and the mirrored pass
    # The same logits: every joint decoded alike, gated ones (NaN) included.
    xa, xb = a["kpts_2d"][:, :, :2], b["kpts_2d"][:, :, :2]
    agree = (((xa - xb).abs() < 1e-2) | (torch.isnan(xa) & torch.isnan(xb))).all(2)
    assert agree.float().mean() >= 0.95
    _same_outputs(a, b)


def test_full_width_detectors_draw_usable_boxes(card):
    """RTMDet-m and YOLOX-s at full width on the card, seeded random weights:
    every frame's top box finite and of positive size inside the frame."""
    from multi_camera_3d_pose_estimation_tpu_torch.models.registry import build_detector

    frames = torch.randint(0, 256, (16, 256, 256, 3), generator=torch.Generator().manual_seed(7),
                           dtype=torch.uint8)
    for name in ("rtmdet_m", "yolox_s", "centernet_w32"):
        boxes = build_detector(name, device=card, bbox_thr=0.0).detect(frames.to(card))
        assert torch.isfinite(boxes).all() and ((boxes[:, 2:] - boxes[:, :2]) > 0).all(), name


def test_stage_blocks_match_host_blocks(card):
    """`io.stage_blocks` through its pinned ring (depth 2: 3 buffers, so
    every buffer is refilled) over 7 blocks, the last zero-padded: each
    staged block equals its host block bit for bit, and the results of
    `cli.run_pipeline_on_blocks` on them equal `pipeline.run` on the host
    blocks in memory."""
    import numpy as np

    from multi_camera_3d_pose_estimation_tpu_torch.cli import run_pipeline_on_blocks
    from multi_camera_3d_pose_estimation_tpu_torch.entry import build_pipeline
    from multi_camera_3d_pose_estimation_tpu_torch.io import stage_blocks

    rng = np.random.default_rng(3)
    shape = (4, 2, 96, 80, 3)
    host = [(rng.integers(0, 256, shape, dtype=np.uint8), 4) for _ in range(6)]
    tail = np.zeros(shape, np.uint8)
    tail[:3] = rng.integers(0, 256, (3,) + shape[1:], dtype=np.uint8)
    host.append((tail, 3))
    events = []
    staged = [(b.cpu().numpy(), n) for b, n in stage_blocks(iter(host), card, copy_events=events)]
    assert len(events) == len(host) and all(e.query() for _, e in events)
    for (h, n), (s, m) in zip(host, staged):
        assert n == m and np.array_equal(h, s)
    cfg, size = TINY_HRNET
    pipe = build_pipeline(cfg, size, shape, device=card, seed=3)
    streamed = run_pipeline_on_blocks(pipe, stage_blocks(iter(host), card), progress=False)
    ref = [{k: v.cpu().numpy()[:n] for k, v in pipe.run(torch.as_tensor(h).to(card)).items()}
           for h, n in host]
    for key, out in zip(("kpts_2d", "heatmaps_2d", "kpts_3d"), streamed):
        want = np.concatenate([r[key] for r in ref])
        assert out.shape == want.shape and out.shape[0] == 27
        np.testing.assert_array_equal(out, want)


def test_npz_checkpoint_on_the_card(card, tmp_path):
    """The JAX-format `.npz` written from a CPU model loads into the card's
    model with the same weights, and the card's writer gives the same file."""
    from multi_camera_3d_pose_estimation_tpu_torch.models import convert, registry

    for name, family in (("test_tiny", "hrnet"), ("test_swin_128", "swin")):
        cpu = registry.build_estimator(name, device="cpu", seed=4).model
        path = str(tmp_path / f"{name}.npz")
        convert.save_checkpoint_npz(cpu, path, family)
        on_card = registry.build_estimator(name, checkpoint=path, device=card).model
        a, b = cpu.state_dict(), on_card.state_dict()
        assert all(b[k].is_cuda and torch.equal(a[k], b[k].cpu()) for k in a)
        again = str(tmp_path / f"{name}_card.npz")
        convert.save_checkpoint_npz(on_card, again, family)
        with open(path, "rb") as f, open(again, "rb") as g:
            assert f.read() == g.read()


def test_refine_cli_matches_cpu(card, tmp_path):
    """The refine CLI with --device cuda against --device cpu (float32) on a
    17-joint, 3-camera scene: the interpolation equal, the SGD trajectory
    within 1 unit (mm) MPJPE."""
    import numpy as np

    from multi_camera_3d_pose_estimation_tpu_torch import io as pio
    from multi_camera_3d_pose_estimation_tpu_torch.cli import refine

    gauss, init, cams = _refine_scene(J=17)
    for c, (K, R, Tv, dist) in cams.items():
        pio.save_camera_intrinsics(K, dist, f"cam{c}", root_path=str(tmp_path))
        pio.save_extrinsic_calibration_parameters(R, Tv, f"cam{c}", root_dir=str(tmp_path))
    pio.save_camera_names({c: f"cam{c}" for c in cams}, "cam0", str(tmp_path))
    np.save(tmp_path / "kpts_3d.npy", init.astype(np.float32))
    np.save(tmp_path / "heatmaps_2d.npy", gauss.astype(np.float32))
    out = {}
    for dev in ("cuda", "cpu"):
        (tmp_path / dev).mkdir()
        refine.main(["--run_path", str(tmp_path), "--save_path", str(tmp_path / dev),
                     "--refinement_types", "linear_interpolation", "SGD",
                     "--kpts_3d", str(tmp_path / "kpts_3d.npy"),
                     "--heatmaps_2d", str(tmp_path / "heatmaps_2d.npy"),
                     "--extrinsic_params_dir", str(tmp_path / "extrinsic_camera_parameters"),
                     "--intrinsic_params_dir", str(tmp_path / "intrinsic_camera_parameters"),
                     "--ignore_body_lengths", "--device", dev])
        out[dev] = [np.load(tmp_path / dev / f) for f in
                    ("kpts_3d_linear_interpolation.npy", "kpts_3d_SGD.npy")]
    np.testing.assert_array_equal(out["cuda"][0], out["cpu"][0])
    assert np.linalg.norm(out["cuda"][1] - out["cpu"][1], axis=-1).mean() < 1.0


def test_stage_blocks_stops_and_raises(card):
    """`io.stage_blocks`' producer thread: a consumer that stops after two
    blocks ends it (no thread left behind), and an exception raised by the
    host blocks reaches the consumer."""
    import threading

    import numpy as np

    from multi_camera_3d_pose_estimation_tpu_torch.io import stage_blocks

    block = np.arange(2 * 3 * 4 * 3, dtype=np.uint8).reshape(1, 2, 3, 4, 3)
    before = threading.active_count()
    gen = stage_blocks(((block + i, 1) for i in range(100)), card)
    got = [next(gen)[0].cpu().numpy() for _ in range(2)]
    gen.close()
    assert threading.active_count() == before
    assert np.array_equal(got[0], block) and np.array_equal(got[1], block + 1)

    def broken():
        yield block, 1
        raise OSError("decode failed")

    staged = stage_blocks(broken(), card)
    assert np.array_equal(next(staged)[0].cpu().numpy(), block)
    with pytest.raises(OSError, match="decode failed"):
        next(staged)


def test_pth_checkpoint_on_the_card(card, tmp_path):
    """A small HRNet ``.pth`` (the port's MMPose mirror, mmengine prefixes)
    built on the card with the stage-1 and decode kernels on (the JAX
    keyword ``use_pallas_stage1``) gives the same keypoints bit for bit as
    the ``.npz`` that ``convert --out`` writes from it, both kernels
    launched."""
    import numpy as np

    from multi_camera_3d_pose_estimation_tpu_torch.cli import convert as convert_cli
    from multi_camera_3d_pose_estimation_tpu_torch.models import registry
    from multi_camera_3d_pose_estimation_tpu_torch.models.mirrors.hrnet import (MMPoseHRNet,
                                                                               randomize_)

    mirror = MMPoseHRNet(registry.MODEL_REGISTRY["test_tiny"]["cfg"])
    randomize_(mirror, seed=3)
    pth, npz = str(tmp_path / "tiny.pth"), str(tmp_path / "tiny.npz")
    torch.save({"state_dict": {("keypoint_head." if k.startswith("final_layer") else "backbone.")
                               + k: v for k, v in mirror.state_dict().items()}}, pth)
    convert_cli.main([pth, "--model", "test_tiny", "--out", npz, "--verify"])
    frames = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (6, 96, 80, 3),
                                                                dtype=np.uint8)).to(card)
    out = {}
    for ckpt in (pth, npz):
        est = registry.build_estimator("test_tiny", checkpoint=ckpt, device=card,
                                       use_pallas_stage1=True, use_fused_decode=True)
        bn.fused_bottleneck_block.launches = fd.heatmap_decode_raw.launches = 0
        out[ckpt] = {k: v.cpu() for k, v in est.predict_batch(frames).items()}
        assert bn.fused_bottleneck_block.launches > 0 and fd.heatmap_decode_raw.launches == 1
    assert all(torch.equal(out[pth][k], out[npz][k]) for k in out[pth])

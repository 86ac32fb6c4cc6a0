#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root, one card

Phases (each synchronises the card; any failure exits non-zero):

1. the card's name and power limit (``nvidia-smi``);
2. build every CUDA kernel of the port from ``csrc/`` (one nvcc each, in
   parallel) and print the compiler's register/shared-memory report;
3. the full-width main path: HRNet-W32 at 192x256 input, 2 cameras, blocks
   of T=256 frames of 256x256 (512 crops), random weights from a seed.  One
   warm-up block, then the launch counts are set to 0, a few blocks run and
   the counts are read; frames/s and the output checks are printed;
4. each kernel against its plain PyTorch version on the card, on the inputs
   the main path gave it (the stem output of a block's crops for the
   Bottleneck chain, the block's heatmaps for the decode), with kernel,
   plain and library times (CUDA events) and the bound from this run's
   shapes;
5. the whole pipeline on the card against the plain CPU path (the one the
   CPU tests hold against the JAX package) at a small HRNet size;
6. the Swin-B main path at full width: input 192x256, 2 cameras, blocks of
   T=128 frames of 256x256 (256 crops), every SwinBlock through the
   swin_gemm and window-attention kernels, random weights from a seed.  One
   warm-up block, then the counts are set to 0, a few blocks run and the
   counts are read (96 swin_gemm, 24 window-attention and 1 decode launch
   per block); frames/s and the output checks are printed;
7. one SwinBlock of each stage against its plain version, on the inputs
   the main path gave it (captured by a forward pre-hook), and the window
   attention of each stage against its plain version, with kernel, plain
   and library (``scaled_dot_product_attention``) times and the bounds
   (from the map's real tokens: window padding needs no work); the
   attention again on the same qkv with a bias of trained scale, with
   controls showing that a wrong bias or mask fails its tolerance;
8. a small Swin pipeline on the card against the plain CPU path;
9. one JSON line with every kernel, the card's line, and the final
   ``{"ok": true, "device": {...}}`` line.

It imports nothing of JAX.  Without a CUDA device, or without the port
package beside it, it prints no result and exits 1.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
PORT = "multi_camera_3d_pose_estimation_tpu_torch"

# Hopper H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit).
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_S = 3.35e12

T, C, H, W = 256, 2, 256, 256
INPUT = (192, 256)  # (w, h)
N_BLOCKS = 3  # timed blocks of the main path
# The kernel and the plain version sum bf16 products in f32 in another order,
# so an output may round to the neighbouring bf16 value.  Each block, on the
# same input: at most 2 bf16 steps (2^-8) of its largest output, and under
# 0.1% of outputs more than one step (of their own binade) apart.  The whole
# chain, where such flips propagate through 4 blocks: 4 steps of its
# largest output.
BLOCK_REL_TOL, BLOCK_FLIP_SHARE, CHAIN_REL_TOL = 2 * 2.0 ** -8, 1e-3, 4 * 2.0 ** -8
DECODE_TOL = 1e-5  # f32 sums in another order, relative to |value| + 1
SWIN_T = 128  # frames per Swin-B block (256 crops), as the JAX bench's bench_swin
N_SWIN_BLOCKS = 3
# A SwinBlock is five launches; a bf16 rounding flip in qkv, the
# probabilities or the MLP hidden moves the block's output, and where the
# residual sum cancels, an output near zero is many steps of its own binade
# off while one step of its operands.  (Summation order alone, f64 against
# f32 accumulation with the same cast points on the CPU, puts 2e-4 to 3e-3
# of outputs more than one own-binade step apart and none more than one
# step of their token's largest value.)  Each block, on the same input: at
# most 4 bf16 steps (2^-8) of its largest output, and at most 1e-3 of
# outputs more than one bf16 step of their token's largest value apart.
# The attention core alone: 2 steps of its largest output.
SWIN_BLOCK_REL_TOL, SWIN_ROW_FLIP_SHARE, ATTN_REL_TOL = 4 * 2.0 ** -8, 1e-3, 2 * 2.0 ** -8


def log(*args):
    print(*args, flush=True)


def check(ok, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def cuda_ms(fn, n):
    """Mean ms per call of ``fn`` over ``n`` calls, timed with CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def bf16_steps_apart(a, ref):
    """Share of ``a`` more than one bf16 step of ``ref``'s binade from ``ref``."""
    import torch

    ref = ref.float()
    step = torch.ldexp(torch.ones_like(ref), torch.frexp(ref).exponent - 8)
    return ((a.float() - ref).abs() > step).float().mean().item()


def bf16_steps_apart_rows(a, ref):
    """Share of ``a`` more than one bf16 step of its row's largest |ref| from ``ref``."""
    import torch

    ref = ref.float()
    top = ref.abs().amax(-1, keepdim=True)
    step = torch.ldexp(torch.ones_like(top), torch.frexp(top).exponent - 8)
    return ((a.float() - ref).abs() > step).float().mean().item()


def chain_library(x, blocks):
    """The same folded stage-1 chain through cuDNN convolutions (bf16,
    channels_last): a yardstick only, the port never calls it."""
    import torch
    import torch.nn.functional as F

    def conv(inp, w, b, k):  # w in the kernel's layout (cout, k*k*cin)
        wk = w.view(w.shape[0], k, k, -1).permute(0, 3, 1, 2)
        return F.conv2d(inp, wk.contiguous(memory_format=torch.channels_last),
                        b.to(inp.dtype), padding=k // 2)

    y = x.permute(0, 3, 1, 2)
    for p in blocks:
        y1 = torch.relu(conv(y, p["w1"], p["b1"], 1))
        y2 = torch.relu(conv(y1, p["w2"], p["b2"], 3))
        res = conv(y, p["wd"], p["bd"], 1) if "wd" in p else y
        y = torch.relu(conv(y2, p["w3"], p["b3"], 1) + res)
    return y


def chain_bound(x, blocks, out):
    """Least time of the chain: bytes of x, weights and output once, and its
    bf16 tensor-core operations, over the card's peaks."""
    B, Hh, Ww, _ = x.shape
    flops = 0
    nbytes = x.numel() * x.element_size() + out.numel() * out.element_size()
    for p in blocks:
        for key in ("w1", "w2", "w3", "wd"):
            if key in p:
                flops += 2 * B * Hh * Ww * p[key].numel()
                nbytes += p[key].numel() * p[key].element_size()
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes"), flops, nbytes

SMALL = {  # (config, input (w, h)) of the small card-vs-CPU pipelines
    "hrnet": ({"widths": (8, 16, 32, 64), "modules": (1, 1, 1, 1), "stem": 16}, (32, 64)),
    "swin": ({"embed": 64, "depths": (2, 2), "heads": (2, 4), "window": 7, "mlp_ratio": 4,
              "deconv": (32,)}, (64, 96)),
}


def check_small_pipeline(gen, family: str) -> None:
    """The whole pipeline on the card against the plain CPU path (the one the
    CPU tests hold against the JAX package), at a small size."""
    import torch
    from multi_camera_3d_pose_estimation_tpu_torch.entry import build_pipeline

    cfg, input_size = SMALL[family]
    shape = (4, 2, 96, 80, 3)
    small = torch.randint(0, 256, shape, generator=gen, dtype=torch.uint8)
    res = {}
    for device in ("cuda", "cpu"):
        p = build_pipeline(cfg, input_size, shape, device=device, seed=3, family=family)
        res[device] = {k: v.float().cpu() for k, v in p.run(small).items()}
    a, b = res["cuda"], res["cpu"]
    same = ((a["kpts_2d"][:, :, :2] - b["kpts_2d"][:, :, :2]).abs() < 1e-2).all(2).all(-1)
    both = same & torch.isfinite(a["kpts_3d"]).all(-1) & torch.isfinite(b["kpts_3d"]).all(-1)
    d3 = (a["kpts_3d"][both] - b["kpts_3d"][both]).abs()
    tol3 = 1e-2 + 1e-3 * b["kpts_3d"][both].abs()
    log(f"small {family} pipeline, card vs CPU plain: {same.float().mean().item():.3f} of joints "
        f"with the same peaks, {int(both.sum())} triangulated on both, max |d kpts_3d| "
        f"{d3.max().item() if d3.numel() else 0.0:.4g}")
    check(same.float().mean() >= 0.5 and both.sum() >= 5 and bool((d3 <= tol3).all()),
          f"the {family} pipeline on the card agrees with the plain CPU path")


def check_outputs(out, pipe, T_: int) -> None:
    """Shapes, finite Gaussians, and NaN kpts_3d exactly where a view was gated."""
    import torch

    k2d, g2d, k3d = out["kpts_2d"], out["heatmaps_2d"], out["kpts_3d"]
    check(k2d.shape == (T_, 17, 3, C) and g2d.shape == (T_, C, 17, 6)
          and k3d.shape == (T_, 17, 3), "output shapes")
    check(bool(torch.isfinite(g2d).all() and torch.isfinite(k2d[:, :, 2]).all()),
          "Gaussians and confidences are finite")
    conf_ok = (k2d[:, :, 2] > pipe.conf_threshold).all(-1)  # both views pass the gate
    finite3d = torch.isfinite(k3d).all(-1)
    check(torch.equal(finite3d, conf_ok), "kpts_3d is NaN exactly where a view was gated")
    log(f"outputs: shapes ok, Gaussians finite, {finite3d.float().mean().item():.3f} of joints "
        "triangulated (random weights; the rest gated at conf 0.3)")


def run_swin_main_path(dev, gen) -> dict:
    """Swin-B at full width through `build_pipeline(family="swin")`: a warm-up
    block, then N_SWIN_BLOCKS counted and timed blocks."""
    import torch
    from multi_camera_3d_pose_estimation_tpu_torch.entry import build_pipeline
    from multi_camera_3d_pose_estimation_tpu_torch.models.swin import SWIN_B
    from multi_camera_3d_pose_estimation_tpu_torch.ops import fused_decode as fd
    from multi_camera_3d_pose_estimation_tpu_torch.ops import swin_block as sb
    from multi_camera_3d_pose_estimation_tpu_torch.ops import window_attention as wa

    t0 = time.perf_counter()
    pipe = build_pipeline(SWIN_B, INPUT, (SWIN_T, C, H, W, 3), device=dev, seed=0,
                          family="swin")
    blocks_u8 = [torch.randint(0, 256, (SWIN_T, C, H, W, 3), generator=gen,
                               dtype=torch.uint8).to(dev) for _ in range(2)]
    torch.cuda.synchronize()
    log(f"Swin-B pipeline built in {time.perf_counter() - t0:.1f} s")
    out = pipe.run(blocks_u8[0])  # warm-up
    torch.cuda.synchronize()
    counters = {"swin_gemm": sb.swin_gemm, "window_attention": wa.window_attention,
                "heatmap_decode": fd.heatmap_decode_raw}
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    for i in range(N_SWIN_BLOCKS):
        out = pipe.run(blocks_u8[i % 2])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    fps = SWIN_T * N_SWIN_BLOCKS / dt
    log(f"Swin-B main path: {N_SWIN_BLOCKS} blocks of ({SWIN_T}, {C}, {H}, {W}, 3) in "
        f"{dt:.3f} s -> {fps:.1f} multi-camera frames/s; launches {launches}")
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched on the Swin main path")
    n_blocks = sum(SWIN_B["depths"])
    check(launches == {"swin_gemm": 4 * n_blocks * N_SWIN_BLOCKS,
                       "window_attention": n_blocks * N_SWIN_BLOCKS,
                       "heatmap_decode": N_SWIN_BLOCKS},
          "96 swin_gemm, 24 window-attention and 1 decode launch per block")
    check_outputs(out, pipe, SWIN_T)
    return {"pipe": pipe, "frames": blocks_u8[0], "fps": fps, "launches": launches}


def block_bound(real: int, p: dict, heads: int, n: int, C_: int):
    """Least time of one SwinBlock whose map holds ``real`` tokens: its bf16
    tensor-core operations against one read of the real tokens, weights and
    tables and one write of the real outputs.  Window padding needs no work:
    pad rows enter qkv as zeros (their k/v are the bias, which the
    attention reads as keys) and their other products are zeroed or cropped
    off, so the four products count real rows, and the attention n keys
    for each real query."""
    flops = 2 * real * sum(p[k].numel() for k in ("wqkv", "wproj", "wfc1", "wfc2"))
    flops += 4 * real * n * C_
    nbytes = 2 * real * C_ * 2 + sum(t.numel() * t.element_size() for v in p.values()
                                     for t in (v if isinstance(v, tuple) else (v,)))
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def attention_bound(qkv, bias, mask, heads: int, real: int):
    """Least time of the attention core on a map of ``real`` tokens: the
    real queries and every window token's k and v read once, bias and mask
    read once, the real tokens' ctx written once, against the bf16
    tensor-core operations of n keys for each real query."""
    Bw, n, C3 = qkv.shape
    C_ = C3 // 3
    flops = 4 * real * n * C_
    nbytes = (real * C_ * 2 + Bw * n * 2 * C_ * 2 + real * C_ * 2
              + bias.numel() * bias.element_size() + (mask.numel() * 4 if mask is not None else 0))
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def sdpa_library(qkv, bias, mask, heads: int):
    """``F.scaled_dot_product_attention`` on the same q, k, v with the bias
    and shift mask as one additive bf16 mask: a yardstick only, the port
    never calls it.  Returns (fn, its mask tensor)."""
    import torch
    import torch.nn.functional as F

    Bw, n, C3 = qkv.shape
    q, k, v = qkv.view(Bw, n, 3, heads, C3 // 3 // heads).permute(2, 0, 3, 1, 4).unbind(0)
    add = bias[None].expand(Bw, -1, -1, -1)
    if mask is not None:
        nW = mask.shape[0]
        add = (bias[None, None] + mask[None, :, None]).expand(Bw // nW, -1, -1, -1, -1)
        add = add.reshape(Bw, heads, n, n)
    add = add.to(qkv.dtype).contiguous()
    return (lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=add)), add


def check_swin_kernels(swin: dict, dev) -> list:
    """One SwinBlock of each stage (the first shifted one: window-order
    tokens in) and its attention core, kernel against plain, on the inputs
    the main path gave them."""
    import torch
    from multi_camera_3d_pose_estimation_tpu_torch.models.topdown import preprocess_crops
    from multi_camera_3d_pose_estimation_tpu_torch.ops import swin_block as sb
    from multi_camera_3d_pose_estimation_tpu_torch.ops import window_attention as wa

    pipe = swin["pipe"]
    model = pipe.estimator.model
    cfg = model.cfg
    frames = swin["frames"].reshape(SWIN_T * C, H, W, 3).to(torch.bfloat16) / 255.0
    boxes = torch.tensor([0.0, 0.0, W, H], device=dev).expand(SWIN_T * C, 4)
    captured, hooks = {}, []
    bias_gen = torch.Generator().manual_seed(7)

    def capture(i):
        def hook(module, args, kwargs):  # returns None: the call goes on unchanged
            captured.setdefault(i, (args[0], dict(kwargs)))
        return hook

    for i in range(len(cfg["depths"])):
        blk = getattr(model.backbone, f"stage_{i}_block_1")
        hooks.append(blk.register_forward_pre_hook(capture(i), with_kwargs=True))
    with torch.inference_mode():
        crops, _, _ = preprocess_crops(frames, boxes, INPUT)
        model(crops)
        torch.cuda.synchronize()
        for h in hooks:
            h.remove()
        stages, attn_stages = [], []
        for i, depth in enumerate(cfg["depths"]):
            blk = getattr(model.backbone, f"stage_{i}_block_1")
            x, kw = captured[i]
            p = blk.prepared()
            args = dict(heads=blk.heads, window=blk.window, shift=blk.shift,
                        mlp_ratio=blk.mlp_ratio, pre_partitioned=kw.get("pre_part"),
                        emit_partitioned=kw.get("emit_part", False))
            kern = sb.fused_swin_block(x, p, **args)
            plain = sb.swin_block_plain(x, p, **args)
            torch.cuda.synchronize()
            err = (kern.float() - plain.float()).abs().max().item()
            scale = plain.float().abs().max().item()
            share = bf16_steps_apart(kern, plain)
            row_share = bf16_steps_apart_rows(kern, plain)
            C_ = kern.shape[-1]
            B_, Hc, Wc = args["pre_partitioned"]
            n, real = blk.window ** 2, B_ * Hc * Wc
            bound, by = block_bound(real, p, blk.heads, n, C_)
            t = {"ms": cuda_ms(lambda: sb.fused_swin_block(x, p, **args), 10),
                 "plain_ms": cuda_ms(lambda: sb.swin_block_plain(x, p, **args), 2)}
            log(f"Swin stage {i} block 1 (x{depth}) tokens {tuple(x.shape)} ({real} real), "
                f"map {Hc}x{Wc}: "
                f"max |kernel - plain| {err:.6g} (tolerance {SWIN_BLOCK_REL_TOL} x {scale:.4g}), "
                f"share > 1 bf16 step of the token's largest {row_share:.3g} (tolerance "
                f"{SWIN_ROW_FLIP_SHARE}), of their own binade {share:.3g}; kernel "
                f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms; bound {bound:.4f} ms by {by}")
            check(err <= SWIN_BLOCK_REL_TOL * scale and row_share <= SWIN_ROW_FLIP_SHARE,
                  f"Swin stage {i}: the block kernels agree with their plain version")
            stages.append(dict(t, depth=depth, err=err, bound=bound, by=by))

            # The attention core on this block's own qkv.
            valid, mask = sb.block_tables(Hc, Wc, blk.window, blk.shift, dev)
            qkv = sb.swin_gemm("qkv", x, p["wqkv"], p["bqkv"], ln=p["norm1"],
                               valid=valid).view(-1, n, 3 * C_)
            ka = wa.window_attention(qkv, p["bias"], mask, blk.heads)
            pa = wa.window_attention_plain(qkv, p["bias"], mask, blk.heads)
            lib, add = sdpa_library(qkv, p["bias"], mask, blk.heads)
            la = lib().transpose(1, 2).reshape(ka.shape)
            torch.cuda.synchronize()
            aerr = (ka.float() - pa.float()).abs().max().item()
            ascale = pa.float().abs().max().item()
            lerr = (la.float() - pa.float()).abs().max().item()
            abound, aby = attention_bound(qkv, p["bias"], mask, blk.heads, real)
            ta = {"ms": cuda_ms(lambda: wa.window_attention(qkv, p["bias"], mask, blk.heads), 20),
                  "plain_ms": cuda_ms(lambda: wa.window_attention_plain(qkv, p["bias"], mask,
                                                                        blk.heads), 3),
                  "library_ms": cuda_ms(lib, 20)}
            log(f"  attention qkv {tuple(qkv.shape)} heads {blk.heads}: max |kernel - plain| "
                f"{aerr:.6g} (tolerance {ATTN_REL_TOL} x {ascale:.4g}), share > 1 bf16 step "
                f"{bf16_steps_apart(ka, pa):.3g}; SDPA yardstick max |SDPA - plain| {lerr:.6g}; "
                f"kernel {ta['ms']:.4f} ms, plain {ta['plain_ms']:.4f} ms, SDPA "
                f"{ta['library_ms']:.4f} ms; bound {abound:.4f} ms by {aby}")
            check(aerr <= ATTN_REL_TOL * ascale,
                  f"Swin stage {i}: the window attention kernel agrees with its plain version")
            # The random table (N(0, 0.02^2)) moves ctx by about 1e-3, under
            # that tolerance, so the same qkv again with a bias of trained
            # scale, N(0, 1): controls show that plain with no bias, with the
            # next head's bias or (shifted) with no mask fails the tolerance.
            strong = torch.randn(p["bias"].shape, generator=bias_gen).to(dev)
            kb = wa.window_attention(qkv, strong, mask, blk.heads)
            pb = wa.window_attention_plain(qkv, strong, mask, blk.heads)
            controls = {"no bias": (torch.zeros_like(strong), mask),
                        "the next head's bias": (strong.roll(1, 0), mask)}
            if mask is not None:
                controls["no mask"] = (strong, None)
            torch.cuda.synchronize()
            berr = (kb.float() - pb.float()).abs().max().item()
            bscale = pb.float().abs().max().item()
            cerr = {k: (wa.window_attention_plain(qkv, b_, m_, blk.heads).float()
                        - pb.float()).abs().max().item() for k, (b_, m_) in controls.items()}
            log(f"  with an N(0, 1) bias: max |kernel - plain| {berr:.6g} (tolerance "
                f"{ATTN_REL_TOL} x {bscale:.4g}); plain controls off by "
                + ", ".join(f"{k} {v:.4g}" for k, v in cerr.items()))
            check(berr <= ATTN_REL_TOL * bscale,
                  f"Swin stage {i}: the window attention kernel agrees with a trained-scale bias")
            check(all(v > ATTN_REL_TOL * bscale for v in cerr.values()),
                  f"Swin stage {i}: a wrong bias or mask fails the attention tolerance")
            attn_stages.append(dict(ta, depth=depth, err=aerr, bias_err=berr, bound=abound,
                                    by=aby))
            del add

    def total(rows, key):
        return sum(r["depth"] * r[key] for r in rows)

    def by(rows):
        return "operations" if all(r["by"] == "operations" for r in rows) else (
            "bytes" if all(r["by"] == "bytes" for r in rows) else "mixed")

    here = "multi_camera_3d_pose_estimation_tpu/ops/pallas"
    launches = swin["launches"]
    log("Swin totals per forward (sum over stages of depth x one block): blocks kernel "
        f"{total(stages, 'ms'):.4f} ms, bound {total(stages, 'bound'):.4f} ms; attention kernel "
        f"{total(attn_stages, 'ms'):.4f} ms, SDPA {total(attn_stages, 'library_ms'):.4f} ms, "
        f"bound {total(attn_stages, 'bound'):.4f} ms")
    return [
        {"name": "swin_block", "route": "cuda",
         "source": f"{PORT}/csrc/swin_gemm.cu + {PORT}/csrc/window_attention.cu",
         "replaces": f"{here}/swin_block.py:704 (fused_swin_block, pallas_call :833)",
         "launches": launches["swin_gemm"] + launches["window_attention"],
         "max_abs_err": max(r["err"] for r in stages),
         "ms": total(stages, "ms"), "plain_ms": total(stages, "plain_ms"),
         "bound_ms": total(stages, "bound"), "bound_by": by(stages), "library_ms": None,
         "per_forward": f"{sum(cfg['depths'])} blocks: sum over stages of depth x one block "
                        "of the main path"},
        {"name": "window_attention", "route": "cuda",
         "source": f"{PORT}/csrc/window_attention.cu",
         "replaces": f"{here}/window_attention.py:76 (fused_window_attention, pallas_call "
                     f":115); {here}/window_attention.py:189 (packed_window_attention, "
                     f"pallas_call :282)",
         "launches": launches["window_attention"],
         "max_abs_err": max(r["err"] for r in attn_stages),
         "ms": total(attn_stages, "ms"), "plain_ms": total(attn_stages, "plain_ms"),
         "bound_ms": total(attn_stages, "bound"), "bound_by": by(attn_stages),
         "library_ms": total(attn_stages, "library_ms"),
         "max_abs_err_trained_bias": max(r["bias_err"] for r in attn_stages),
         "per_forward": f"{sum(cfg['depths'])} launches: sum over stages of depth x one "
                        "launch of the main path"},
    ]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(ROOT, PORT)):
        print(f"chip_smoke: the {PORT} package is not beside this script", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from multi_camera_3d_pose_estimation_tpu_torch import _native
    from multi_camera_3d_pose_estimation_tpu_torch.entry import build_pipeline
    from multi_camera_3d_pose_estimation_tpu_torch.models.hrnet import HRNET_W32
    from multi_camera_3d_pose_estimation_tpu_torch.models.topdown import preprocess_crops
    from multi_camera_3d_pose_estimation_tpu_torch.ops import bottleneck as bn
    from multi_camera_3d_pose_estimation_tpu_torch.ops import fused_decode as fd

    dev = torch.device("cuda")
    # 1. The card.
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    # 2. Build every kernel.
    t0 = time.perf_counter()
    reports = _native.build_all()
    log(f"built {list(reports)} in {time.perf_counter() - t0:.1f} s")
    for name, text in reports.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    # 3. The main path at full width.
    t0 = time.perf_counter()
    pipe = build_pipeline(HRNET_W32, INPUT, (T, C, H, W, 3), device="cuda", seed=0)
    gen = torch.Generator().manual_seed(1)
    blocks_u8 = [torch.randint(0, 256, (T, C, H, W, 3), generator=gen, dtype=torch.uint8).to(dev)
                 for _ in range(2)]
    torch.cuda.synchronize()
    log(f"pipeline built in {time.perf_counter() - t0:.1f} s")
    out = pipe.run(blocks_u8[0])  # warm-up
    torch.cuda.synchronize()
    counters = {"bottleneck": bn.fused_bottleneck_block, "heatmap_decode": fd.heatmap_decode_raw}
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    for i in range(N_BLOCKS):
        out = pipe.run(blocks_u8[i % 2])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    fps = T * N_BLOCKS / dt
    log(f"main path: {N_BLOCKS} blocks of ({T}, {C}, {H}, {W}, 3) in {dt:.3f} s -> "
        f"{fps:.1f} multi-camera frames/s; launches {launches}")
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched on the main path")
    check(launches == {"bottleneck": 4 * N_BLOCKS, "heatmap_decode": N_BLOCKS},
          "4 Bottleneck launches and 1 decode launch per block")
    check_outputs(out, pipe, T)

    # 4. Each kernel against its plain version, on the main path's inputs.
    est = pipe.estimator
    model, blocks = est.model, est.fused_stage1.blocks
    frames = blocks_u8[0].reshape(T * C, H, W, 3).to(torch.bfloat16) / 255.0
    boxes = torch.tensor([0.0, 0.0, W, H], device=dev).expand(T * C, 4)
    with torch.inference_mode():
        crops, _, _ = preprocess_crops(frames, boxes, INPUT)
        stem = model.ConvBN_1(model.ConvBN_0(crops.permute(0, 3, 1, 2)))
        x = stem.permute(0, 2, 3, 1).contiguous()  # (512, 64, 48, 64) NHWC bf16
        heat = model(crops.permute(0, 3, 1, 2), fused_stage1=est.fused_stage1)
        torch.cuda.synchronize()

        xs = [x]  # each block's input on the plain path
        for p in blocks:
            xs.append(bn.bottleneck_block_plain(xs[-1], p))
        for i, p in enumerate(blocks):
            kb = bn.fused_bottleneck_block(xs[i], p)
            torch.cuda.synchronize()
            berr = (kb.float() - xs[i + 1].float()).abs().max().item()
            bscale = xs[i + 1].float().abs().max().item()
            share = bf16_steps_apart(kb, xs[i + 1])
            log(f"block {i} {tuple(xs[i].shape)}: max |kernel - plain| {berr:.6g} (tolerance "
                f"{BLOCK_REL_TOL} x {bscale:.4g}), share > 1 bf16 step {share:.3g} "
                f"(tolerance {BLOCK_FLIP_SHARE})")
            check(berr <= BLOCK_REL_TOL * bscale and share <= BLOCK_FLIP_SHARE,
                  f"Bottleneck block {i}: the kernel agrees with its plain version")
        kern = bn.fused_stage1_chain(x, blocks)
        plain = xs[-1]
        lib = chain_library(x, blocks).permute(0, 2, 3, 1)
        torch.cuda.synchronize()
        err = (kern.float() - plain.float()).abs().max().item()
        scale = plain.float().abs().max().item()
        lib_err = (lib.float() - plain.float()).abs().max().item()
        log(f"stage-1 chain {tuple(x.shape)} -> {tuple(kern.shape)}: max |kernel - plain| "
            f"{err:.6g} (tolerance {CHAIN_REL_TOL} x {scale:.4g}), share > 1 bf16 step "
            f"{bf16_steps_apart(kern, plain):.3g}; cuDNN yardstick: max |cuDNN - plain| "
            f"{lib_err:.6g}, share {bf16_steps_apart(lib, plain):.3g}")
        check(err <= CHAIN_REL_TOL * scale, "the Bottleneck chain agrees with its plain version")
        chain = {"ms": cuda_ms(lambda: bn.fused_stage1_chain(x, blocks), 10),
                 "plain_ms": cuda_ms(lambda: bn.stage1_chain_plain(x, blocks), 3),
                 "library_ms": cuda_ms(lambda: chain_library(x, blocks), 10)}
        bound_ms, bound_by, flops, nbytes = chain_bound(x, blocks, kern)
        log(f"  kernel {chain['ms']:.4f} ms, plain {chain['plain_ms']:.4f} ms, cuDNN "
            f"{chain['library_ms']:.4f} ms; bound {bound_ms:.4f} ms by {bound_by} "
            f"({flops / 1e12:.4f} TFLOP, {nbytes / 1e9:.4f} GB)")
        # One launch alone (fused_bottleneck_block): an identity block, 256 -> 256.
        one = {"ms": cuda_ms(lambda: bn.fused_bottleneck_block(xs[1], blocks[1]), 20),
               "plain_ms": cuda_ms(lambda: bn.bottleneck_block_plain(xs[1], blocks[1]), 3),
               "library_ms": cuda_ms(lambda: chain_library(xs[1], blocks[1:2]), 20)}
        one_bound, one_by, _, _ = chain_bound(xs[1], blocks[1:2], xs[2])
        log(f"one block {tuple(xs[1].shape)}: kernel {one['ms']:.4f} ms, plain "
            f"{one['plain_ms']:.4f} ms, cuDNN {one['library_ms']:.4f} ms; bound "
            f"{one_bound:.4f} ms by {one_by}")

        flat = heat.reshape(-1, heat.shape[-2] * heat.shape[-1]).contiguous()
        hw = heat.shape[-1]
        kd = fd.heatmap_decode_raw(flat, hw, est.heatmap_threshold)
        pd = fd.heatmap_decode_raw_plain(flat, hw, est.heatmap_threshold)
        torch.cuda.synchronize()
        derr = ((kd - pd).abs() / (pd.abs() + 1)).max().item()
        # Error of what the decode returns: moments and xy in heatmap px, score.
        dec_err = max((a - b).abs().max().item() for a, b in
                      zip(fd.finish_decode(kd, hw), fd.finish_decode(pd, hw)))
        argmax_same = torch.equal(kd[:, 7], pd[:, 7]) and torch.equal(kd[:, 6], pd[:, 6])
        log(f"decode {tuple(flat.shape)}: raw sums max |kernel - plain| / (|plain| + 1) "
            f"{derr:.3g} (tolerance {DECODE_TOL}); peak and argmax identical: {argmax_same}; "
            f"decoded moments/xy/score max |kernel - plain| {dec_err:.3g}")
        check(derr <= DECODE_TOL and argmax_same, "the decode kernel agrees with its plain version")
        dec = {"ms": cuda_ms(lambda: fd.heatmap_decode_raw(flat, hw, est.heatmap_threshold), 50),
               "plain_ms": cuda_ms(lambda: fd.heatmap_decode_raw_plain(flat, hw,
                                                                       est.heatmap_threshold), 20)}
        dec_bytes = flat.numel() * 4 + kd.numel() * 4
        dec_bound = dec_bytes / PEAK_BYTES_S * 1e3
        log(f"  kernel {dec['ms']:.4f} ms, plain {dec['plain_ms']:.4f} ms; bound "
            f"{dec_bound:.4f} ms by bytes ({dec_bytes / 1e6:.2f} MB)")

    # 5. The pipeline on the card against the plain CPU path, small size.
    check_small_pipeline(gen, family="hrnet")

    # 6. The Swin-B main path at full width.
    swin = run_swin_main_path(dev, gen)
    # 7. One SwinBlock of each stage and its attention against the plain versions.
    swin_rows = check_swin_kernels(swin, dev)
    # 8. A small Swin pipeline on the card against the plain CPU path.
    check_small_pipeline(gen, family="swin")

    # 9. Results.
    here = "multi_camera_3d_pose_estimation_tpu/ops/pallas"
    kernels = [
        {"name": "stage1_bottleneck_chain", "route": "cuda", "source": f"{PORT}/csrc/bottleneck.cu",
         "replaces": f"{here}/bottleneck.py:299 (fused_stage1_chain, 4 launches); "
                     f"{here}/bottleneck.py:150 (fused_bottleneck_block, 1 launch)",
         "launches": launches["bottleneck"], "max_abs_err": err, "ms": chain["ms"],
         "plain_ms": chain["plain_ms"], "bound_ms": bound_ms, "bound_by": bound_by,
         "library_ms": chain["library_ms"]},
        {"name": "heatmap_decode", "route": "cuda", "source": f"{PORT}/csrc/fused_decode.cu",
         "replaces": f"{here}/fused_decode.py:104 (fused_heatmap_decode)",
         "launches": launches["heatmap_decode"],
         "max_abs_err": dec_err, "ms": dec["ms"],
         "plain_ms": dec["plain_ms"], "bound_ms": dec_bound, "bound_by": "bytes",
         "library_ms": None},
    ]
    kernels += swin_rows
    print(json.dumps({"kernels": kernels, "frames_per_s": fps,
                      "swin_frames_per_s": swin["fps"]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

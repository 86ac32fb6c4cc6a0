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
   shapes; the chain also beside the bytes bound of four launches, and
   block 0 and an identity block each alone beside its own bound, with
   every timed kernel's share of its bound;
5. the whole pipeline on the card against the plain CPU path (the one the
   CPU tests hold against the JAX package) at a small HRNet size;
6. the Swin-B main path at full width: input 192x256, 2 cameras, blocks of
   T=128 frames of 256x256 (256 crops), every SwinBlock through the
   swin_gemm and window-attention kernels, random weights from a seed.  One
   warm-up block, then the counts are set to 0, a few blocks run and the
   counts are read (96 swin_gemm product launches, 48 of them after a
   LayerNorm row-kernel launch, 24 window-attention and 1 decode launch
   per block); frames/s and the output checks are printed;
7. one SwinBlock of each stage against its plain version, on the inputs
   the main path gave it (captured by a forward pre-hook); each of its four
   token products (qkv, proj, fc1, fc2) on that block's own operands
   against `swin_gemm_plain`, with kernel and cuBLAS product times, the
   host's time per call and the bound over the real rows; and the window
   attention of each stage against its plain version, with kernel, plain
   and library (``scaled_dot_product_attention``) times, the host's time
   per call and the bounds (from the map's real tokens: window padding
   needs no work) with the kernel's share of its bound; the
   attention again on the same qkv with a bias of trained scale, with
   controls showing that a wrong bias or mask fails its tolerance;
8. a small Swin pipeline on the card against the plain CPU path;
9. the Swin-B main path again with ``MC3D_SWIN_FIXED=1``: every stage in
   fixed order (tokens in shift-0 window order for the whole stage, each
   shifted block's attention reading its windows through a row table).  A
   warm-up block, then the counts are set to 0, a few blocks run and the
   counts are read (96 swin_gemm and 48 LayerNorm row-kernel launches, 24
   row-mode attention, 0 chained-layout attention and 1 decode launch per
   block); spies show that every stage
   ran `fused_swin_stage_fixed` and the chained `fused_swin_block` never;
10. the first shifted fixed-order block of each stage (captured on the main
   path) against its plain version and against the chained
   `fused_swin_block` on the same map, its four token products as in 7,
   its row-mode attention against its plain version (again with an
   N(0, 1) bias, with controls: the identity
   row table, no mask, the next head's bias), and each whole stage against
   its plain version and against its blocks one by one, with kernel,
   plain, chained and SDPA times and the bounds (the row-mode and
   chained-layout attention timed in turns, with the host's time per call
   and the share of the bound);
11. a small fixed-order Swin pipeline on the card against the plain CPU path;
12. the n-view + flip-TTA path at full width: HRNet-W32 at 192x256 input, 4
   cameras, blocks of T=128 frames of 256x256 (512 crops, each through the
   model twice), robust n-view triangulation.  A warm-up block, then the
   counts are set to 0, a few blocks run and the counts are read (8
   Bottleneck launches, two stage-1 passes, and 1 decode launch per
   block); frames/s and the output checks are printed;
13. small pipelines on the card against the plain CPU path: n-view with
   flip-TTA on the fused decode (4 cameras), end to end and on the card's
   own heatmaps replayed into the CPU path, and flip-TTA with the DARK
   decode (unfused) on the card's own heatmaps;
14. the refinement: `bench.py::bench_refinement`'s scene (400 frames x 17
   joints x 4 cameras) in float32, 100 warm-up epochs then 2000 timed
   (epochs/s), the device's busy share over a profiler window, float64
   runs card against CPU (one window, then 7 overlapping windows) and the
   `ExtrinsicRefiner` on 3 of the cameras card against CPU;
15. the detector path at full width: HRNet-W32 at 192x256 behind RTMDet-m
   (``rtmdet_m``, top-1 selection) on the headline block (T=256 x C=2 of
   256x256, 512 crops), random weights from a seed.  A warm-up block, then
   the counts are set to 0, a few blocks run and the counts are read (4
   Bottleneck and 1 decode launch per block); frames/s, the full-frame
   frames/s of the same pipeline (boxes given) and the detector's cost
   ``1 - det/full``, the share of frames whose box was kept (each kept box
   finite, inside the frame, of positive size) and the output checks;
16. one timed block each behind ``centernet_w32`` (top-1) and ``yolox_s``
   (consistent selection: top-4 candidates, a 9-frame window): launch
   counts, frames/s, kept boxes and the output checks;
17. the SimCC path at full width: RTMPose-t (``coco_rtmpose-t``) at 192x256
   on T=256 x C=2, a few timed blocks: 0 Bottleneck and 0 decode launches,
   frames/s, the share of joints passing the 0.3 gate, the output checks;
18. small pipelines on the card against the plain CPU path: the detector
   path with top-1 and with consistent selection, the CPU path also on the
   card's own detector outputs replayed (boxes and scores equal), and end
   to end with the detector in float32 where both sides kept the same box;
   RTMPose with flip-TTA on the card's own SimCC logits replayed;
19. one JSON line with every kernel (with its launches on phases 15-17), the
   script's wall time, the card's line, and the final
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
from functools import partial

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
# The attention core alone: 2 steps of its largest output.  A whole stage
# of depth blocks, where each block's flips carry into the next: depth x 4
# steps of its largest output.
SWIN_BLOCK_REL_TOL, SWIN_ROW_FLIP_SHARE, ATTN_REL_TOL = 4 * 2.0 ** -8, 1e-3, 2 * 2.0 ** -8
# One token product alone (swin_gemm, one launch): 2 bf16 steps of its
# largest output, as the attention core.
PRODUCT_REL_TOL = 2 * 2.0 ** -8
PRODUCTS = ("qkv", "proj", "fc1", "fc2")  # a block's swin_gemm calls, in order


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


def host_ms(fn, n=20):
    """Mean host ms per call of ``fn`` over ``n`` calls after a synchronise:
    the wrapper and its launch, while the card runs the calls before."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    return (time.perf_counter() - t0) / n * 1e3


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
    "rtmpose": ({"widen": 0.125, "deepen": 0.167, "embed": 32}, (64, 96)),
}


def compare_small(a: dict, b: dict, what: str) -> None:
    """Card outputs ``a`` against CPU outputs ``b``: at least half the joints
    with the same decoded peaks (kpts_2d within 1e-2 px in every view), at
    least 5 of them triangulated on both, and their kpts_3d within
    1e-2 + 1e-3·|x|."""
    import torch

    same = ((a["kpts_2d"][:, :, :2] - b["kpts_2d"][:, :, :2]).abs() < 1e-2).all(2).all(-1)
    both = same & torch.isfinite(a["kpts_3d"]).all(-1) & torch.isfinite(b["kpts_3d"]).all(-1)
    d3 = (a["kpts_3d"][both] - b["kpts_3d"][both]).abs()
    tol3 = 1e-2 + 1e-3 * b["kpts_3d"][both].abs()
    log(f"{what}, card vs CPU plain: {same.float().mean().item():.3f} of joints "
        f"with the same peaks, {int(both.sum())} triangulated on both, max |d kpts_3d| "
        f"{d3.max().item() if d3.numel() else 0.0:.4g}")
    check(same.float().mean() >= 0.5 and both.sum() >= 5 and bool((d3 <= tol3).all()),
          f"{what} on the card agrees with the plain CPU path")


def check_small_pipeline(gen, family: str, label: str = "", cams: int = 2, **build_kw) -> None:
    """The whole pipeline on the card against the plain CPU path (the one the
    CPU tests hold against the JAX package), at a small size; ``build_kw``
    are `build_pipeline` options (triangulation, flip-TTA, decode)."""
    import torch
    from multi_camera_3d_pose_estimation_tpu_torch.entry import build_pipeline

    cfg, input_size = SMALL[family]
    shape = (4, cams, 96, 80, 3)
    small = torch.randint(0, 256, shape, generator=gen, dtype=torch.uint8)
    res = {}
    for device in ("cuda", "cpu"):
        p = build_pipeline(cfg, input_size, shape, device=device, seed=3, family=family,
                           **build_kw)
        res[device] = {k: v.float().cpu() for k, v in p.run(small).items()}
    compare_small(res["cuda"], res["cpu"], f"small {label}{family} pipeline")


def check_outputs(out, pipe, T_: int, C_: int = C) -> None:
    """Shapes, finite Gaussians, and NaN kpts_3d exactly where fewer than two
    views passed the confidence gate."""
    import torch

    k2d, g2d, k3d = out["kpts_2d"], out["heatmaps_2d"], out["kpts_3d"]
    check(k2d.shape == (T_, 17, 3, C_) and g2d.shape == (T_, C_, 17, 6)
          and k3d.shape == (T_, 17, 3), "output shapes")
    check(bool(torch.isfinite(g2d).all() and torch.isfinite(k2d[:, :, 2]).all()),
          "Gaussians and confidences are finite")
    conf_ok = (k2d[:, :, 2] > pipe.conf_threshold).sum(-1) >= 2  # two views pass the gate
    finite3d = torch.isfinite(k3d).all(-1)
    check(torch.equal(finite3d, conf_ok),
          "kpts_3d is NaN exactly where fewer than two views passed the gate")
    log(f"outputs: shapes ok, Gaussians finite, {finite3d.float().mean().item():.3f} of joints "
        "triangulated (random weights; the rest gated at conf 0.3)")


NVIEW_T, NVIEW_C = 128, 4  # the n-view + flip-TTA path: 512 crops, two passes each


def run_nview_flip_main_path(dev, gen) -> dict:
    """HRNet-W32 at full width through `build_pipeline(triangulation="nview",
    flip_test=True)` on 4 cameras: a warm-up block, then N_BLOCKS counted and
    timed blocks (two stage-1 passes per block: 8 Bottleneck launches, and
    1 decode launch on the averaged maps)."""
    import torch
    from multi_camera_3d_pose_estimation_tpu_torch.entry import build_pipeline
    from multi_camera_3d_pose_estimation_tpu_torch.models.hrnet import HRNET_W32
    from multi_camera_3d_pose_estimation_tpu_torch.ops import bottleneck as bn
    from multi_camera_3d_pose_estimation_tpu_torch.ops import fused_decode as fd

    shape = (NVIEW_T, NVIEW_C, H, W, 3)
    pipe = build_pipeline(HRNET_W32, INPUT, shape, device=dev, seed=0, triangulation="nview",
                          flip_test=True)
    blocks_u8 = [torch.randint(0, 256, shape, generator=gen, dtype=torch.uint8).to(dev)
                 for _ in range(2)]
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
    fps = NVIEW_T * N_BLOCKS / dt
    log(f"n-view + flip-TTA main path: {N_BLOCKS} blocks of {shape} in {dt:.3f} s -> "
        f"{fps:.1f} multi-camera frames/s; launches {launches}")
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched on the n-view + flip-TTA path")
    check(launches == {"bottleneck": 8 * N_BLOCKS, "heatmap_decode": N_BLOCKS},
          "8 Bottleneck launches (two passes) and 1 decode launch per block")
    check_outputs(out, pipe, NVIEW_T, NVIEW_C)
    return {"fps": fps, "launches": launches}


def check_same_maps(gen, label: str, cams: int = 2, dev="cuda", **build_kw) -> None:
    """The small HRNet pipeline's decode, flip-TTA, gate and triangulation on
    the card against the CPU path on the SAME heatmaps: the card's model
    outputs (direct and mirrored crops) replayed into the CPU pipeline."""
    import torch
    from multi_camera_3d_pose_estimation_tpu_torch.entry import build_pipeline

    cfg, input_size = SMALL["hrnet"]
    shape = (4, cams, 96, 80, 3)
    small = torch.randint(0, 256, shape, generator=gen, dtype=torch.uint8)
    card, cpu = (build_pipeline(cfg, input_size, shape, device=d, seed=3, **build_kw)
                 for d in (dev, "cpu"))
    model, maps = card.estimator.model, []

    def record(x, fused_stage1=None):
        maps.append(model(x, fused_stage1=fused_stage1))
        return maps[-1]

    card.estimator.model = record
    a = {k: v.float().cpu() for k, v in card.run(small).items()}
    replay = iter([m.float().cpu() for m in maps])
    cpu.estimator.model = lambda x, fused_stage1=None: next(replay)
    b = {k: v.float().cpu() for k, v in cpu.run(small).items()}
    check(len(maps) == (2 if build_kw.get("flip_test") else 1), "one model call per pass")
    compare_small(a, b, f"small {label} pipeline on the card's own heatmaps")


def refine_scene(C_: int = 4):
    """`bench.py::bench_refinement`'s scene (BASELINE config 4): 400 frames
    x 17 joints seen by 4 cameras, Gaussians on the exact projections
    (variance 16), the start 3 units of noise off the truth."""
    import numpy as np

    rng = np.random.default_rng(0)
    T_, J = 400, 17
    t = np.linspace(0, 8 * np.pi, T_)[:, None, None]
    traj = rng.uniform([-30, -30, 280], [30, 30, 360], (1, J, 3)) + 10 * np.sin(t)
    gauss = np.zeros((T_, 4, J, 6))
    cams = {}
    for c in range(4):
        K = np.array([[900.0, 0, 640], [0, 900.0, 360], [0, 0, 1]])
        th = np.deg2rad(-30 + 20 * c)
        R = np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0], [-np.sin(th), 0, np.cos(th)]])
        Tv = np.array([40.0 * c - 60, 0.0, 10.0 * c])
        cams[c] = [K, R, Tv, np.zeros(5)]
        cam = traj.reshape(-1, 3) @ R.T + Tv
        gauss[:, c, :, :2] = np.stack([K[0, 0] * cam[:, 0] / cam[:, 2] + K[0, 2],
                                       K[1, 1] * cam[:, 1] / cam[:, 2] + K[1, 2]],
                                      -1).reshape(T_, J, 2)
        gauss[:, c, :, 2] = gauss[:, c, :, 5] = 16.0
    noisy = traj + rng.normal(0, 3.0, traj.shape)
    return gauss[:, :C_], noisy, {c: cams[c] for c in range(C_)}, traj


REFINE_KW = dict(lr=0.01, lambda_smooth=0.01, lambda_body_length=1.0, batch_size=400,
                 patience=10 ** 9, tolerance=0.0)
REFINE_BODY = {"left_shoulder_left_elbow": 38.0, "left_hip_left_knee": 51.0}
REFINE_COST_RTOL, REFINE_TRAJ_ATOL = 1e-9, 1e-7  # float64, card against CPU


def run_refinement_phase(dev="cuda") -> dict:
    """The refinement on the card: epochs/s in float32 (100 warm-up epochs,
    then 2000 timed, ended by the returned numpy trajectory), the busy share
    of one profiler window, and float64 runs card against CPU (one window,
    then batch_size 100: 7 overlapping windows, gate on), and the
    `ExtrinsicRefiner` on 3 of the cameras."""
    import numpy as np
    import torch
    from multi_camera_3d_pose_estimation_tpu_torch.refine import ExtrinsicRefiner, PoseRefiner

    gauss, noisy, cams, truth = refine_scene()
    ref = PoseRefiner(gauss, noisy, cams, body_lengths=REFINE_BODY, device=dev)
    ref.sgd_optimize(max_iter=99, **REFINE_KW)  # warm-up: 100 epochs
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = ref.sgd_optimize(max_iter=1999, **REFINE_KW)
    dt = time.perf_counter() - t0
    eps = res.n_iter / dt
    err0 = np.linalg.norm(noisy - truth, axis=-1).mean()
    err1 = np.linalg.norm(res.trajectory - truth, axis=-1).mean()
    log(f"refinement (400 frames x 17 joints x 4 cameras, float32): {res.n_iter} epochs in "
        f"{dt:.3f} s -> {eps:.1f} epochs/s; mean joint error {err0:.4f} -> {err1:.4f}")
    check(res.n_iter == 2000 and np.isfinite(res.trajectory).all() and err1 < err0,
          "the float32 refinement ran 2000 epochs and moved toward the truth")

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        ref.sgd_optimize(max_iter=199, **REFINE_KW)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy = sum(e.device_time for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e6
    n_kernels = sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA)
    log(f"  profiler window, 200 epochs: wall {wall * 1e3:.3f} ms, device busy "
        f"{busy * 1e3:.3f} ms = {busy / wall:.4f} of wall, {n_kernels / 200:.0f} kernels "
        f"per epoch")

    for B in (400, 100):
        kw = dict(REFINE_KW, batch_size=B, max_iter=49)
        out = {d: PoseRefiner(gauss, noisy, cams, body_lengths=REFINE_BODY, dtype=torch.float64,
                              device=d).sgd_optimize(**kw) for d in (dev, "cpu")}
        a, b = out[dev], out["cpu"]
        rel = max(np.abs(a.cost_history[k] - v).max() / np.abs(v).max()
                  for k, v in b.cost_history.items())
        dtraj = np.abs(a.trajectory - b.trajectory).max()
        log(f"  float64, batch_size {B} ({len(b.gate_weights)} windows, gate weights "
            f"{b.gate_weights.tolist()}), card vs CPU over {b.n_iter} epochs: costs max rel "
            f"{rel:.3g} (tolerance {REFINE_COST_RTOL}), trajectory max |d| {dtraj:.3g} "
            f"(tolerance {REFINE_TRAJ_ATOL})")
        check(a.n_iter == b.n_iter == 50 and list(a.cost_history) == list(b.cost_history),
              "the float64 refinement ran 50 epochs on both")
        check(all(np.allclose(a.cost_history[k], v, rtol=REFINE_COST_RTOL, atol=0)
                  for k, v in b.cost_history.items()) and dtraj <= REFINE_TRAJ_ATOL,
              f"the float64 refinement (batch_size {B}) on the card agrees with the CPU")

    g3, _, cams3, _ = refine_scene(3)
    th = np.deg2rad(2.0)
    bad = {k: [p.copy() for p in v] for k, v in cams3.items()}
    bad[2][1] = np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0],
                          [0, 0, 1]]) @ bad[2][1]
    bad[2][2] = bad[2][2] + np.array([3.0, -2.0, 3.0])
    ext = {}
    for d in (dev, "cpu"):
        er = ExtrinsicRefiner(g3, bad, N_sample_points=10, dtype=torch.float64, device=d)
        ext[d] = (*er.optimize(learning_rate=0.01, max_iter=150, patience=30, seed=0),
                  er.n_iter, er.best_cost)
    (Ra, Ta, na, ca), (Rb, Tb, nb, cb) = ext[dev], ext["cpu"]
    dR, dT = np.abs(Ra - Rb).max(), np.abs(Ta - Tb).max()
    log(f"  ExtrinsicRefiner (3 cameras, float64, samples drawn on the CPU): {nb} steps, best "
        f"cost {cb:.6g}; card vs CPU max |d R| {dR:.3g}, |d T| {dT:.3g}, cost rel "
        f"{abs(ca - cb) / abs(cb):.3g}; rotation error {np.abs(Rb - cams3[2][1]).max():.4g} "
        f"(start {np.abs(bad[2][1] - cams3[2][1]).max():.4g})")
    check(na == nb and abs(ca - cb) <= REFINE_COST_RTOL * abs(cb) and dR <= REFINE_TRAJ_ATOL
          and dT <= REFINE_TRAJ_ATOL, "the ExtrinsicRefiner on the card agrees with the CPU")
    return {"epochs_per_s": eps, "busy_share": busy / wall}


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
    sb.swin_gemm.ln_launches = 0
    t0 = time.perf_counter()
    for i in range(N_SWIN_BLOCKS):
        out = pipe.run(blocks_u8[i % 2])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    launches["swin_gemm_ln"] = sb.swin_gemm.ln_launches
    fps = SWIN_T * N_SWIN_BLOCKS / dt
    log(f"Swin-B main path: {N_SWIN_BLOCKS} blocks of ({SWIN_T}, {C}, {H}, {W}, 3) in "
        f"{dt:.3f} s -> {fps:.1f} multi-camera frames/s; launches {launches}")
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched on the Swin main path")
    n_blocks = sum(SWIN_B["depths"])
    check(launches == {"swin_gemm": 4 * n_blocks * N_SWIN_BLOCKS,
                       "swin_gemm_ln": 2 * n_blocks * N_SWIN_BLOCKS,
                       "window_attention": n_blocks * N_SWIN_BLOCKS,
                       "heatmap_decode": N_SWIN_BLOCKS},
          "96 swin_gemm product launches (48 after a LayerNorm row-kernel launch), "
          "24 window-attention and 1 decode launch per block")
    check_outputs(out, pipe, SWIN_T)
    return {"pipe": pipe, "frames": blocks_u8[0], "blocks": blocks_u8, "fps": fps,
            "launches": launches}


def run_fixed_main_path(swin: dict) -> dict:
    """The Swin-B main path of `run_swin_main_path` (same pipeline, weights
    and frames) with ``MC3D_SWIN_FIXED=1``, which the caller has set: a
    warm-up block, then N_SWIN_BLOCKS counted and timed blocks, with spies
    on the stage and chained-block entry points the model calls."""
    import torch
    from multi_camera_3d_pose_estimation_tpu_torch.models.swin import SWIN_B
    from multi_camera_3d_pose_estimation_tpu_torch.ops import fused_decode as fd
    from multi_camera_3d_pose_estimation_tpu_torch.ops import swin_block as sb
    from multi_camera_3d_pose_estimation_tpu_torch.ops import window_attention as wa

    pipe, blocks_u8 = swin["pipe"], swin["blocks"]
    out = pipe.run(blocks_u8[0])  # warm-up
    torch.cuda.synchronize()
    counters = {"swin_gemm": sb.swin_gemm, "window_attention_rows": wa.window_attention_rows,
                "window_attention": wa.window_attention, "heatmap_decode": fd.heatmap_decode_raw}
    calls = {"fused_swin_stage_fixed": [], "fused_swin_block": []}
    originals = {name: getattr(sb, name) for name in calls}

    def spy(name):
        def fn(*args, **kwargs):
            calls[name].append(args[0].shape[-1])
            return originals[name](*args, **kwargs)
        return fn

    for name in calls:
        setattr(sb, name, spy(name))
    for fn in counters.values():
        fn.launches = 0
    sb.swin_gemm.ln_launches = 0
    t0 = time.perf_counter()
    for i in range(N_SWIN_BLOCKS):
        out = pipe.run(blocks_u8[i % 2])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    for name, fn in originals.items():
        setattr(sb, name, fn)
    launches = {k: fn.launches for k, fn in counters.items()}
    launches["swin_gemm_ln"] = sb.swin_gemm.ln_launches
    fps = SWIN_T * N_SWIN_BLOCKS / dt
    log(f"Swin-B fixed-order main path: {N_SWIN_BLOCKS} blocks of ({SWIN_T}, {C}, {H}, {W}, 3) "
        f"in {dt:.3f} s -> {fps:.1f} multi-camera frames/s (chained layout {swin['fps']:.1f}); "
        f"launches {launches}; stages run fixed {calls['fused_swin_stage_fixed']}, chained "
        f"blocks {calls['fused_swin_block']}")
    n_blocks = sum(SWIN_B["depths"])
    check(launches == {"swin_gemm": 4 * n_blocks * N_SWIN_BLOCKS,
                       "swin_gemm_ln": 2 * n_blocks * N_SWIN_BLOCKS,
                       "window_attention_rows": n_blocks * N_SWIN_BLOCKS,
                       "window_attention": 0, "heatmap_decode": N_SWIN_BLOCKS},
          "96 swin_gemm product and 48 LayerNorm row-kernel launches, 24 row-mode attention, "
          "0 chained attention and 1 decode launch per block on the fixed-order path")
    widths = [SWIN_B["embed"] * 2 ** i for i in range(len(SWIN_B["depths"]))]
    check(calls["fused_swin_stage_fixed"] == widths * N_SWIN_BLOCKS,
          "every stage ran fused_swin_stage_fixed")
    check(not calls["fused_swin_block"], "the chained fused_swin_block ran no time")
    check_outputs(out, pipe, SWIN_T)
    return {"fps": fps, "launches": launches}


def block_bound(real: int, p: dict, heads: int, n: int, C_: int, extra_bytes: int = 0):
    """Least time of one SwinBlock whose map holds ``real`` tokens: its bf16
    tensor-core operations against one read of the real tokens, weights and
    tables (and ``extra_bytes``: a row table) and one write of the real
    outputs.  Window padding needs no work: pad rows enter qkv as zeros
    (their k/v are the bias, which the attention reads as keys) and their
    other products are zeroed, cropped off or never reach a real token, so
    the four products count real rows, and the attention n keys for each
    real query."""
    flops = 2 * real * sum(p[k].numel() for k in ("wqkv", "wproj", "wfc1", "wfc2"))
    flops += 4 * real * n * C_
    nbytes = 2 * real * C_ * 2 + extra_bytes + sum(
        t.numel() * t.element_size() for v in p.values()
        for t in (v if isinstance(v, tuple) else (v,)))
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def attention_bound(Bw: int, n: int, C_: int, bias, mask, real: int, extra_bytes: int = 0):
    """Least time of the attention core over Bw windows of n tokens on a
    map of ``real`` tokens: the real queries and every window token's k and
    v read once, bias, mask (and ``extra_bytes``: a row table, alignment
    rows) read once, the real tokens' ctx written once, against the bf16
    tensor-core operations of n keys for each real query."""
    flops = 4 * real * n * C_
    nbytes = (real * C_ * 2 + Bw * n * 2 * C_ * 2 + real * C_ * 2 + extra_bytes
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


def capture_products(run_block) -> dict:
    """The arguments of the four `swin_gemm` calls that ``run_block()``
    makes (one SwinBlock), by product name, recorded by a stand-in for
    ``swin_block.swin_gemm`` that passes each call on."""
    from multi_camera_3d_pose_estimation_tpu_torch.ops import swin_block as sb

    calls, original = [], sb.swin_gemm

    def record(mode, a, w, b, res=None, ln=None, valid=None):
        calls.append((mode, a, w, b, res, ln, valid))
        return original(mode, a, w, b, res=res, ln=ln, valid=valid)

    record.launches = record.ln_launches = 0  # the wrapper counts on whatever swin_gemm names
    sb.swin_gemm = record
    try:
        run_block()
    finally:
        sb.swin_gemm = original
    check(len(calls) == len(PRODUCTS), "a SwinBlock makes four swin_gemm calls")
    return dict(zip(PRODUCTS, calls))


def check_products(calls: dict, real: int, label: str) -> dict:
    """Each token product of one block on its own operands: the kernel
    against `swin_gemm_plain` within PRODUCT_REL_TOL of its largest output,
    its time, the bound over the ``real`` rows (one read of their operand
    and residual, the weights and tables, one write of their output, against
    their bf16 operations), the host's time per call (the wrapper and its
    launches, while the card runs the calls before) and, as a yardstick,
    cuBLAS ``F.linear`` on the same (M, K) x (N, K) operands: the product
    alone, no LN prologue or epilogue (the port never calls it)."""
    import torch
    import torch.nn.functional as F
    from multi_camera_3d_pose_estimation_tpu_torch.ops import swin_block as sb

    rows = {}
    for name, (mode, a, w, b, res, ln, valid) in calls.items():
        kw = dict(res=res, ln=ln, valid=valid)
        out = sb.swin_gemm(mode, a, w, b, **kw)
        ref = sb.swin_gemm_plain(mode, a, w, b, **kw)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        scale = ref.float().abs().max().item()
        del out, ref
        (M, K), N = a.shape, w.shape[0]
        flops = 2 * real * N * K
        tables = sum(t.numel() * t.element_size() for t in (b, valid, *(ln or ())) if t is not None)
        nbytes = real * (K + N * (2 if res is not None else 1)) * 2 + w.numel() * 2 + tables
        t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_S
        call = partial(sb.swin_gemm, mode, a, w, b, **kw)
        r = {"ms": cuda_ms(call, 20), "host_ms": host_ms(call),
             "library_ms": cuda_ms(lambda: F.linear(a, w), 20),
             "bound": max(t_ops, t_bytes) * 1e3,
             "by": "operations" if t_ops >= t_bytes else "bytes",
             "computed_tflop": 2 * M * N * K / 1e12, "err": err}
        log(f"  {label} {name} ({mode}) ({M}, {K}) x ({N}, {K}): max |kernel - plain| {err:.6g} "
            f"(tolerance {PRODUCT_REL_TOL} x {scale:.4g}); kernel {r['ms']:.4f} ms "
            f"({r['computed_tflop'] / r['ms'] * 1e3:.1f} TFLOP/s on the {M} rows computed), cuBLAS "
            f"product alone {r['library_ms']:.4f} ms; bound {r['bound']:.4f} ms by {r['by']} "
            f"({real} real rows); host {r['host_ms']:.4f} ms per call")
        check(err <= PRODUCT_REL_TOL * scale,
              f"{label} {name}: the swin_gemm kernel agrees with its plain version")
        rows[name] = r
    return rows


def products_keys(stage_products: list) -> dict:
    """Per forward (sum over stages of depth x one block's four products):
    kernel, cuBLAS product, bound and host ms, for the kernels JSON line."""
    def per_forward(key):
        return sum(depth * sum(r[key] for r in prods.values()) for depth, prods in stage_products)
    return {"products_ms": per_forward("ms"), "products_library_ms": per_forward("library_ms"),
            "products_bound_ms": per_forward("bound"), "products_host_ms": per_forward("host_ms"),
            "products_note": "the four swin_gemm products per forward; library: cuBLAS "
                             "F.linear, the product alone, no LN prologue or epilogue"}


def total(rows, key):
    """Per forward: the sum over stages of depth x one block's ``key``."""
    return sum(r["depth"] * r[key] for r in rows)


def rows_bound_by(rows):
    """What bounds a sum of stage rows: "operations", "bytes" or "mixed"."""
    return "operations" if all(r["by"] == "operations" for r in rows) else (
        "bytes" if all(r["by"] == "bytes" for r in rows) else "mixed")


def check_trained_bias(kernel, plain, args, controls: dict, what: str) -> float:
    """The attention kernel against its plain version with a bias of
    trained scale: ``kernel(*args)`` within ATTN_REL_TOL of
    ``plain(*args)``'s largest output, while ``plain`` with each control's
    arguments (one of them wrong) is off by more.  The random table
    (N(0, 0.02^2)) moves ctx by about 1e-3, under that tolerance, which
    is why the check runs again with an N(0, 1) bias.  Returns the error."""
    import torch

    kb, pb = kernel(*args), plain(*args)
    torch.cuda.synchronize()
    err = (kb.float() - pb.float()).abs().max().item()
    scale = pb.float().abs().max().item()
    off = {k: (plain(*a).float() - pb.float()).abs().max().item() for k, a in controls.items()}
    log(f"  with an N(0, 1) bias: max |kernel - plain| {err:.6g} (tolerance {ATTN_REL_TOL} x "
        f"{scale:.4g}); plain controls off by " + ", ".join(f"{k} {v:.4g}" for k, v in off.items()))
    check(err <= ATTN_REL_TOL * scale, f"{what} agrees with a trained-scale bias")
    check(all(v > ATTN_REL_TOL * scale for v in off.values()),
          f"{what}: each control fails the attention tolerance")
    return err


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
        stages, attn_stages, products = [], [], []
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
            calls = capture_products(lambda: sb.fused_swin_block(x, p, **args))
            products.append((depth, check_products(calls, real, f"stage {i}")))

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
            abound, aby = attention_bound(qkv.shape[0], n, C_, p["bias"], mask, real)
            call = partial(wa.window_attention, qkv, p["bias"], mask, blk.heads)
            ta = {"ms": cuda_ms(call, 20), "host_ms": host_ms(call),
                  "plain_ms": cuda_ms(lambda: wa.window_attention_plain(qkv, p["bias"], mask,
                                                                        blk.heads), 3),
                  "library_ms": cuda_ms(lib, 20)}
            log(f"  attention qkv {tuple(qkv.shape)} heads {blk.heads}: max |kernel - plain| "
                f"{aerr:.6g} (tolerance {ATTN_REL_TOL} x {ascale:.4g}), share > 1 bf16 step "
                f"{bf16_steps_apart(ka, pa):.3g}; SDPA yardstick max |SDPA - plain| {lerr:.6g}; "
                f"kernel {ta['ms']:.4f} ms ({abound / ta['ms']:.3f} of its bound), plain "
                f"{ta['plain_ms']:.4f} ms, SDPA {ta['library_ms']:.4f} ms; bound {abound:.4f} ms "
                f"by {aby}; host {ta['host_ms']:.4f} ms per call")
            check(aerr <= ATTN_REL_TOL * ascale,
                  f"Swin stage {i}: the window attention kernel agrees with its plain version")
            # The random table (N(0, 0.02^2)) moves ctx by about 1e-3, under
            # that tolerance, so the same qkv again with a bias of trained
            # scale, N(0, 1): controls show that plain with no bias, with the
            # next head's bias or (shifted) with no mask fails the tolerance.
            strong = torch.randn(p["bias"].shape, generator=bias_gen).to(dev)
            controls = {"no bias": (torch.zeros_like(strong), mask),
                        "the next head's bias": (strong.roll(1, 0), mask)}
            if mask is not None:
                controls["no mask"] = (strong, None)
            berr = check_trained_bias(
                lambda b_, m_: wa.window_attention(qkv, b_, m_, blk.heads),
                lambda b_, m_: wa.window_attention_plain(qkv, b_, m_, blk.heads),
                (strong, mask), controls, f"Swin stage {i}: the window attention kernel")
            attn_stages.append(dict(ta, depth=depth, err=aerr, bias_err=berr, bound=abound,
                                    by=aby))
            del add

    here = "multi_camera_3d_pose_estimation_tpu/ops/pallas"
    launches = swin["launches"]
    pk = products_keys(products)
    log("Swin totals per forward (sum over stages of depth x one block): blocks kernel "
        f"{total(stages, 'ms'):.4f} ms, bound {total(stages, 'bound'):.4f} ms; token products "
        f"{pk['products_ms']:.4f} ms, cuBLAS products alone {pk['products_library_ms']:.4f} ms, "
        f"bound {pk['products_bound_ms']:.4f} ms; attention kernel "
        f"{total(attn_stages, 'ms'):.4f} ms, SDPA {total(attn_stages, 'library_ms'):.4f} ms, "
        f"bound {total(attn_stages, 'bound'):.4f} ms, host {total(attn_stages, 'host_ms'):.4f} ms")
    return [
        {"name": "swin_block", "route": "cuda",
         "source": f"{PORT}/csrc/swin_gemm.cu + {PORT}/csrc/window_attention.cu",
         "replaces": f"{here}/swin_block.py:704 (fused_swin_block, pallas_call :833)",
         "launches": launches["swin_gemm"] + launches["window_attention"],
         "ln_launches": launches["swin_gemm_ln"],
         "max_abs_err": max(r["err"] for r in stages),
         "ms": total(stages, "ms"), "plain_ms": total(stages, "plain_ms"),
         "bound_ms": total(stages, "bound"), "bound_by": rows_bound_by(stages), "library_ms": None,
         **products_keys(products),
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
         "bound_ms": total(attn_stages, "bound"), "bound_by": rows_bound_by(attn_stages),
         "library_ms": total(attn_stages, "library_ms"),
         "attention_host_ms": total(attn_stages, "host_ms"),
         "max_abs_err_trained_bias": max(r["bias_err"] for r in attn_stages),
         "per_forward": f"{sum(cfg['depths'])} launches: sum over stages of depth x one "
                        "launch of the main path"},
    ]


def check_fixed_kernels(swin: dict, fixed: dict, dev) -> list:
    """The fixed-order path's kernels on the inputs its main path gave them
    (``MC3D_SWIN_FIXED=1``, set by the caller): per stage, the first shifted
    block and its row-mode attention, and the whole stage."""
    import torch
    from multi_camera_3d_pose_estimation_tpu_torch.models.topdown import preprocess_crops
    from multi_camera_3d_pose_estimation_tpu_torch.ops import swin_block as sb
    from multi_camera_3d_pose_estimation_tpu_torch.ops import window_attention as wa
    from multi_camera_3d_pose_estimation_tpu_torch.ops.swin_geometry import (
        device_table, fixed_reverse, fixed_rows, padded_dims, window_partition, window_roll_perm)

    model = swin["pipe"].estimator.model
    cfg = model.cfg
    frames = swin["frames"].reshape(SWIN_T * C, H, W, 3).to(torch.bfloat16) / 255.0
    boxes = torch.tensor([0.0, 0.0, W, H], device=dev).expand(SWIN_T * C, 4)
    blocks_in, stages_in = {}, {}
    originals = {name: getattr(sb, name) for name in ("fused_swin_block_fixed",
                                                      "fused_swin_stage_fixed")}

    def block_hook(x, p, **kw):  # the call goes on unchanged
        if kw["shift"]:
            blocks_in.setdefault(x.shape[-1], (x, p, kw))
        return originals["fused_swin_block_fixed"](x, p, **kw)

    def stage_hook(x, plist, **kw):
        stages_in.setdefault(x.shape[-1], (x, plist, kw))
        return originals["fused_swin_stage_fixed"](x, plist, **kw)

    sb.fused_swin_block_fixed, sb.fused_swin_stage_fixed = block_hook, stage_hook
    with torch.inference_mode():
        crops, _, _ = preprocess_crops(frames, boxes, INPUT)
        model(crops)
        torch.cuda.synchronize()
    for name, fn in originals.items():
        setattr(sb, name, fn)
    bias_gen = torch.Generator().manual_seed(8)
    blocks, attns, stages, products = [], [], [], []
    with torch.inference_mode():
        for i, depth in enumerate(cfg["depths"]):
            C_ = cfg["embed"] * 2 ** i
            x, p, kw = blocks_in[C_]
            heads, win, shift = kw["heads"], kw["window"], kw["shift"]
            B_, Hc, Wc = kw["geom"]
            n, real, P = win * win, B_ * Hc * Wc, fixed_rows(Hc, Wc, win)
            Hp, Wp = padded_dims(Hc, Wc, win)
            valid, rows, mask = sb.fixed_tables(Hc, Wc, win, shift, dev)
            kern = sb.fused_swin_block_fixed(x, p, **kw)
            plain = sb.swin_block_fixed_plain(x, p, **kw)
            # The chained block on the same map, window-order tokens in and out.
            chained_args = dict(heads=heads, window=win, shift=shift, mlp_ratio=kw["mlp_ratio"])
            img = fixed_reverse(x, B_, Hc, Wc, win)
            xw = window_partition(img, win, shift).contiguous()
            chained = sb.fused_swin_block(img, p, **chained_args)
            torch.cuda.synchronize()
            err = (kern.float() - plain.float()).abs().max().item()
            scale = plain.float().abs().max().item()
            row_share = bf16_steps_apart_rows(kern, plain)
            kimg = fixed_reverse(kern, B_, Hc, Wc, win)
            cerr = (kimg.float() - chained.float()).abs().max().item()
            cscale = chained.float().abs().max().item()
            crow_share = bf16_steps_apart_rows(kimg, chained)
            extra = rows.numel() * 4
            bound, bby = block_bound(real, p, heads, n, C_, extra)
            t = {"ms": cuda_ms(lambda: sb.fused_swin_block_fixed(x, p, **kw), 10),
                 "plain_ms": cuda_ms(lambda: sb.swin_block_fixed_plain(x, p, **kw), 2),
                 "chained_ms": cuda_ms(lambda: sb.fused_swin_block(
                     xw, p, pre_partitioned=(B_, Hc, Wc), emit_partitioned=True,
                     **chained_args), 10)}
            log(f"fixed stage {i} block 1 (x{depth}) tokens {tuple(x.shape)} (P={P}, {real} "
                f"real), map {Hc}x{Wc}: max |kernel - plain| {err:.6g} (tolerance "
                f"{SWIN_BLOCK_REL_TOL} x {scale:.4g}), share > 1 bf16 step of the token's largest "
                f"{row_share:.3g}; against the chained block after fixed_reverse {cerr:.6g} "
                f"(tolerance {SWIN_BLOCK_REL_TOL} x {cscale:.4g}), share {crow_share:.3g} "
                f"(tolerance {SWIN_ROW_FLIP_SHARE}); kernel {t['ms']:.4f} ms, chained block "
                f"{t['chained_ms']:.4f} ms, plain {t['plain_ms']:.4f} ms; bound {bound:.4f} ms "
                f"by {bby}")
            check(err <= SWIN_BLOCK_REL_TOL * scale and row_share <= SWIN_ROW_FLIP_SHARE,
                  f"fixed stage {i}: the block kernels agree with their plain version")
            check(cerr <= SWIN_BLOCK_REL_TOL * cscale and crow_share <= SWIN_ROW_FLIP_SHARE,
                  f"fixed stage {i}: the fixed-order block agrees with the chained block")
            blocks.append(dict(t, depth=depth, err=err, bound=bound, by=bby))
            calls = capture_products(lambda: sb.fused_swin_block_fixed(x, p, **kw))
            products.append((depth, check_products(calls, real, f"fixed stage {i}")))

            # The row-mode attention on this block's own qkv.
            qkv = sb.swin_gemm("qkv", x, p["wqkv"], p["bqkv"], ln=p["norm1"], valid=valid)
            ka = wa.window_attention_rows(qkv, p["bias"], mask, heads, rows, P)
            pa = wa.window_attention_rows_plain(qkv, p["bias"], mask, heads, rows, P)
            Bw = B_ * (Hp // win) * (Wp // win)
            idx = (torch.arange(B_, device=dev)[:, None] * P + rows.long()[None, :]).reshape(-1)
            qkv_w = qkv[idx].view(Bw, n, 3 * C_)  # gathered for the yardstick, untimed
            lib, add = sdpa_library(qkv_w, p["bias"], mask, heads)
            valid_c, mask_c = sb.block_tables(Hc, Wc, win, shift, dev)
            qkv_c = sb.swin_gemm("qkv", xw, p["wqkv"], p["bqkv"], ln=p["norm1"],
                                 valid=valid_c).view(Bw, n, 3 * C_)
            torch.cuda.synchronize()
            aerr = (ka.float() - pa.float()).abs().max().item()
            ascale = pa.float().abs().max().item()
            tail = (P - Hp * Wp) * B_
            abound, aby = attention_bound(Bw, n, C_, p["bias"], mask, real,
                                          extra + 2 * tail * C_ * 2)
            call = partial(wa.window_attention_rows, qkv, p["bias"], mask, heads, rows, P)
            chained_call = partial(wa.window_attention, qkv_c, p["bias"], mask_c, heads)
            # Row mode and the chained layout in turns (row, chained, chained,
            # row), each the smaller of its two turns.
            turns = [cuda_ms(fn, 20) for fn in (call, chained_call, chained_call, call)]
            ta = {"ms": min(turns[0], turns[3]), "chained_ms": min(turns[1], turns[2]),
                  "host_ms": host_ms(call),
                  "plain_ms": cuda_ms(lambda: wa.window_attention_rows_plain(
                      qkv, p["bias"], mask, heads, rows, P), 3),
                  "library_ms": cuda_ms(lib, 20)}
            log(f"  row-mode attention qkv {tuple(qkv.shape)} heads {heads}, {Bw} windows: max "
                f"|kernel - plain| {aerr:.6g} (tolerance {ATTN_REL_TOL} x {ascale:.4g}); kernel "
                f"{ta['ms']:.4f} ms ({abound / ta['ms']:.3f} of its bound), chained-layout "
                f"attention {ta['chained_ms']:.4f} ms, plain {ta['plain_ms']:.4f} ms, SDPA on the "
                f"gathered windows (gather and scatter left out) {ta['library_ms']:.4f} ms; bound "
                f"{abound:.4f} ms by {aby}; host {ta['host_ms']:.4f} ms per call")
            check(aerr <= ATTN_REL_TOL * ascale,
                  f"fixed stage {i}: the row-mode attention agrees with its plain version")
            strong = torch.randn(p["bias"].shape, generator=bias_gen).to(dev)
            identity = torch.arange(rows.numel(), dtype=torch.int32, device=dev)
            controls = {"the identity row table": (strong, mask, identity),
                        "no mask": (strong, None, rows),
                        "the next head's bias": (strong.roll(1, 0), mask, rows)}
            berr = check_trained_bias(
                lambda b_, m_, r_=rows: wa.window_attention_rows(qkv, b_, m_, heads, r_, P),
                lambda b_, m_, r_=rows: wa.window_attention_rows_plain(qkv, b_, m_, heads, r_, P),
                (strong, mask), controls, f"fixed stage {i}: the row-mode attention")
            attns.append(dict(ta, depth=depth, err=aerr, bias_err=berr, bound=abound, by=aby))
            del add, qkv_w, qkv_c

            # The whole stage: its blocks one by one, and its plain version.
            xs, plist, skw = stages_in[C_]
            ks = sb.fused_swin_stage_fixed(xs, plist, **skw)
            one_by_one = xs
            for p_, s_ in zip(plist, skw["shifts"]):
                one_by_one = sb.fused_swin_block_fixed(
                    one_by_one, p_, heads=heads, window=win, shift=s_,
                    mlp_ratio=skw["mlp_ratio"], geom=skw["geom"])
            # The same stage in the chained window layout, as the model runs it.
            cw = sb.fused_swin_block(fixed_reverse(xs, B_, Hc, Wc, win), plist[0],
                                     emit_partitioned=True, **dict(chained_args, shift=0))
            for j in range(1, depth):
                perm = device_table(window_roll_perm, Hc, Wc, win, skw["shifts"][j - 1],
                                    skw["shifts"][j], device=dev, dtype=torch.long)
                cw = cw.view(B_, -1, C_).index_select(1, perm).view(-1, C_)
                cw = sb.fused_swin_block(cw, plist[j], pre_partitioned=(B_, Hc, Wc),
                                         emit_partitioned=j < depth - 1,
                                         **dict(chained_args, shift=skw["shifts"][j]))
            pstage = sb.swin_stage_fixed_plain(xs, plist, **skw)
            torch.cuda.synchronize()
            same_chained = torch.equal(fixed_reverse(ks, B_, Hc, Wc, win), cw)
            serr = (ks.float() - pstage.float()).abs().max().item()
            sscale = pstage.float().abs().max().item()
            ts = {"ms": cuda_ms(lambda: sb.fused_swin_stage_fixed(xs, plist, **skw), 3),
                  "plain_ms": cuda_ms(lambda: sb.swin_stage_fixed_plain(xs, plist, **skw), 1)}
            log(f"  the whole stage ({depth} blocks): equal to its blocks one by one "
                f"{torch.equal(ks, one_by_one)}, to the chained-layout stage on its real tokens "
                f"{same_chained}; max |kernel - plain| {serr:.6g} (tolerance {depth} blocks x "
                f"{SWIN_BLOCK_REL_TOL} x {sscale:.4g}; {serr / sscale / 2.0 ** -8:.3g} bf16 steps "
                f"of its largest output), share > 1 bf16 step of the token's largest "
                f"{bf16_steps_apart_rows(ks, pstage):.3g}; kernel {ts['ms']:.4f} ms, plain "
                f"{ts['plain_ms']:.4f} ms")
            check(torch.equal(ks, one_by_one), f"fixed stage {i}: the stage is its blocks")
            check(same_chained, f"fixed stage {i}: the stage equals the chained-layout stage")
            check(serr <= depth * SWIN_BLOCK_REL_TOL * sscale,
                  f"fixed stage {i}: the stage agrees with its plain version")
            stages.append(dict(ts, depth=1, err=serr, bound=depth * bound, by=bby))

    here = "multi_camera_3d_pose_estimation_tpu/ops/pallas"
    launches = fixed["launches"]["swin_gemm"] + fixed["launches"]["window_attention_rows"]
    ln_launches = fixed["launches"]["swin_gemm_ln"]
    pk = products_keys(products)
    log("fixed-order Swin totals per forward (sum over stages of depth x one block): blocks "
        f"kernel {total(blocks, 'ms'):.4f} ms (chained layout {total(blocks, 'chained_ms'):.4f}),"
        f" token products {pk['products_ms']:.4f} ms (cuBLAS products alone "
        f"{pk['products_library_ms']:.4f}, bound {pk['products_bound_ms']:.4f}),"
        f" bound {total(blocks, 'bound'):.4f} ms; stages kernel {total(stages, 'ms'):.4f} ms; "
        f"row-mode attention {total(attns, 'ms'):.4f} ms (chained layout "
        f"{total(attns, 'chained_ms'):.4f}), SDPA {total(attns, 'library_ms'):.4f} ms, bound "
        f"{total(attns, 'bound'):.4f} ms, host {total(attns, 'host_ms'):.4f} ms")
    src = f"{PORT}/csrc/swin_gemm.cu + {PORT}/csrc/window_attention.cu (row mode)"
    return [
        {"name": "swin_block_fixed", "route": "cuda", "source": src,
         "replaces": f"{here}/swin_block.py:473 (fused_swin_block_fixed, pallas_call :528)",
         "launches": launches, "ln_launches": ln_launches,
         "max_abs_err": max(r["err"] for r in blocks),
         "ms": total(blocks, "ms"), "plain_ms": total(blocks, "plain_ms"),
         "bound_ms": total(blocks, "bound"), "bound_by": rows_bound_by(blocks), "library_ms": None,
         **products_keys(products),
         "chained_ms": total(blocks, "chained_ms"),
         "attention_ms": total(attns, "ms"), "attention_bound_ms": total(attns, "bound"),
         "attention_sdpa_ms": total(attns, "library_ms"),
         "attention_host_ms": total(attns, "host_ms"),
         "max_abs_err_attention_trained_bias": max(r["bias_err"] for r in attns),
         "per_forward": f"{sum(cfg['depths'])} blocks: sum over stages of depth x one block "
                        "of the fixed-order main path"},
        {"name": "swin_stage_fixed", "route": "cuda", "source": src,
         "replaces": f"{here}/swin_block.py:379 (fused_swin_stage_fixed, pallas_call :452)",
         "launches": launches, "ln_launches": ln_launches,
         "max_abs_err": max(r["err"] for r in stages),
         "ms": total(stages, "ms"), "plain_ms": total(stages, "plain_ms"),
         "bound_ms": total(stages, "bound"), "bound_by": rows_bound_by(stages), "library_ms": None,
         "per_forward": f"{len(cfg['depths'])} stages of the fixed-order main path, each whole"},
    ]


def kernel_counters() -> dict:
    """Every kernel wrapper of the port, by counter name."""
    from multi_camera_3d_pose_estimation_tpu_torch.ops import bottleneck as bn
    from multi_camera_3d_pose_estimation_tpu_torch.ops import fused_decode as fd
    from multi_camera_3d_pose_estimation_tpu_torch.ops import swin_block as sb
    from multi_camera_3d_pose_estimation_tpu_torch.ops import window_attention as wa

    return {"bottleneck": bn.fused_bottleneck_block, "heatmap_decode": fd.heatmap_decode_raw,
            "swin_gemm": sb.swin_gemm, "window_attention": wa.window_attention,
            "window_attention_rows": wa.window_attention_rows}


# The counters whose launches make up each row of the results line.
ROW_COUNTERS = {"stage1_bottleneck_chain": ("bottleneck",), "heatmap_decode": ("heatmap_decode",),
                "swin_block": ("swin_gemm", "window_attention"),
                "window_attention": ("window_attention",),
                "swin_block_fixed": ("swin_gemm", "window_attention_rows"),
                "swin_stage_fixed": ("swin_gemm", "window_attention_rows")}


def timed_blocks(pipe, blocks, n: int, bboxes=None):
    """``n`` blocks through ``pipe.run`` with every count set to 0 just
    before: (the last output, seconds, every counter's launches)."""
    import torch

    counters = kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    for i in range(n):
        out = pipe.run(blocks[i % len(blocks)], bboxes)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    return out, dt, {k: fn.launches for k, fn in counters.items()}


def check_kept_boxes(pipe, block, what: str) -> float:
    """The boxes ``pipe.run(block)`` crops to: every kept one finite, inside
    the frame and of positive size, and at least one kept.  Returns the
    share of (frame, camera) pairs whose detection was kept."""
    import torch

    boxes, score, kept = pipe.detect(block)
    Hh, Ww = block.shape[2:4]
    b = boxes[kept]
    wh = b[:, 2:] - b[:, :2]
    ok = (torch.isfinite(b).all(-1) & (b[:, :2] >= 0).all(-1) & (b[:, 2] <= Ww)
          & (b[:, 3] <= Hh) & (wh > 0).all(-1))
    share = kept.float().mean().item()
    check(bool(kept.any()), f"{what}: the detector's box was kept somewhere")
    q = torch.quantile(wh.float().flatten(), torch.tensor([0.0, 0.5, 1.0], device=wh.device))
    log(f"  {what}: {share:.4f} of frames x cameras kept the detector's box (score > "
        f"{pipe.detector.bbox_thr}; selected scores {score.min().item():.4f}-"
        f"{score.max().item():.4f}); kept box sides min/median/max "
        f"{[round(v, 2) for v in q.tolist()]} px; all finite, inside the frame, positive: "
        f"{bool(ok.all())}")
    check(bool(ok.all()), f"{what}: kept boxes are finite, inside the frame and of positive size")
    return share


def run_detector_path(dev, gen, det_name: str, select: str, n_blocks: int,
                      full_frame: bool = False) -> dict:
    """HRNet-W32 behind ``det_name`` through `build_pipeline(detector=...)`
    on the headline block: a warm-up block, then ``n_blocks`` counted and
    timed blocks (4 Bottleneck and 1 decode launch per block); with
    ``full_frame``, the same pipeline again on given full-frame boxes."""
    import torch
    from multi_camera_3d_pose_estimation_tpu_torch.entry import build_pipeline
    from multi_camera_3d_pose_estimation_tpu_torch.models.hrnet import HRNET_W32

    what = f"HRNet-W32 behind {det_name} ({select})"
    shape = (T, C, H, W, 3)
    t0 = time.perf_counter()
    pipe = build_pipeline(HRNET_W32, INPUT, shape, device=dev, seed=0, detector=det_name,
                          detector_select=select)
    blocks = [torch.randint(0, 256, shape, generator=gen, dtype=torch.uint8).to(dev)
              for _ in range(2)]
    torch.cuda.synchronize()
    log(f"{what}: built in {time.perf_counter() - t0:.1f} s")
    pipe.run(blocks[0])  # warm-up
    torch.cuda.synchronize()
    out, dt, launches = timed_blocks(pipe, blocks, n_blocks)
    fps = T * n_blocks / dt
    log(f"{what}: {n_blocks} blocks of {shape} in {dt:.3f} s -> {fps:.1f} multi-camera "
        f"frames/s; launches {launches}")
    check(launches == dict(bottleneck=4 * n_blocks, heatmap_decode=n_blocks, swin_gemm=0,
                           window_attention=0, window_attention_rows=0),
          f"{what}: 4 Bottleneck launches and 1 decode launch per block, no other kernel")
    check_outputs(out, pipe, T)
    res = {"fps": fps, "launches": launches,
           "kept_share": check_kept_boxes(pipe, blocks[(n_blocks - 1) % 2], what)}
    if full_frame:
        full = torch.tensor([0.0, 0.0, W, H], device=dev).expand(T, C, 4)
        _, dt_ff, _ = timed_blocks(pipe, blocks, n_blocks, full)
        res["full_frame_fps"] = T * n_blocks / dt_ff
        res["detector_cost"] = 1.0 - fps / res["full_frame_fps"]
        log(f"  the same pipeline on given full-frame boxes: {res['full_frame_fps']:.1f} "
            f"frames/s; the detector's cost 1 - det/full = {res['detector_cost']:.4f}")
    return res


def run_simcc_path(dev, gen) -> dict:
    """RTMPose-t through `build_pipeline(family="rtmpose")` on T=256 x C=2:
    a warm-up block, then N_BLOCKS counted and timed blocks (no kernel)."""
    import torch
    from multi_camera_3d_pose_estimation_tpu_torch.entry import build_pipeline
    from multi_camera_3d_pose_estimation_tpu_torch.models.registry import MODEL_REGISTRY

    spec = MODEL_REGISTRY["coco_rtmpose-t"]
    shape = (T, C, H, W, 3)
    t0 = time.perf_counter()
    pipe = build_pipeline(spec["cfg"], spec["input_size"], shape, device=dev, seed=0,
                          family="rtmpose")
    blocks = [torch.randint(0, 256, shape, generator=gen, dtype=torch.uint8).to(dev)
              for _ in range(2)]
    torch.cuda.synchronize()
    log(f"RTMPose-t pipeline built in {time.perf_counter() - t0:.1f} s")
    pipe.run(blocks[0])  # warm-up
    torch.cuda.synchronize()
    out, dt, launches = timed_blocks(pipe, blocks, N_BLOCKS)
    fps = T * N_BLOCKS / dt
    share = (out["kpts_2d"][:, :, 2] > pipe.conf_threshold).float().mean().item()
    log(f"SimCC path (RTMPose-t): {N_BLOCKS} blocks of {shape} in {dt:.3f} s -> {fps:.1f} "
        f"multi-camera frames/s; launches {launches}; {share:.4f} of joints pass the "
        f"{pipe.conf_threshold} gate")
    check(all(n == 0 for n in launches.values()),
          "the SimCC path launches no kernel (0 Bottleneck, 0 decode)")
    check_outputs(out, pipe, T)
    return {"fps": fps, "launches": launches, "joint_share": share}


DET_SMALL_SHAPE = (4, 2, 64, 96, 3)  # RTMDet needs H, W multiples of 32


def check_small_detector_pipeline(gen, dev, select: str) -> None:
    """The small HRNet pipeline behind ``test_rtmdet_micro`` on the card
    against the CPU path: (1) the CPU path on the card's own (bf16)
    detector outputs replayed: the same boxes and scores, and the outputs
    as phase 5 holds them; (2) end to end with the detector in float32 on
    both sides (TF32 off: the same candidate then gives the same box within
    1e-2 px), compared on the frames where both sides kept the same box."""
    import torch
    from multi_camera_3d_pose_estimation_tpu_torch.entry import build_pipeline
    from multi_camera_3d_pose_estimation_tpu_torch.models import RTMDet, SinglePersonDetector
    from multi_camera_3d_pose_estimation_tpu_torch.models.registry import (DETECTOR_REGISTRY,
                                                                           init_rtmdet_)

    cfg, input_size = SMALL["hrnet"]
    small = torch.randint(0, 256, DET_SMALL_SHAPE, generator=gen, dtype=torch.uint8)
    card, cpu = (build_pipeline(cfg, input_size, DET_SMALL_SHAPE, device=d, seed=3,
                                detector="test_rtmdet_micro", detector_select=select)
                 for d in (dev, "cpu"))
    model, recorded = card.detector.model, []

    def record(x):
        recorded.append(model(x))
        return recorded[-1]

    card.detector.model = record
    a_det = [t.cpu() for t in card.detect(small)]
    a = {k: v.float().cpu() for k, v in card.run(small).items()}
    replay = iter([{k: v.cpu() for k, v in o.items() if k != "raw"} for o in recorded])
    cpu.detector.model = lambda x: next(replay)
    b_det = list(cpu.detect(small))
    b = {k: v.float().cpu() for k, v in cpu.run(small).items()}
    same = all(torch.equal(x, y) for x, y in zip(a_det, b_det))
    log(f"small {select} detector pipeline, the CPU path on the card's detector outputs: boxes, "
        f"scores and kept flags equal {same} ({a_det[2].float().mean().item():.3f} kept)")
    check(len(recorded) == 2 and same,
          f"{select} selection on the card's detector outputs gives the card's boxes on the CPU")
    compare_small(a, b, f"small {select} detector pipeline on the card's own detections")

    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    res = {}
    for d in (dev, "cpu"):
        det_model = RTMDet(**DETECTOR_REGISTRY["test_rtmdet_micro"]["cfg"], dtype=torch.float32,
                           device=d)
        det = SinglePersonDetector(init_rtmdet_(det_model, torch.Generator().manual_seed(3)),
                                   select=select, device=d)
        p = build_pipeline(cfg, input_size, DET_SMALL_SHAPE, device=d, seed=3, detector=det)
        res[d] = ({k: v.float().cpu() for k, v in p.run(small).items()}, p.detect(small)[0].cpu())
    torch.backends.cudnn.allow_tf32 = prev
    (a, ba), (b, bb) = res[dev], res["cpu"]
    frames_ok = ((ba - bb).abs() < 1e-2).all(-1).all(-1)  # (T,): both views kept the same box
    log(f"small {select} detector pipeline end to end (float32 detector): "
        f"{int(frames_ok.sum())} of {len(frames_ok)} frames with the same boxes in every view, "
        f"max |d box| {(ba - bb).abs().max().item():.3g} px")
    check(frames_ok.float().mean() >= 0.5, f"{select}: most frames crop to the same boxes")
    compare_small({k: v[frames_ok] for k, v in a.items()},
                  {k: v[frames_ok] for k, v in b.items()},
                  f"small {select} detector pipeline end to end, same-box frames")


def check_simcc_replay(gen, dev) -> None:
    """The small RTMPose + flip-TTA pipeline's decode, gate and triangulation
    on the card against the CPU path on the card's own SimCC logits (direct
    and mirrored passes) replayed."""
    import torch
    from multi_camera_3d_pose_estimation_tpu_torch.entry import build_pipeline

    cfg, input_size = SMALL["rtmpose"]
    shape = (4, 2, 96, 80, 3)
    small = torch.randint(0, 256, shape, generator=gen, dtype=torch.uint8)
    card, cpu = (build_pipeline(cfg, input_size, shape, device=d, seed=3, family="rtmpose",
                                flip_test=True) for d in (dev, "cpu"))
    model, logits = card.estimator.model, []

    def record(x):
        logits.append(model(x))
        return logits[-1]

    card.estimator.model = record
    a = {k: v.float().cpu() for k, v in card.run(small).items()}
    replay = iter([tuple(t.cpu() for t in pair) for pair in logits])
    cpu.estimator.model = lambda x: next(replay)
    b = {k: v.float().cpu() for k, v in cpu.run(small).items()}
    check(len(logits) == 2, "two RTMPose passes (direct and mirrored)")
    # The same logits: the decode must agree on (nearly) every joint, the
    # gated ones (NaN on both sides) included.
    xa, xb = a["kpts_2d"][:, :, :2], b["kpts_2d"][:, :, :2]
    agree = (((xa - xb).abs() < 1e-2) | (torch.isnan(xa) & torch.isnan(xb))).all(2).float()
    both = torch.isfinite(a["kpts_3d"]).all(-1) & torch.isfinite(b["kpts_3d"]).all(-1)
    d3 = (a["kpts_3d"][both] - b["kpts_3d"][both]).abs()
    log(f"small RTMPose + flip pipeline on the card's own SimCC logits, card vs CPU plain: "
        f"{agree.mean().item():.3f} of joints decoded alike (gated alike included), "
        f"{int(both.sum())} triangulated on both, max |d kpts_3d| "
        f"{d3.max().item() if d3.numel() else 0.0:.4g}")
    check(agree.mean() >= 0.95 and both.sum() >= 5
          and bool((d3 <= 1e-2 + 1e-3 * b["kpts_3d"][both].abs()).all()),
          "the SimCC decode of the card's logits agrees on the card and the CPU")


def main() -> int:
    import torch

    wall0 = time.perf_counter()

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
        # The chain as four launches: each reads its input and writes its
        # output once, so it cannot beat the sum of the blocks' byte bounds.
        four_bytes = sum(chain_bound(xs[i], blocks[i:i + 1], xs[i + 1])[3]
                         for i in range(len(blocks)))
        four_bound = four_bytes / PEAK_BYTES_S * 1e3
        log(f"  four-launch bytes bound {four_bound:.4f} ms ({four_bytes / 1e9:.4f} GB), fused "
            f"single-launch bound {bound_ms:.4f} ms by {bound_by}; kernel at "
            f"{bound_ms / chain['ms']:.3f} of the fused bound, {four_bound / chain['ms']:.3f} of "
            f"the four-launch bound")
        # One launch alone (fused_bottleneck_block): block 0 (cin -> 256 with
        # the downsample) and an identity block (256 -> 256).
        one = {}
        for i, what in ((0, "block0"), (1, "identity")):
            r = {"ms": cuda_ms(lambda: bn.fused_bottleneck_block(xs[i], blocks[i]), 20),
                 "plain_ms": cuda_ms(lambda: bn.bottleneck_block_plain(xs[i], blocks[i]), 3),
                 "library_ms": cuda_ms(lambda: chain_library(xs[i], blocks[i:i + 1]), 20)}
            r["bound_ms"], r["bound_by"], _, _ = chain_bound(xs[i], blocks[i:i + 1], xs[i + 1])
            log(f"one block ({what}) {tuple(xs[i].shape)}: kernel {r['ms']:.4f} ms "
                f"({r['bound_ms'] / r['ms']:.3f} of its bound), plain {r['plain_ms']:.4f} ms, "
                f"cuDNN {r['library_ms']:.4f} ms; bound {r['bound_ms']:.4f} ms by {r['bound_by']}")
            one[what] = r

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

    # 9-11. The fixed-order Swin layout: main path, kernels, small pipeline.
    before = os.environ.get("MC3D_SWIN_FIXED")
    os.environ["MC3D_SWIN_FIXED"] = "1"
    fixed = run_fixed_main_path(swin)
    fixed_rows_json = check_fixed_kernels(swin, fixed, dev)
    check_small_pipeline(gen, family="swin", label="fixed-order ")
    if before is None:
        del os.environ["MC3D_SWIN_FIXED"]
    else:
        os.environ["MC3D_SWIN_FIXED"] = before

    # 12. The n-view + flip-TTA main path at full width (4 cameras).
    nview = run_nview_flip_main_path(dev, gen)
    # 13. Small n-view / flip / DARK pipelines on the card against the CPU.
    check_small_pipeline(gen, family="hrnet", label="n-view + flip ", cams=NVIEW_C,
                         triangulation="nview", flip_test=True)
    check_same_maps(gen, "n-view + flip hrnet", cams=NVIEW_C, dev=dev, triangulation="nview",
                    flip_test=True)
    # The DARK decode's offsets follow the maps continuously, so the card's and
    # the CPU's bf16 models (a few bf16 steps apart) decode other sub-pixel
    # positions and no joint keeps the same peak within 1e-2 px: this
    # configuration is held on the card's own heatmaps only.
    check_same_maps(gen, "flip + DARK hrnet", dev=dev, flip_test=True, decode_mode="dark",
                    use_fused_decode=False)
    # 14. The refinement on the card.
    refine = run_refinement_phase(dev)

    # 15. The detector path at full width: HRNet-W32 behind RTMDet-m.
    paths = {"rtmdet_m": run_detector_path(dev, gen, "rtmdet_m", "top1", N_BLOCKS,
                                           full_frame=True)}
    # 16. CenterNet (top-1) and YOLOX-s (consistent selection), one block each.
    paths["centernet_w32"] = run_detector_path(dev, gen, "centernet_w32", "top1", 1)
    paths["yolox_s_consistent"] = run_detector_path(dev, gen, "yolox_s", "consistent", 1)
    # 17. The SimCC path at full width.
    paths["rtmpose_t"] = run_simcc_path(dev, gen)
    # 18. Small detector and SimCC pipelines on the card against the CPU.
    for select in ("top1", "consistent"):
        check_small_detector_pipeline(gen, dev, select)
    check_simcc_replay(gen, dev)

    # 19. Results.
    here = "multi_camera_3d_pose_estimation_tpu/ops/pallas"
    kernels = [
        {"name": "stage1_bottleneck_chain", "route": "cuda", "source": f"{PORT}/csrc/bottleneck.cu",
         "replaces": f"{here}/bottleneck.py:299 (fused_stage1_chain, 4 launches); "
                     f"{here}/bottleneck.py:150 (fused_bottleneck_block, 1 launch)",
         "launches": launches["bottleneck"], "max_abs_err": err, "ms": chain["ms"],
         "plain_ms": chain["plain_ms"], "bound_ms": bound_ms, "bound_by": bound_by,
         "library_ms": chain["library_ms"], "share_of_bound": bound_ms / chain["ms"],
         "flip_path_launches": nview["launches"]["bottleneck"],
         "four_launch_bound_ms": four_bound, "four_launch_bound_by": "bytes",
         "share_of_four_launch_bound": four_bound / chain["ms"],
         **{f"{what}_{k}": v for what, r in one.items() for k, v in r.items()},
         **{f"{what}_share_of_bound": r["bound_ms"] / r["ms"] for what, r in one.items()}},
        {"name": "heatmap_decode", "route": "cuda", "source": f"{PORT}/csrc/fused_decode.cu",
         "replaces": f"{here}/fused_decode.py:104 (fused_heatmap_decode)",
         "launches": launches["heatmap_decode"],
         "flip_path_launches": nview["launches"]["heatmap_decode"],
         "max_abs_err": dec_err, "ms": dec["ms"],
         "plain_ms": dec["plain_ms"], "bound_ms": dec_bound, "bound_by": "bytes",
         "library_ms": None},
    ]
    kernels += swin_rows + fixed_rows_json
    for row in kernels:
        row["launches_phases_15_17"] = {
            path: sum(r["launches"][c] for c in ROW_COUNTERS[row["name"]])
            for path, r in paths.items()}
    wall = time.perf_counter() - wall0
    log(f"chip_smoke wall time {wall:.1f} s")
    det = paths["rtmdet_m"]
    print(json.dumps({"kernels": kernels, "frames_per_s": fps, "swin_frames_per_s": swin["fps"],
                      "swin_fixed_frames_per_s": fixed["fps"],
                      "nview_flip_frames_per_s": nview["fps"],
                      "refine_epochs_per_s": refine["epochs_per_s"],
                      "refine_busy_share": refine["busy_share"],
                      "rtmdet_frames_per_s": det["fps"],
                      "rtmdet_full_frame_frames_per_s": det["full_frame_fps"],
                      "rtmdet_detector_cost": det["detector_cost"],
                      "rtmdet_kept_share": det["kept_share"],
                      "centernet_frames_per_s": paths["centernet_w32"]["fps"],
                      "yolox_consistent_frames_per_s": paths["yolox_s_consistent"]["fps"],
                      "simcc_frames_per_s": paths["rtmpose_t"]["fps"],
                      "simcc_joint_share": paths["rtmpose_t"]["joint_share"],
                      "wall_s": wall}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Where a block's time goes on the card: a torch.profiler trace of the
headline pipeline (HRNet-W32, input 192x256, T=256 x C=2 frames of
256x256) or, with ``--family swin``, the Swin-B pipeline (input 192x256,
T=128 x C=2 frames of 256x256, as the JAX bench's ``bench_swin``), or with
``--family rtmpose`` RTMPose-t (T=256 x C=2, as ``bench_simcc``), random
weights from a seed; ``--detector NAME`` puts a registry detector in
front (``--select top1`` or ``consistent``) and also times the detection
alone (``ShardedPosePipeline.detect``) per block.

    python -m multi_camera_3d_pose_estimation_tpu_torch.profile_block [--family swin] [--blocks 2]
    python -m multi_camera_3d_pose_estimation_tpu_torch.profile_block --detector rtmdet_m
    MC3D_SWIN_FIXED=1 python -m multi_camera_3d_pose_estimation_tpu_torch.profile_block --family swin

(``MC3D_SWIN_FIXED`` reaches the Swin model, which reads it at every
forward: ``1`` profiles the fixed-order stage layout.)  The blocks run as
the estimate command runs them: host blocks through `io.stage_blocks`
into `cli.estimate.run_pipeline_on_blocks` (two in flight).  Prints the
wall time per block, the device's busy share (the union of the device
intervals, kernels and copies on every stream, over the wall time), the
time by kernel family and the top kernels, the program's spans
(`utils.profiling.span`) per block by name: host ms, device ms (their
CUDA events) and the device's idle ms that opened while the span was the
innermost one open on the launching thread, and writes the Chrome trace
(spans included) to ``--trace`` (default ``build/profile_block.json``).
"""

from __future__ import annotations

import argparse
import bisect
import os
import subprocess
import threading
import time
from collections import defaultdict

import numpy as np
import torch

from .cli.estimate import run_pipeline_on_blocks
from .entry import build_pipeline
from .io.frames import stage_blocks
from .models.hrnet import HRNET_W32
from .models.rtmpose import RTMPOSE_T
from .models.swin import SWIN_B
from .utils.profiling import clear_spans, spans

# (config, frames per block) of each family's pipeline; input 192x256, C=2.
PIPELINES = {"hrnet": (HRNET_W32, 256), "swin": (SWIN_B, 128), "rtmpose": (RTMPOSE_T, 256)}

# Substrings of CUDA kernel names -> the family a kernel's time is filed under,
# first match wins: the port's own kernels come before the library families
# ("swin_gemm_kernel" and "swin_gemm_ln_kernel" contain "gemm").
FAMILIES = (
    ("bottleneck_kernel", "stage-1 Bottleneck kernel (ours)"),
    ("decode_kernel", "heatmap decode kernel (ours)"),
    ("swin_gemm", "Swin token GEMMs (ours)"),
    ("window_attention_kernel", "window attention kernel (ours)"),
    ("conv", "convolution (cuDNN)"), ("xmma", "convolution (cuDNN)"),
    ("implicit_convolve", "convolution (cuDNN)"), ("sm90_", "convolution/GEMM (cuDNN/cuBLAS)"),
    ("gemm", "matmul (cuBLAS)"), ("upsample", "nearest upsample"),
    ("max_pool", "max pools (SPP, peak test)"), ("sort", "sorts (top-k)"),
    ("elementwise", "elementwise (casts, BatchNorm, ReLU, adds)"),
    ("reduce", "reductions"), ("copy", "copies/layout"), ("cat", "copies/layout"),
)


def family(name: str) -> str:
    low = name.lower()
    for key, fam in FAMILIES:
        if key.lower() in low:
            return fam
    return "other"


def _is_annotation(ev) -> bool:
    """A span's mirror on the device timeline (no device work).  Some torch
    builds' events have no ``activity_type``; a span's mirror carries its
    name."""
    kind = str(ev.activity_type()).lower() if hasattr(ev, "activity_type") else ""
    return "annotation" in kind or ev.name().startswith("mc3d.")


def device_intervals(prof) -> list:
    """The union of the device's busy intervals (kernels, copies and sets on
    every stream; ns on the profiler's clock) in a finished profile."""
    spans_ = sorted((ev.start_ns(), ev.start_ns() + ev.duration_ns())
                    for ev in prof.profiler.kineto_results.events()
                    if ev.device_type() != torch.autograd.DeviceType.CPU
                    and not _is_annotation(ev))
    out: list = []
    for s, e in spans_:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def span_table(recorded: list, intervals: list, thread: int) -> dict:
    """{span name: [host ms, device ms or None, idle ms]} summed over
    ``recorded``: idle is the time of each gap between ``intervals`` filed
    under the innermost span open on ``thread`` as the gap opened ("(no
    span)" where none was)."""
    table: dict = defaultdict(lambda: [0.0, None, 0.0])
    for s in recorded:
        row = table[s.name]
        row[0] += (s.end_ns - s.start_ns) * 1e-6
        if s.device_ms is not None:
            row[1] = (row[1] or 0.0) + s.device_ms
    mine = sorted((s for s in recorded if s.thread == thread), key=lambda s: s.start_ns)
    starts = [s.start_ns for s in mine]
    for (_, opened), (closed, _) in zip(intervals, intervals[1:]):
        name = "(no span)"
        for i in range(bisect.bisect_right(starts, opened) - 1, -1, -1):
            if mine[i].end_ns > opened:
                name = mine[i].name
                break
        table[name][2] += (closed - opened) * 1e-6
    return dict(table)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--family", choices=sorted(PIPELINES), default="hrnet")
    ap.add_argument("--blocks", type=int, default=2)
    ap.add_argument("--detector", default=None, help="a DETECTOR_REGISTRY name")
    ap.add_argument("--select", choices=("top1", "consistent"), default="top1")
    ap.add_argument("--trace", default="build/profile_block.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_block needs a CUDA device")

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    cfg, T = PIPELINES[args.family]
    C, H, W = 2, 256, 256
    pipe = build_pipeline(cfg, (192, 256), (T, C, H, W, 3), device="cuda", seed=0,
                          family=args.family, detector=args.detector,
                          detector_select=args.select)
    rng = np.random.default_rng(1)
    host = rng.integers(0, 256, (T, C, H, W, 3), dtype=np.uint8)

    def blocks(n):
        return ((host, T) for _ in range(n))

    run_pipeline_on_blocks(pipe, stage_blocks(blocks(2), "cuda"), progress=False)  # warm-up
    torch.cuda.synchronize()

    n = args.blocks
    clear_spans()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run_pipeline_on_blocks(pipe, stage_blocks(blocks(n), "cuda"), progress=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    recorded = spans()
    clear_spans()

    kernels: dict[str, list] = defaultdict(lambda: [0.0, 0])
    for evt in prof.events():
        # The spans' mirrors on the device timeline are no device work.
        if evt.device_type == torch.autograd.DeviceType.CUDA and not evt.name.startswith("mc3d."):
            kernels[evt.name][0] += evt.device_time / 1e3  # us -> ms
            kernels[evt.name][1] += 1
    summed = sum(ms for ms, _ in kernels.values())
    intervals = device_intervals(prof)
    busy = sum(e - s for s, e in intervals) * 1e-6
    by_family: dict[str, float] = defaultdict(float)
    for name, (ms, _) in kernels.items():
        by_family[family(name)] += ms
    print(f"card: {card}; family {args.family}, T={T}, detector {args.detector} ({args.select})")
    if args.detector:
        frames = torch.from_numpy(host).cuda()
        pipe.detect(frames)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(args.blocks):
            pipe.detect(frames)
        torch.cuda.synchronize()
        print(f"detection alone: {(time.perf_counter() - t0) * 1e3 / args.blocks:.3f} ms/block")
    print(f"wall {wall * 1e3 / n:.3f} ms/block ({T * n / wall:.1f} frames/s); device busy "
          f"{busy / n:.3f} ms/block = {busy / (wall * 1e3):.3f} of wall (union of the device "
          f"intervals; device operations sum to {summed / n:.3f} ms/block); "
          f"{sum(c for _, c in kernels.values()) / n:.0f} device operations/block")
    for fam, ms in sorted(by_family.items(), key=lambda kv: -kv[1]):
        print(f"  {ms / n:10.3f} ms/block  {ms / summed:6.3f}  {fam}")
    print("top kernels (ms/block, launches/block):")
    for name, (ms, cnt) in sorted(kernels.items(), key=lambda kv: -kv[1][0])[:20]:
        print(f"  {ms / n:10.3f}  {cnt / n:6.0f}  {name[:110]}")
    print("spans (ms/block: host, device, device idle opened inside as the innermost span):")
    table = span_table(recorded, intervals, threading.get_ident())
    for name, (host_ms, dev_ms, idle_ms) in sorted(table.items()):
        dev = "-" if dev_ms is None else f"{dev_ms / n:10.3f}"
        print(f"  {name:28s} {host_ms / n:10.3f} {dev:>10s} {idle_ms / n:10.3f}")
    os.makedirs(os.path.dirname(args.trace) or ".", exist_ok=True)
    prof.export_chrome_trace(args.trace)


if __name__ == "__main__":
    main()

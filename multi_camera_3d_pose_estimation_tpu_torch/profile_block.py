"""Where a block's time goes on the card: a torch.profiler trace of the
headline pipeline (HRNet-W32, input 192x256, T=256 x C=2 frames of
256x256) or, with ``--family swin``, the Swin-B pipeline (input 192x256,
T=128 x C=2 frames of 256x256, as the JAX bench's ``bench_swin``), random
weights from a seed.

    python -m multi_camera_3d_pose_estimation_tpu_torch.profile_block [--family swin] [--blocks 2]

Prints the wall time per block, the device's busy share (the sum of CUDA
kernel times over the wall time; the pipeline runs on one stream), the
time by kernel family and the top kernels, and writes the Chrome trace to
``--trace`` (default ``build/profile_block.json``).
"""

from __future__ import annotations

import argparse
import os
import subprocess
import time
from collections import defaultdict

import torch

from .entry import build_pipeline
from .models.hrnet import HRNET_W32
from .models.swin import SWIN_B

# (config, frames per block) of each family's pipeline; input 192x256, C=2.
PIPELINES = {"hrnet": (HRNET_W32, 256), "swin": (SWIN_B, 128)}

# Substrings of CUDA kernel names -> the family a kernel's time is filed under,
# first match wins: the port's own kernels come before the library families
# ("swin_gemm_kernel" contains "gemm").
FAMILIES = (
    ("bottleneck_kernel", "stage-1 Bottleneck kernel (ours)"),
    ("decode_kernel", "heatmap decode kernel (ours)"),
    ("swin_gemm_kernel", "Swin token GEMMs (ours)"),
    ("window_attention_kernel", "window attention kernel (ours)"),
    ("conv", "convolution (cuDNN)"), ("xmma", "convolution (cuDNN)"),
    ("implicit_convolve", "convolution (cuDNN)"), ("sm90_", "convolution/GEMM (cuDNN/cuBLAS)"),
    ("gemm", "matmul (cuBLAS)"), ("upsample", "nearest upsample"),
    ("elementwise", "elementwise (casts, BatchNorm, ReLU, adds)"),
    ("reduce", "reductions"), ("copy", "copies/layout"), ("cat", "copies/layout"),
)


def family(name: str) -> str:
    low = name.lower()
    for key, fam in FAMILIES:
        if key.lower() in low:
            return fam
    return "other"


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--family", choices=sorted(PIPELINES), default="hrnet")
    ap.add_argument("--blocks", type=int, default=2)
    ap.add_argument("--trace", default="build/profile_block.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_block needs a CUDA device")

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    cfg, T = PIPELINES[args.family]
    C, H, W = 2, 256, 256
    pipe = build_pipeline(cfg, (192, 256), (T, C, H, W, 3), device="cuda", seed=0,
                          family=args.family)
    gen = torch.Generator().manual_seed(1)
    frames = torch.randint(0, 256, (T, C, H, W, 3), generator=gen, dtype=torch.uint8).cuda()
    pipe.run(frames)
    torch.cuda.synchronize()

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(args.blocks):
            pipe.run(frames)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    kernels: dict[str, list] = defaultdict(lambda: [0.0, 0])
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            kernels[evt.name][0] += evt.device_time / 1e3  # us -> ms
            kernels[evt.name][1] += 1
    busy = sum(ms for ms, _ in kernels.values())
    by_family: dict[str, float] = defaultdict(float)
    for name, (ms, _) in kernels.items():
        by_family[family(name)] += ms
    n = args.blocks
    print(f"card: {card}; family {args.family}, T={T}")
    print(f"wall {wall * 1e3 / n:.3f} ms/block ({T * n / wall:.1f} frames/s); device busy "
          f"{busy / n:.3f} ms/block = {busy / (wall * 1e3):.3f} of wall; "
          f"{sum(c for _, c in kernels.values()) / n:.0f} kernel launches/block")
    for fam, ms in sorted(by_family.items(), key=lambda kv: -kv[1]):
        print(f"  {ms / n:10.3f} ms/block  {ms / busy:6.3f}  {fam}")
    print("top kernels (ms/block, launches/block):")
    for name, (ms, cnt) in sorted(kernels.items(), key=lambda kv: -kv[1][0])[:20]:
        print(f"  {ms / n:10.3f}  {cnt / n:6.0f}  {name[:110]}")
    os.makedirs(os.path.dirname(args.trace) or ".", exist_ok=True)
    prof.export_chrome_trace(args.trace)


if __name__ == "__main__":
    main()

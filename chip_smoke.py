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
   the counts are read (1 crop, 4 Bottleneck, 279 ConvBN epilogue and 1
   decode launch per block, no other kernel; here and on every inference
   path below whose counts are read, no eval-mode bf16 BatchNorm takes the
   plain form, ``bn_epilogue.plain`` 0); frames/s and the output checks
   are printed;
4. each kernel against its plain PyTorch version on the card, on the inputs
   the main path gave it (the stem output of a block's crops for the
   Bottleneck chain, the block's heatmaps for the decode), with kernel,
   plain and library times (CUDA events) and the bound from this run's
   shapes; the chain also beside the bytes bound of four launches, and
   block 0 and an identity block each alone beside its own bound, with
   every timed kernel's share of its bound; the crop kernel on the
   benchmark cells' blocks, 512 and 256 bf16 640x480 frames with
   full-frame boxes: every 32nd crop and the last against the plain form
   computed in f32 and rounded once, and the block timed alone beside its
   bytes bound and the plain bf16 path;
5. the whole pipeline on the card against the plain CPU path (the one the
   CPU tests hold against the JAX package) at a small HRNet size; here and
   in phases 8, 11, 13 and 18 the CPU side crops with the plain form
   computed in f32 and rounded once (`f32_plain_crop`), the reference the
   crop kernel is held to in phase 4;
6. the Swin-B main path at full width: input 192x256, 2 cameras, blocks of
   T=128 frames of 256x256 (256 crops), every SwinBlock through the
   swin_gemm and window-attention kernels, random weights from a seed.  One
   warm-up block, then the counts are set to 0, a few blocks run and the
   counts are read (1 crop launch, 96 swin_gemm product launches, 48 of
   them after a LayerNorm row-kernel launch, 24 window-attention, 3 ConvBN
   epilogue (the head) and 1 decode launch per block); frames/s and the output checks are printed;
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
   counts are read (1 crop, 96 swin_gemm and 48 LayerNorm row-kernel
   launches, 24 row-mode attention, 0 chained-layout attention, 3 ConvBN
   epilogue and 1 decode launch per block); spies show that every stage
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
   counts are set to 0, a few blocks run and the counts are read (1 crop
   launch, 8 Bottleneck and 2 x 279 ConvBN epilogue launches, two forwards,
   and 1 decode launch per block); frames/s and the output checks are printed;
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
   the counts are set to 0, a few blocks run and the counts are read (1
   crop, 4 Bottleneck, 279 + 112 ConvBN epilogue (the pose model's and the
   detector's) and 1 decode launch per block); frames/s, the full-frame
   frames/s of the same pipeline (boxes given) and the detector's cost
   ``1 - det/full``, the share of frames whose box was kept (each kept box
   finite, inside the frame, of positive size) and the output checks;
16. one timed block each behind ``centernet_w32`` (top-1) and ``yolox_s``
   (consistent selection: top-4 candidates, a 9-frame window): launch
   counts (279 + 9 and 279 + 74 ConvBN epilogues), frames/s, kept boxes and the output checks;
17. the SimCC path at full width: RTMPose-t (``coco_rtmpose-t``) at 192x256
   on T=256 x C=2, a few timed blocks: 1 crop and 33 ConvBN epilogue
   launches per block and no other kernel,
   frames/s, the share of joints passing the 0.3 gate, the output checks;
18. small pipelines on the card against the plain CPU path: the detector
   path with top-1 and with consistent selection, the CPU path also on the
   card's own detector outputs replayed (boxes and scores equal), and end
   to end with the detector in float32 where both sides kept the same box;
   RTMPose with flip-TTA on the card's own SimCC logits replayed;
19. the artifact chain at full width: a project directory in a temporary
   folder (the synthetic 2-camera rig's ``.dat`` files and
   ``camera_names.pkl`` written by the port's ``io``, an HRNet-W32 ``.npz``
   checkpoint in the JAX package's format), the pipeline built as
   `cli.estimate_pose_from_video` builds it with the stage-1 and decode
   kernels on; 1024 frames x 2 cameras of 256x256, cycled from 3 host
   blocks made once, streamed through `io.stage_blocks` (pinned ring, copy
   stream) and `cli.run_pipeline_on_blocks` (inflight 2) in blocks of 256
   and of 64: the counts set to 0 just before each streamed run and read
   just after (4 Bottleneck, 279 ConvBN epilogue and 1 decode launch per
   block), frames/s beside
   the same pipeline in memory and phase 3, the H2D copy time (copy-stream
   events), the steady state and the one-time fill of both from runs of 1024
   and 4096 frames, and the card's busy share over a profiler window; the streamed
   artifacts equal to ``pipeline.run`` in memory bit for bit (a 1000-frame
   run with a padded last block, and blocks of 64); the cached-2D reuse
   path through `cli.estimate_pose_from_video` (no video read) against
   the streamed kpts_3d; the refine CLI (interpolation + SGD) on a
   128-frame cut, ``--device cuda`` against ``--device cpu``;
20. training at full width, the train CLI's step (`cli.train.build_trainer`):
   HRNet-W32 in bf16 with clip 1.0 -> AdamW, on batches of 192x256 crops
   that `make_crop_batch` cuts on the card (flips on) from host images of
   512x512 made from a seed (host arrays, no image files); at batch 32
   and 128 on one fixed batch each, 3 warm-up and 20 timed steps (steps/s
   and images/s on the host clock, ended by fetching every step's loss),
   the device time of 2 profiled steps over the timed step (the busy
   share), the peak memory, and no kernel launched while training (train
   mode's BatchNorm is the plain form); the
   loss falling over batch 32's 30 steps; test_tiny card against CPU at
   batch 8 (TF32 off; three losses each in float32 and float64); the
   trained weights saved with `save_checkpoint_npz`, built back with
   ``build_estimator(checkpoint=)`` and both kernels on, one headline block
   (4 Bottleneck, 279 ConvBN epilogue and 1 decode launch) equal bit for
   bit to the weights in
   memory, both kernels against their plain versions on that block's
   inputs; then Swin-B (plain attention) and RTMPose-t, 5 timed steps each
   at batch 32;
21. weights from an MMPose ``.pth``: HRNet-W32 and Swin-B files written by
   the port's MMPose mirrors (``randomize_``, HRNet's names under mmengine's
   ``backbone.`` / ``keypoint_head.``), each through the convert CLI on the
   card (``--verify --out``: the per-stage drill within 2e-3, the JAX
   package's ``.npz`` written); HRNet-W32 built from the ``.pth`` with the
   JAX keyword ``use_pallas_stage1`` as `cli.estimate` builds it, timed on
   phase 3's blocks in memory, two blocks streamed through
   `cli.run_pipeline_on_blocks` (4 Bottleneck, 279 ConvBN epilogue and 1
   decode launch per block) bit for bit equal to the ``.npz`` route, and the stage-1 chain
   against its plain version on the checkpoint's BatchNorm statistics;
   Swin-B from the ``.pth``, one block of T=128 x C=2 (96 swin_gemm, 24
   attention, 3 ConvBN epilogue and 1 decode launch) bit for bit equal to the ``.npz`` route,
   each stage's window attention against its plain version on the
   checkpoint's bias table; `cli.estimate_pose_from_video` from the
   ``.pth`` on 128 frames of phase 19's rig (raw frame stacks in place of
   videos, so no decoder's rounding enters), its artifacts equal to the
   ``.npz`` route's;
22. the mesh paths (`parallel`) as a one-rank NCCL group: first the CPU
   references in a one-rank gloo group (then destroyed), then
   `init_distributed` on a free local port (NCCL) and the headline block
   through ``ShardedPosePipeline(mesh=make_mesh(1))`` (4 Bottleneck, 279
   ConvBN epilogue and 1 decode launch per block, outputs equal to phase 3's ``mesh=None`` run bit
   for bit, frames/s); phase 6's Swin-B block the same way (96 swin_gemm,
   24 attention, 3 ConvBN epilogue and 1 decode launch, bit for bit phase
   6's pipeline);
   BASELINE config 5 (`bench.py::bench_multiclip`: 8
   clips x T=32 x 4 cameras of 256x256, 1024 crops per block) through
   `run_clips_batched` on ``make_clip_mesh(1, 1)``, a warm-up and 3 timed
   blocks (4 + 279 + 1 launches each), split equal to unsplit and to ``mesh=None``,
   4-camera frames/s; phase 20's HRNet-W32 bf16 step at batch 32 through
   ``make_train_step(mesh=make_mesh(1))``, 3 steps against ``mesh=None`` on
   the same batch and weights (bit for bit), the collectives per step and the
   step's cost against ``mesh=None`` (timed in turns); test_tiny's DP step
   and `sharded_refine_step` (30 steps on ``tests/test_parallel.py``'s
   scene) in float64, card against CPU (losses within 1e-9 relative,
   test_tiny's weights within 1e-3 lr per step); the group destroyed.
   Every collective really runs, over one rank: no multi-GPU speed is
   claimed;
23. the calibration chain (`calib`) in float64: noisy (0.2 px) projected
   corners of the synthetic 2-camera rig (a 6x9 board, square 3.0; 12 board
   poses per camera, 10 in front of both; no images: the corners are
   projected), `calibrate_camera` per camera and `stereo_calibrate` on the card,
   every LM solve under ``torch.cuda.set_sync_debug_mode("error")`` (no host
   sync inside the steps) and timed (seconds, steps/s, the last cost), each
   result against the port's own CPU run and against the truth; the rig
   written as `cli.configure.configure_cameras` writes it (origin camera at
   R = I, T = 0) and read back through ``io``; phase 3's headline block on
   the calibrated rig (4 Bottleneck, 279 ConvBN epilogue and 1 decode
   launch per block, kpts_2d
   bit for bit phase 3's, kpts_3d against the CPU-calibrated rig, frames/s);
24. the last modules: (a) `utils.trace` around 2 headline blocks
   between a lead-in and a lead-out block (the trace it wrote parsed: the
   kernels launched inside the counted blocks' ``mc3d.pipeline.run``
   spans, 4 stage-1, 279 ConvBN epilogue and 1 decode kernel per block by
   name, as the wrappers count them; outputs bit for bit phase 3's;
   frames/s under the profiler); (b) `utils.StepTimer` over the staged,
   compute and drain stages of 4 blocks streamed through `io.stage_blocks`;
   (c) `utils.profile_refinement_costs` on phase 14's scene in float32 and
   float64; (d) `utils.convert_keypoint_definition` on the card for every
   frame and camera of the headline block's kpts, to H36M and
   MPI-INF-3DHP, bit for bit the CPU result; (e) RTMDet-m and YOLOX-s
   ``.pth`` files written by the port's own MMDet mirrors, built through
   `build_detector(checkpoint=)` in float32, their raw head outputs
   against the mirror's forward on one seeded 640x640 batch (TF32 off);
   (f) ``python -m multi_camera_3d_pose_estimation_tpu_torch doctor
   --require_device`` as a subprocess: its report printed, the device row
   ``cuda × 1`` with the card's name, every kernel library, the gloo
   row ok, and the exit code 0 exactly when every required row is ok (the
   card's machine has no libav, so the media runtime row is printed as it
   is);
25. the registry's other two heatmap models at full width, random weights
   from a seed: HRNet-W48 at 288x384 input on the headline blocks (T=256 x
   C=2 of 256x256, 512 crops; a warm-up block, then 3 counted and timed
   blocks: 4 Bottleneck, 279 ConvBN epilogue and 1 decode launch per
   block), its stage-1 chain
   (4 bf16 steps), block 0 and an identity block at 96x72 (each with its
   bound) and its decode on the block's own 96x72 maps against their plain
   versions, as in phase 4, and a small W48-width pipeline card against
   CPU; then Swin-L (T=128 x C=2) chained and with ``MC3D_SWIN_FIXED=1``
   (96 swin_gemm, 48 LayerNorm row-kernel, 24 attention, 3 ConvBN epilogue
   and 1 decode launch per block), each stage's block, its four products and its attention
   (and, fixed, each whole stage) against their plain versions, as in
   phases 7 and 10; frames/s and ``torch.cuda.max_memory_allocated`` of
   each path and every kernel's time against its bound, each line beside
   the card's name and power limit;
26. accuracy from trained weights (the JAX package's accuracy drills, the
   port's ``examples``): HRNet-W32 trained by the accuracy harness (150 of
   the flagship recipe's 5000 f32 steps: batch 8, warmup+cosine; the
   CenterNet detector 100), its weights saved and built back in bf16, and
   deployed behind the detector on the harness's validation clip (16
   frames x 2 cameras of 256x256) four ways: (a) the JAX recipe's deploy
   (f32, flip-TTA, DARK, the stage-1 and decode kernels off), (b) bf16,
   flip-TTA, the default decode, those kernels off, (c) as (b) with the
   stage-1 and decode kernels, (p) as (c) with every kernel wrapper (the
   crop's and the ConvBN epilogue's included) computing its plain version
   (counts set to 0 just before each deploy and read just after, per
   flip-TTA pair: 1 crop launch in (a), (b) and (c), as on every card path,
   2 x 292 ConvBN epilogue launches in (b), 8 Bottleneck, 2 x 279 epilogue
   and 1 decode launch in (c), none in (p); the f32 CenterNet none); MPJPE raw, median and refined and
   the 2D error of each, the same
   three at random init; (c)'s mean errors within 5% of (b)'s (joint by
   joint printed), each stage-1 block and the decode against their plain
   versions on the trained weights' inputs from the clip (phase 4's
   tolerances), (c)'s 2D error against random init's printed; then the
   train drill (``examples.train_synthetic_coco``, 200 steps: trained
   error at most 1/2 of random init's) and the demo's steps 1-6
   (``examples.synthetic_demo`` at its defaults: ``.mp4`` videos written
   and read back through cv2, the estimate and refine commands; raw MPJPE
   at most twice the JAX demo's run, refined at most 5% above raw), cv2's
   Video I/O build line printed;
27. the ConvBN epilogue kernel (`ops.bn_epilogue`) on a HRNet-W32 block's
   shapes: one forward of 512 random 256x192 crops (random weights, BatchNorm
   statistics far from identity, the stage-1 kernel) with every epilogue
   call recorded (279 launches, no plain call), each call's output bit for
   bit its plain form's (up to the sign of a zero from the ReLU), the
   heatmaps equal to the same forward forced plain; the 279 calls replayed,
   kernel and plain form, timed beside their bytes bound, per distinct
   shape too, the host's time per launch, and the forward both ways;
28. one JSON line with every kernel (the phase-25 rows named ``*_w48`` and
   ``*_swin_l``; the others with their launches on phases 15-17 and 19-26;
   phase 27's row last, its ``launches`` phase 3's, with phase 6's, 9's
   and 12's beside), the script's wall time, the card's line, and the
   final ``{"ok": true, "device": {...}}`` line.

It imports nothing of JAX.  Without a CUDA device, or without the port
package beside it, it prints no result and exits 1.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import re
import subprocess
import sys
import tempfile
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
    # HRNet-W48's widths and its 64-wide stage 1, one module per stage.
    "hrnet_w48": ({"widths": (48, 96, 192, 384), "modules": (1, 1, 1, 1), "stem": 64},
                  (96, 128)),
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


def check_small_pipeline(gen, family: str, label: str = "", cams: int = 2, small: str = "",
                         **build_kw) -> None:
    """The whole pipeline on the card against the plain CPU path (the one the
    CPU tests hold against the JAX package, its crop the plain form in f32
    rounded once: `f32_plain_crop`), at a small size (``SMALL[small or
    family]``); ``build_kw`` are `build_pipeline` options (triangulation,
    flip-TTA, decode)."""
    import torch
    from multi_camera_3d_pose_estimation_tpu_torch.entry import build_pipeline

    cfg, input_size = SMALL[small or family]
    shape = (4, cams, 96, 80, 3)
    small = torch.randint(0, 256, shape, generator=gen, dtype=torch.uint8)
    res = {}
    for device in ("cuda", "cpu"):
        p = build_pipeline(cfg, input_size, shape, device=device, seed=3, family=family,
                           **build_kw)
        with f32_plain_crop() if device == "cpu" else contextlib.nullcontext():
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
    timed blocks (one crop launch and two forwards per block: 8 Bottleneck
    and 2 x 279 ConvBN epilogue launches, and 1 decode launch on the averaged
    maps; no eval-mode BatchNorm left to the plain form)."""
    import torch
    from multi_camera_3d_pose_estimation_tpu_torch.entry import build_pipeline
    from multi_camera_3d_pose_estimation_tpu_torch.models.hrnet import HRNET_W32
    from multi_camera_3d_pose_estimation_tpu_torch.ops import bn_epilogue as be
    from multi_camera_3d_pose_estimation_tpu_torch.ops import bottleneck as bn
    from multi_camera_3d_pose_estimation_tpu_torch.ops import crop_resample as cr
    from multi_camera_3d_pose_estimation_tpu_torch.ops import fused_decode as fd

    shape = (NVIEW_T, NVIEW_C, H, W, 3)
    pipe = build_pipeline(HRNET_W32, INPUT, shape, device=dev, seed=0, triangulation="nview",
                          flip_test=True)
    blocks_u8 = [torch.randint(0, 256, shape, generator=gen, dtype=torch.uint8).to(dev)
                 for _ in range(2)]
    out = pipe.run(blocks_u8[0])  # warm-up
    torch.cuda.synchronize()
    counters = {"bottleneck": bn.fused_bottleneck_block, "heatmap_decode": fd.heatmap_decode_raw,
                "crop_resample": cr.crop_resample, "bn_epilogue": be.bn_epilogue}
    for fn in counters.values():
        fn.launches = 0
    be.bn_epilogue.plain = 0
    t0 = time.perf_counter()
    for i in range(N_BLOCKS):
        out = pipe.run(blocks_u8[i % 2])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    check_no_plain_epilogue("the n-view + flip-TTA path")
    fps = NVIEW_T * N_BLOCKS / dt
    log(f"n-view + flip-TTA main path: {N_BLOCKS} blocks of {shape} in {dt:.3f} s -> "
        f"{fps:.1f} multi-camera frames/s; launches {launches}")
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched on the n-view + flip-TTA path")
    check(launches == {"bottleneck": 8 * N_BLOCKS, "heatmap_decode": N_BLOCKS,
                       "crop_resample": N_BLOCKS, "bn_epilogue": 2 * EPI_HRNET * N_BLOCKS},
          f"1 crop, 8 Bottleneck and {2 * EPI_HRNET} ConvBN epilogue (two passes) and 1 decode "
          "launch per block")
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


def run_swin_main_path(dev, gen, cfg, label: str, suffix: str = "") -> dict:
    """Swin at full width (``cfg``: `SWIN_B` or `SWIN_L`) through
    `build_pipeline(family="swin")`: a warm-up block, then N_SWIN_BLOCKS
    counted and timed blocks, and the peak memory of the timed blocks.  The
    returned dict carries ``label`` and ``suffix`` (of its kernel rows'
    names) for the checks that follow."""
    import torch
    from multi_camera_3d_pose_estimation_tpu_torch.entry import build_pipeline
    from multi_camera_3d_pose_estimation_tpu_torch.ops import bn_epilogue as be
    from multi_camera_3d_pose_estimation_tpu_torch.ops import crop_resample as cr
    from multi_camera_3d_pose_estimation_tpu_torch.ops import fused_decode as fd
    from multi_camera_3d_pose_estimation_tpu_torch.ops import swin_block as sb
    from multi_camera_3d_pose_estimation_tpu_torch.ops import window_attention as wa

    t0 = time.perf_counter()
    pipe = build_pipeline(cfg, INPUT, (SWIN_T, C, H, W, 3), device=dev, seed=0,
                          family="swin")
    blocks_u8 = [torch.randint(0, 256, (SWIN_T, C, H, W, 3), generator=gen,
                               dtype=torch.uint8).to(dev) for _ in range(2)]
    torch.cuda.synchronize()
    log(f"{label} pipeline built in {time.perf_counter() - t0:.1f} s")
    out = pipe.run(blocks_u8[0])  # warm-up
    torch.cuda.synchronize()
    counters = {"swin_gemm": sb.swin_gemm, "window_attention": wa.window_attention,
                "heatmap_decode": fd.heatmap_decode_raw, "crop_resample": cr.crop_resample,
                "bn_epilogue": be.bn_epilogue}
    for fn in counters.values():
        fn.launches = 0
    sb.swin_gemm.ln_launches = be.bn_epilogue.plain = 0
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for i in range(N_SWIN_BLOCKS):
        out = pipe.run(blocks_u8[i % 2])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = {k: fn.launches for k, fn in counters.items()}
    launches["swin_gemm_ln"] = sb.swin_gemm.ln_launches
    check_no_plain_epilogue(f"the {label} main path")
    fps = SWIN_T * N_SWIN_BLOCKS / dt
    log(f"{label} main path: {N_SWIN_BLOCKS} blocks of ({SWIN_T}, {C}, {H}, {W}, 3) in "
        f"{dt:.3f} s -> {fps:.1f} multi-camera frames/s; launches {launches}; peak memory "
        f"{peak / 2 ** 30:.2f} GiB ({held / 2 ** 30:.2f} held before)")
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched on the {label} main path")
    n_blocks = sum(cfg["depths"])
    check(launches == {"swin_gemm": 4 * n_blocks * N_SWIN_BLOCKS,
                       "swin_gemm_ln": 2 * n_blocks * N_SWIN_BLOCKS,
                       "window_attention": n_blocks * N_SWIN_BLOCKS,
                       "heatmap_decode": N_SWIN_BLOCKS, "crop_resample": N_SWIN_BLOCKS,
                       "bn_epilogue": EPI_SWIN * N_SWIN_BLOCKS},
          f"{label}: 1 crop, {4 * n_blocks} swin_gemm product launches ({2 * n_blocks} after a "
          f"LayerNorm row-kernel launch), {n_blocks} window-attention, {EPI_SWIN} ConvBN "
          "epilogue and 1 decode launch per block")
    check_outputs(out, pipe, SWIN_T)
    return {"pipe": pipe, "frames": blocks_u8[0], "blocks": blocks_u8, "fps": fps,
            "launches": launches, "peak_bytes": peak, "held_bytes": held, "label": label,
            "suffix": suffix, "config": f"{label} {INPUT[0]}x{INPUT[1]}"}


def run_fixed_main_path(swin: dict) -> dict:
    """The Swin main path of `run_swin_main_path` (same pipeline, weights
    and frames) with ``MC3D_SWIN_FIXED=1``, which the caller has set: a
    warm-up block, then N_SWIN_BLOCKS counted and timed blocks, with spies
    on the stage and chained-block entry points the model calls, and the
    peak memory of the timed blocks."""
    import torch
    from multi_camera_3d_pose_estimation_tpu_torch.ops import bn_epilogue as be
    from multi_camera_3d_pose_estimation_tpu_torch.ops import crop_resample as cr
    from multi_camera_3d_pose_estimation_tpu_torch.ops import fused_decode as fd
    from multi_camera_3d_pose_estimation_tpu_torch.ops import swin_block as sb
    from multi_camera_3d_pose_estimation_tpu_torch.ops import window_attention as wa

    pipe, blocks_u8 = swin["pipe"], swin["blocks"]
    out = pipe.run(blocks_u8[0])  # warm-up
    torch.cuda.synchronize()
    counters = {"swin_gemm": sb.swin_gemm, "window_attention_rows": wa.window_attention_rows,
                "window_attention": wa.window_attention, "heatmap_decode": fd.heatmap_decode_raw,
                "crop_resample": cr.crop_resample, "bn_epilogue": be.bn_epilogue}
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
    sb.swin_gemm.ln_launches = be.bn_epilogue.plain = 0
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for i in range(N_SWIN_BLOCKS):
        out = pipe.run(blocks_u8[i % 2])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    for name, fn in originals.items():
        setattr(sb, name, fn)
    launches = {k: fn.launches for k, fn in counters.items()}
    launches["swin_gemm_ln"] = sb.swin_gemm.ln_launches
    check_no_plain_epilogue(f"the {swin['label']} fixed-order main path")
    fps = SWIN_T * N_SWIN_BLOCKS / dt
    label, cfg = swin["label"], pipe.estimator.model.cfg
    log(f"{label} fixed-order main path: {N_SWIN_BLOCKS} blocks of ({SWIN_T}, {C}, {H}, {W}, 3) "
        f"in {dt:.3f} s -> {fps:.1f} multi-camera frames/s (chained layout {swin['fps']:.1f}); "
        f"launches {launches}; stages run fixed {calls['fused_swin_stage_fixed']}, chained "
        f"blocks {calls['fused_swin_block']}; peak memory {peak / 2 ** 30:.2f} GiB "
        f"({held / 2 ** 30:.2f} held before)")
    n_blocks = sum(cfg["depths"])
    check(launches == {"swin_gemm": 4 * n_blocks * N_SWIN_BLOCKS,
                       "swin_gemm_ln": 2 * n_blocks * N_SWIN_BLOCKS,
                       "window_attention_rows": n_blocks * N_SWIN_BLOCKS,
                       "window_attention": 0, "heatmap_decode": N_SWIN_BLOCKS,
                       "crop_resample": N_SWIN_BLOCKS, "bn_epilogue": EPI_SWIN * N_SWIN_BLOCKS},
          f"{label}: 1 crop, {4 * n_blocks} swin_gemm product and {2 * n_blocks} LayerNorm row-kernel "
          f"launches, {n_blocks} row-mode attention, 0 chained attention, {EPI_SWIN} ConvBN "
          "epilogue and 1 decode launch per block on the fixed-order path")
    widths = [cfg["embed"] * 2 ** i for i in range(len(cfg["depths"]))]
    check(calls["fused_swin_stage_fixed"] == widths * N_SWIN_BLOCKS,
          f"{label}: every stage ran fused_swin_stage_fixed")
    check(not calls["fused_swin_block"], f"{label}: the chained fused_swin_block ran no time")
    check_outputs(out, pipe, SWIN_T)
    return {"fps": fps, "launches": launches, "peak_bytes": peak, "held_bytes": held}


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
            log(f"{swin['label']} stage {i} block 1 (x{depth}) tokens {tuple(x.shape)} "
                f"({real} real), map {Hc}x{Wc}: "
                f"max |kernel - plain| {err:.6g} (tolerance {SWIN_BLOCK_REL_TOL} x {scale:.4g}), "
                f"share > 1 bf16 step of the token's largest {row_share:.3g} (tolerance "
                f"{SWIN_ROW_FLIP_SHARE}), of their own binade {share:.3g}; kernel "
                f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms; bound {bound:.4f} ms by {by}")
            check(err <= SWIN_BLOCK_REL_TOL * scale and row_share <= SWIN_ROW_FLIP_SHARE,
                  f"{swin['label']} stage {i}: the block kernels agree with their plain version")
            stages.append(dict(t, depth=depth, err=err, bound=bound, by=by))
            calls = capture_products(lambda: sb.fused_swin_block(x, p, **args))
            products.append((depth, check_products(calls, real,
                                                   f"{swin['label']} stage {i}")))

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
            check(aerr <= ATTN_REL_TOL * ascale, f"{swin['label']} stage {i}: the window "
                  "attention kernel agrees with its plain version")
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
                (strong, mask), controls,
                f"{swin['label']} stage {i}: the window attention kernel")
            attn_stages.append(dict(ta, depth=depth, err=aerr, bias_err=berr, bound=abound,
                                    by=aby))
            del add

    here = "multi_camera_3d_pose_estimation_tpu/ops/pallas"
    launches = swin["launches"]
    pk = products_keys(products)
    log(f"{swin['label']} totals per forward (sum over stages of depth x one block): blocks kernel "
        f"{total(stages, 'ms'):.4f} ms, bound {total(stages, 'bound'):.4f} ms; token products "
        f"{pk['products_ms']:.4f} ms, cuBLAS products alone {pk['products_library_ms']:.4f} ms, "
        f"bound {pk['products_bound_ms']:.4f} ms; attention kernel "
        f"{total(attn_stages, 'ms'):.4f} ms, SDPA {total(attn_stages, 'library_ms'):.4f} ms, "
        f"bound {total(attn_stages, 'bound'):.4f} ms, host {total(attn_stages, 'host_ms'):.4f} ms")
    return [
        {"name": f"swin_block{swin['suffix']}", "config": swin["config"], "route": "cuda",
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
        {"name": f"window_attention{swin['suffix']}", "config": swin["config"], "route": "cuda",
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
            log(f"{swin['label']} fixed stage {i} block 1 (x{depth}) tokens {tuple(x.shape)} "
                f"(P={P}, {real} real), map {Hc}x{Wc}: max |kernel - plain| {err:.6g} (tolerance "
                f"{SWIN_BLOCK_REL_TOL} x {scale:.4g}), share > 1 bf16 step of the token's largest "
                f"{row_share:.3g}; against the chained block after fixed_reverse {cerr:.6g} "
                f"(tolerance {SWIN_BLOCK_REL_TOL} x {cscale:.4g}), share {crow_share:.3g} "
                f"(tolerance {SWIN_ROW_FLIP_SHARE}); kernel {t['ms']:.4f} ms, chained block "
                f"{t['chained_ms']:.4f} ms, plain {t['plain_ms']:.4f} ms; bound {bound:.4f} ms "
                f"by {bby}")
            what = f"{swin['label']} fixed stage {i}"
            check(err <= SWIN_BLOCK_REL_TOL * scale and row_share <= SWIN_ROW_FLIP_SHARE,
                  f"{what}: the block kernels agree with their plain version")
            check(cerr <= SWIN_BLOCK_REL_TOL * cscale and crow_share <= SWIN_ROW_FLIP_SHARE,
                  f"{what}: the fixed-order block agrees with the chained block")
            blocks.append(dict(t, depth=depth, err=err, bound=bound, by=bby))
            calls = capture_products(lambda: sb.fused_swin_block_fixed(x, p, **kw))
            products.append((depth, check_products(calls, real, what)))

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
                  f"{what}: the row-mode attention agrees with its plain version")
            strong = torch.randn(p["bias"].shape, generator=bias_gen).to(dev)
            identity = torch.arange(rows.numel(), dtype=torch.int32, device=dev)
            controls = {"the identity row table": (strong, mask, identity),
                        "no mask": (strong, None, rows),
                        "the next head's bias": (strong.roll(1, 0), mask, rows)}
            berr = check_trained_bias(
                lambda b_, m_, r_=rows: wa.window_attention_rows(qkv, b_, m_, heads, r_, P),
                lambda b_, m_, r_=rows: wa.window_attention_rows_plain(qkv, b_, m_, heads, r_, P),
                (strong, mask), controls, f"{what}: the row-mode attention")
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
            check(torch.equal(ks, one_by_one), f"{what}: the stage is its blocks")
            check(same_chained, f"{what}: the stage equals the chained-layout stage")
            check(serr <= depth * SWIN_BLOCK_REL_TOL * sscale,
                  f"{what}: the stage agrees with its plain version")
            stages.append(dict(ts, depth=1, err=serr, bound=depth * bound, by=bby))

    here = "multi_camera_3d_pose_estimation_tpu/ops/pallas"
    launches = fixed["launches"]["swin_gemm"] + fixed["launches"]["window_attention_rows"]
    ln_launches = fixed["launches"]["swin_gemm_ln"]
    pk = products_keys(products)
    log(f"fixed-order {swin['label']} totals per forward (sum over stages of depth x one "
        f"block): blocks kernel {total(blocks, 'ms'):.4f} ms (chained layout {total(blocks, 'chained_ms'):.4f}),"
        f" token products {pk['products_ms']:.4f} ms (cuBLAS products alone "
        f"{pk['products_library_ms']:.4f}, bound {pk['products_bound_ms']:.4f}),"
        f" bound {total(blocks, 'bound'):.4f} ms; stages kernel {total(stages, 'ms'):.4f} ms; "
        f"row-mode attention {total(attns, 'ms'):.4f} ms (chained layout "
        f"{total(attns, 'chained_ms'):.4f}), SDPA {total(attns, 'library_ms'):.4f} ms, bound "
        f"{total(attns, 'bound'):.4f} ms, host {total(attns, 'host_ms'):.4f} ms")
    src = f"{PORT}/csrc/swin_gemm.cu + {PORT}/csrc/window_attention.cu (row mode)"
    return [
        {"name": f"swin_block_fixed{swin['suffix']}", "config": swin["config"], "route": "cuda",
         "source": src,
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
        {"name": f"swin_stage_fixed{swin['suffix']}", "config": swin["config"], "route": "cuda",
         "source": src,
         "replaces": f"{here}/swin_block.py:379 (fused_swin_stage_fixed, pallas_call :452)",
         "launches": launches, "ln_launches": ln_launches,
         "max_abs_err": max(r["err"] for r in stages),
         "ms": total(stages, "ms"), "plain_ms": total(stages, "plain_ms"),
         "bound_ms": total(stages, "bound"), "bound_by": rows_bound_by(stages), "library_ms": None,
         "per_forward": f"{len(cfg['depths'])} stages of the fixed-order main path, each whole"},
    ]


@contextlib.contextmanager
def fixed_layout():
    """``MC3D_SWIN_FIXED=1`` inside the block (the Swin model reads it at
    every forward), the variable as it was after."""
    before = os.environ.get("MC3D_SWIN_FIXED")
    os.environ["MC3D_SWIN_FIXED"] = "1"
    try:
        yield
    finally:
        if before is None:
            del os.environ["MC3D_SWIN_FIXED"]
        else:
            os.environ["MC3D_SWIN_FIXED"] = before


@contextlib.contextmanager
def f32_plain_crop():
    """Inside the block the crop wrapper computes the plain form in f32 and
    rounds it once to the frames' dtype, on the CPU and in place of the
    card's kernel (no launch, no count): the reference phase 4 and the
    card tests hold the kernel to.  A CPU pipeline's bf16 plain form rounds
    its products at three points, the kernel once."""
    from multi_camera_3d_pose_estimation_tpu_torch.ops import crop_resample as cr

    saved = cr.crop_and_normalize, cr._launch
    plain = saved[0]

    def f32_once(frames, bboxes, input_size, bbox_padding=1.25):
        crops, scale, offset = plain(frames.float(), bboxes, input_size, bbox_padding)
        return crops.to(frames.dtype), scale, offset

    cr.crop_and_normalize = cr._launch = f32_once
    try:
        yield
    finally:
        cr.crop_and_normalize, cr._launch = saved


def kernel_counters() -> dict:
    """Every kernel wrapper of the port, by counter name."""
    from multi_camera_3d_pose_estimation_tpu_torch.ops import bn_epilogue as be
    from multi_camera_3d_pose_estimation_tpu_torch.ops import bottleneck as bn
    from multi_camera_3d_pose_estimation_tpu_torch.ops import crop_resample as cr
    from multi_camera_3d_pose_estimation_tpu_torch.ops import fused_decode as fd
    from multi_camera_3d_pose_estimation_tpu_torch.ops import swin_block as sb
    from multi_camera_3d_pose_estimation_tpu_torch.ops import window_attention as wa

    return {"bottleneck": bn.fused_bottleneck_block, "heatmap_decode": fd.heatmap_decode_raw,
            "swin_gemm": sb.swin_gemm, "window_attention": wa.window_attention,
            "window_attention_rows": wa.window_attention_rows,
            "crop_resample": cr.crop_resample, "bn_epilogue": be.bn_epilogue}


def check_no_plain_epilogue(what: str) -> None:
    """No eval-mode bf16 BatchNorm of ``what`` took the plain form since
    ``bn_epilogue.plain`` was set to 0: each was one epilogue launch."""
    from multi_camera_3d_pose_estimation_tpu_torch.ops import bn_epilogue as be

    check(be.bn_epilogue.plain == 0, f"{what}: {be.bn_epilogue.plain} eval-mode BatchNorm "
          "calls took the plain form in place of the ConvBN epilogue kernel")


# ConvBN epilogue launches per forward (`ops.bn_epilogue`): one per BatchNorm
# of the model, each called once (counted through the plain form on the CPU),
# but the 13 of HRNet's stage-1 chain where the Bottleneck kernel runs it.
EPI_HRNET = 279  # HRNet-W32 and -W48, with the stage-1 kernel
EPI_HRNET_PLAIN_STAGE1 = 292
EPI_SMALL_128 = 90  # test_small_128, with the stage-1 kernel
EPI_SMALL_128_PLAIN_STAGE1 = 103
EPI_SWIN = 3  # the head's deconvs (Swin-B and Swin-L)
EPI_RTMPOSE_T = 33
EPI_DETECTOR = {"rtmdet_m": 112, "centernet_w32": 9, "yolox_s": 74}  # bf16 on the card


# The counters whose launches make up each row of the results line.
ROW_COUNTERS = {"stage1_bottleneck_chain": ("bottleneck",), "heatmap_decode": ("heatmap_decode",),
                "swin_block": ("swin_gemm", "window_attention"),
                "window_attention": ("window_attention",),
                "swin_block_fixed": ("swin_gemm", "window_attention_rows"),
                "swin_stage_fixed": ("swin_gemm", "window_attention_rows"),
                "crop_resample": ("crop_resample",), "bn_epilogue": ("bn_epilogue",)}


def timed_blocks(pipe, blocks, n: int, bboxes=None):
    """``n`` blocks through ``pipe.run`` with every count set to 0 just
    before: (the last output, seconds, every counter's launches); no
    eval-mode bf16 BatchNorm took the plain form."""
    import torch
    from multi_camera_3d_pose_estimation_tpu_torch.ops import bn_epilogue as be

    counters = kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    be.bn_epilogue.plain = 0
    t0 = time.perf_counter()
    for i in range(n):
        out = pipe.run(blocks[i % len(blocks)], bboxes)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    check_no_plain_epilogue("the timed blocks")
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
    timed blocks (4 Bottleneck, the pose model's and the detector's ConvBN
    epilogues and 1 decode launch per block); with
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
    epi = EPI_HRNET + EPI_DETECTOR[det_name]
    check(launches == dict(bottleneck=4 * n_blocks, heatmap_decode=n_blocks, swin_gemm=0,
                           window_attention=0, window_attention_rows=0,
                           crop_resample=n_blocks, bn_epilogue=epi * n_blocks),
          f"{what}: 1 crop, 4 Bottleneck, {epi} ConvBN epilogue and 1 decode launch per block, "
          "no other kernel")
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
    a warm-up block, then N_BLOCKS counted and timed blocks (1 crop and 33
    ConvBN epilogue launches per block, no other kernel)."""
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
    check(launches == dict(bottleneck=0, heatmap_decode=0, swin_gemm=0, window_attention=0,
                           window_attention_rows=0, crop_resample=N_BLOCKS,
                           bn_epilogue=EPI_RTMPOSE_T * N_BLOCKS),
          f"the SimCC path launches 1 crop and {EPI_RTMPOSE_T} ConvBN epilogue kernels per "
          "block and no other kernel")
    check_outputs(out, pipe, T)
    return {"fps": fps, "launches": launches, "joint_share": share}


DET_SMALL_SHAPE = (4, 2, 64, 96, 3)  # RTMDet needs H, W multiples of 32


def check_small_detector_pipeline(gen, dev, select: str) -> None:
    """The small HRNet pipeline behind ``test_rtmdet_micro`` on the card
    against the CPU path: (1) the CPU path on the card's own (bf16)
    detector outputs replayed: the same boxes and scores, and the outputs
    as phase 5 holds them (the CPU crop the plain form in f32); (2)
    end to end with the detector in float32 on
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
    with f32_plain_crop():
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
        with f32_plain_crop() if d == "cpu" else contextlib.nullcontext():
            res[d] = ({k: v.float().cpu() for k, v in p.run(small).items()},
                      p.detect(small)[0].cpu())
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


# The artifact chain (phase 19).
STREAM_FRAMES, TAIL_FRAMES = 1024, 1000  # streamed frames; a run whose last block is padded
LONG_FRAMES = 4096  # a longer run: with STREAM_FRAMES, separates the steady state from the fill
STREAM_BLOCKS = (256, 64)  # the headline block and the CLI's default block_size
N_SOURCE = 3  # distinct host blocks of T frames, made once and cycled
REFINE_CUT = 128  # frames of the artifacts the refine CLI runs on
# The cached-2D reuse path triangulates the f32 kpts_2d artifact in float64;
# the streamed kpts_3d came from the pipeline's f32 top-2 DLT.  Per joint,
# r = |reuse - streamed| / max(|X|, 1): the median r <= 1e-5, at least 95%
# of joints r <= 1e-4 and every joint r <= 0.1.  Random-weight peaks give
# some near-parallel ray pairs, whose f32 solve is ill-conditioned (the CPU
# at a small size: median 4.6e-7, 0.9945 of joints under 1e-4, largest
# 1.4e-4); a wrong camera, camera order or method gives r of order 1.
REUSE_MEDIAN, REUSE_RTOL, REUSE_SHARE, REUSE_MAX = 1e-5, 1e-4, 0.95, 0.1
SGD_MPJPE_TOL = 1.0  # card against CPU, in the trajectory's units (mm)


def device_busy_ms(prof) -> float:
    """Union of the device intervals (kernels and copies, on every stream)
    in a profiler window, in ms."""
    import torch

    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for s, e in spans:
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy / 1e3


def host_blocks(sources, block: int, n_frames: int):
    """``(block, n_valid)`` host blocks of ``n_frames`` frames cut from the
    cycled ``sources`` (each T frames); the last one zero-padded."""
    import numpy as np

    for start in range(0, n_frames, block):
        n = min(block, n_frames - start)
        src = sources[(start // T) % len(sources)]
        off = start % T
        if n == block:
            yield src[off:off + block], n
        else:
            out = np.zeros((block,) + src.shape[1:], np.uint8)
            out[:n] = src[off:off + n]
            yield out, n


def in_memory(pipe, blocks, dev):
    """``pipe.run`` on each host block moved to the card beforehand, the
    valid frames' results concatenated (numpy)."""
    import numpy as np
    import torch

    outs = [(pipe.run(torch.from_numpy(np.ascontiguousarray(b)).to(dev)), n) for b, n in blocks]
    return tuple(np.concatenate([o[k][:n].cpu().numpy() for o, n in outs])
                 for k in ("kpts_2d", "heatmaps_2d", "kpts_3d"))


def run_refine_cli(args: list) -> tuple[float, list]:
    """`cli.refine.main(args)`: (seconds, the lines it printed)."""
    import contextlib
    import io

    from multi_camera_3d_pose_estimation_tpu_torch.cli import refine

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        refine.main(args)
    return time.perf_counter() - t0, buf.getvalue().splitlines()


def run_artifact_chain(dev, phase3_fps: float) -> dict:
    """The user's chain on the card: a project directory (the synthetic
    2-camera rig's .dat files and camera_names.pkl, an HRNet-W32 .npz
    checkpoint), the pipeline built as `cli.estimate_pose_from_video` builds
    it (stage-1 and decode kernels on), 1024 frames streamed through
    `io.stage_blocks` and `cli.run_pipeline_on_blocks` at blocks of 256 and
    64, the cached-2D reuse path through the real entry, and the refine CLI
    card against CPU.  ``conf_threshold=-inf`` keeps every joint (as
    ``tests/test_e2e.py``'s -1 does for its random weights; HRNet-W32's
    random maps can peak below -1): the refinement then has a finite
    trajectory to move (a NaN joint makes its window's costs NaN).  Each
    streamed run follows a warm-up run of the same length, so that the
    pinned ring and the copy stream's device blocks come from the caching
    allocators as in a long run."""
    import importlib.util
    import tempfile

    import numpy as np
    import torch
    from multi_camera_3d_pose_estimation_tpu_torch.cli.estimate import (
        build_estimate_pipeline, estimate_pose_from_video, run_pipeline_on_blocks)
    from multi_camera_3d_pose_estimation_tpu_torch.entry import synthetic_rig
    from multi_camera_3d_pose_estimation_tpu_torch.io import (
        save_camera_intrinsics, save_camera_names, save_extrinsic_calibration_parameters,
        stage_blocks, write_recording_log)
    from multi_camera_3d_pose_estimation_tpu_torch.models import convert, registry

    res = {"phase3_fps": phase3_fps}
    with tempfile.TemporaryDirectory() as tmp:
        # 1. The project directory.
        rig = synthetic_rig(C, H, W)
        names = [f"cam{c}" for c in range(C)]
        for c, name in enumerate(names):
            save_camera_intrinsics(rig["K"][c], rig["dist"][c], name, root_path=tmp)
            save_extrinsic_calibration_parameters(rig["R"][c], rig["T"][c], name, root_dir=tmp)
        save_camera_names(dict(enumerate(names)), names[0], tmp)
        ckpt = os.path.join(tmp, "coco_hrnet_w32.npz")
        convert.save_checkpoint_npz(
            registry.build_estimator("coco_hrnet_w32", device="cpu", seed=0).model, ckpt, "hrnet")
        log(f"artifact chain: project in a temporary directory, checkpoint "
            f"{os.path.getsize(ckpt) / 1e6:.1f} MB")

        # 2. The pipeline, as estimate_pose_from_video builds it.
        t0 = time.perf_counter()
        pipe = build_estimate_pipeline(
            tmp, pose_estimation_model="coco_hrnet_w32", checkpoint=ckpt,
            conf_threshold=float("-inf"),
            estimator_kwargs={"use_fused_stage1": True, "use_fused_decode": True}, device=dev)
        for k in ("K", "R", "T", "dist"):  # the .dat files round-trip the rig's f32 values
            check(torch.equal(pipe.cam_stack[k].cpu(), torch.as_tensor(rig[k])),
                  f"the camera files give the rig's {k}")
        log(f"  pipeline from the project and checkpoint in {time.perf_counter() - t0:.1f} s")

        # 3. Stream the frames.
        rng = np.random.default_rng(7)
        sources = [rng.integers(0, 256, (T, C, H, W, 3), dtype=np.uint8) for _ in range(N_SOURCE)]
        counters = kernel_counters()
        res["launches"], streamed = {}, {}
        for bs in STREAM_BLOCKS:
            n_blocks = STREAM_FRAMES // bs
            run_pipeline_on_blocks(pipe, stage_blocks(host_blocks(sources, bs, STREAM_FRAMES),
                                                      dev), progress=False)  # warm-up
            dev_blocks = [torch.from_numpy(np.ascontiguousarray(b)).to(dev)
                          for b, _ in host_blocks(sources, bs, 2 * bs)]

            def in_memory_s(n_frames):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for i in range(n_frames // bs):
                    out = pipe.run(dev_blocks[i % 2])
                out["kpts_3d"].cpu()
                return time.perf_counter() - t0

            mem = {n: in_memory_s(n) for n in (STREAM_FRAMES, LONG_FRAMES)}
            del dev_blocks
            for fn in counters.values():
                fn.launches = 0
            events = []
            t0 = time.perf_counter()
            streamed[bs] = run_pipeline_on_blocks(
                pipe, stage_blocks(host_blocks(sources, bs, STREAM_FRAMES), dev,
                                   copy_events=events), progress=False, inflight=2)
            dt = time.perf_counter() - t0
            launches = {k: fn.launches for k, fn in counters.items()}
            t0 = time.perf_counter()
            run_pipeline_on_blocks(pipe, stage_blocks(host_blocks(sources, bs, LONG_FRAMES), dev),
                                   progress=False)
            st = {STREAM_FRAMES: dt, LONG_FRAMES: time.perf_counter() - t0}
            # t(n) = fill + n x per-block time: the steady state and the one-time
            # fill (for the stream: the first block's host copy and H2D).
            steady, fill = {}, {}
            for what, t in (("streamed", st), ("in memory", mem)):
                per_block = (t[LONG_FRAMES] - t[STREAM_FRAMES]) * bs / (LONG_FRAMES - STREAM_FRAMES)
                steady[what] = bs / per_block
                fill[what] = (t[STREAM_FRAMES] - n_blocks * per_block) * 1e3
            copy_ms = [s.elapsed_time(e) for s, e in events]
            fps, mem_fps = STREAM_FRAMES / dt, STREAM_FRAMES / mem[STREAM_FRAMES]
            res[f"block_{bs}"] = {
                "fps": fps, "in_memory_fps": mem_fps, "steady_fps": steady["streamed"],
                "in_memory_steady_fps": steady["in memory"], "fill_ms": fill["streamed"],
                "in_memory_fill_ms": fill["in memory"], "h2d_ms_per_block": float(np.mean(copy_ms)),
                "h2d_GB_s": bs * C * H * W * 3 / np.mean(copy_ms) / 1e6}
            res["launches"][bs] = launches
            log(f"  streamed {STREAM_FRAMES} frames in blocks of {bs} ({n_blocks} blocks, "
                f"inflight 2) in {dt:.3f} s -> {fps:.1f} frames/s; the same pipeline in memory "
                f"{mem_fps:.1f} frames/s (phase 3: {phase3_fps:.1f}); H2D copy "
                f"{np.mean(copy_ms):.3f} ms per block ({res[f'block_{bs}']['h2d_GB_s']:.2f} "
                f"GB/s, copy-stream events); launches {launches}")
            log(f"    from {STREAM_FRAMES} and {LONG_FRAMES} frames: steady state streamed "
                f"{steady['streamed']:.1f} frames/s, in memory {steady['in memory']:.1f} "
                f"({steady['streamed'] / steady['in memory']:.4f}); fill streamed "
                f"{fill['streamed']:.3f} ms, in memory {fill['in memory']:.3f} ms")
            check(launches == dict(bottleneck=4 * n_blocks, heatmap_decode=n_blocks, swin_gemm=0,
                                   window_attention=0, window_attention_rows=0,
                                   crop_resample=n_blocks, bn_epilogue=EPI_HRNET * n_blocks),
                  f"blocks of {bs}: 1 crop, 4 Bottleneck, {EPI_HRNET} ConvBN epilogue and 1 "
                  "decode launch per streamed block")
            check(all(a.shape[0] == STREAM_FRAMES for a in streamed[bs]), "every frame returned")
            acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
            window = 4 * bs if bs < T else 2 * bs
            with torch.profiler.profile(activities=acts) as prof:
                t0 = time.perf_counter()
                run_pipeline_on_blocks(pipe, stage_blocks(host_blocks(sources, bs, window), dev),
                                       progress=False)
                wall = time.perf_counter() - t0
            busy = device_busy_ms(prof)
            res[f"block_{bs}"]["busy_share"] = busy / (wall * 1e3)
            log(f"    profiler window ({window} frames streamed): wall {wall * 1e3:.3f} ms, "
                f"device busy (union over streams) {busy:.3f} ms = "
                f"{busy / (wall * 1e3):.4f} of wall")

        # 4. The streamed artifacts against pipeline.run in memory, bit for bit.
        big, small = STREAM_BLOCKS
        for bs, n_frames in ((big, TAIL_FRAMES), (small, STREAM_FRAMES)):
            blocks = list(host_blocks(sources, bs, n_frames))
            got = run_pipeline_on_blocks(pipe, stage_blocks(iter(blocks), dev), progress=False)
            want = in_memory(pipe, blocks, dev)
            same = all(a.shape == b.shape == (n_frames,) + a.shape[1:]
                       and np.array_equal(a, b, equal_nan=True) for a, b in zip(got, want))
            log(f"  {n_frames} frames in blocks of {bs} (last block {blocks[-1][1]} valid): "
                f"streamed artifacts equal pipeline.run in memory bit for bit: {same}")
            check(same, f"the streamed artifacts (blocks of {bs}) equal pipeline.run in memory")
        k2, hm, k3 = streamed[big]
        log(f"  artifacts kpts_2d {k2.shape} {k2.dtype}, heatmaps_2d {hm.shape}, kpts_3d "
            f"{k3.shape}; finite: Gaussians {np.isfinite(hm).mean():.4f}, kpts_3d joints "
            f"{np.isfinite(k3).all(-1).mean():.4f}")
        check(k2.shape == (STREAM_FRAMES, 17, 3, C) and hm.shape == (STREAM_FRAMES, C, 17, 6)
              and k3.shape == (STREAM_FRAMES, 17, 3), "artifact shapes")
        check(np.isfinite(hm).all() and np.isfinite(k3).all(),
              "finite Gaussians, and every joint triangulated with the gate off")
        check(all(np.array_equal(a, b, equal_nan=True) for a, b in zip(streamed[big],
                                                                   streamed[small])),
              f"blocks of {big} and of {small} give the same artifacts")

        # 5. The cached-2D reuse path through the real entry.
        run_dir = os.path.join(tmp, "recordings")
        os.makedirs(run_dir)
        np.save(os.path.join(run_dir, "kpts_2d.npy"), k2)
        np.save(os.path.join(run_dir, "heatmaps_2d.npy"), hm)
        videos = [os.path.join(run_dir, f"{n}_synced.mp4") for n in names]  # never written
        t0 = time.perf_counter()
        _, _, k3_reuse = estimate_pose_from_video(videos, project_dir=tmp, save_dir=run_dir,
                                                  device=dev)
        dt = time.perf_counter() - t0
        rel = (np.abs(k3_reuse - k3) / np.maximum(np.abs(k3_reuse).max(-1, keepdims=True), 1))
        rel = rel.max(-1)
        share = float((rel <= REUSE_RTOL).mean())
        res.update(reuse_max_rel=float(rel.max()), reuse_share=share)
        log(f"  cached-2D reuse (no video read, {dt:.3f} s): float64 kpts_3d {k3_reuse.shape} "
            f"against the streamed f32 kpts_3d: r = |d| / max(|X|, 1) median "
            f"{np.median(rel):.3g} (tolerance {REUSE_MEDIAN}), max {rel.max():.3g} (tolerance "
            f"{REUSE_MAX}), share r <= "
            f"{REUSE_RTOL} {share:.5f} (tolerance {REUSE_SHARE})")
        check(not any(os.path.exists(v) for v in videos) and k3_reuse.dtype == np.float64
              and np.median(rel) <= REUSE_MEDIAN and rel.max() <= REUSE_MAX
              and share >= REUSE_SHARE,
              "the reuse path's kpts_3d agrees with the streamed")

        # 6. The refine CLI on a 128-frame cut, card against CPU.
        cut = os.path.join(tmp, "cut")
        os.makedirs(cut)
        np.save(os.path.join(cut, "kpts_3d.npy"), k3[:REFINE_CUT])
        np.save(os.path.join(cut, "heatmaps_2d.npy"), hm[:REFINE_CUT])

        def card_vs_cpu(tag: str, extra: list) -> tuple:
            out = {}
            for label, d in (("card", str(dev)), ("cpu", "cpu")):
                save = os.path.join(cut, tag + label)
                os.makedirs(save)
                secs, lines = run_refine_cli([
                    "--run_path", cut, "--save_path", save,
                    "--refinement_types", "linear_interpolation", "SGD",
                    "--kpts_3d", os.path.join(cut, "kpts_3d.npy"),
                    "--heatmaps_2d", os.path.join(cut, "heatmaps_2d.npy"),
                    "--extrinsic_params_dir", os.path.join(tmp, "extrinsic_camera_parameters"),
                    "--intrinsic_params_dir", os.path.join(tmp, "intrinsic_camera_parameters"),
                    "--ignore_body_lengths", "--device", d, *extra])
                out[label] = [np.load(os.path.join(save, f)) for f in
                              ("kpts_3d_linear_interpolation.npy", "kpts_3d_SGD.npy")]
                for line in lines:
                    if line.startswith(("auto-gate", "saving SGD")):
                        log(f"  refine {tag}--device {d} ({secs:.2f} s): {line}")
            li_same = np.array_equal(out["card"][0], out["cpu"][0], equal_nan=True)
            mpjpe = float(np.linalg.norm(out["card"][1] - out["cpu"][1], axis=-1).mean())
            moved = float(np.linalg.norm(out["cpu"][1] - k3[:REFINE_CUT], axis=-1).mean())
            log(f"  refine {tag}card vs CPU: interpolation equal {li_same}; SGD MPJPE "
                f"{mpjpe:.4g} (tolerance {SGD_MPJPE_TOL}; SGD moved the trajectory {moved:.4g})")
            check(li_same and np.isfinite(out["card"][1]).all() and mpjpe <= SGD_MPJPE_TOL,
                  f"the refine CLI ({tag or 'defaults'}) on the card agrees with the CPU")
            return out, mpjpe, moved

        out, mpjpe, moved = card_vs_cpu("", [])
        res.update(refine_mpjpe=mpjpe, refine_moved=moved)
        if importlib.util.find_spec("yaml") is None:
            log("  PyYAML absent: no YAML passed and no recording log written")
            return res
        import yaml

        params = os.path.join(cut, "params.yaml")
        with open(params, "w") as f:
            yaml.safe_dump({"SGD": {"auto_gate": False, "max_iter": 300}}, f)
        _, mpjpe, moved = card_vs_cpu("gate-off-", ["--refinement_params_yaml", params])
        res.update(refine_gate_off_mpjpe=mpjpe, refine_gate_off_moved=moved)
        write_recording_log(cut, videos, "coco_hrnet_w32", "full_frame")
        save = os.path.join(cut, "from_log")
        os.makedirs(save)
        run_refine_cli(["--run_path", cut, "--save_path", save, "--device", str(dev)])
        backfilled = np.load(os.path.join(save, "kpts_3d_linear_interpolation.npy"))
        check(np.array_equal(backfilled, out["card"][0], equal_nan=True),
              "the recording-log backfill gives the same interpolation")
        log("  PyYAML present: SGD with the gate off and the recording-log backfill ran")
    return res


# Phase 20: training at full width (the train CLI's default configuration).
TRAIN_BATCHES = (32, 128)  # the CLI's default batch, and four times it
TRAIN_WARMUP, TRAIN_STEPS, TRAIN_PROFILED = 3, 20, 2
TRAIN_FALL_STEPS = 30  # batch 32's steps, one fixed batch: the last 5 losses below the first 5
TRAIN_OTHER_STEPS = 5  # Swin-B and RTMPose-t, after 2 warm-up steps
TRAIN_SRC = 512  # the source images' size (the CLI's --image_size default)
TRAIN_LOSS_RTOL = 1e-4  # card against CPU, test_tiny: float64, and float32's first step
# float32's three steps: the first, then the limits of tests/test_torch_train_cli.py at the
# same batch of 8 (rounding decides the direction of many of Adam's first steps, see there)
TRAIN_F32_RTOL = (TRAIN_LOSS_RTOL, 1e-2, 3e-2)
TRAIN_CHECK_BATCH = 8


def train_images(n: int, seed: int):
    """``n`` host images (n, 512, 512, 3) uint8 from a seed, each with a box
    and 17 visible keypoints inside it (host arrays, no image files)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (n, TRAIN_SRC, TRAIN_SRC, 3), dtype=np.uint8)
    x0 = rng.uniform(0, 200, (n, 2))
    size = rng.uniform(150, 300, (n, 2))
    boxes = np.concatenate([x0, np.minimum(x0 + size, TRAIN_SRC)], -1).astype(np.float32)
    kps = (x0[:, None] + rng.uniform(0.05, 0.95, (n, 17, 2)) * (boxes[:, None, 2:] - x0[:, None]))
    return images, boxes, kps.astype(np.float32), np.full((n, 17), 2.0, np.float32)


def train_batches(trainer, B: int, n_batches: int, seed: int, dev):
    """``n_batches`` batches of ``B`` through `make_crop_batch` on the card
    (flips drawn from ``torch.Generator(seed)``, as the CLI's batcher); and
    the host ms per batch (the H2D copy of the uint8 images included)."""
    import torch
    from multi_camera_3d_pose_estimation_tpu_torch.training import make_crop_batch

    images, boxes, kps, vis = train_images(B * n_batches, seed)
    flips = torch.Generator().manual_seed(seed)
    out, ms = [], []
    for i in range(n_batches):
        s = slice(i * B, (i + 1) * B)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out.append(make_crop_batch(images[s], boxes[s], kps[s], vis[s],
                                   input_size=trainer.spec["input_size"], target=trainer.target,
                                   flip_generator=flips, device=dev))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return out, sum(ms[1:]) / max(len(ms) - 1, 1) if len(ms) > 1 else ms[0]


def train_steps(trainer, state, batches, n: int):
    """``n`` steps with every kernel count set to 0 just before: (state, the
    losses (host), seconds on the host clock ended by the fetch of every
    step's loss, every counter's launches)."""
    import torch

    counters = kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    losses = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n):
        state, loss = trainer.step_fn(state, batches[i % len(batches)])
        losses.append(loss)
    host = torch.stack(losses).float().cpu()
    dt = time.perf_counter() - t0
    return state, host.tolist(), dt, {k: fn.launches for k, fn in counters.items()}


def check_train_card_vs_cpu(dev) -> dict:
    """test_tiny (batch 8, the same weights and batch) card against CPU, with
    TF32 off: float32 (the three losses within TRAIN_F32_RTOL) and float64
    (all three within TRAIN_LOSS_RTOL)."""
    import numpy as np
    import torch
    from multi_camera_3d_pose_estimation_tpu_torch.cli.train import build_trainer
    from multi_camera_3d_pose_estimation_tpu_torch.training import make_crop_batch

    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        images, boxes, kps, vis = train_images(TRAIN_CHECK_BATCH, 7)
        batch = make_crop_batch(images, boxes, kps, vis, input_size=(32, 64),
                                flip_mask=torch.arange(TRAIN_CHECK_BATCH) % 2 == 0, device="cpu")
        res = {}
        for dtype in ("float32", "float64"):
            losses = {}
            for d in (dev, "cpu"):
                tr = build_trainer("test_tiny", dtype, 5e-4, seed=0, device=d)
                tr.model.to(getattr(torch, dtype))
                b = {k: v.to(d, getattr(torch, dtype)) for k, v in batch.items()}
                st = tr.init_fn()
                out = []
                for _ in range(3):
                    st, loss = tr.step_fn(st, b)
                    out.append(loss.item())
                losses[str(d)] = np.array(out)
            a, c = losses[str(dev)], losses["cpu"]
            rel = np.abs(a - c) / np.abs(c)
            log(f"  test_tiny {dtype} card vs CPU, 3 steps: losses card {a.tolist()}, CPU "
                f"{c.tolist()}, relative gaps {rel.tolist()}")
            limit = TRAIN_LOSS_RTOL if dtype == "float64" else np.array(TRAIN_F32_RTOL)
            check(bool(np.all(rel <= limit)),
                  f"test_tiny {dtype} training on the card agrees with the CPU")
            res[dtype] = rel.tolist()
        return res
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


def check_bottleneck_blocks(est, block, dev, label: str = "", boxes=None):
    """Each stage-1 Bottleneck block through the kernel against its plain
    version, on the inputs that ``est`` (the stage-1 and decode kernels on)
    gives the chain for ``block`` (T, C, H, W, 3) uint8 on the card, cropped
    to ``boxes`` (T·C, 4) (the full frames where None).
    Returns (the stem output x (T·C, h, w, 64) NHWC, each block's input on
    the plain path and the chain's plain output, the heatmaps with the
    kernels on, each block's max |kernel - plain|)."""
    import torch
    from multi_camera_3d_pose_estimation_tpu_torch.models.topdown import preprocess_crops
    from multi_camera_3d_pose_estimation_tpu_torch.ops import bottleneck as bn

    T_, C_, H_, W_ = block.shape[:4]
    model, blocks = est.model, est.fused_stage1.blocks
    frames = block.reshape(T_ * C_, H_, W_, 3).to(torch.bfloat16) / 255.0
    if boxes is None:
        boxes = torch.tensor([0.0, 0.0, W_, H_], device=dev).expand(T_ * C_, 4)
    errs = []
    with torch.inference_mode():
        crops, _, _ = preprocess_crops(frames, boxes, est.input_size)
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
            log(f"{label}block {i} {tuple(xs[i].shape)}: max |kernel - plain| {berr:.6g} "
                f"(tolerance {BLOCK_REL_TOL} x {bscale:.4g}), share > 1 bf16 step {share:.3g} "
                f"(tolerance {BLOCK_FLIP_SHARE})")
            check(berr <= BLOCK_REL_TOL * bscale and share <= BLOCK_FLIP_SHARE,
                  f"{label}Bottleneck block {i}: the kernel agrees with its plain version")
            errs.append(berr)
    return x, xs, heat, errs


def check_decode(est, heat, label: str = ""):
    """The decode kernel against its plain version on ``heat`` (the maps
    the pipeline decodes).  Returns (the maps flattened (N, h·w), the
    kernel's raw (N, 12) result, the max error of what the decode returns:
    moments and xy in heatmap px, score)."""
    import torch
    from multi_camera_3d_pose_estimation_tpu_torch.ops import fused_decode as fd

    with torch.inference_mode():
        flat = heat.reshape(-1, heat.shape[-2] * heat.shape[-1]).contiguous()
        hw = heat.shape[-1]
        kd = fd.heatmap_decode_raw(flat, hw, est.heatmap_threshold)
        pd = fd.heatmap_decode_raw_plain(flat, hw, est.heatmap_threshold)
        torch.cuda.synchronize()
        derr = ((kd - pd).abs() / (pd.abs() + 1)).max().item()
        dec_err = max((a - b).abs().max().item() for a, b in
                      zip(fd.finish_decode(kd, hw), fd.finish_decode(pd, hw)))
        argmax_same = torch.equal(kd[:, 7], pd[:, 7]) and torch.equal(kd[:, 6], pd[:, 6])
    log(f"{label}decode {tuple(flat.shape)}: raw sums max |kernel - plain| / (|plain| + 1) "
        f"{derr:.3g} (tolerance {DECODE_TOL}); peak and argmax identical: {argmax_same}; "
        f"decoded moments/xy/score max |kernel - plain| {dec_err:.3g}")
    check(derr <= DECODE_TOL and argmax_same,
          f"the {label}decode kernel agrees with its plain version")
    return flat, kd, dec_err


# The benchmark cells' crops per block (2 cameras of 640x480 x 256 or 128
# frames), full-frame boxes, 256x192 crops.
CROP_BLOCKS = {"w32_vga_c2_b256": 512, "swinb_vga_c2_b128": 256}
CROP_STRIDE = 32  # every 32nd crop and the last held against the f32 plain form


def check_crop_kernel(dev, launches: dict) -> list:
    """The crop kernel (`ops.crop_resample`) on each benchmark cell's block
    of bf16 VGA frames: every CROP_STRIDE-th crop and the last against the
    plain form computed in f32 and rounded once (one bf16 step of the
    largest output, under 1% of outputs more than one step of their own
    binade off), scale and offset bit for bit the CPU's, and the whole
    block timed alone (CUDA events) beside its bytes bound and the plain
    bf16 path (`crop_and_normalize`, the crop before the kernel).  Rows for
    the results line, with ``launches`` (the main path's counts)."""
    import torch
    from multi_camera_3d_pose_estimation_tpu_torch.ops import crop_resample as cr

    rows = []
    for cell, B in CROP_BLOCKS.items():
        gen = torch.Generator(device=dev).manual_seed(B)
        frames = torch.rand((B, 480, 640, 3), generator=gen, device=dev).to(torch.bfloat16)
        boxes = torch.tensor([[0.0, 0.0, 640.0, 480.0]], device=dev).expand(B, 4).contiguous()
        idx = torch.tensor(sorted({*range(0, B, CROP_STRIDE), B - 1}), device=dev)
        with torch.inference_mode():
            crops, scale, offset = cr.crop_resample(frames, boxes, INPUT)
            ref = torch.cat([cr.crop_and_normalize(frames[i:i + 1].float(), boxes[i:i + 1],
                                                   INPUT)[0] for i in idx.tolist()])
            cpu = cr.crop_and_normalize(frames[idx].cpu().float(), boxes[idx].cpu(), INPUT)
            torch.cuda.synchronize()
            err = (crops[idx].float() - ref.to(torch.bfloat16).float()).abs().max().item()
            flips = bf16_steps_apart(crops[idx], ref)
            same_geometry = (torch.equal(scale[idx].cpu(), cpu[1])
                             and torch.equal(offset[idx].cpu(), cpu[2]))
            ms = cuda_ms(lambda: cr.crop_resample(frames, boxes, INPUT), 20)
            plain_ms = cuda_ms(lambda: cr.crop_and_normalize(frames, boxes, INPUT), 3)
        in_w, in_h = INPUT
        nbytes = B * ((480 * 640 + in_h * in_w) * 3 * frames.element_size() + 32)
        bound_ms = nbytes / PEAK_BYTES_S * 1e3
        log(f"crop kernel, {cell}: {B} bf16 640x480 frames -> {in_h}x{in_w}, {len(idx)} crops "
            f"(every {CROP_STRIDE}th and the last) checked: max |kernel - plain f32| {err:.3g} "
            f"(largest output {ref.abs().max().item():.3g}), share more than one bf16 step "
            f"{flips:.2g}; scale and offset the CPU's: {same_geometry}; kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms by bytes ({nbytes / 1e6:.1f} "
            f"MB): {bound_ms / ms:.1%} of the bound")
        check(err <= 2.0 ** -8 * ref.abs().max().item() and flips < 0.01 and same_geometry,
              f"the crop kernel agrees with the plain form on {cell}'s block")
        rows.append({"name": "crop_resample", "config": cell, "route": "cuda",
                     "source": f"{PORT}/csrc/crop_resample.cu", "replaces": None,
                     "launches": launches["crop_resample"], "crops": B,
                     "crops_checked": len(idx), "max_abs_err": err, "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes",
                     "library_ms": None, "share_of_bound": bound_ms / ms})
        del frames, crops, ref
        torch.cuda.empty_cache()
    return rows


EPILOGUE_CROPS = 512  # a w32_vga_c2_b256 block: 256 frames x 2 cameras


def run_bn_epilogue_phase(dev, card: str, launches: dict) -> list:
    """Phase 27: the ConvBN epilogue kernel (`ops.bn_epilogue`) on a
    HRNet-W32 block's ConvBN shapes.  HRNet-W32 with random weights and
    BatchNorm statistics far from identity, one forward of EPILOGUE_CROPS
    random 256x192 crops with the stage-1 kernel, every epilogue call
    recorded: 279 launches and no plain call, each call's output against the
    plain form on its own inputs (bit for bit up to the sign of a zero), the
    heatmaps against the same forward forced plain (equal); then the 279
    recorded calls replayed, kernel and plain form, timed with CUDA events
    beside their bytes bound (the map read, the residual read, the output
    written), per distinct shape too; the forward timed both ways.  One row
    for the results line (``launches``: phase 3's main path counts)."""
    import torch
    from multi_camera_3d_pose_estimation_tpu_torch.models.batchnorm import BatchNorm
    from multi_camera_3d_pose_estimation_tpu_torch.models.hrnet import HRNET_W32
    from multi_camera_3d_pose_estimation_tpu_torch.models.registry import build_model
    from multi_camera_3d_pose_estimation_tpu_torch.ops import bn_epilogue as be
    from multi_camera_3d_pose_estimation_tpu_torch.ops.bottleneck import make_fused_stage1

    model = build_model("hrnet", HRNET_W32, dev, seed=0)
    gen = torch.Generator().manual_seed(27)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                n = m.num_features
                m.running_mean.copy_(0.2 * torch.randn(n, generator=gen))
                m.running_var.copy_(0.5 + torch.rand(n, generator=gen))
                m.weight.copy_(0.5 + torch.rand(n, generator=gen))
                m.bias.copy_(0.2 * torch.randn(n, generator=gen))
    stage1 = make_fused_stage1(model)
    in_w, in_h = INPUT
    x = torch.randn(EPILOGUE_CROPS, 3, in_h, in_w, generator=gen).to(dev)
    launch, calls, main_launches = be._launch, [], launches["bn_epilogue"]

    def record(*args):
        out = launch(*args)
        calls.append((args, out))
        return out

    def forced_plain(y, mean, mul, bias, residual, upsample, relu, lay):
        return be.bn_epilogue_plain(y, mean, mul, bias, torch.bfloat16, residual, upsample, relu)

    with torch.inference_mode():
        model(x, fused_stage1=stage1)  # warm-up: cuDNN's plans, the kernel's build
        torch.cuda.synchronize()
        before, plain = be.bn_epilogue.launches, be.bn_epilogue.plain
        be._launch = record
        try:
            heat = model(x, fused_stage1=stage1)
        finally:
            be._launch = launch
        torch.cuda.synchronize()
        n_launch, n_plain = be.bn_epilogue.launches - before, be.bn_epilogue.plain - plain
        check(n_launch == len(calls) == 279 and n_plain == 0,
              f"279 epilogue launches and no plain call a W32 forward (got {n_launch}, "
              f"{n_plain})")
        worst = 0
        for args, out in calls:
            ref = forced_plain(*args)
            worst += int(not torch.equal(out, ref))
        check(worst == 0, f"every epilogue call equals its plain form ({worst} differ)")
        be._launch = forced_plain
        try:
            heat_plain = model(x, fused_stage1=stage1)
            model_plain_ms = cuda_ms(lambda: model(x, fused_stage1=stage1), 3)
        finally:
            be._launch = launch
        check(torch.equal(heat, heat_plain), "W32 heatmaps: kernel routed = forced plain")
        model_ms = cuda_ms(lambda: model(x, fused_stage1=stage1), 5)

        def nbytes(args):
            y, residual, upsample = args[0], args[4], args[5]
            out = y.numel() << (2 * upsample)
            return 2 * (y.numel() + out + (out if residual is not None else 0))

        def replay(fn):
            for a, _ in calls:
                fn(*a)  # each output freed at once, as in the forward

        total = sum(nbytes(a) for a, _ in calls)
        bound_ms = total / PEAK_BYTES_S * 1e3
        ms = cuda_ms(lambda: replay(launch), 10)
        plain_ms = cuda_ms(lambda: replay(forced_plain), 3)
        host = host_ms(lambda: replay(launch), 5) / len(calls)
        log(f"ConvBN epilogue kernel, HRNet-W32 {in_w}x{in_h}, {EPILOGUE_CROPS} crops: "
            f"{n_launch} launches, every output the plain form's, heatmaps equal; all 279: "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms by bytes "
            f"({total / 1e9:.2f} GB): {bound_ms / ms:.1%} of the bound; host "
            f"{host * 1e3:.1f} us a launch; forward {model_ms:.2f} ms, forced plain "
            f"{model_plain_ms:.2f} ms; {card}")
        shapes = {}
        for args, _ in calls:
            y, residual, upsample, relu, lay = args[0], args[4], args[5], args[6], args[7]
            key = (tuple(y.shape), upsample, residual is not None, relu, lay)
            shapes.setdefault(key, []).append(args)
        for key, group in sorted(shapes.items(), key=lambda kv: -nbytes(kv[1][0]) * len(kv[1])):
            one = cuda_ms(lambda: launch(*group[0]), 20)
            b = nbytes(group[0]) / PEAK_BYTES_S * 1e3
            log(f"  y {key[0]}, upsample {key[1]}, residual {key[2]}, relu {key[3]}, {key[4]}: "
                f"x{len(group)}, {one * 1e3:.1f} us each, bound {b * 1e3:.1f} us ({b / one:.1%})")
    del calls
    torch.cuda.empty_cache()
    return [{"name": "bn_epilogue", "config": f"HRNet-W32 {in_w}x{in_h}",
             "route": "cuda", "source": f"{PORT}/csrc/bn_epilogue.cu", "replaces": None,
             "launches": main_launches, "launches_phase_27": n_launch,
             "crops": EPILOGUE_CROPS, "ms": ms, "plain_ms": plain_ms,
             "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": None,
             "share_of_bound": bound_ms / ms, "host_us_per_launch": host * 1e3,
             "model_ms": model_ms, "model_plain_ms": model_plain_ms}]


def run_hrnet_main_path(dev, cfg, input_size, blocks_u8, label: str) -> dict:
    """HRNet at full width through `build_pipeline` on ``blocks_u8`` (T, C,
    H, W, 3) uint8 on the card, crops of ``input_size`` (w, h): a warm-up
    block, then N_BLOCKS blocks with every count set to 0 just before and
    read just after (1 crop, 4 Bottleneck, 279 ConvBN epilogue and 1 decode
    launch per block, no other kernel; no eval-mode BatchNorm left to the
    plain form), frames/s, the output checks and the peak memory of the timed
    blocks (``held_bytes`` allocated before them)."""
    import torch
    from multi_camera_3d_pose_estimation_tpu_torch.entry import build_pipeline

    shape = tuple(blocks_u8[0].shape)
    t0 = time.perf_counter()
    pipe = build_pipeline(cfg, input_size, shape, device=dev, seed=0)
    torch.cuda.synchronize()
    log(f"{label} pipeline built in {time.perf_counter() - t0:.1f} s")
    pipe.run(blocks_u8[0])  # warm-up
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out, dt, launches = timed_blocks(pipe, blocks_u8, N_BLOCKS)
    peak = torch.cuda.max_memory_allocated()
    fps = shape[0] * N_BLOCKS / dt
    log(f"{label} main path: {N_BLOCKS} blocks of {shape}, crops {input_size[0]}x"
        f"{input_size[1]}, in {dt:.3f} s -> {fps:.1f} multi-camera frames/s; launches "
        f"{launches}; peak memory {peak / 2 ** 30:.2f} GiB ({held / 2 ** 30:.2f} held before)")
    for name in ("bottleneck", "heatmap_decode", "crop_resample", "bn_epilogue"):
        check(launches[name] > 0, f"kernel {name} was not launched on the {label} main path")
    check(launches == dict(bottleneck=4 * N_BLOCKS, heatmap_decode=N_BLOCKS, swin_gemm=0,
                           window_attention=0, window_attention_rows=0,
                           crop_resample=N_BLOCKS, bn_epilogue=EPI_HRNET * N_BLOCKS),
          f"{label}: 1 crop, 4 Bottleneck, {EPI_HRNET} ConvBN epilogue and 1 decode launch per "
          "block, no other kernel")
    check_outputs(out, pipe, shape[0], shape[1])
    return {"pipe": pipe, "fps": fps, "launches": launches, "peak_bytes": peak,
            "held_bytes": held}


def check_hrnet_kernels(est, block, dev, launches: dict, config: str, label: str = "",
                        suffix: str = "") -> list:
    """The stage-1 and decode kernels of an HRNet pipeline's estimator
    ``est`` against their plain versions on the inputs its main path gave
    them for ``block`` (the stem output for the Bottleneck chain, the
    block's heatmaps for the decode), with kernel, plain and library times
    (CUDA events) and the bounds from this run's shapes: the chain beside
    the bytes bound of four launches, and block 0 and an identity block each
    alone beside its own bound.  Returns the two kernel rows of the results
    line (named with ``suffix``; ``launches``: the main path's counts)."""
    import torch
    from multi_camera_3d_pose_estimation_tpu_torch.ops import bottleneck as bn
    from multi_camera_3d_pose_estimation_tpu_torch.ops import fused_decode as fd

    blocks = est.fused_stage1.blocks
    x, xs, heat, _ = check_bottleneck_blocks(est, block, dev, label)
    flat, kd, dec_err = check_decode(est, heat, label)
    hw = heat.shape[-1]
    with torch.inference_mode():
        kern = bn.fused_stage1_chain(x, blocks)
        plain = xs[-1]
        lib = chain_library(x, blocks).permute(0, 2, 3, 1)
        torch.cuda.synchronize()
        err = (kern.float() - plain.float()).abs().max().item()
        scale = plain.float().abs().max().item()
        lib_err = (lib.float() - plain.float()).abs().max().item()
        log(f"{label}stage-1 chain {tuple(x.shape)} -> {tuple(kern.shape)}: max |kernel - plain| "
            f"{err:.6g} (tolerance {CHAIN_REL_TOL} x {scale:.4g}), share > 1 bf16 step "
            f"{bf16_steps_apart(kern, plain):.3g}; cuDNN yardstick: max |cuDNN - plain| "
            f"{lib_err:.6g}, share {bf16_steps_apart(lib, plain):.3g}")
        check(err <= CHAIN_REL_TOL * scale,
              f"the {label}Bottleneck chain agrees with its plain version")
        del lib
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
            log(f"{label}one block ({what}) {tuple(xs[i].shape)}: kernel {r['ms']:.4f} ms "
                f"({r['bound_ms'] / r['ms']:.3f} of its bound), plain {r['plain_ms']:.4f} ms, "
                f"cuDNN {r['library_ms']:.4f} ms; bound {r['bound_ms']:.4f} ms by {r['bound_by']}")
            one[what] = r

        dec = {"ms": cuda_ms(lambda: fd.heatmap_decode_raw(flat, hw, est.heatmap_threshold), 50),
               "plain_ms": cuda_ms(lambda: fd.heatmap_decode_raw_plain(flat, hw,
                                                                       est.heatmap_threshold), 20)}
        dec_bytes = flat.numel() * 4 + kd.numel() * 4
        dec_bound = dec_bytes / PEAK_BYTES_S * 1e3
        log(f"  {label}decode kernel {dec['ms']:.4f} ms, plain {dec['plain_ms']:.4f} ms; bound "
            f"{dec_bound:.4f} ms by bytes ({dec_bytes / 1e6:.2f} MB)")
    maps = [flat.shape[0], flat.shape[1] // hw, hw]
    del x, xs, heat, flat, kd, kern, plain
    torch.cuda.empty_cache()
    here = "multi_camera_3d_pose_estimation_tpu/ops/pallas"
    return [
        {"name": f"stage1_bottleneck_chain{suffix}", "config": config, "route": "cuda",
         "source": f"{PORT}/csrc/bottleneck.cu",
         "replaces": f"{here}/bottleneck.py:299 (fused_stage1_chain, 4 launches); "
                     f"{here}/bottleneck.py:150 (fused_bottleneck_block, 1 launch)",
         "launches": launches["bottleneck"], "max_abs_err": err, "ms": chain["ms"],
         "plain_ms": chain["plain_ms"], "bound_ms": bound_ms, "bound_by": bound_by,
         "library_ms": chain["library_ms"], "share_of_bound": bound_ms / chain["ms"],
         "four_launch_bound_ms": four_bound, "four_launch_bound_by": "bytes",
         "share_of_four_launch_bound": four_bound / chain["ms"],
         **{f"{what}_{k}": v for what, r in one.items() for k, v in r.items()},
         **{f"{what}_share_of_bound": r["bound_ms"] / r["ms"] for what, r in one.items()}},
        {"name": f"heatmap_decode{suffix}", "config": config, "route": "cuda",
         "source": f"{PORT}/csrc/fused_decode.cu",
         "replaces": f"{here}/fused_decode.py:104 (fused_heatmap_decode)",
         "launches": launches["heatmap_decode"], "max_abs_err": dec_err, "ms": dec["ms"],
         "plain_ms": dec["plain_ms"], "bound_ms": dec_bound, "bound_by": "bytes",
         "library_ms": None, "maps": maps},
    ]


def top_device_ops(prof, k: int = 8) -> list:
    """The ``k`` device ops (kernels, copies) of a profiler window with the
    most time: [(name cut to 70 characters, ms, count)], summed over the
    window."""
    import torch

    tot = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            ms, n = tot.get(e.name, (0.0, 0))
            tot[e.name] = (ms + (e.time_range.end - e.time_range.start) / 1e3, n + 1)
    top = sorted(tot.items(), key=lambda kv: -kv[1][0])[:k]
    return [(name[:70], round(ms, 3), n) for name, (ms, n) in top]


def run_training_phase(dev, block) -> dict:
    """Phase 20: the train CLI's step (`cli.train.build_trainer`) at full
    width on batches from `make_crop_batch`, then the trained weights
    deployed through their ``.npz`` checkpoint on the headline ``block``."""
    import tempfile

    import numpy as np
    import torch
    from multi_camera_3d_pose_estimation_tpu_torch.cli.train import build_trainer
    from multi_camera_3d_pose_estimation_tpu_torch.entry import synthetic_rig
    from multi_camera_3d_pose_estimation_tpu_torch.models.convert import save_checkpoint_npz
    from multi_camera_3d_pose_estimation_tpu_torch.models.registry import build_estimator
    from multi_camera_3d_pose_estimation_tpu_torch.models.topdown import TopDownEstimator
    from multi_camera_3d_pose_estimation_tpu_torch.parallel.pipeline import ShardedPosePipeline

    res = {"launches": {}}
    t0 = time.perf_counter()
    trainer = build_trainer("coco_hrnet_w32", "bfloat16", 5e-4, seed=0, device=dev)
    state = trainer.init_fn()
    log(f"HRNet-W32 trainer built in {time.perf_counter() - t0:.1f} s (bf16 activations, "
        f"clip 1.0 -> AdamW lr 5e-4 wd 1e-4, flips on)")
    for B in TRAIN_BATCHES:
        # One fixed batch (the step's time does not depend on its data); at
        # batch 32 all TRAIN_FALL_STEPS steps' losses are kept.
        batches, batch_ms = train_batches(trainer, B, 1, seed=B, dev=dev)
        torch.cuda.reset_peak_memory_stats()
        state, seen, _, _ = train_steps(trainer, state, batches, TRAIN_WARMUP)
        state, losses, dt, launches = train_steps(trainer, state, batches, TRAIN_STEPS)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        torch.cuda.synchronize()
        w0 = time.perf_counter()
        with torch.profiler.profile(activities=acts) as prof:
            state, profiled, _, _ = train_steps(trainer, state, batches, TRAIN_PROFILED)
        wall = time.perf_counter() - w0
        busy = device_busy_ms(prof)
        n_ops = sum(1 for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA) / TRAIN_PROFILED
        sps = TRAIN_STEPS / dt
        step_ms = dt / TRAIN_STEPS * 1e3
        device_ms = busy / TRAIN_PROFILED
        r = {"steps_per_s": sps, "images_per_s": sps * B, "step_ms": step_ms,
             "device_ms_per_step": device_ms, "busy_share": device_ms / step_ms,
             "busy_share_profiled": busy / (wall * 1e3), "peak_gib": peak,
             "device_ops_per_step": n_ops, "make_crop_batch_ms": batch_ms,
             "last_loss": losses[-1], "top_device_ops_per_step": top_device_ops(prof)}
        log(f"  batch {B}: {TRAIN_STEPS} steps in {dt:.3f} s -> {sps:.3f} steps/s, "
            f"{sps * B:.1f} images/s ({step_ms:.2f} ms per step); device {device_ms:.2f} ms "
            f"per step ({n_ops:.0f} device ops, {TRAIN_PROFILED} profiled steps): busy share "
            f"{r['busy_share']:.4f} of the unprofiled step ({r['busy_share_profiled']:.4f} of "
            f"the profiled window, {wall * 1e3:.1f} ms); peak memory {peak:.2f} GiB; "
            f"make_crop_batch {batch_ms:.2f} ms per batch (H2D of the uint8 images included); "
            f"losses {losses[0]:.5f} .. {losses[-1]:.5f}; kernel launches {launches}")
        for name, ms, n in r["top_device_ops_per_step"]:
            log(f"    {ms / TRAIN_PROFILED:9.3f} ms per step in {n // TRAIN_PROFILED:5d} x {name}")
        check(all(n == 0 for n in launches.values()), "training launches no inference kernel")
        check(all(math.isfinite(x) for x in losses), "finite training losses")
        res[f"b{B}"] = r
        res["launches"][f"train_b{B}"] = launches
        if B == TRAIN_BATCHES[0]:
            more = TRAIN_FALL_STEPS - TRAIN_WARMUP - TRAIN_STEPS - TRAIN_PROFILED
            state, tail, _, _ = train_steps(trainer, state, batches, more)
            seen = seen + losses + profiled + tail
            first, last = sum(seen[:5]) / 5, sum(seen[-5:]) / 5
            log(f"  one fixed batch of {B}, {len(seen)} steps: mean loss of the first 5 "
                f"{first:.6f}, of the last 5 {last:.6f}")
            check(len(seen) == TRAIN_FALL_STEPS and last < first,
                  "the loss falls on one fixed batch")
            res["fixed_batch_first5"], res["fixed_batch_last5"] = first, last
        del batches

    # Card against CPU at a small size.
    res["card_vs_cpu_rel"] = check_train_card_vs_cpu(dev)

    # Deploy: the trained weights through their .npz, with both kernels on.
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "hrnet_w32_trained.npz")
        save_checkpoint_npz(trainer.model, path, "hrnet")
        kw = dict(use_fused_stage1=True, use_fused_decode=True, device=dev)
        est = build_estimator("coco_hrnet_w32", checkpoint=path, **kw)
    rig = synthetic_rig(C, H, W)
    pipe = ShardedPosePipeline(est, rig, device=dev)
    mem = ShardedPosePipeline(TopDownEstimator(trainer.model, input_size=INPUT, **kw), rig,
                              device=dev)
    pipe.run(block)  # warm-up
    out, dt, launches = timed_blocks(pipe, [block], 1)
    ref = mem.run(block)
    torch.cuda.synchronize()
    equal = {k: np.array_equal(out[k].cpu().numpy(), ref[k].cpu().numpy(), equal_nan=True)
             for k in out}
    log(f"  deployed through the .npz: one block ({T}, {C}, {H}, {W}, 3) in {dt:.3f} s, "
        f"launches {launches}; outputs equal bit for bit to the weights in memory: {equal}")
    check(launches["bottleneck"] == 4 and launches["heatmap_decode"] == 1
          and launches["bn_epilogue"] == EPI_HRNET,
          f"4 Bottleneck, {EPI_HRNET} ConvBN epilogue and 1 decode launch on the deployed block")
    check(all(equal.values()), "the deployed checkpoint gives the in-memory weights' outputs")
    check_outputs(out, pipe, T)
    _, _, heat, errs = check_bottleneck_blocks(est, block, dev, "deployed ")
    _, _, dec_err = check_decode(est, heat, "deployed ")
    res["deploy"] = {"bottleneck_max_abs_err": max(errs), "decode_max_abs_err": dec_err}
    res["launches"]["deploy_block"] = launches
    del trainer, state, pipe, mem, est
    torch.cuda.empty_cache()

    # The other families at batch 32.
    for name in ("coco_swin-b", "coco_rtmpose-t"):
        tr = build_trainer(name, "bfloat16", 5e-4, seed=0, device=dev)
        st = tr.init_fn()
        batches, _ = train_batches(tr, 32, 2, seed=5, dev=dev)
        torch.cuda.reset_peak_memory_stats()
        st, _, _, _ = train_steps(tr, st, batches, 2)
        st, losses, dt, launches = train_steps(tr, st, batches, TRAIN_OTHER_STEPS)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        sps = TRAIN_OTHER_STEPS / dt
        log(f"  {name} ({tr.target}, batch 32): {TRAIN_OTHER_STEPS} steps in {dt:.3f} s -> "
            f"{sps * 32:.1f} images/s ({dt / TRAIN_OTHER_STEPS * 1e3:.2f} ms per step), peak "
            f"{peak:.2f} GiB, losses {losses[0]:.5f} .. {losses[-1]:.5f}, launches {launches}")
        check(all(n == 0 for n in launches.values()) and all(math.isfinite(x) for x in losses),
              f"{name} trains without the inference kernels, finite losses")
        res[name] = {"images_per_s": sps * 32, "step_ms": dt / TRAIN_OTHER_STEPS * 1e3,
                     "peak_gib": peak}
        res["launches"][f"train_{name}"] = launches
        del tr, st, batches
        torch.cuda.empty_cache()
    return res


# Phase 21: weights from an MMPose .pth (the port's MMPose mirrors write the files).
PTH_SEED = 21  # the mirrors' randomize_ seed
PTH_FRAMES = 128  # the estimate CLI's run: frames x C cameras, as phase 19's refine cut
PTH_CLI_BLOCK = 64  # the estimate CLI's default block_size


def write_pth_files(tmp: str) -> dict:
    """HRNet-W32 and Swin-B ``.pth`` files as zoo files hold them
    (``{"state_dict": ...}``; HRNet's names under mmengine's ``backbone.`` /
    ``keypoint_head.``, the Swin mirror's already under its own), written
    by the port's MMPose mirrors with ``randomize_(PTH_SEED)``."""
    import torch
    from multi_camera_3d_pose_estimation_tpu_torch.models.hrnet import HRNET_W32
    from multi_camera_3d_pose_estimation_tpu_torch.models.mirrors import hrnet as mh
    from multi_camera_3d_pose_estimation_tpu_torch.models.mirrors import swin as ms
    from multi_camera_3d_pose_estimation_tpu_torch.models.swin import SWIN_B

    paths = {}
    for name, mirror, randomize_ in (("coco_hrnet_w32", mh.MMPoseHRNet(HRNET_W32), mh.randomize_),
                                     ("coco_swin-b", ms.MMPoseSwin(SWIN_B), ms.randomize_)):
        t0 = time.perf_counter()
        randomize_(mirror, seed=PTH_SEED)
        sd = mirror.state_dict()
        if name == "coco_hrnet_w32":
            sd = {("keypoint_head." if k.startswith("final_layer") else "backbone.") + k: v
                  for k, v in sd.items()}
        paths[name] = os.path.join(tmp, f"{name}.pth")
        torch.save({"state_dict": sd}, paths[name])
        n = sum(v.numel() for k, v in sd.items() if v.is_floating_point())
        log(f"  {name}.pth: {n / 1e6:.2f} M float32 values, "
            f"{os.path.getsize(paths[name]) / 1e6:.1f} MB, written in "
            f"{time.perf_counter() - t0:.1f} s")
    return paths


def run_convert_cli(pth: str, name: str, npz: str, dev) -> dict:
    """`cli.convert.main([pth, --model name, --verify, --out npz, --device
    dev])`: the drill's per-stage report (printed) and the call's seconds."""
    import contextlib
    import io

    from multi_camera_3d_pose_estimation_tpu_torch.cli import convert as convert_cli

    buf = io.StringIO()
    t0 = time.perf_counter()
    code = 0
    with contextlib.redirect_stdout(buf):
        try:
            convert_cli.main([pth, "--model", name, "--verify", "--out", npz, "--device",
                              str(dev)])
        except SystemExit as e:
            code = e.code
    secs = time.perf_counter() - t0
    stages = {}
    for line in buf.getvalue().splitlines():
        log(f"    {line}")
        tok = line.split()
        if len(tok) >= 4 and tok[3] in ("PASS", "FAIL"):
            stages[tok[0]] = float(tok[2])
    check(code == 0 and "VERIFY: PASS" in buf.getvalue() and os.path.exists(npz),
          f"convert --verify --out on {name}: every stage within 2e-3 and the .npz written")
    log(f"  convert --verify --out {name}: {secs:.2f} s (the drill on the card, then the "
        f"conversion and the .npz); largest per-stage rel {max(stages.values()):.3g}")
    return {"seconds": secs, "max_rel": max(stages.values()), "stages": stages}


class FrameStackReader:
    """`io.frames.VideoReader`'s interface over a ``.npy`` frame stack
    (T, H, W, 3) uint8 RGB at ``path + ".npy"``: phase 21 stores its
    recordings as raw frames, so that the frames it estimates from are the
    frames it wrote (phase 26 writes and reads real ``.mp4`` files)."""

    def __init__(self, path: str, prefetch: int = 16, bgr: bool = False):
        import numpy as np

        self._frames = np.load(path + ".npy")
        self.n_frames, self.height, self.width = self._frames.shape[:3]
        self.bgr, self.fps, self._at = bgr, 30.0, 0

    def read_block(self, n: int):
        out = self._frames[self._at:self._at + n]
        self._at += out.shape[0]
        return out[..., ::-1] if self.bgr else out

    def close(self):
        self._frames = None


def run_pth_phase(dev, blocks_u8, phase3_fps: float) -> dict:
    """Phase 21: HRNet-W32 and Swin-B from MMPose ``.pth`` files, through the
    convert CLI's drill, the builders' JAX keywords, the block pipeline and
    the estimate CLI, each against the route through the ``.npz`` that
    ``convert --out`` wrote."""
    import tempfile

    import numpy as np
    import torch
    from multi_camera_3d_pose_estimation_tpu_torch.cli import estimate as est_cli
    from multi_camera_3d_pose_estimation_tpu_torch.entry import synthetic_rig
    from multi_camera_3d_pose_estimation_tpu_torch.io import (
        frames, save_camera_intrinsics, save_camera_names, save_extrinsic_calibration_parameters,
        stage_blocks)
    from multi_camera_3d_pose_estimation_tpu_torch.models.topdown import preprocess_crops
    from multi_camera_3d_pose_estimation_tpu_torch.ops import bottleneck as bn
    from multi_camera_3d_pose_estimation_tpu_torch.ops import swin_block as sb
    from multi_camera_3d_pose_estimation_tpu_torch.ops import window_attention as wa

    res: dict = {"launches": {}}
    counters = kernel_counters()

    def counted(fn):
        for c in counters.values():
            c.launches = 0
        out = fn()
        torch.cuda.synchronize()
        return out, {k: c.launches for k, c in counters.items()}

    def same(a, b):
        return all(np.array_equal(x, y, equal_nan=True) for x, y in zip(a, b))

    with tempfile.TemporaryDirectory() as tmp:
        # 1. The files and the project (phase 19's rig).
        pths = write_pth_files(tmp)
        rig = synthetic_rig(C, H, W)
        names = [f"cam{c}" for c in range(C)]
        for c, name in enumerate(names):
            save_camera_intrinsics(rig["K"][c], rig["dist"][c], name, root_path=tmp)
            save_extrinsic_calibration_parameters(rig["R"][c], rig["T"][c], name, root_dir=tmp)
        save_camera_names(dict(enumerate(names)), names[0], tmp)

        # 2. The drill and the conversion, through the convert CLI on the card.
        npzs = {name: pth[:-4] + ".npz" for name, pth in pths.items()}
        res["convert"] = {name: run_convert_cli(pths[name], name, npzs[name], dev)
                          for name in pths}

        # 3. HRNet-W32 from the .pth in the block pipeline, against the .npz route.
        kw = {"use_pallas_stage1": True, "use_fused_decode": True}  # the JAX keyword for stage 1
        pipes = {}
        for route in ("pth", "npz"):
            t0 = time.perf_counter()
            ckpt = pths["coco_hrnet_w32"] if route == "pth" else npzs["coco_hrnet_w32"]
            pipes[route] = est_cli.build_estimate_pipeline(
                tmp, pose_estimation_model="coco_hrnet_w32", checkpoint=ckpt,
                estimator_kwargs=kw, device=dev)
            res[f"hrnet_build_{route}_s"] = time.perf_counter() - t0
        pipe = pipes["pth"]
        pipe.run(blocks_u8[0])  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(N_BLOCKS):
            pipe.run(blocks_u8[i % 2])
        torch.cuda.synchronize()
        res["hrnet_fps"] = T * N_BLOCKS / (time.perf_counter() - t0)
        host = [(b.cpu().numpy(), T) for b in blocks_u8]
        outs = {}
        for route, p in pipes.items():
            outs[route], launches = counted(lambda: est_cli.run_pipeline_on_blocks(
                p, stage_blocks(iter(host), dev), progress=False))
            res["launches"][f"hrnet_{route}"] = launches
        n = len(host)
        log(f"  HRNet-W32 from the .pth (build {res['hrnet_build_pth_s']:.2f} s, from the .npz "
            f"{res['hrnet_build_npz_s']:.2f} s): {N_BLOCKS} blocks of ({T}, {C}, {H}, {W}, 3) in "
            f"memory -> {res['hrnet_fps']:.1f} frames/s (phase 3, seeded weights: "
            f"{phase3_fps:.1f}); {n} blocks streamed through run_pipeline_on_blocks, launches "
            f"{res['launches']['hrnet_pth']}")
        check(res["launches"]["hrnet_pth"] == dict(bottleneck=4 * n, heatmap_decode=n,
                                                   swin_gemm=0, window_attention=0,
                                                   window_attention_rows=0, crop_resample=n,
                                                   bn_epilogue=EPI_HRNET * n),
              f"HRNet from the .pth: 1 crop, 4 Bottleneck, {EPI_HRNET} ConvBN epilogue and 1 "
              "decode launch per block")
        check(same(outs["pth"], outs["npz"]),
              "HRNet from the .pth: the artifacts equal the .npz route's bit for bit")
        check_outputs({k: torch.from_numpy(v) for k, v in zip(("kpts_2d", "heatmaps_2d",
                                                                "kpts_3d"), outs["pth"])},
                      pipe, n * T)
        # The stage-1 chain on this block's stem output, the checkpoint's BN statistics.
        est = pipe.estimator
        x, xs, _, _ = check_bottleneck_blocks(est, blocks_u8[0], dev, label="the .pth's ")
        with torch.inference_mode():
            kern = bn.fused_stage1_chain(x, est.fused_stage1.blocks)
            torch.cuda.synchronize()
            err = (kern.float() - xs[-1].float()).abs().max().item()
            scale = xs[-1].float().abs().max().item()
        log(f"  the .pth's stage-1 chain {tuple(x.shape)}: max |kernel - plain| {err:.6g} "
            f"(tolerance {CHAIN_REL_TOL} x {scale:.4g})")
        check(err <= CHAIN_REL_TOL * scale,
              "the Bottleneck chain agrees with its plain version on the .pth's weights")
        res["chain_err"] = err
        del pipes, pipe, est

        # 4. Swin-B from the .pth: one block of bench_swin's configuration.
        gen = torch.Generator().manual_seed(PTH_SEED)
        sblock = torch.randint(0, 256, (SWIN_T, C, H, W, 3), generator=gen,
                               dtype=torch.uint8).to(dev)
        souts = {}
        for route in ("pth", "npz"):
            ckpt = pths["coco_swin-b"] if route == "pth" else npzs["coco_swin-b"]
            t0 = time.perf_counter()
            p = est_cli.build_estimate_pipeline(
                tmp, pose_estimation_model="coco_swin-b", checkpoint=ckpt,
                estimator_kwargs={"use_fused_decode": True}, device=dev)
            res[f"swin_build_{route}_s"] = time.perf_counter() - t0
            p.run(sblock)  # warm-up
            out, launches = counted(lambda: p.run(sblock))
            souts[route] = {k: v.cpu().numpy() for k, v in out.items()}
            res["launches"][f"swin_{route}"] = launches
            if route == "pth":
                spipe = p
        n_blocks = sum(spipe.estimator.model.cfg["depths"])
        log(f"  Swin-B from the .pth (build {res['swin_build_pth_s']:.2f} s, from the .npz "
            f"{res['swin_build_npz_s']:.2f} s): one block of ({SWIN_T}, {C}, {H}, {W}, 3), "
            f"launches {res['launches']['swin_pth']}")
        check(res["launches"]["swin_pth"] == dict(bottleneck=0, heatmap_decode=1,
                                                  swin_gemm=4 * n_blocks,
                                                  window_attention=n_blocks,
                                                  window_attention_rows=0, crop_resample=1,
                                                  bn_epilogue=EPI_SWIN),
              "Swin-B from the .pth: 1 crop, 96 swin_gemm, 24 attention, 3 ConvBN epilogue and "
              "1 decode launch per block")
        check(same(souts["pth"].values(), souts["npz"].values()),
              "Swin-B from the .pth: the outputs equal the .npz route's bit for bit")
        # Each stage's first shifted block: its window attention on the checkpoint's bias table.
        model = spipe.estimator.model
        captured, hooks = {}, []

        def capture(i):
            def hook(module, args, kwargs):  # returns None: the call goes on unchanged
                captured.setdefault(i, (args[0], dict(kwargs)))
            return hook

        for i in range(len(model.cfg["depths"])):
            blk = getattr(model.backbone, f"stage_{i}_block_1")
            hooks.append(blk.register_forward_pre_hook(capture(i), with_kwargs=True))
        frames_ = sblock.reshape(SWIN_T * C, H, W, 3).to(torch.bfloat16) / 255.0
        boxes = torch.tensor([0.0, 0.0, W, H], device=dev).expand(SWIN_T * C, 4)
        errs = []
        with torch.inference_mode():
            model(preprocess_crops(frames_, boxes, INPUT)[0])
            for h in hooks:
                h.remove()
            for i in range(len(model.cfg["depths"])):
                blk = getattr(model.backbone, f"stage_{i}_block_1")
                x, kw_ = captured[i]
                p_ = blk.prepared()
                B_, Hc, Wc = kw_["pre_part"]
                nw = blk.window ** 2
                valid, mask = sb.block_tables(Hc, Wc, blk.window, blk.shift, dev)
                qkv = sb.swin_gemm("qkv", x, p_["wqkv"], p_["bqkv"], ln=p_["norm1"],
                                   valid=valid).view(-1, nw, 3 * x.shape[-1])
                ka = wa.window_attention(qkv, p_["bias"], mask, blk.heads)
                pa = wa.window_attention_plain(qkv, p_["bias"], mask, blk.heads)
                torch.cuda.synchronize()
                aerr = (ka.float() - pa.float()).abs().max().item()
                ascale = pa.float().abs().max().item()
                log(f"  the .pth's Swin stage {i} attention qkv {tuple(qkv.shape)}, bias table "
                    f"std {p_['bias'].float().std().item():.3f}: max |kernel - plain| "
                    f"{aerr:.6g} (tolerance {ATTN_REL_TOL} x {ascale:.4g})")
                check(aerr <= ATTN_REL_TOL * ascale, f"the .pth's Swin stage {i}: the window "
                      "attention kernel agrees with its plain version")
                errs.append(aerr)
        res["attention_err"] = max(errs)
        del spipe, model, captured

        # 5. The estimate CLI from the .pth, against the .npz route.
        rng = np.random.default_rng(PTH_SEED)
        rec = os.path.join(tmp, "recordings")
        os.makedirs(rec)
        videos = [os.path.join(rec, f"{name}_synced.mp4") for name in names]
        for v in videos:
            np.save(v + ".npy", rng.integers(0, 256, (PTH_FRAMES, H, W, 3), dtype=np.uint8))
        reader = frames.VideoReader
        frames.VideoReader = FrameStackReader
        try:
            arts = {}
            for route in ("pth", "npz"):
                ckpt = pths["coco_hrnet_w32"] if route == "pth" else npzs["coco_hrnet_w32"]
                t0 = time.perf_counter()
                arts[route], launches = counted(lambda: est_cli.estimate_pose_from_video(
                    videos, project_dir=tmp, pose_estimation_model="coco_hrnet_w32",
                    checkpoint=ckpt, estimator_kwargs=kw, block_size=PTH_CLI_BLOCK,
                    save_dir=os.path.join(tmp, route), device=dev))
                res[f"estimate_{route}_s"] = time.perf_counter() - t0
                res["launches"][f"estimate_{route}"] = launches
        finally:
            frames.VideoReader = reader
        nb = PTH_FRAMES // PTH_CLI_BLOCK
        on_disk = [np.load(os.path.join(tmp, "pth", f"{k}.npy"))
                   for k in ("kpts_2d", "heatmaps_2d", "kpts_3d")]
        log(f"  estimate_pose_from_video(checkpoint=.pth): {PTH_FRAMES} frames x {C} cameras "
            f"(raw frame stacks) in {res['estimate_pth_s']:.2f} s "
            f"(.npz route {res['estimate_npz_s']:.2f} s), launches "
            f"{res['launches']['estimate_pth']}; kpts_2d {on_disk[0].shape}")
        check(res["launches"]["estimate_pth"]["bottleneck"] == 4 * nb
              and res["launches"]["estimate_pth"]["heatmap_decode"] == nb
              and res["launches"]["estimate_pth"]["bn_epilogue"] == EPI_HRNET * nb,
              f"the estimate CLI from the .pth: 4 Bottleneck, {EPI_HRNET} ConvBN epilogue and 1 "
              "decode launch per block")
        check(on_disk[0].shape == (PTH_FRAMES, 17, 3, C) and same(arts["pth"], on_disk)
              and same(arts["pth"], arts["npz"]),
              "the estimate CLI from the .pth: the artifacts equal the .npz route's bit for bit")
    return res


# Phase 22: the mesh paths as a one-rank NCCL group (the card's machine has one card).
MULTICLIP = (8, 32, 4)  # bench.py::bench_multiclip (BASELINE config 5): clips, T, cameras
N_MULTICLIP_BLOCKS = 3
MESH_TRAIN_B = 32  # phase 20's batch
MESH_TRAIN_STEPS = 3  # compared with mesh=None
MESH_TIMED_STEPS = 3  # per turn: none, mesh, mesh, none
MESH_REFINE_STEPS = 30
MESH_F64_RTOL = 1e-9  # float64, card against CPU: losses, and the refinement's parameters
# test_tiny's weights after 3 clip -> AdamW steps: Adam moves a weight by about
# lr whatever its gradient's size, so rounding-level gradients part by up to
# that; held at 1e-3 lr per step (tests/test_torch_train_loop.py's limit).
MESH_TINY_WEIGHT_ATOL = 1e-3 * 5e-4 * 3


def refine_step_scene():
    """``tests/test_parallel.py``'s `sharded_refine_step` scene in float64:
    16 windows of 4 frames x 5 joints, 2 cameras."""
    import numpy as np

    N, B, C_, J = 16, 4, 2, 5
    rng = np.random.default_rng(0)
    params = {"traj": rng.normal(0, 1, (N, B, J, 3)) + np.array([0, 0, 300.0]),
              "rvecs": np.full((C_, 3), 1e-4), "tvecs": np.stack([np.zeros(3), [-30.0, 0, 0]])}
    batch = {"means": rng.uniform(20, 140, (N, B, C_, J, 2)),
             "cov_inv": np.broadcast_to(np.eye(2) / 25.0, (N, B, C_, J, 2, 2)).copy(),
             "Ks": np.broadcast_to([[300.0, 0, 80.0], [0, 300.0, 60.0], [0, 0, 1.0]],
                                   (C_, 3, 3)).copy(),
             "dists": np.zeros((C_, 5))}
    return params, batch


def run_refine_steps(mesh, dev):
    """`sharded_refine_step` (smoothness on) for MESH_REFINE_STEPS steps on
    ``dev``: (the losses, the final parameters as numpy)."""
    import torch
    from multi_camera_3d_pose_estimation_tpu_torch.parallel import sharded_refine_step

    params, batch = refine_step_scene()
    params = {k: torch.tensor(v, device=dev) for k, v in params.items()}
    batch = {k: torch.tensor(v, device=dev) for k, v in batch.items()}
    step, tx = sharded_refine_step(mesh, lr=0.05, lambda_smooth=1.0)
    state, losses = tx.init(params), []
    for _ in range(MESH_REFINE_STEPS):
        params, state, loss = step(params, state, batch)
        losses.append(loss)
    return torch.stack(losses).cpu().numpy(), {k: v.cpu().numpy() for k, v in params.items()}


def run_tiny_dp_steps(mesh, dev):
    """test_tiny in float64 through `make_train_step(mesh=)` (the train CLI's
    loss and clip -> AdamW) at batch 8, 3 steps on ``dev``: (the losses, the
    final state dict as numpy)."""
    import torch
    from multi_camera_3d_pose_estimation_tpu_torch.cli.train import build_trainer
    from multi_camera_3d_pose_estimation_tpu_torch.training import make_crop_batch, make_train_step
    from multi_camera_3d_pose_estimation_tpu_torch.training.losses import heatmap_mse_loss

    images, boxes, kps, vis = train_images(TRAIN_CHECK_BATCH, 7)
    vis[TRAIN_CHECK_BATCH // 2:, :5] = 0.0  # unequal weights between the batch's halves
    batch = make_crop_batch(images, boxes, kps, vis, input_size=(32, 64),
                            flip_mask=torch.arange(TRAIN_CHECK_BATCH) % 2 == 0, device="cpu")
    batch = {k: v.to(dev, torch.float64) for k, v in batch.items()}
    tr = build_trainer("test_tiny", "float64", 5e-4, seed=0, device=dev)
    tr.model.to(torch.float64)
    init_fn, step_fn = make_train_step(
        tr.model, lambda o, b: heatmap_mse_loss(o, b["targets"], b["weights"]),
        learning_rate=5e-4, mesh=mesh)
    state, losses = init_fn(), []
    for _ in range(3):
        state, loss = step_fn(state, batch)
        losses.append(loss)
    return (torch.stack(losses).cpu().numpy(),
            {k: v.cpu().numpy() for k, v in tr.model.state_dict().items()})


class CollectiveCount:
    """Within it, counts the calls of torch.distributed's collectives (the
    port's mesh helpers look them up at each call)."""

    NAMES = ("all_reduce", "all_gather", "broadcast", "barrier")

    def __enter__(self):
        import torch.distributed as dist

        self.counts = dict.fromkeys(self.NAMES, 0)
        self.saved = {n: getattr(dist, n) for n in self.NAMES}

        def counting(name, fn):
            def call(*args, **kwargs):
                self.counts[name] += 1
                return fn(*args, **kwargs)
            return call

        for n, fn in self.saved.items():
            setattr(dist, n, counting(n, fn))
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist

        for n, fn in self.saved.items():
            setattr(dist, n, fn)


def same_tensors(a: dict, b: dict) -> bool:
    """Every entry equal bit for bit, NaN where NaN."""
    import torch

    return all(torch.equal(torch.nan_to_num(a[k], 7.0), torch.nan_to_num(b[k], 7.0)) for k in a)


def rel_gap(a, b) -> float:
    import numpy as np

    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def run_mesh_phase(dev, pipe, blocks_u8, phase3_fps: float, swin: dict) -> dict:
    """Phase 22: the CPU references in a one-rank gloo group, then a one-rank
    NCCL group (`init_distributed`) through the headline block, phase 6's
    Swin-B block, BASELINE config 5's clips, the data-parallel train step
    and `sharded_refine_step`."""
    import socket

    import numpy as np
    import torch
    import torch.distributed as dist
    from multi_camera_3d_pose_estimation_tpu_torch.cli.train import build_trainer
    from multi_camera_3d_pose_estimation_tpu_torch.entry import build_pipeline
    from multi_camera_3d_pose_estimation_tpu_torch.models.batchnorm import BatchNorm
    from multi_camera_3d_pose_estimation_tpu_torch.models.hrnet import HRNET_W32
    from multi_camera_3d_pose_estimation_tpu_torch.ops import bn_epilogue as be
    from multi_camera_3d_pose_estimation_tpu_torch.parallel import (ShardedPosePipeline,
                                                                    init_distributed,
                                                                    make_clip_mesh, make_mesh,
                                                                    run_clips_batched)
    from multi_camera_3d_pose_estimation_tpu_torch.training import make_train_step
    from multi_camera_3d_pose_estimation_tpu_torch.training.losses import heatmap_mse_loss

    res = {"launches": {}}
    # The CPU references: one rank of gloo, the group destroyed after.
    cpu_mesh = make_mesh(1, device="cpu")
    refine_cpu = run_refine_steps(cpu_mesh, "cpu")
    tiny_cpu = run_tiny_dp_steps(cpu_mesh, "cpu")
    dist.destroy_process_group()

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    init_distributed(f"127.0.0.1:{port}", 1, 0)
    try:
        check(dist.get_backend() == "nccl" and dist.get_world_size() == 1,
              "a one-rank NCCL group")
        log(f"one-rank group: backend {dist.get_backend()}, NCCL "
            f"{'.'.join(map(str, torch.cuda.nccl.version()))}")
        mesh = make_mesh(1)

        # The headline block through the mesh, against phase 3's one-device run.
        sharded = ShardedPosePipeline(pipe.estimator, pipe.cam_stack, mesh=mesh, device=dev)
        sharded.run(blocks_u8[0])  # warm-up
        torch.cuda.synchronize()
        out, dt, launches = timed_blocks(sharded, blocks_u8, N_BLOCKS)
        ref = pipe.run(blocks_u8[(N_BLOCKS - 1) % len(blocks_u8)])
        equal = same_tensors(out, ref)
        res["mesh_frames_per_s"] = T * N_BLOCKS / dt
        log(f"  headline block on make_mesh(1): {N_BLOCKS} blocks of ({T}, {C}, {H}, {W}, 3) in "
            f"{dt:.3f} s -> {res['mesh_frames_per_s']:.1f} frames/s (phase 3 {phase3_fps:.1f}); "
            f"launches {launches}; equal to mesh=None bit for bit: {equal}")
        check(launches["bottleneck"] == 4 * N_BLOCKS and launches["heatmap_decode"] == N_BLOCKS
              and launches["bn_epilogue"] == EPI_HRNET * N_BLOCKS,
              f"the mesh pipeline: 4 Bottleneck, {EPI_HRNET} ConvBN epilogue and 1 decode launch "
              "per block")
        check(equal, "the one-rank mesh pipeline equals mesh=None bit for bit")
        check_outputs(out, sharded, T)
        res["launches"]["headline"] = launches

        # Phase 6's Swin-B block through the mesh, against its one-device run.
        spipe = swin["pipe"]
        ssharded = ShardedPosePipeline(spipe.estimator, spipe.cam_stack, mesh=mesh, device=dev)
        ssharded.run(swin["blocks"][0])  # warm-up
        torch.cuda.synchronize()
        out, dt, launches = timed_blocks(ssharded, swin["blocks"], 1)
        equal = same_tensors(out, spipe.run(swin["blocks"][0]))
        res["swin_mesh_frames_per_s"] = SWIN_T / dt
        log(f"  Swin-B block on make_mesh(1): ({SWIN_T}, {C}, {H}, {W}, 3) in {dt:.3f} s -> "
            f"{res['swin_mesh_frames_per_s']:.1f} frames/s (phase 6 {swin['fps']:.1f}); "
            f"launches {launches}; equal to mesh=None bit for bit: {equal}")
        n_swin = sum(spipe.estimator.model.cfg["depths"])
        check(launches == dict(bottleneck=0, heatmap_decode=1, swin_gemm=4 * n_swin,
                               window_attention=n_swin, window_attention_rows=0,
                               crop_resample=1, bn_epilogue=EPI_SWIN),
              "the Swin-B mesh pipeline: 1 crop, 96 swin_gemm, 24 attention, 3 ConvBN epilogue "
              "and 1 decode launch")
        check(equal, "the one-rank mesh Swin-B pipeline equals mesh=None bit for bit")
        res["launches"]["swin_b"] = launches
        del ssharded, out

        # BASELINE config 5: 8 clips x T=32 x 4 cameras (1024 crops per block).
        n_clips, clip_t, cams = MULTICLIP
        mc = build_pipeline(HRNET_W32, INPUT, (n_clips * clip_t, cams, H, W, 3), device=dev,
                            seed=0)
        clip_mesh = make_clip_mesh(1, 1)
        mc_mesh = ShardedPosePipeline(mc.estimator, mc.cam_stack, mesh=clip_mesh, device=dev)
        gen = torch.Generator(dev).manual_seed(5)
        clips = [torch.randint(0, 256, (n_clips, clip_t, cams, H, W, 3), generator=gen,
                               device=dev, dtype=torch.uint8) for _ in range(2)]
        run_clips_batched(mc_mesh, clips[0], split=False)  # warm-up
        torch.cuda.synchronize()
        counters = kernel_counters()
        for fn in counters.values():
            fn.launches = 0
        be.bn_epilogue.plain = 0
        t0 = time.perf_counter()
        for i in range(N_MULTICLIP_BLOCKS):
            stacked = run_clips_batched(mc_mesh, clips[i % 2], split=False)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in counters.items()}
        check_no_plain_epilogue("run_clips_batched")
        res["multiclip_frames_per_s"] = n_clips * clip_t * N_MULTICLIP_BLOCKS / dt
        last = clips[(N_MULTICLIP_BLOCKS - 1) % 2]
        split = run_clips_batched(mc_mesh, last, split=True)
        split_equal = all(same_tensors(split[i], {k: v[i] for k, v in stacked.items()})
                          for i in range(n_clips))
        flat = {k: v.flatten(0, 1) for k, v in stacked.items()}
        one = mc.run(last.flatten(0, 1))
        log(f"  BASELINE config 5 ({n_clips} clips x T={clip_t} x {cams} cameras of {H}x{W}, "
            f"{n_clips * clip_t * cams} crops per block) through run_clips_batched on "
            f"make_clip_mesh(1, 1): {N_MULTICLIP_BLOCKS} blocks in {dt:.3f} s -> "
            f"{res['multiclip_frames_per_s']:.1f} {cams}-camera frames/s; launches {launches}; "
            f"split=True equal to split=False: {split_equal}; equal to mesh=None: "
            f"{same_tensors(flat, one)}")
        check(launches["bottleneck"] == 4 * N_MULTICLIP_BLOCKS
              and launches["heatmap_decode"] == N_MULTICLIP_BLOCKS
              and launches["bn_epilogue"] == EPI_HRNET * N_MULTICLIP_BLOCKS,
              f"run_clips_batched: 4 Bottleneck, {EPI_HRNET} ConvBN epilogue and 1 decode launch "
              "per block")
        check(split_equal and same_tensors(flat, one),
              "run_clips_batched: split equals unsplit, and both the one-device pipeline")
        check_outputs(flat, mc_mesh, n_clips * clip_t, cams)
        res["launches"]["multiclip"] = launches
        del mc, mc_mesh, clips, stacked, split, flat, one
        torch.cuda.empty_cache()

        # The data-parallel train step at world 1 against mesh=None (phase 20's step).
        trainers = {k: build_trainer("coco_hrnet_w32", "bfloat16", 5e-4, seed=0, device=dev)
                    for k in ("none", "mesh")}
        n_bn = sum(isinstance(m, BatchNorm) for m in trainers["mesh"].model.modules())
        _, step_mesh = make_train_step(
            trainers["mesh"].model, lambda o, b: heatmap_mse_loss(o, b["targets"], b["weights"]),
            learning_rate=5e-4, mesh=mesh)
        steps = {"none": trainers["none"].step_fn, "mesh": step_mesh}
        states = {k: trainers[k].init_fn() for k in trainers}
        batches, _ = train_batches(trainers["none"], MESH_TRAIN_B, 1, seed=MESH_TRAIN_B, dev=dev)
        losses = {}
        counters = kernel_counters()
        for fn in counters.values():
            fn.launches = 0
        for k in ("none", "mesh"):
            out = []
            for _ in range(MESH_TRAIN_STEPS):
                if k == "mesh":
                    with CollectiveCount() as cc:
                        states[k], loss = steps[k](states[k], batches[0])
                else:
                    states[k], loss = steps[k](states[k], batches[0])
                out.append(loss)
            losses[k] = torch.stack(out).float().cpu().numpy()
        launches = {k: fn.launches for k, fn in counters.items()}
        sd = {k: trainers[k].model.state_dict() for k in trainers}
        bitwise = (np.array_equal(losses["mesh"], losses["none"])
                   and all(torch.equal(sd["mesh"][n], sd["none"][n]) for n in sd["none"]))
        weight_gap = max(rel_gap(sd["mesh"][n].float().cpu(), sd["none"][n].float().cpu())
                         for n in sd["none"] if sd["none"][n].is_floating_point())
        loss_rel = np.abs(losses["mesh"] - losses["none"]) / np.abs(losses["none"])
        # Timed in turns on the same batch: none, mesh, mesh, none.
        ms = {"none": [], "mesh": []}
        for k in ("none", "mesh", "mesh", "none"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(MESH_TIMED_STEPS):
                states[k], loss = steps[k](states[k], batches[0])
            loss.item()
            ms[k].append((time.perf_counter() - t0) / MESH_TIMED_STEPS * 1e3)
        step_ms = {k: sum(v) / len(v) for k, v in ms.items()}
        collectives = sum(cc.counts.values())
        # One profiled step each: device ops and busy time, and the host time
        # inside the collectives (torch.distributed's c10d ops).
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        profiled = {}
        for k in ("none", "mesh"):
            torch.cuda.synchronize()
            with torch.profiler.profile(activities=acts) as prof:
                states[k], loss = steps[k](states[k], batches[0])
                loss.item()
            c10d = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CPU
                    and e.name.startswith("c10d::")]
            profiled[k] = {
                "device_ops": sum(1 for e in prof.events()
                                  if e.device_type == torch.autograd.DeviceType.CUDA),
                "device_ms": device_busy_ms(prof), "c10d_calls": len(c10d),
                "c10d_host_ms": sum((e.time_range.end - e.time_range.start) / 1e3 for e in c10d)}
        res["train"] = {"bitwise_equal": bitwise, "loss_rel_gap": loss_rel.tolist(),
                        "weight_rel_gap": weight_gap, "step_ms": step_ms["mesh"],
                        "step_ms_no_mesh": step_ms["none"],
                        "cost": step_ms["mesh"] / step_ms["none"] - 1.0,
                        "collectives_per_step": cc.counts, "batchnorm_layers": n_bn,
                        "turns_ms": ms, "profiled_step": profiled}
        log(f"  DP train step (HRNet-W32 bf16, batch {MESH_TRAIN_B}) on make_mesh(1) against "
            f"mesh=None, {MESH_TRAIN_STEPS} steps: losses {losses['mesh'].tolist()} / "
            f"{losses['none'].tolist()}; bit for bit (losses and every weight and statistic): "
            f"{bitwise}, largest relative weight gap {weight_gap:.3g}; {collectives} collectives "
            f"per step {cc.counts} over {n_bn} BatchNorm layers; {step_ms['mesh']:.2f} ms per "
            f"step against {step_ms['none']:.2f} (turns {ms}): cost "
            f"{res['train']['cost']:+.4f}; kernel launches {launches}; one profiled step each: "
            f"{profiled}")
        check(all(n == 0 for n in launches.values()), "training launches no inference kernel")
        check(bitwise or bool(np.all(loss_rel <= np.array(TRAIN_F32_RTOL))),
              "the DP train step at world 1 equals mesh=None (else within phase 20's limits)")
        res["launches"]["train"] = launches
        del trainers, steps, states, batches, sd
        torch.cuda.empty_cache()

        # Float64, card against CPU: test_tiny's DP step and sharded_refine_step.
        tiny = run_tiny_dp_steps(mesh, dev)
        tiny_loss = rel_gap(tiny[0], tiny_cpu[0])
        tiny_w = max(float(np.abs(tiny[1][n] - tiny_cpu[1][n]).max()) for n in tiny_cpu[1]
                     if np.issubdtype(tiny_cpu[1][n].dtype, np.floating))
        refine = run_refine_steps(mesh, dev)
        ref_loss = float(np.max(np.abs(refine[0] - refine_cpu[0]) / np.abs(refine_cpu[0])))
        ref_p = max(rel_gap(refine[1][k], refine_cpu[1][k]) for k in refine_cpu[1])
        res["float64"] = {"tiny_loss_rel": tiny_loss, "tiny_weight_abs": tiny_w,
                          "refine_loss_rel": ref_loss, "refine_param_rel": ref_p,
                          "refine_first_last": [float(refine[0][0]), float(refine[0][-1])]}
        log(f"  float64 card against CPU: test_tiny DP step, losses {tiny_loss:.3g} relative, "
            f"weights {tiny_w:.3g} apart (limit {MESH_TINY_WEIGHT_ATOL:.3g}); "
            f"sharded_refine_step, {MESH_REFINE_STEPS} steps (loss {refine[0][0]:.4f} -> "
            f"{refine[0][-1]:.4f}), losses {ref_loss:.3g}, parameters {ref_p:.3g} relative "
            f"(limit {MESH_F64_RTOL})")
        check(max(tiny_loss, ref_loss, ref_p) <= MESH_F64_RTOL
              and tiny_w <= MESH_TINY_WEIGHT_ATOL and refine[0][-1] < refine[0][0],
              "float64 DP train and refine steps on the card agree with the CPU")
    finally:
        dist.destroy_process_group()
    return res


# The calibration chain (phase 23).
CAL_BOARD = (6, 9, 3.0)  # rows, columns, square: tests/test_calibration.py::synth_views
CAL_NOISE = 0.2  # px of corner noise, as tests/test_calibration.py:64-70
CAL_VIEWS, CAL_PAIRS = 12, 10  # board poses per camera (intrinsics), seen by both (stereo)
CAL_CPU_RTOL = 1e-8  # card against the port's CPU run: rmse, K, dist (to the largest entry)
CAL_STEREO_CPU_RTOL = 1e-7  # R, T: inherit both intrinsics' spread along the flat valley
CAL_K_RTOL = 0.02  # the focal lengths against truth at 0.2 px (tests/test_calibration.py:69-70)
# R_rel and T_rel against truth.  tests/test_calibration.py:107-108 holds a
# noiseless solve at 1e-4 / 1e-3; at 0.2 px the chain inherits the
# intrinsics' errors (principal points within about 5 px), which moved
# R_rel by up to 0.011 and T_rel by up to 3.2 units (of a 34-unit baseline
# at 150-220 units) over six seeds on the CPU: held at twice that.
CAL_R_ATOL, CAL_T_ATOL = 0.025, 6.5
CAL_3D_RTOL = 1e-4  # kpts_3d on the card's rig against the CPU's rig (f32 DLT), of the largest


def calibration_corners(rig: dict, seed: int = 23) -> dict:
    """Noisy projected corners of the float64 rig ``{"K", "R", "T"}`` (no
    distortion): for each camera CAL_VIEWS board poses in front of it, and
    CAL_PAIRS board poses in front of both.  The synthetic rig's cameras
    look apart (yawed -20 and +20 degrees, 12 degrees of half field at
    f = 600 over 256 px), so no board lies inside both frames: the corners
    are the pinhole projections at up to 30 degrees off axis for both
    (the intrinsic views spread as wide), outside the 256x256 frames; the
    solvers see only corner coordinates."""
    import numpy as np

    from multi_camera_3d_pose_estimation_tpu_torch.calib import board_object_points

    rng = np.random.default_rng(seed)
    rows, cols, square = CAL_BOARD
    obj = board_object_points(rows, cols, square)
    centre = obj.mean(0)

    def rot(v):
        th = np.linalg.norm(v)
        k = v / th
        kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
        return np.eye(3) + np.sin(th) * kx + (1 - np.cos(th)) * kx @ kx

    def project(X, c):
        x = X @ rig["R"][c].T + rig["T"][c]
        uv = x[:, :2] / x[:, 2:] * np.diag(rig["K"][c])[:2] + rig["K"][c][:2, 2]
        return uv + rng.normal(0, CAL_NOISE, uv.shape)

    intr = []
    for c in range(2):
        Rc_inv, Tc = rig["R"][c].T, rig["T"][c]
        imgs = []
        for _ in range(CAL_VIEWS):  # a pose in camera c's frame, mapped to the world
            R = rot(rng.uniform(-0.4, 0.4, 3))
            z = rng.uniform(60, 110)
            t = np.array([rng.uniform(-0.5, 0.5) * z, rng.uniform(-0.5, 0.5) * z, z]) - R @ centre
            imgs.append(project((obj @ R.T + t - Tc) @ Rc_inv.T, c))
        intr.append(np.stack(imgs))
    i0, i1 = [], []
    for _ in range(CAL_PAIRS):
        R = rot(rng.uniform(-0.3, 0.3, 3))
        X = obj @ R.T + np.array([rng.uniform(-5, 5), rng.uniform(-4, 4),
                                  rng.uniform(150, 220)]) - R @ centre
        i0.append(project(X, 0))
        i1.append(project(X, 1))
    return {"intr_obj": np.stack([obj] * CAL_VIEWS), "intr": intr,
            "stereo_obj": np.stack([obj] * CAL_PAIRS), "stereo": (np.stack(i0), np.stack(i1))}


def run_calibration(corners: dict, dev) -> dict:
    """`calibrate_camera` per camera, then `stereo_calibrate` on the two
    calibrations, on ``dev`` in float64.  On the card every LM solve runs
    under ``torch.cuda.set_sync_debug_mode("error")`` (a host sync inside the
    steps raises) and is timed alone: seconds, steps and the cost history's
    last value per solve."""
    import torch

    from multi_camera_3d_pose_estimation_tpu_torch.calib import (calibrate_camera, intrinsic,
                                                                 pnp, stereo, stereo_calibrate)

    lm = intrinsic.levenberg_marquardt
    solves = []

    def timed_lm(fn, x0, n_iter=50, lam0=1e-3):
        on_card = x0.is_cuda
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
        t0 = time.perf_counter()
        try:
            x, final, hist = lm(fn, x0, n_iter, lam0)
        finally:
            if on_card:
                torch.cuda.set_sync_debug_mode(0)
        if on_card:
            torch.cuda.synchronize()
        solves.append({"seconds": time.perf_counter() - t0, "steps": n_iter,
                       "problems": x0.shape[0] if x0.dim() == 2 else 1, "n": x0.shape[-1],
                       "last_cost": hist[..., -1].cpu().tolist()})
        return x, final, hist

    res = {"cameras": [], "solves": solves}
    modules = (intrinsic, pnp, stereo)
    for m in modules:
        m.levenberg_marquardt = timed_lm
    try:
        for c in range(2):
            t0 = time.perf_counter()
            out = calibrate_camera(corners["intr_obj"], corners["intr"][c], device=dev)
            res["cameras"].append({"seconds": time.perf_counter() - t0, "rmse": out[0],
                                   "K": out[1], "dist": out[2]})
        t0 = time.perf_counter()
        rmse, R, T = stereo_calibrate(corners["stereo_obj"], *corners["stereo"],
                                      res["cameras"][0]["K"], res["cameras"][0]["dist"],
                                      res["cameras"][1]["K"], res["cameras"][1]["dist"],
                                      device=dev)
        res["stereo"] = {"seconds": time.perf_counter() - t0, "rmse": rmse, "R": R, "T": T}
    finally:
        for m in modules:
            m.levenberg_marquardt = lm
    return res


def write_calibrated_rig(root: str, cal: dict) -> dict:
    """The rig as `cli.configure.configure_cameras` writes it (the origin
    camera at R = I, T = 0, camera 1 from the stereo result) through the
    port's ``io``, read back with `get_params_from_name` and stacked."""
    import os

    import numpy as np

    from multi_camera_3d_pose_estimation_tpu_torch.io import (
        get_params_from_name, save_camera_intrinsics, save_extrinsic_calibration_parameters,
        stack_camera_params)

    names = ["cam0", "cam1"]
    for name, cam in zip(names, cal["cameras"]):
        save_camera_intrinsics(cam["K"], cam["dist"], name, root_path=root)
    save_extrinsic_calibration_parameters(np.eye(3), np.zeros((3, 1)), names[0], root_dir=root)
    save_extrinsic_calibration_parameters(cal["stereo"]["R"], cal["stereo"]["T"], names[1],
                                          root_dir=root)
    return stack_camera_params([
        get_params_from_name(n, os.path.join(root, "intrinsic_camera_parameters"),
                             os.path.join(root, "extrinsic_camera_parameters"))[1]
        for n in names])


def run_calibration_phase(dev, pipe, blocks_u8, phase3_fps: float) -> dict:
    """Phase 23: the calibration chain on the card in float64 against the
    port's CPU run and the truth, the rig written and read back, and the
    headline block on the calibrated rig."""
    import tempfile

    import numpy as np
    import torch
    from multi_camera_3d_pose_estimation_tpu_torch.entry import synthetic_rig
    from multi_camera_3d_pose_estimation_tpu_torch.parallel import ShardedPosePipeline

    rig = {k: np.asarray(v, np.float64) for k, v in synthetic_rig(C, H, W).items()}
    corners = calibration_corners(rig)
    # The first run on the card pays the one-time costs (torch.func's import,
    # cuSOLVER's handles); the second is the one timed and checked.
    t0 = time.perf_counter()
    first = run_calibration(corners, dev)
    res = {"launches": {}, "first_run_s": time.perf_counter() - t0}
    cal = {"cuda": run_calibration(corners, dev), "cpu": run_calibration(corners, "cpu")}
    res["repeat_equal"] = all(
        np.array_equal(a[k], b[k]) for a, b in zip(first["cameras"] + [first["stereo"]],
                                                   cal["cuda"]["cameras"] + [cal["cuda"]["stereo"]])
        for k in ("rmse", "K", "dist", "R", "T") if k in a)
    log(f"  first calibration run on the card {res['first_run_s']:.3f} s; the second equal to it "
        f"bit for bit: {res['repeat_equal']}")
    for side in ("cuda", "cpu"):
        r = cal[side]
        steps = sum(s["steps"] for s in r["solves"])
        lm_s = sum(s["seconds"] for s in r["solves"])
        res[side] = {"intrinsic_s": [c["seconds"] for c in r["cameras"]],
                     "stereo_s": r["stereo"]["seconds"], "lm_steps": steps, "lm_s": lm_s,
                     "lm_steps_per_s": steps / lm_s,
                     "solves": r["solves"]}
        where = "the card" if side == "cuda" else "the CPU"
        log(f"  calibration on {where} (float64): intrinsics "
            f"{[round(c['seconds'], 3) for c in r['cameras']]} s "
            f"(rmse {[round(c['rmse'], 4) for c in r['cameras']]} px), stereo "
            f"{r['stereo']['seconds']:.3f} s (rmse {r['stereo']['rmse']:.4f} px); LM {steps} steps "
            f"in {lm_s:.3f} s -> {steps / lm_s:.1f} steps/s")
        for s in r["solves"]:
            last = np.round(np.atleast_1d(s["last_cost"]), 6).tolist()
            log(f"    LM solve: {s['problems']} x n={s['n']}, {s['steps']} steps in "
                f"{s['seconds']:.3f} s ({s['steps'] / s['seconds']:.1f} steps/s), last cost "
                f"(per problem) {last}")
    # The card against the CPU, and both against the truth.
    gaps = {}
    for c in range(2):
        a, b = cal["cuda"]["cameras"][c], cal["cpu"]["cameras"][c]
        gaps[f"cam{c}"] = {"rmse": abs(a["rmse"] - b["rmse"]) / b["rmse"],
                           "K": rel_gap(a["K"], b["K"]),
                           "dist": float(np.abs(a["dist"] - b["dist"]).max())}
    sa, sb = cal["cuda"]["stereo"], cal["cpu"]["stereo"]
    gaps["stereo"] = {"rmse": abs(sa["rmse"] - sb["rmse"]) / sb["rmse"],
                      "R": rel_gap(sa["R"], sb["R"]), "T": rel_gap(sa["T"], sb["T"])}
    R_rel = rig["R"][1] @ rig["R"][0].T
    T_rel = rig["T"][1] - R_rel @ rig["T"][0]
    truth = {"f_rel": [float(np.abs(np.diag(c["K"])[:2] / np.diag(rig["K"][i])[:2] - 1).max())
                       for i, c in enumerate(cal["cuda"]["cameras"])],
             "pp_px": [(c["K"][:2, 2] - rig["K"][i][:2, 2]).tolist()
                       for i, c in enumerate(cal["cuda"]["cameras"])],
             "R_abs": float(np.abs(sa["R"] - R_rel).max()),
             "T_abs": float(np.abs(sa["T"].ravel() - T_rel).max())}
    res["card_vs_cpu"], res["truth"] = gaps, truth
    log(f"  card against the CPU (relative to the largest entry; dist absolute): {gaps} "
        f"(limits {CAL_CPU_RTOL}, stereo R and T {CAL_STEREO_CPU_RTOL})")
    log(f"  against the truth: focal lengths {truth['f_rel']} relative (limit {CAL_K_RTOL}), "
        f"principal points {np.round(truth['pp_px'], 3).tolist()} px; R_rel {truth['R_abs']:.3g} "
        f"(limit {CAL_R_ATOL}), T_rel {truth['T_abs']:.3g} units (limit {CAL_T_ATOL})")
    check(all(max(g["rmse"], g["K"], g["dist"]) <= CAL_CPU_RTOL
              for k, g in gaps.items() if k != "stereo")
          and gaps["stereo"]["rmse"] <= CAL_CPU_RTOL
          and max(gaps["stereo"]["R"], gaps["stereo"]["T"]) <= CAL_STEREO_CPU_RTOL,
          "the calibration on the card agrees with the port's CPU run")
    check(max(truth["f_rel"]) <= CAL_K_RTOL and truth["R_abs"] <= CAL_R_ATOL
          and truth["T_abs"] <= CAL_T_ATOL, "the calibration agrees with the truth")

    # The rig on disk, and the headline block on it.
    with tempfile.TemporaryDirectory() as tmp:
        cams = {side: write_calibrated_rig(os.path.join(tmp, side), cal[side])
                for side in ("cuda", "cpu")}
    for side in ("cuda", "cpu"):
        cam_r, c_r = cams[side], cal[side]
        check(np.array_equal(cam_r["R"][0], np.eye(3)) and not cam_r["T"][0].any(),
              "the origin camera at R = I, T = 0")
        check(rel_gap(cam_r["K"][1], c_r["cameras"][1]["K"]) < 1e-15
              and rel_gap(cam_r["R"][1], c_r["stereo"]["R"]) < 1e-15,
              "the rig read back from its .dat files")
    calibrated = ShardedPosePipeline(pipe.estimator, cams["cuda"], device=dev)
    calibrated.run(blocks_u8[0])  # warm-up
    torch.cuda.synchronize()
    out, dt, launches = timed_blocks(calibrated, blocks_u8, N_BLOCKS)
    block = blocks_u8[(N_BLOCKS - 1) % len(blocks_u8)]
    ref = pipe.run(block)
    cpu_rig = ShardedPosePipeline(pipe.estimator, cams["cpu"], device=dev).run(block)
    same_2d = torch.equal(out["kpts_2d"].nan_to_num(7.0), ref["kpts_2d"].nan_to_num(7.0))
    k3, k3_cpu = out["kpts_3d"], cpu_rig["kpts_3d"]
    nan_same = torch.equal(k3.isnan(), k3_cpu.isnan())
    fin = torch.isfinite(k3) & torch.isfinite(k3_cpu)
    gap_3d = float((k3[fin] - k3_cpu[fin]).abs().max() / k3_cpu[fin].abs().max())
    res["fps"] = T * N_BLOCKS / dt
    res["kpts_3d_rel_gap"] = gap_3d
    res["launches"]["calibrated_rig"] = launches
    log(f"  headline block on the calibrated rig: {N_BLOCKS} blocks of ({T}, {C}, {H}, {W}, 3) in "
        f"{dt:.3f} s -> {res['fps']:.1f} frames/s (phase 3 {phase3_fps:.1f}); launches {launches}; "
        f"kpts_2d equal to phase 3's bit for bit: {same_2d}; kpts_3d against the CPU-calibrated "
        f"rig {gap_3d:.3g} of the largest (limit {CAL_3D_RTOL}), NaN where NaN: {nan_same}, "
        f"finite share {float(fin.float().mean()):.4f}")
    check(launches["bottleneck"] == 4 * N_BLOCKS and launches["heatmap_decode"] == N_BLOCKS
          and launches["bn_epilogue"] == EPI_HRNET * N_BLOCKS,
          f"the calibrated rig: 4 Bottleneck, {EPI_HRNET} ConvBN epilogue and 1 decode launch "
          "per block")
    check(same_2d, "kpts_2d on the calibrated rig equal phase 3's bit for bit")
    check(nan_same and gap_3d <= CAL_3D_RTOL, "kpts_3d on the card's and the CPU's rigs agree")
    check_outputs(out, calibrated, T)
    return res


# Phase 24: the last modules (profiling, keypoint conversion, the detector
# mirrors, doctor).
TRACE_BLOCKS = 2  # headline blocks under utils.trace
TIMER_BLOCKS = 4  # headline blocks streamed under StepTimer
MIRROR_SEED = 24  # the detector mirrors' randomize_ seed
MIRROR_BATCH = 4  # 640x640 frames through each detector
MIRROR_REL_TOL = 1e-4  # raw head outputs, float32 with TF32 off, of the largest output
LIFT = ("Body3DH36MDataset", "Body3DMpiInf3dhpDataset")
# The rows of doctor's report that decide its exit code (cv2 and yaml are optional).
DOCTOR_REQUIRED = ("import torch", "import numpy", "native mediadec", "4-rank gloo CPU mesh",
                   "device backend", "kernel libraries")


def trace_kernel_counts(path: str, runs: slice) -> dict:
    """CUDA kernels in a Chrome trace written by `utils.trace`, by the
    substrings `profile_block.py` files the port's kernels under: those
    launched inside the ``mc3d.pipeline.run`` spans that ``runs`` selects
    (in time order), each kernel matched to its launch by correlation id."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("name") == "mc3d.pipeline.run" and e.get("ph") == "X")[runs]
    launched = {e["args"]["correlation"]: e["ts"] for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    names = [e["name"] for e in events if e.get("cat") == "kernel"
             and any(a <= launched.get(e["args"].get("correlation"), -1) <= b for a, b in spans)]
    return {"bottleneck": sum("bottleneck_kernel" in n for n in names),
            "heatmap_decode": sum("decode_kernel" in n for n in names),
            "bn_epilogue": sum("bn_epilogue_kernel" in n for n in names),
            "all_kernels": len(names)}


def run_trace_and_timer(dev, pipe, blocks_u8, phase3_fps: float, res: dict) -> None:
    """(a) `utils.trace` around TRACE_BLOCKS headline blocks between a
    lead-in and a lead-out block, the trace parsed for the stage-1, decode
    and ConvBN epilogue kernels the counted blocks launched; (b) `StepTimer` over TIMER_BLOCKS streamed
    blocks."""
    import tempfile

    import torch
    from multi_camera_3d_pose_estimation_tpu_torch.io import stage_blocks
    from multi_camera_3d_pose_estimation_tpu_torch.utils import StepTimer, trace

    counters = kernel_counters()
    with tempfile.TemporaryDirectory() as tmp:
        with trace(tmp) as prof:
            # The profiler's device timestamps drift from its host clock as
            # a process runs (on an H100, kernels placed up to ~10 ms off
            # their launches after 5 minutes), and it drops the device
            # events it places outside its capture window: a lead-in and a
            # lead-out block, not counted, take that loss.
            pipe.run(blocks_u8[-1])
            torch.cuda.synchronize()
            for fn in counters.values():
                fn.launches = 0
            t0 = time.perf_counter()
            outs = [pipe.run(blocks_u8[i % len(blocks_u8)]) for i in range(TRACE_BLOCKS)]
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            launches = {k: fn.launches for k, fn in counters.items()}
            pipe.run(blocks_u8[-1])
        in_trace = trace_kernel_counts(prof.trace_path, slice(1, 1 + TRACE_BLOCKS))
        size = os.path.getsize(prof.trace_path)
    res["launches"]["trace"] = launches
    res["trace_fps"] = T * TRACE_BLOCKS / dt
    res["trace_kernels"] = in_trace
    refs = [pipe.run(blocks_u8[i % len(blocks_u8)]) for i in range(TRACE_BLOCKS)]
    same = all(torch.equal(o[k].nan_to_num(7.0), r[k].nan_to_num(7.0))
               for o, r in zip(outs, refs) for k in o)
    log(f"  (a) trace: {TRACE_BLOCKS} blocks of ({T}, {C}, {H}, {W}, 3) under the profiler in "
        f"{dt:.3f} s -> {res['trace_fps']:.1f} frames/s (phase 3, no profiler: "
        f"{phase3_fps:.1f}); the trace file {size / 1e6:.2f} MB, {in_trace['all_kernels']} CUDA "
        f"kernels launched in the counted blocks, of them stage-1 {in_trace['bottleneck']}, decode "
        f"{in_trace['heatmap_decode']} and ConvBN epilogue {in_trace['bn_epilogue']}; the "
        f"wrappers counted {launches}; outputs equal to "
        f"phase 3's bit for bit: {same}")
    check(in_trace["bottleneck"] == 4 * TRACE_BLOCKS
          and in_trace["heatmap_decode"] == TRACE_BLOCKS
          and in_trace["bn_epilogue"] == EPI_HRNET * TRACE_BLOCKS,
          f"the trace holds 4 stage-1, {EPI_HRNET} ConvBN epilogue and 1 decode kernel per block")
    check(all(launches[k] == in_trace[k] for k in ("bottleneck", "heatmap_decode", "bn_epilogue")),
          "the wrappers counted the kernels the trace holds")
    check(same, "the traced blocks' outputs equal phase 3's bit for bit")

    host = [b.cpu().numpy() for b in blocks_u8]
    timer = StepTimer(block_jax=True)
    for fn in counters.values():
        fn.launches = 0
    staged = stage_blocks(((host[i % len(host)], T) for i in range(TIMER_BLOCKS)), dev)
    n_out = 0
    while True:
        with timer.stage("staged"):
            item = next(staged, None)
        if item is None:
            break
        with timer.stage("compute"):
            out = pipe.run(item[0])
        with timer.stage("drain"):
            n_out += out["kpts_2d"].cpu().shape[0]
    res["launches"]["step_timer"] = {k: fn.launches for k, fn in counters.items()}
    log(f"  (b) StepTimer over {TIMER_BLOCKS} streamed blocks (synchronized per stage):")
    report = timer.report()
    res["step_timer"] = {k: {"s": timer.totals[k], "calls": timer.counts[k]} for k in timer.totals}
    check(n_out == T * TIMER_BLOCKS and timer.counts["compute"] == TIMER_BLOCKS
          and timer.counts["staged"] == TIMER_BLOCKS + 1 and "compute: " in report,
          "StepTimer timed every stage of every block")
    check(res["launches"]["step_timer"]["bottleneck"] == 4 * TIMER_BLOCKS
          and res["launches"]["step_timer"]["bn_epilogue"] == EPI_HRNET * TIMER_BLOCKS,
          f"the streamed blocks launched the stage-1 kernel 4 times and the ConvBN epilogue "
          f"{EPI_HRNET} times each")


def run_cost_profile(dev, res: dict) -> None:
    """(c) `profile_refinement_costs` on phase 14's scene, float32 and float64."""
    import contextlib
    import io

    import torch
    from multi_camera_3d_pose_estimation_tpu_torch.refine import PoseRefiner
    from multi_camera_3d_pose_estimation_tpu_torch.utils import profile_refinement_costs

    gauss, noisy, cams, _ = refine_scene()
    res["cost_ms"] = {}
    for dtype in (torch.float32, torch.float64):
        ref = PoseRefiner(gauss, noisy, cams, body_lengths=REFINE_BODY, dtype=dtype, device=dev)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            times = profile_refinement_costs(ref, n_iters=50)
        name = str(dtype).split(".")[-1]
        res["cost_ms"][name] = {k: v * 1e3 for k, v in times.items()}
        log(f"  (c) refinement costs, {name}, 400 x 17 x 4, ms per evaluation (synchronized): "
            + ", ".join(f"{k} {v * 1e3:.4f}" for k, v in times.items())
            + f"; {buf.getvalue().strip()}")
        check(list(times) == ["likelihood_cost", "smoothness_cost", "body_length_cost"]
              and all(v > 0 for v in times.values()), f"every cost timed in {name}")


def run_keypoint_conversion(pipe, blocks_u8, res: dict) -> None:
    """(d) The headline block's kpts of every frame and camera converted on
    the card and on the CPU (tensor and numpy paths): bit for bit."""
    import numpy as np
    import torch
    from multi_camera_3d_pose_estimation_tpu_torch.utils import convert_keypoint_definition

    kpts = pipe.run(blocks_u8[0])["kpts_2d"]  # (T, 17, 3, C) on the card
    per_cam = kpts.permute(0, 3, 1, 2).reshape(-1, 17, 3)  # (T*C, 17, 3)
    host = per_cam.cpu().numpy()
    n_same = n = 0
    t0 = time.perf_counter()
    for lift in LIFT:
        for i in range(per_cam.shape[0]):
            card = convert_keypoint_definition(per_cam[i], "TopDownCocoDataset", lift)
            cpu = convert_keypoint_definition(host[i], "TopDownCocoDataset", lift)
            cpu_t = convert_keypoint_definition(torch.from_numpy(host[i]), "TopDownCocoDataset",
                                                lift)
            a = card.cpu().numpy()
            n += 1
            n_same += (card.is_cuda and np.array_equal(a, cpu, equal_nan=True)
                       and np.array_equal(cpu_t.numpy(), cpu, equal_nan=True))
    dt = time.perf_counter() - t0
    res["keypoint_conversion"] = {"conversions": n, "bit_for_bit": n_same, "seconds": dt}
    log(f"  (d) keypoint conversion COCO -> H36M and MPI-INF-3DHP of {per_cam.shape[0]} frames x "
        f"cameras on the card: {n_same} of {n} bit for bit the CPU result ({dt:.2f} s, "
        f"CPU and card calls together)")
    check(n_same == n == 2 * T * C, "keypoint conversion on the card is bit for bit the CPU's")


def run_detector_mirrors(dev, res: dict) -> None:
    """(e) RTMDet-m and YOLOX-s from ``.pth`` files written by the port's
    MMDet mirrors, built by `build_detector(checkpoint=)` in float32: the
    raw head outputs against the mirror's own forward (TF32 off)."""
    import tempfile

    import torch
    from multi_camera_3d_pose_estimation_tpu_torch.models import registry
    from multi_camera_3d_pose_estimation_tpu_torch.models.mirrors import rtmdet as mr
    from multi_camera_3d_pose_estimation_tpu_torch.models.mirrors import yolox as my

    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(MIRROR_SEED)
    x = torch.rand(MIRROR_BATCH, 3, 640, 640, generator=gen).to(dev)
    res["mirrors"] = {}
    try:
        with tempfile.TemporaryDirectory() as tmp:
            for name, cls, randomize_ in (("rtmdet_m", mr.MMDetRTMDet, mr.randomize_),
                                          ("yolox_s", my.MMDetYOLOX, my.randomize_)):
                mirror = cls(registry.DETECTOR_REGISTRY[name]["cfg"])
                randomize_(mirror, seed=MIRROR_SEED)
                path = os.path.join(tmp, f"{name}.pth")
                torch.save({"state_dict": mirror.state_dict()}, path)
                det = registry.build_detector(name, checkpoint=path, device=dev,
                                              dtype=torch.float32)
                mirror = mirror.to(dev).eval()
                with torch.inference_mode():
                    want = mirror.bbox_head(mirror.neck(mirror.backbone(x)))
                    got = det.model(x)["raw"]
                    wb, ws = mirror(x)
                pairs = [(g, w.permute(0, 2, 3, 1)) for gl, wl in zip(got, want)
                         for g, w in zip(gl, wl)]
                scale = max(w.abs().max().item() for _, w in pairs)
                err = max((g - w).abs().max().item() for g, w in pairs)
                res["mirrors"][name] = {"max_abs_err": err, "scale": scale,
                                        "outputs": len(pairs)}
                log(f"  (e) {name} from the port's mirror (.pth {os.path.getsize(path) / 1e6:.1f} "
                    f"MB): {len(pairs)} raw head outputs of ({MIRROR_BATCH}, 3, 640, 640), "
                    f"max |built - mirror| {err:.4g} (tolerance {MIRROR_REL_TOL} x {scale:.4g}); "
                    f"the mirror's decoded boxes {tuple(wb.shape)}, scores {tuple(ws.shape)}")
                check(err <= MIRROR_REL_TOL * scale and bool(torch.isfinite(wb).all()),
                      f"{name} built from the mirror's .pth agrees with the mirror")
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


def run_doctor(card: str, res: dict) -> None:
    """(f) The doctor command in a subprocess; its rows against the card."""
    import torch
    from multi_camera_3d_pose_estimation_tpu_torch import _native

    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", PORT, "doctor", "--require_device",
                           "--probe_timeout", "300"], cwd=ROOT, capture_output=True, text=True,
                          timeout=600, env=dict(os.environ, PYTHONPATH=ROOT))
    dt = time.perf_counter() - t0
    lines = proc.stdout.strip().splitlines()
    log(f"  (f) doctor --require_device: exit code {proc.returncode} in {dt:.1f} s")
    for line in lines:
        log(f"    {line}")
    rows = {}  # name -> (status, detail), from "<name padded>  <status padded to 4>  <detail>"
    for line in lines[:-1]:
        m = re.match(r"^(.+?) {2,}(ok|FAIL) *(.*)$", line)
        if m:
            rows[m.group(1)] = (m.group(2), m.group(3))
    res["doctor"] = {"exit_code": proc.returncode, "seconds": dt,
                     "rows": {k: v[0] for k, v in rows.items()}}
    name = torch.cuda.get_device_name(0)
    dev_row = rows.get("device backend", ("", ""))
    check(dev_row[0] == "ok" and dev_row[1] == f"cuda × 1 ({name})",
          f"doctor's device row says cuda × 1 ({name})")
    kern = rows.get("kernel libraries", ("", ""))
    check(kern[0] == "ok" and kern[1].endswith(",".join(_native.SOURCES)),
          "doctor's kernel row lists every kernel library built and loaded")
    check(rows.get("4-rank gloo CPU mesh", ("",))[0] == "ok", "doctor's gloo row is ok")
    all_ok = all(rows.get(r, ("FAIL",))[0] == "ok" for r in DOCTOR_REQUIRED)
    check((proc.returncode == 0) == all_ok and proc.returncode in (0, 1)
          and lines[-1] == f"doctor: {'healthy' if all_ok else 'PROBLEMS FOUND'}",
          "doctor's exit code is 0 exactly when every required row is ok")
    import importlib.util

    log(f"  doctor on this machine ({card}): required rows ok: {all_ok}; media runtime "
        f"{rows.get('native mediadec', ('?', ''))[0]}; matplotlib importable: "
        f"{importlib.util.find_spec('matplotlib') is not None}")


def run_last_modules_phase(dev, pipe, blocks_u8, phase3_fps: float, card: str) -> dict:
    """Phase 24: (a)-(f) of the docstring."""
    res = {"launches": {}}
    log("phase 24: the last modules (profiling, keypoint conversion, detector mirrors, doctor)")
    run_trace_and_timer(dev, pipe, blocks_u8, phase3_fps, res)
    run_cost_profile(dev, res)
    run_keypoint_conversion(pipe, blocks_u8, res)
    run_detector_mirrors(dev, res)
    run_doctor(card, res)
    return res


W48_INPUT = (288, 384)  # (w, h): the registry's coco_hrnet_w48


def run_published_widths_phase(dev, gen, blocks_u8, card: str) -> dict:
    """Phase 25: the registry's other two heatmap models at full width.
    HRNet-W48 at 288x384 on the headline blocks (4 Bottleneck and 1 decode
    launch per block), its kernels against their plain versions at 96x72,
    and a small W48-width pipeline card against CPU; then Swin-L chained
    and with ``MC3D_SWIN_FIXED=1`` (96 swin_gemm, 48 LayerNorm row-kernel,
    24 attention and 1 decode launch per block), each stage's block,
    products, attention (and fixed stage) against their plain versions.
    Prints frames/s, peak memory and every kernel row beside the card."""
    import torch
    from multi_camera_3d_pose_estimation_tpu_torch.models.hrnet import HRNET_W48
    from multi_camera_3d_pose_estimation_tpu_torch.models.swin import SWIN_L

    w48 = run_hrnet_main_path(dev, HRNET_W48, W48_INPUT, blocks_u8, "HRNet-W48")
    rows = check_hrnet_kernels(w48.pop("pipe").estimator, blocks_u8[0], dev, w48["launches"],
                               config=f"HRNet-W48 {W48_INPUT[0]}x{W48_INPUT[1]}",
                               label="HRNet-W48 ", suffix="_w48")
    torch.cuda.empty_cache()
    check_small_pipeline(gen, family="hrnet", label="W48-width ", small="hrnet_w48")

    swin = run_swin_main_path(dev, gen, SWIN_L, "Swin-L", suffix="_swin_l")
    rows += check_swin_kernels(swin, dev)
    with fixed_layout():
        fixed = run_fixed_main_path(swin)
        rows += check_fixed_kernels(swin, fixed, dev)
    del swin["pipe"], swin["blocks"], swin["frames"]
    torch.cuda.empty_cache()

    res = {"launches": {"hrnet_w48": w48["launches"], "swin_l": swin["launches"],
                        "swin_l_fixed": fixed["launches"]},
           "paths": {name: {k: r[k] for k in ("fps", "peak_bytes", "held_bytes")}
                     for name, r in (("hrnet_w48", w48), ("swin_l", swin),
                                     ("swin_l_fixed", fixed))}}
    for name, r in res["paths"].items():
        log(f"[{card}] {name}: {r['fps']:.1f} multi-camera frames/s; "
            f"torch.cuda.max_memory_allocated {r['peak_bytes'] / 2 ** 30:.3f} GiB over the "
            f"timed blocks ({r['held_bytes'] / 2 ** 30:.3f} GiB held before them)")
    for r in rows:
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
        log(f"[{card}] {r['name']} ({r['config']}): kernel {r['ms']:.4f} ms, bound "
            f"{r['bound_ms']:.4f} ms by {r['bound_by']} ({r['bound_ms'] / r['ms']:.3f} of it), "
            f"plain {r['plain_ms']:.4f} ms, library {lib}"
            + (f"; products {r['products_ms']:.4f} ms, cuBLAS {r['products_library_ms']:.4f} "
               f"ms, bound {r['products_bound_ms']:.4f} ms" if "products_ms" in r else "")
            + (f"; SDPA {r['attention_sdpa_ms']:.4f} ms" if "attention_sdpa_ms" in r else "")
            + f"; {r['launches']} launches on its main path")
    res["rows"] = rows
    return res


# Phase 26: accuracy from trained weights (the JAX package's accuracy drills).
ACC_MODEL = "coco_hrnet_w32"
# The phase's budgets: the flagship's recipe (batch 8, warmup+cosine) at
# 150 of its 5000 steps, the train drill at 200 of its 3000, the demo at
# the JAX demo's defaults.  W32 does not train in a smoke run's time: at
# 150 / 300 / 600 recipe steps its 2D error through the kernels was
# 37.3-47.2 / 33.4 / 32.8 px (random init 51.7-53.6), so the flagship drill
# holds what its shapes test (the launches, each kernel against its plain
# version on the clip, (c) against (b) on the means).  The train drill's
# test_small_128 trains in 200 steps and runs the same stage-1 chain
# (Bottleneck(cin, 64) -> 256, cin 32 in block 0) and the same decode: the
# holds on trained weights are made there.  The runs of record use the
# examples' budgets.
ACC_BUDGET = {"pose_steps": 150, "det_steps": 100, "frames": 16, "train_cli_steps": 200,
              "demo_steps": 400, "demo_frames": 48}
# The same bf16 weights with the stage-1 and decode kernels (c) against
# cuDNN and the plain decode (b): the mean 2D and raw 3-D errors within
# ACC_REL of (b)'s (measured 0.0-3.5% on W32 from 150 to 5000 steps).
ACC_REL = 0.05
# (p) is (c) with each kernel's wrapper computing its plain version on the
# card (`plain_kernels`): the same pipeline, the kernels' arithmetic in
# plain PyTorch.  Joint by joint no two bf16 paths agree to 99% within 0.5
# px: the maps are bf16, so a peak's neighbours often tie, and the default
# decode's ±¼-pixel shift (the sign of their difference) and the argmax
# then follow any rounding.  On the train drill's 2176 trained joints 0.891
# stayed within 0.5 px between (p) and (b), neither with a kernel, and
# 0.887 between (c) and (p) (W32 at 150 steps: 0.436 and 0.482 of 544).
# Held on the trained weights: the share of (c) against (p) within
# ACC_JOINT_TOL px at least that of (p) against (b) less ACC_JOINT_MARGIN,
# i.e. the kernels move joints no more than cuDNN's stage 1 moves them from
# the same arithmetic done plainly.
ACC_JOINT_TOL = 0.5
ACC_JOINT_MARGIN = 0.03
# Through the kernels, the train drill's trained 2D error is at most
# 1/TRAINED_RANDOM_RATIO of random init's (1/10.8 measured without kernels).
TRAINED_RANDOM_RATIO = 5.0
# The example's own hold (its estimators, no stage-1 or decode kernel): at most 1/2
# (measured 1/10.8 at 200 steps, 1/38.7 at 3000).
TRAIN_CLI_RANDOM_RATIO = 2.0
TRAIN_EVAL_N = 128  # held-out images the train drill's weights are scored on
# The JAX demo's own run (examples/synthetic_demo.py --cpu, 48 frames, 400
# steps): raw triangulation 3.48 mean / 3.42 median world units, refined
# the same (its one refinement window is frozen at the 2D noise floor).
# Held: raw at most twice that run's mean (random init's is of order 150;
# the port measured 4.13-4.95 in five runs on an H100), and the refined
# mean at most 5% above the raw one (equal where the window freezes).
DEMO_RAW_MAX = 2 * 3.48
DEMO_REFINED_REL = 1.05
# The JAX package's numbers on a TPU v5e (PARITY.md, 5000 pose steps, 400
# detector steps, 48 frames; cm, as the harness reports them).
PARITY_W32 = {"mpjpe_3d": 0.98, "mpjpe_3d_median": 0.95, "mpjpe_3d_refined": 1.16,
              "px_err_2d": 0.56}


@contextlib.contextmanager
def plain_kernels():
    """Inside the block the stage-1, decode, crop and ConvBN epilogue
    wrappers compute their plain versions on the card (no launch, no count;
    the crop's is `f32_plain_crop`): path (p) of phase 26."""
    import torch
    from multi_camera_3d_pose_estimation_tpu_torch.ops import bn_epilogue as be
    from multi_camera_3d_pose_estimation_tpu_torch.ops import bottleneck as bn
    from multi_camera_3d_pose_estimation_tpu_torch.ops import fused_decode as fd

    def epilogue_plain(y, mean, mul, bias, residual, upsample, relu, lay):
        return be.bn_epilogue_plain(y, mean, mul, bias, torch.bfloat16, residual, upsample, relu)

    saved = bn._launch, fd._launch, be._launch
    bn._launch, fd._launch = bn.bottleneck_block_plain, fd.heatmap_decode_raw_plain
    be._launch = epilogue_plain
    try:
        with f32_plain_crop():
            yield
    finally:
        bn._launch, fd._launch, be._launch = saved


def joint_gaps(xy_x, xy_y) -> dict:
    """Per-joint distances between two decodes of the same joints (..., 2):
    the shares within 0.5, 1 and 2 px, the 99th percentile and the largest."""
    import numpy as np

    dist = np.linalg.norm(np.asarray(xy_x, np.float64) - np.asarray(xy_y, np.float64), axis=-1)
    return {"n": int(dist.size), **{f"within_{t:g}": float((dist <= t).mean()) for t in
                                    (0.5, 1.0, 2.0)},
            "p99": float(np.percentile(dist, 99)), "max": float(dist.max())}


def log_gaps(label: str, gaps: dict) -> None:
    log(f"  {label}, {gaps['n']} joints: within 0.5 / 1 / 2 px {gaps['within_0.5']:.4f} / "
        f"{gaps['within_1']:.4f} / {gaps['within_2']:.4f}, p99 {gaps['p99']:.4f} px, largest "
        f"{gaps['max']:.4f} px")


def check_kernel_launches(label: str, launches: dict, way: str, forwards: int,
                          epilogues: tuple) -> None:
    """(a), (b) and (c): 1 crop launch per flip-TTA pair (the crop kernel is
    on every card path); (b) and (c), bf16, also one ConvBN epilogue launch
    per BatchNorm a forward (``epilogues``: (b)'s with the stage-1 chain
    plain, (c)'s with it in the Bottleneck kernel), (a) in f32 none; (c)
    also 4 Bottleneck launches per model forward and 1 decode launch per
    flip-TTA pair; (p): no launch.  (The detector is f32: no launch.)"""
    if way == "p":
        check(not any(launches.values()), f"{label} (p) launches no kernel")
        return
    stage1 = way == "c"
    want = dict(bottleneck=4 * forwards if stage1 else 0,
                heatmap_decode=forwards // 2 if stage1 else 0, swin_gemm=0, window_attention=0,
                window_attention_rows=0, crop_resample=forwards // 2,
                bn_epilogue=0 if way == "a" else epilogues[stage1] * forwards)
    check(launches == want, f"{label} ({way}): {want} in {forwards} forwards")


def deploy_ways(dev, f32_model, bf16_model, detector, scene, input_size, n_frames: int,
                label: str) -> dict:
    """One pose model's weights deployed behind ``detector`` on the harness's
    validation clip four ways: (a) the JAX recipe (f32, flip-TTA, DARK, the
    stage-1 and decode kernels off), (b) bf16, flip-TTA, the default decode,
    those kernels off, (c) as (b) with the stage-1 and decode kernels, (p)
    as (c) with each kernel wrapper (the crop's included) computing its
    plain version.  Every count is set to 0 just before each
    deploy and read just after.  Returns {way: (metrics, the pipeline's
    output, the clip, launches, seconds)}."""
    import torch
    from multi_camera_3d_pose_estimation_tpu_torch.training import harness

    kernels = {"use_fused_stage1": True, "use_fused_decode": True}
    ways = {"a": (f32_model, {"decode_mode": "dark"}), "b": (bf16_model, {}),
            "c": (bf16_model, kernels), "p": (bf16_model, kernels)}
    counters = kernel_counters()
    res = {}
    for way, (model, kw) in ways.items():
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        with plain_kernels() if way == "p" else contextlib.nullcontext():
            metrics, out, clip = harness._deploy_and_score(
                model, input_size, detector, scene, n_frames, 0, "heatmap", device=dev,
                flip_test=True, **kw)
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in counters.items()}
        res[way] = (metrics, out, clip, launches, dt)
        log(f"  {label} ({way}): mpjpe_3d {metrics['mpjpe_3d']:.4f} cm (median "
            f"{metrics['mpjpe_3d_median']:.4f}, refined {metrics['mpjpe_3d_refined']:.4f}), "
            f"px_err_2d {metrics['px_err_2d']:.4f} px, flip shift/noshift "
            f"{metrics['px_err_flip_shift']:.4f}/{metrics['px_err_flip_noshift']:.4f} px, "
            f"det_tight_frac {metrics['det_tight_frac']:.3f}; {dt:.2f} s; launches {launches}")
    return res


def run_flagship_drill(dev, pose_steps: int, det_steps: int, n_frames: int,
                       workdir: str) -> dict:
    """HRNet-W32 and the CenterNet (top-1) trained by the accuracy harness
    (its flagship recipe) for ``pose_steps`` / ``det_steps``, resumed from
    ``workdir``'s files where a harness run left them, the weights saved and
    built back in bf16, and scored on ``n_frames`` x 2 cameras four ways
    (`deploy_ways`), then random init's the same way.  Held: the launches,
    each stage-1 block and the decode against their plain versions on the
    trained weights' inputs from the clip, and (c) against (b) on the means.
    Printed: the per-joint gaps of (c) to (p) and (b), and of (p) to (b),
    and the trained 2D error against random init's (at this budget W32's
    maps are still near random init's: `run_train_cli_drill` holds both on
    trained weights)."""
    import numpy as np
    import torch
    from multi_camera_3d_pose_estimation_tpu_torch.models.convert import save_checkpoint_npz
    from multi_camera_3d_pose_estimation_tpu_torch.models.registry import build_estimator
    from multi_camera_3d_pose_estimation_tpu_torch.models.topdown import TopDownEstimator
    from multi_camera_3d_pose_estimation_tpu_torch.training import harness

    t0 = time.perf_counter()
    scene, detector, det_loss, model, input_size, pose_loss = harness._train_models(
        n_cams=2, seed=0, det_steps=det_steps, pose_steps=pose_steps, pose_family="heatmap",
        pose_model_name=ACC_MODEL, distortion=None, hard=False, schedule="auto",
        workdir=workdir, device=dev)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    log(f"{ACC_MODEL}: {pose_steps} pose steps (batch 8, f32, warmup+cosine) "
        f"and {det_steps} CenterNet steps in {train_s:.1f} s (checkpoints in {workdir}, resumed "
        f"where present); last losses pose {pose_loss}, detector {det_loss}")
    path = os.path.join(workdir, "flagship_trained.npz")
    save_checkpoint_npz(model, path, "hrnet")
    bf16 = build_estimator(ACC_MODEL, checkpoint=path, device=dev).model
    trained = deploy_ways(dev, model, bf16, detector, scene, input_size, n_frames, "trained")
    untrained = deploy_ways(
        dev, build_estimator(ACC_MODEL, seed=3, dtype=torch.float32, device=dev).model,
        build_estimator(ACC_MODEL, seed=3, device=dev).model, detector, scene, input_size,
        n_frames, "random init")

    # The pipeline's block and the flip-shift pair, each through flip-TTA.
    for name, r in (("trained", trained), ("random init", untrained)):
        for way in "abcp":
            check_kernel_launches(f"W32 {name}", r[way][3], way, forwards=6,
                                  epilogues=(EPI_HRNET_PLAIN_STAGE1, EPI_HRNET))

    # Each kernel against its plain version on the trained weights' inputs
    # (full-frame crops of the clip the deploys scored, as phase 4 holds
    # random weights).
    est = TopDownEstimator(bf16, input_size=input_size, use_fused_stage1=True,
                           use_fused_decode=True, device=dev)
    clip = torch.as_tensor(trained["c"][2], device=dev)
    _, _, heat, block_errs = check_bottleneck_blocks(est, clip, dev, "trained W32 ")
    _, _, dec_err = check_decode(est, heat, "trained W32 ")
    del heat, est, clip

    def xy(way):
        return trained[way][1]["kpts_2d"][:, :, :2].float().cpu().numpy()

    gaps = {"c_p": joint_gaps(xy("c"), xy("p")), "c_b": joint_gaps(xy("c"), xy("b")),
            "p_b": joint_gaps(xy("p"), xy("b"))}
    for key, what in (("c_p", "(c) against (p)"), ("c_b", "(c) against (b)"),
                      ("p_b", "(p) against (b), no stage-1 or decode kernel on either")):
        log_gaps(f"W32 trained {what}", gaps[key])
    mb, mc = trained["b"][0], trained["c"][0]
    rel = {k: abs(mc[k] - mb[k]) / mb[k] for k in ("px_err_2d", "mpjpe_3d")}
    ratio = untrained["c"][0]["px_err_2d"] / mc["px_err_2d"]
    log(f"  W32 trained (c) against (b): px_err_2d {mc['px_err_2d']:.4f} vs "
        f"{mb['px_err_2d']:.4f} ({rel['px_err_2d']:.4f} relative), mpjpe_3d "
        f"{mc['mpjpe_3d']:.4f} vs {mb['mpjpe_3d']:.4f} cm ({rel['mpjpe_3d']:.4f} relative; at "
        f"most {ACC_REL})")
    log(f"  W32 random init through the kernels: px_err_2d {untrained['c'][0]['px_err_2d']:.4f} "
        f"px, {ratio:.2f}x the trained after {pose_steps} steps (not yet trained; the ratio is "
        f"held on the train drill's weights)")
    ma = trained["a"][0]
    log(f"  (a), the JAX recipe's deploy, beside PARITY.md (TPU v5e, 5000 steps at batch 8): "
        f"mpjpe_3d {ma['mpjpe_3d'] * 10:.3f} mm (PARITY {PARITY_W32['mpjpe_3d'] * 10:.1f}), "
        f"median {ma['mpjpe_3d_median'] * 10:.3f} mm ({PARITY_W32['mpjpe_3d_median'] * 10:.1f}), "
        f"refined {ma['mpjpe_3d_refined'] * 10:.3f} mm ({PARITY_W32['mpjpe_3d_refined'] * 10:.1f}),"
        f" px_err_2d {ma['px_err_2d']:.4f} px ({PARITY_W32['px_err_2d']}) after {pose_steps} "
        f"steps")
    check(all(v <= ACC_REL for v in rel.values()),
          f"W32: (c)'s mean 2D and raw 3-D errors within {ACC_REL} of (b)'s")
    check(all(math.isfinite(r[w][0][k]) for r in (trained, untrained) for w in "abcp"
              for k in ("mpjpe_3d", "px_err_2d")), "finite accuracy metrics")

    def keep(r):
        return {w: {**{k: v for k, v in m.items() if isinstance(v, float)}, "seconds": dt}
                for w, (m, _, _, _, dt) in r.items()}

    return {"pose_steps": pose_steps, "det_steps": det_steps, "frames": n_frames, "train_s": train_s,
            "pose_loss": pose_loss, "det_loss": det_loss, "trained": keep(trained),
            "random_init": keep(untrained), "joint_gaps": gaps, "c_vs_b_rel": rel,
            "random_ratio": ratio, "bottleneck_max_abs_err": max(block_errs),
            "decode_max_abs_err": dec_err,
            "launches": {"flagship_trained_c": trained["c"][3],
                         "flagship_random_c": untrained["c"][3]}}


def run_train_cli_drill(dev, steps: int, workdir: str) -> dict:
    """`examples.train_synthetic_coco` at ``steps``: the train command on a
    generated COCO set of 256 images under ``workdir``, and the example's
    score (its estimators, no stage-1 or decode kernel; trained at most
    1/TRAIN_CLI_RANDOM_RATIO of random init's error).  Then the same weights
    and random init's, bf16 with flip-TTA, scored on TRAIN_EVAL_N held-out
    images three ways: (b) no stage-1 or decode kernel, (c) the stage-1 and
    decode kernels, (p) as (c) with each kernel wrapper (the crop's
    included) computing its plain version.  Held: the launches, the trained error through the kernels at most
    1/TRAINED_RANDOM_RATIO of random init's, (c) against (b) on the mean,
    (c) against (p) joint by joint, and each stage-1 block and the decode
    against their plain versions on the trained weights' crops."""
    import numpy as np
    import torch
    from multi_camera_3d_pose_estimation_tpu_torch.examples import train_synthetic_coco as tsc
    from multi_camera_3d_pose_estimation_tpu_torch.models.registry import build_estimator

    args = tsc.build_parser().parse_args(["--steps", str(steps), "--device", str(dev)])
    t0 = time.perf_counter()
    res = tsc.score(args, *tsc.train_checkpoint(args, workdir))
    ckpt = os.path.join(workdir, "model.npz")
    res["seconds"] = time.perf_counter() - t0
    log(f"train drill ({res['model']}, {steps} steps, bf16): px_err {res['px_err_trained']} "
        f"trained against {res['px_err_random_init']} at random init (at most 1/"
        f"{TRAIN_CLI_RANDOM_RATIO:g}); training {res['train_wall_s']} s, drill "
        f"{res['seconds']:.1f} s")
    check(res["px_err_trained"] * TRAIN_CLI_RANDOM_RATIO <= res["px_err_random_init"],
          f"the train drill's trained error is at most 1/{TRAIN_CLI_RANDOM_RATIO:g} of random "
          f"init's")

    frames, boxes, truth = tsc.held_out_set(TRAIN_EVAL_N, args.size, args.size)
    kernels = {"use_fused_stage1": True, "use_fused_decode": True}
    counters = kernel_counters()
    xy, px, launches = {}, {}, {}
    for name, weights in (("trained", {"checkpoint": ckpt}), ("random", {"seed": 3})):
        for way, kw in (("b", {}), ("c", kernels), ("p", kernels)):
            est = build_estimator(args.model, device=dev, flip_test=True, **weights, **kw)
            for fn in counters.values():
                fn.launches = 0
            with plain_kernels() if way == "p" else contextlib.nullcontext():
                out = est.predict_batch(frames, boxes)["keypoints"][..., :2]
                xy[name, way] = out.double().cpu().numpy()
            launches[name, way] = {k: fn.launches for k, fn in counters.items()}
            px[name, way] = float(np.linalg.norm(xy[name, way] - truth, axis=-1).mean())
            log(f"  {res['model']} {name} ({way}): px_err {px[name, way]:.4f} on {TRAIN_EVAL_N} "
                f"held-out images (flip-TTA); launches {launches[name, way]}")
            check_kernel_launches(f"{res['model']} {name}", launches[name, way], way, forwards=2,
                                  epilogues=(EPI_SMALL_128_PLAIN_STAGE1, EPI_SMALL_128))
            del est

    est = build_estimator(args.model, checkpoint=ckpt, device=dev, **kernels)
    _, _, heat, block_errs = check_bottleneck_blocks(
        est, torch.as_tensor(frames[:, None], device=dev), dev, f"trained {res['model']} ",
        boxes=torch.as_tensor(boxes, dtype=torch.float32, device=dev))
    _, _, dec_err = check_decode(est, heat, f"trained {res['model']} ")
    del heat, est

    gaps = {"c_p": joint_gaps(xy["trained", "c"], xy["trained", "p"]),
            "c_b": joint_gaps(xy["trained", "c"], xy["trained", "b"]),
            "p_b": joint_gaps(xy["trained", "p"], xy["trained", "b"])}
    for key, what in (("c_p", "(c) against (p)"), ("c_b", "(c) against (b)"),
                      ("p_b", "(p) against (b), no stage-1 or decode kernel on either")):
        log_gaps(f"{res['model']} trained {what}", gaps[key])
    ratio = px["random", "c"] / px["trained", "c"]
    rel = abs(px["trained", "c"] - px["trained", "b"]) / px["trained", "b"]
    log(f"  through the kernels: trained px_err {px['trained', 'c']:.4f}, random init "
        f"{px['random', 'c']:.4f} ({ratio:.2f}x, at least {TRAINED_RANDOM_RATIO:g}x); (c) "
        f"against (b) {rel:.4f} relative (at most {ACC_REL}); joints within {ACC_JOINT_TOL} px "
        f"(c)-(p) {gaps['c_p'][f'within_{ACC_JOINT_TOL:g}']:.4f} against (p)-(b) "
        f"{gaps['p_b'][f'within_{ACC_JOINT_TOL:g}']:.4f} (at most {ACC_JOINT_MARGIN} below)")
    check(ratio >= TRAINED_RANDOM_RATIO,
          f"through the kernels the trained 2D error is at most 1/{TRAINED_RANDOM_RATIO:g} of "
          f"random init's")
    check(rel <= ACC_REL, f"{res['model']}: (c)'s mean 2D error within {ACC_REL} of (b)'s")
    within = f"within_{ACC_JOINT_TOL:g}"
    check(gaps["c_p"][within] >= gaps["p_b"][within] - ACC_JOINT_MARGIN,
          f"on trained weights (c) keeps as many joints within {ACC_JOINT_TOL} px of (p) as (p) "
          f"keeps of (b), less {ACC_JOINT_MARGIN}")
    res["kernels"] = {"px_err": {f"{n}_{w}": v for (n, w), v in px.items()},
                      "random_ratio": ratio, "c_vs_b_rel": rel, "joint_gaps": gaps,
                      "bottleneck_max_abs_err": max(block_errs), "decode_max_abs_err": dec_err}
    res["launches"] = {"train_drill_trained_c": launches["trained", "c"],
                       "train_drill_random_c": launches["random", "c"]}
    return res


def run_demo_drill(dev, steps: int, n_frames: int) -> dict:
    """`examples.synthetic_demo` steps 1-6 on the card, as its ``run_demo``
    calls them: the rig's ``.mp4`` videos written and read back through cv2,
    the 5-joint model trained, the estimate command on the videos, the
    refine command; the 3-D errors held as the JAX demo's own run shows them
    (DEMO_RAW_MAX, DEMO_REFINED_REL).  Step 7 needs matplotlib, which the
    card's machine lacks."""
    import cv2
    import numpy as np
    from multi_camera_3d_pose_estimation_tpu_torch.examples import synthetic_demo as demo

    info = cv2.getBuildInformation()
    video = info[info.find("Video I/O"):].split("\n\n")[0]
    log(f"cv2 {cv2.__version__}; " + " | ".join(line.strip() for line in video.splitlines()))
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        rng = np.random.default_rng(0)
        traj = demo.simulate_trajectory(n_frames)
        cams, videos, rec_dir = demo.write_rig(tmp, traj, rng)
        counts = []
        for path in videos:
            cap = cv2.VideoCapture(path)
            n = 0
            while cap.read()[0]:
                n += 1
            cap.release()
            counts.append(n)
        ckpt = demo.train_model(tmp, traj, cams, rng, steps, str(dev))
        raw, raw_median = demo.estimate(tmp, videos, rec_dir, ckpt, traj, str(dev))
        _, refined, refined_median = demo.refine(tmp, rec_dir, traj, str(dev))
    dt = time.perf_counter() - t0
    log(f"demo ({n_frames} frames, {steps} steps): raw MPJPE {raw:.4f} / median "
        f"{raw_median:.4f}, refined {refined:.4f} / median {refined_median:.4f} world units "
        f"(the JAX demo's CPU run: 3.48 / 3.42, refined the same); frames read back per video "
        f"{counts}; {dt:.1f} s")
    check(counts == [n_frames] * len(counts), "cv2 reads back every frame of the demo's videos")
    check(raw <= DEMO_RAW_MAX, f"the demo's raw MPJPE at most {DEMO_RAW_MAX}")
    check(refined <= DEMO_REFINED_REL * raw,
          f"the demo's refined MPJPE at most {DEMO_REFINED_REL} x the raw one")
    return {"mpjpe_raw": raw, "mpjpe_raw_median": raw_median, "mpjpe_refined": refined,
            "mpjpe_refined_median": refined_median, "seconds": dt, "cv2": cv2.__version__}


def run_accuracy_phase(dev, budget: dict, workdir: str) -> dict:
    """Phase 26: the flagship drill, the train drill and the demo at
    ``budget`` (`ACC_BUDGET`'s keys), their files under ``workdir``."""
    import torch

    flagship_dir, train_dir = os.path.join(workdir, "flagship"), os.path.join(workdir, "train")
    os.makedirs(flagship_dir, exist_ok=True)
    os.makedirs(train_dir, exist_ok=True)
    res = {"flagship": run_flagship_drill(dev, budget["pose_steps"], budget["det_steps"],
                                          budget["frames"], flagship_dir)}
    torch.cuda.empty_cache()
    res["train_cli"] = run_train_cli_drill(dev, budget["train_cli_steps"], train_dir)
    torch.cuda.empty_cache()
    res["demo"] = run_demo_drill(dev, budget["demo_steps"], budget["demo_frames"])
    res["launches"] = res["flagship"].pop("launches") | res["train_cli"].pop("launches")
    torch.cuda.empty_cache()
    return res


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
    from multi_camera_3d_pose_estimation_tpu_torch.models.hrnet import HRNET_W32
    from multi_camera_3d_pose_estimation_tpu_torch.models.swin import SWIN_B

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
    gen = torch.Generator().manual_seed(1)
    blocks_u8 = [torch.randint(0, 256, (T, C, H, W, 3), generator=gen, dtype=torch.uint8).to(dev)
                 for _ in range(2)]
    headline = run_hrnet_main_path(dev, HRNET_W32, INPUT, blocks_u8, "HRNet-W32")
    pipe, fps, launches = headline["pipe"], headline["fps"], headline["launches"]

    # 4. Each kernel against its plain version, on the main path's inputs.
    hrnet_rows = check_hrnet_kernels(pipe.estimator, blocks_u8[0], dev, launches,
                                     config=f"HRNet-W32 {INPUT[0]}x{INPUT[1]}")
    crop_rows = check_crop_kernel(dev, launches)

    # 5. The pipeline on the card against the plain CPU path, small size.
    check_small_pipeline(gen, family="hrnet")

    # 6. The Swin-B main path at full width.
    swin = run_swin_main_path(dev, gen, SWIN_B, "Swin-B")
    # 7. One SwinBlock of each stage and its attention against the plain versions.
    swin_rows = check_swin_kernels(swin, dev)
    # 8. A small Swin pipeline on the card against the plain CPU path.
    check_small_pipeline(gen, family="swin")

    # 9-11. The fixed-order Swin layout: main path, kernels, small pipeline.
    with fixed_layout():
        fixed = run_fixed_main_path(swin)
        fixed_rows_json = check_fixed_kernels(swin, fixed, dev)
        check_small_pipeline(gen, family="swin", label="fixed-order ")

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
    # 19. The artifact chain: project files, checkpoint, streamed blocks, reuse, refine CLI.
    artifact = run_artifact_chain(dev, fps)
    # 20. Training at full width, and the trained weights deployed.
    t20 = time.perf_counter()
    log(f"phases 1-19 took {t20 - wall0:.1f} s")
    training = run_training_phase(dev, blocks_u8[0])
    log(f"phase 20 took {time.perf_counter() - t20:.1f} s")
    # 21. Weights from an MMPose .pth: the drill, the builders, the pipelines, the estimate CLI.
    t21 = time.perf_counter()
    pth = run_pth_phase(dev, blocks_u8, fps)
    pth["seconds"] = time.perf_counter() - t21
    log(f"phase 21 took {pth['seconds']:.1f} s")
    # 22. The mesh paths as a one-rank NCCL group.
    t22 = time.perf_counter()
    mesh = run_mesh_phase(dev, pipe, blocks_u8, fps, swin)
    mesh["seconds"] = time.perf_counter() - t22
    log(f"phase 22 took {mesh['seconds']:.1f} s")
    # 23. The calibration chain on the card, and the headline block on its rig.
    t23 = time.perf_counter()
    calibration = run_calibration_phase(dev, pipe, blocks_u8, fps)
    calibration["seconds"] = time.perf_counter() - t23
    log(f"phase 23 took {calibration['seconds']:.1f} s")
    # 24. The last modules: trace, StepTimer, cost profile, keypoint conversion,
    # the detector mirrors, doctor.
    t24 = time.perf_counter()
    last = run_last_modules_phase(dev, pipe, blocks_u8, fps, card)
    last["seconds"] = time.perf_counter() - t24
    log(f"phase 24 took {last['seconds']:.1f} s")
    # 25. HRNet-W48 at 288x384 and Swin-L (chained and fixed) through every kernel.
    t25 = time.perf_counter()
    published = run_published_widths_phase(dev, gen, blocks_u8, card)
    published["seconds"] = time.perf_counter() - t25
    log(f"phase 25 took {published['seconds']:.1f} s")
    # 26. Accuracy from trained weights: the flagship drill, the train drill, the demo.
    t26 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        accuracy = run_accuracy_phase(dev, ACC_BUDGET, tmp)
    accuracy["seconds"] = time.perf_counter() - t26
    log(f"phase 26 took {accuracy['seconds']:.1f} s")

    # 27. The ConvBN epilogue kernel on a W32 block's shapes.
    t27 = time.perf_counter()
    epilogue_rows = run_bn_epilogue_phase(dev, card, launches)
    log(f"phase 27 took {time.perf_counter() - t27:.1f} s")

    # 28. Results.
    hrnet_rows[0]["flip_path_launches"] = nview["launches"]["bottleneck"]
    hrnet_rows[1]["flip_path_launches"] = nview["launches"]["heatmap_decode"]
    epilogue_rows[0]["flip_path_launches"] = nview["launches"]["bn_epilogue"]
    epilogue_rows[0]["swin_launches"] = swin["launches"]["bn_epilogue"]
    epilogue_rows[0]["swin_fixed_launches"] = fixed["launches"]["bn_epilogue"]
    for row in hrnet_rows + crop_rows + swin_rows + fixed_rows_json + epilogue_rows:
        row["launches_phases_15_17"] = {
            path: sum(r["launches"][c] for c in ROW_COUNTERS[row["name"]])
            for path, r in paths.items()}
        row["launches_phase_19"] = {
            f"block_{bs}": sum(n[c] for c in ROW_COUNTERS[row["name"]])
            for bs, n in artifact["launches"].items()}
        row["launches_phase_20"] = {
            what: sum(n[c] for c in ROW_COUNTERS[row["name"]])
            for what, n in training["launches"].items()}
        row["launches_phase_21"] = {
            what: sum(n[c] for c in ROW_COUNTERS[row["name"]])
            for what, n in pth["launches"].items()}
        row["launches_phase_22"] = {
            what: sum(n[c] for c in ROW_COUNTERS[row["name"]])
            for what, n in mesh["launches"].items()}
        row["launches_phase_23"] = {
            what: sum(n[c] for c in ROW_COUNTERS[row["name"]])
            for what, n in calibration["launches"].items()}
        row["launches_phase_24"] = {
            what: sum(n[c] for c in ROW_COUNTERS[row["name"]])
            for what, n in last["launches"].items()}
        row["launches_phase_25"] = {
            what: sum(n.get(c, 0) for c in ROW_COUNTERS[row["name"]])
            for what, n in published["launches"].items()}
        row["launches_phase_26"] = {
            what: sum(n[c] for c in ROW_COUNTERS[row["name"]])
            for what, n in accuracy["launches"].items()}
    kernels = (hrnet_rows + crop_rows + swin_rows + fixed_rows_json + published["rows"]
               + epilogue_rows)
    wall = time.perf_counter() - wall0
    log(f"chip_smoke wall time {wall:.1f} s")
    det = paths["rtmdet_m"]
    print(json.dumps({"kernels": kernels, "frames_per_s": fps,
                      "swin_frames_per_s": swin["fps"],
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
                      "artifact_chain": {k: v for k, v in artifact.items() if k != "launches"},
                      "training": {k: v for k, v in training.items() if k != "launches"},
                      "pth": {k: v for k, v in pth.items() if k != "launches"},
                      "mesh_frames_per_s": mesh["mesh_frames_per_s"],
                      "multiclip_frames_per_s": mesh["multiclip_frames_per_s"],
                      "mesh": {k: v for k, v in mesh.items() if k != "launches"},
                      "calibration": {k: v for k, v in calibration.items() if k != "launches"},
                      "last_modules": {k: v for k, v in last.items() if k != "launches"},
                      "published_widths": {k: v for k, v in published.items()
                                           if k not in ("launches", "rows")},
                      "accuracy": {k: v for k, v in accuracy.items() if k != "launches"},
                      "wall_s": wall}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

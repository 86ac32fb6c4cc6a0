"""PyTorch/CUDA port of `multi_camera_3d_pose_estimation_tpu` for NVIDIA Hopper.

A package of its own: it imports ``torch`` and never ``jax``, and nothing of
the JAX package (which stays the reference the port is tested against).
Module layout and public names follow the JAX package.  Every entry point
takes ``device=`` and defaults to ``"cuda"``; the CPU is used only when the
caller asks for it, and there each hand-written kernel runs as its plain
PyTorch version.

Ported so far (slices 1 and 2): the 2-camera top-down 2D + top-2 DLT 3D
block pipeline for the HRNet and Swin heatmap families, with CUDA kernels
for the HRNet stage-1 Bottleneck (`ops.bottleneck`, ``csrc/bottleneck.cu``),
the single-pass heatmap decode (`ops.fused_decode`, ``csrc/fused_decode.cu``),
and the whole SwinBlock (`ops.swin_block`: ``csrc/swin_gemm.cu`` and
``csrc/window_attention.cu``).
"""

__version__ = "0.1.0"

"""PyTorch/CUDA port of `multi_camera_3d_pose_estimation_tpu` for NVIDIA Hopper.

A package of its own: it imports ``torch`` and never ``jax``, and nothing of
the JAX package (which stays the reference the port is tested against).
Module layout and public names follow the JAX package.  Every entry point
takes ``device=`` and defaults to ``"cuda"``; the CPU is used only when the
caller asks for it, and there each hand-written kernel runs as its plain
PyTorch version.

Ported so far (slice 1): the 2-camera HRNet top-down 2D + top-2 DLT 3D block
pipeline, with CUDA kernels for the HRNet stage-1 Bottleneck
(`ops.bottleneck`, ``csrc/bottleneck.cu``) and the single-pass heatmap decode
(`ops.fused_decode`, ``csrc/fused_decode.cu``).
"""

__version__ = "0.1.0"

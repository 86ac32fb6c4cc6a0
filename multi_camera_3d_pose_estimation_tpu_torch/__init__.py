"""PyTorch/CUDA port of `multi_camera_3d_pose_estimation_tpu` for NVIDIA Hopper.

A package of its own: it imports ``torch`` and never ``jax``, and nothing of
the JAX package (which stays the reference the port is tested against).
Module layout and public names follow the JAX package.  Every entry point
takes ``device=`` and defaults to ``"cuda"``; the CPU is used only when the
caller asks for it, and there each hand-written kernel runs as its plain
PyTorch version.

Ported: the top-down 2D + 3D block pipeline for the HRNet and Swin
heatmap families (top-2 or robust n-view DLT, flip-TTA, the DARK decode)
and the RTMPose SimCC family, behind the person detectors (CenterNet,
RTMDet, YOLOX; top-1 or consistent selection) in plain PyTorch,
with CUDA kernels for the HRNet stage-1 Bottleneck (`ops.bottleneck`,
``csrc/bottleneck.cu``), the single-pass heatmap decode (`ops.fused_decode`,
``csrc/fused_decode.cu``), the whole SwinBlock (`ops.swin_block`:
``csrc/swin_gemm.cu`` and ``csrc/window_attention.cu``), the crop
(`ops.crop_resample`) and the eval-mode ConvBN epilogue (`ops.bn_epilogue`,
``csrc/bn_epilogue.cu``), each run wherever a call is its function
(`models.batchnorm.runs_kernels`: eval-mode bf16 inference that autograd
does not follow; the default decode and the crop always); and the 3-D half
in plain PyTorch: `ops.get_pose_3d`, `refine.linear_interpolation`, and
the Adam/MLE refiners `refine.PoseRefiner` and `refine.ExtrinsicRefiner`;
the artifact chain (`io`, `cli`), training, MMPose checkpoints and the mesh
paths (`parallel`); and the front end: calibration (`calib`: Zhang, PnP and
stereo Levenberg-Marquardt on the card in float64), capture
(`acquisition`), audio sync (`sync`) and `cli.configure_cameras` /
`cli.record_and_estimate_pose`; and the host tools: the libav media
runtime (`native`), profiling and keypoint conversion (`utils`), the plots
and the live preview (`viz`, matplotlib), and the ``plot`` and ``doctor``
commands.  Every module and command of the JAX package has its
counterpart here.
"""

__version__ = "0.1.0"

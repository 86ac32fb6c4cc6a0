"""Torch models with MMPose's and MMDetection's module names and registration
order (``mirrors.hrnet``, ``mirrors.rtmpose``, ``mirrors.swin``,
``mirrors.rtmdet``, ``mirrors.yolox``).

A copy of the JAX package's ``models/mirrors``, every family:
their ``state_dict()`` has exactly the names and order of a real MMPose
checkpoint, and ``randomize_`` fills one with non-degenerate random weights
(BatchNorm statistics included).  Two jobs: the second, independent
implementation of `models.checkpoint_verify`'s drill, and the writer of
MMPose/MMDet-named ``.pth`` files for tests and the smoke run.
"""

"""Torch models with MMPose's module names and registration order
(``mirrors.hrnet``, ``mirrors.rtmpose``, ``mirrors.swin``).

A copy of the JAX package's ``models/mirrors`` for these three families:
their ``state_dict()`` has exactly the names and order of a real MMPose
checkpoint, and ``randomize_`` fills one with non-degenerate random weights
(BatchNorm statistics included).  Two jobs: the second, independent
implementation of `models.checkpoint_verify`'s drill, and the writer of
MMPose-named ``.pth`` files for tests and the smoke run.
"""

"""Entry points of the port with the JAX package's flag and YAML surface:
`configure_cameras` and the calibration helpers (checkerboard images ->
``.dat`` camera files), `record_and_estimate_pose` (calibrate -> record ->
sync -> estimate), `estimate_pose_from_video` (videos -> 2D/3D artifacts),
the refinement CLI (`refine`), the training CLI (`train`), the
checkpoint CLI (`convert`: MMPose ``.pth`` -> the ``.npz`` format, and the
drill), the animations (`plot`, imported when first used: it needs
matplotlib, which nothing else here imports) and the health check
(`doctor`)."""

import importlib

from . import convert, doctor, refine, train
from .configure import (calibrate_intrinsics_from_images, calibrate_stereo_from_images,
                        configure_cameras, select_webcam_names_or_default)
from .estimate import estimate_pose_from_video, run_pipeline_on_blocks, run_pipeline_on_videos
from .record_and_estimate import record_and_estimate_pose

__all__ = ["configure_cameras", "calibrate_intrinsics_from_images",
           "calibrate_stereo_from_images", "select_webcam_names_or_default",
           "estimate_pose_from_video", "run_pipeline_on_videos", "run_pipeline_on_blocks",
           "record_and_estimate_pose", "convert", "doctor", "plot", "refine", "train"]


def __getattr__(name):
    if name == "plot":
        return importlib.import_module(f"{__name__}.plot")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

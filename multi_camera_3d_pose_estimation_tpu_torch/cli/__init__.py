"""Entry points of the port with the JAX package's flag and YAML surface:
`estimate_pose_from_video` (videos -> 2D/3D artifacts), the refinement
CLI (`refine`), the training CLI (`train`) and the checkpoint CLI
(`convert`: MMPose ``.pth`` -> the ``.npz`` format, and the drill)."""

from . import convert, refine, train
from .estimate import estimate_pose_from_video, run_pipeline_on_blocks, run_pipeline_on_videos

__all__ = ["estimate_pose_from_video", "run_pipeline_on_videos", "run_pipeline_on_blocks",
           "convert", "refine", "train"]

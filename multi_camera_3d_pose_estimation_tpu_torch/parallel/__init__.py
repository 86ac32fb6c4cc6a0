"""Rank meshes over ``torch.distributed`` and the block pipelines and
data-parallel steps that run on them (one process per device)."""

from .mesh import data_sharding, init_distributed, make_clip_mesh, make_mesh, replicated
from .pipeline import ShardedPosePipeline, run_clips_batched, sharded_refine_step

__all__ = [
    "make_mesh",
    "make_clip_mesh",
    "init_distributed",
    "data_sharding",
    "replicated",
    "ShardedPosePipeline",
    "sharded_refine_step",
    "run_clips_batched",
]

"""Block pipelines of the port (one device in this slice)."""

from .pipeline import ShardedPosePipeline

__all__ = ["ShardedPosePipeline"]

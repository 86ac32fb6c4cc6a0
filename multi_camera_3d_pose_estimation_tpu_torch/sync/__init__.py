"""Audio-based multi-camera video synchronization (host glue), as the JAX
package's ``sync/``: audio decoded from the containers by the port's libav
library, or read from sidecar PCM ``.wav`` files."""

from .audio import decode_audio, get_loudest_point
from .videos import (
    synchronize_videos,
    compute_sync_frame_indices,
    build_sync_inspection_grid,
)

__all__ = [
    "decode_audio",
    "get_loudest_point",
    "synchronize_videos",
    "compute_sync_frame_indices",
    "build_sync_inspection_grid",
]

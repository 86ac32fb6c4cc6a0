"""Audio-based multi-camera video synchronization (host glue), as the JAX
package's ``sync/``: sidecar PCM ``.wav`` audio (the libav decoder for audio
inside containers is not ported, ROADMAP Queue A item 12)."""

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

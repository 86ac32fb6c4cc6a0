"""Multi-camera video synchronization by audio peak + fps-drift compensation.

A copy of the JAX package's ``sync/videos.py`` over the port's
`io.frames.VideoReader` (libav, else cv2): the reference's
`synchronize_videos` (synchronize_videos.py:198-286), headless-first.

- The loudest-sample time per video → sync frame index via that video's
  fps (synchronize_videos.py:208); the audio comes from each video's own
  track (libav) or from sidecar ``.wav`` files (``audio_paths``;
  `sync.audio`).
- The interactive ±5-frame grid pick (:142-193) is the non-interactive
  ``adjusted_sync_frame_indices`` (the reference's own parameter, :198),
  or a ``frame_picker`` callback.
- Trim to the common overlap from each video's sync frame, compensating
  fps mismatch by duplicating the previous frame at rate
  max_fps/(max_fps − fps) (:250-263), writing ``*_synced.mp4``.
"""

from __future__ import annotations

import os

import numpy as np

from ..io.frames import VideoReader
from .audio import get_loudest_point

__all__ = [
    "synchronize_videos",
    "compute_sync_frame_indices",
    "build_sync_inspection_grid",
]


def compute_sync_frame_indices(video_paths, search_seconds: float = 30.0,
                               audio_paths=None):
    """Per-video frame index of the loudest audio moment.

    ``audio_paths``: optional sidecar audio files (e.g. WAVs from a rig
    that records audio separately); default reads each video's own audio
    track.
    """
    indices = []
    fps_list = []
    for i, path in enumerate(video_paths):
        src = audio_paths[i] if audio_paths else path
        t = get_loudest_point(src, search_seconds=search_seconds)
        r = VideoReader(path, prefetch=0)
        fps = r.fps
        r.close()
        indices.append(int(t * fps))
        fps_list.append(fps)
    return indices, fps_list


def synchronize_videos(
    video_paths,
    frame_range=tuple(range(-5, 6)),
    save_as_files: bool = True,
    adjusted_sync_frame_indices=None,
    delete_originals: bool = False,
    frame_picker=None,
    max_frames: int | None = None,
    audio_paths=None,
):
    """Returns ``(synchronized_frames, output_paths)`` like the reference.

    ``synchronized_frames``: list over time of ``[frame_cam0, ...]`` (BGR,
    matching the cv2 convention downstream code expects).
    ``frame_picker(sync_indices, video_paths, frame_range) -> indices``
    optionally adjusts the audio-derived indices (the interactive hook;
    ``frame_range`` is the ±offset window the reference's grid UI showed,
    synchronize_videos.py:198).
    """
    if adjusted_sync_frame_indices is None:
        sync_indices, fps_list = compute_sync_frame_indices(
            video_paths, audio_paths=audio_paths
        )
        if frame_picker is not None:
            sync_indices = frame_picker(sync_indices, video_paths, frame_range)
            if sync_indices is None:
                return None
        adjusted_sync_frame_indices = sync_indices
    else:
        fps_list = []
        for path in video_paths:
            r = VideoReader(path, prefetch=0)
            fps_list.append(r.fps)
            r.close()

    readers = [VideoReader(p, bgr=True) for p in video_paths]
    totals = [r.n_frames for r in readers]
    known_totals = [t for t in totals if t > 0]
    overlap = (
        min(t - s for t, s in zip(totals, adjusted_sync_frame_indices))
        if len(known_totals) == len(totals)
        else None
    )
    if max_frames is not None:
        overlap = max_frames if overlap is None else min(overlap, max_frames)

    # Skip to each sync frame (sequential decode — no seek dependency).
    for r, start in zip(readers, adjusted_sync_frame_indices):
        remaining = start
        while remaining > 0:
            got = r.read_block(min(remaining, 64)).shape[0]
            if got == 0:
                break
            remaining -= got

    writers = None
    output_paths = None
    if save_as_files:
        import cv2

        output_paths = [
            os.path.join(
                os.path.dirname(p),
                os.path.splitext(os.path.basename(p))[0] + "_synced.mp4",
            )
            for p in video_paths
        ]
        writers = [
            cv2.VideoWriter(
                out,
                cv2.VideoWriter_fourcc(*"mp4v"),
                fps,
                (r.width, r.height),
            )
            for out, fps, r in zip(output_paths, fps_list, readers)
        ]

    max_fps = max(fps_list)
    adjustment_rates = [
        max_fps / (max_fps - fps) if max_fps != fps else np.inf for fps in fps_list
    ]
    adjustments_made = [0] * len(readers)

    synchronized_frames = []
    previous_frames = None
    frame_idx = 0
    while overlap is None or frame_idx < overlap:
        frames = []
        ok = True
        for i, r in enumerate(readers):
            if (
                previous_frames is not None
                and frame_idx >= (adjustments_made[i] + 1) * adjustment_rates[i]
            ):
                # Slow camera: duplicate its previous frame to stay in step
                # (reference :256-259).
                frame = previous_frames[i]
                adjustments_made[i] += 1
            else:
                block = r.read_block(1)
                if block.shape[0] == 0:
                    ok = False
                    break
                frame = block[0]
            frames.append(frame)
        if not ok or len(frames) != len(readers):
            break
        synchronized_frames.append(frames)
        if writers is not None:
            for w, f in zip(writers, frames):
                w.write(np.ascontiguousarray(f))
        previous_frames = frames
        frame_idx += 1

    for r in readers:
        r.close()
    if writers is not None:
        for w in writers:
            w.release()
    if delete_originals:
        for p in video_paths:
            os.remove(p)
    return synchronized_frames, output_paths


def build_sync_inspection_grid(video_paths, sync_indices,
                               frame_range=tuple(range(-5, 6)),
                               thumb_width: int = 160):
    """Compose the sync-candidate frames into one image per camera row.

    Headless replacement for the reference's interactive grid UI
    (display_and_select_frame / create_scrollable_grid,
    synchronize_videos.py:76-193): each row is one camera, each column the
    frame at ``sync_index + offset``, with the audio-derived candidate in
    the centre.  Save the returned (H, W, 3) uint8 image and pick offsets
    remotely; feed the adjusted indices back via
    ``adjusted_sync_frame_indices``.
    """
    import cv2

    rows = []
    for path, sync_idx in zip(video_paths, sync_indices):
        reader = VideoReader(path, bgr=True)
        scale = thumb_width / reader.width
        th = max(int(reader.height * scale), 1)
        wanted = [sync_idx + off for off in frame_range]
        lo = max(min(wanted), 0)
        hi = max(wanted)
        # Sequential decode up to the window (no seek dependency).
        for _ in range(lo):
            if reader.read_block(1).shape[0] == 0:
                break
        cells = []
        idx = lo
        frames_window = {}
        while idx <= hi:
            block = reader.read_block(1)
            if block.shape[0] == 0:
                break
            frames_window[idx] = block[0]
            idx += 1
        reader.close()
        for off in frame_range:
            i = sync_idx + off
            frame = frames_window.get(i)
            if frame is None:
                cell = np.zeros((th, thumb_width, 3), np.uint8)
            else:
                cell = cv2.resize(frame, (thumb_width, th))
            color = (0, 255, 0) if off == 0 else (255, 255, 255)
            cv2.rectangle(cell, (0, 0), (thumb_width - 1, th - 1), color, 1)
            cv2.putText(cell, f"{off:+d}", (4, 14), cv2.FONT_HERSHEY_SIMPLEX,
                        0.4, color, 1)
            cells.append(cell)
        rows.append(np.concatenate(cells, axis=1))
    width = max(r.shape[1] for r in rows)
    rows = [
        np.pad(r, ((0, 0), (0, width - r.shape[1]), (0, 0))) for r in rows
    ]
    return np.concatenate(rows, axis=0)

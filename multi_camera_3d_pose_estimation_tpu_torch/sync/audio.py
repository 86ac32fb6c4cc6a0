"""Audio decode + loudest-point detection (host numpy).

Counterpart of the JAX package's ``sync/audio.py`` (the reference's
moviepy WAV extraction + librosa ``argmax(abs(y))``,
synchronize_videos.py:12-21, :203-205).  The JAX package decodes audio
inside video containers with its native libav decoder, which the port does
not have yet (ROADMAP Queue A item 12); the port reads plain PCM ``.wav``
files with the standard library's ``wave``, the JAX package's fallback, and
raises the same `RuntimeError` for anything else.
"""

from __future__ import annotations

import os
import wave

import numpy as np

__all__ = ["decode_audio", "get_loudest_point"]


def decode_audio(path: str, max_seconds: float = 120.0):
    """Decode a PCM ``.wav`` file to mono float32; returns (y, sr)."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    if path.lower().endswith(".wav"):
        with wave.open(path, "rb") as w:
            sr = w.getframerate()
            n = min(w.getnframes(), int(max_seconds * sr))
            raw = w.readframes(n)
            width = w.getsampwidth()
            dtype = {1: np.int8, 2: np.int16, 4: np.int32}[width]
            y = np.frombuffer(raw, dtype).astype(np.float32)
            y /= float(np.iinfo(dtype).max)
            if w.getnchannels() > 1:
                y = y.reshape(-1, w.getnchannels()).mean(axis=1)
            return y, sr
    raise RuntimeError(
        f"no audio decoder available for {path} (the port reads PCM .wav files only: "
        f"audio inside a video container needs the native libav decoder, ROADMAP Queue A "
        f"item 12; pass sidecar .wav files as audio_paths)"
    )


def get_loudest_point(path_or_samples, sr: int | None = None,
                      search_seconds: float = 30.0):
    """Time (seconds) of the loudest sample within the first
    ``search_seconds`` (reference `get_loudest_point`,
    synchronize_videos.py:12-21)."""
    if isinstance(path_or_samples, (str, os.PathLike)):
        y, sr = decode_audio(str(path_or_samples), max_seconds=search_seconds)
    else:
        y = np.asarray(path_or_samples)
        if sr is None:
            raise ValueError("sr required when passing raw samples")
        y = y[: int(search_seconds * sr)]
    idx = int(np.argmax(np.abs(y)))
    return idx / sr

"""Audio decode + loudest-point detection (host numpy).

Counterpart of the JAX package's ``sync/audio.py`` (the reference's
moviepy WAV extraction + librosa ``argmax(abs(y))``,
synchronize_videos.py:12-21, :203-205): the first audio stream of a
container decoded to mono float PCM by the port's libav library
(`native.load_mediadec`, no temporary WAV files), with the standard
library's ``wave`` reading plain PCM ``.wav`` files where the library is
unavailable.
"""

from __future__ import annotations

import ctypes
import os
import wave

import numpy as np

from ..native import load_mediadec

__all__ = ["decode_audio", "get_loudest_point"]


def decode_audio(path: str, max_seconds: float = 120.0):
    """Decode the first audio stream to mono float32; returns (y, sr)."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    lib = load_mediadec()
    if lib is not None:
        max_samples = int(max_seconds * 192000)
        buf = np.empty(max_samples, np.float32)
        sr = ctypes.c_int()
        n = lib.md_read_audio(path.encode(), buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                              max_samples, sr)
        if n > 0:
            return buf[:n].copy(), int(sr.value)
    if path.lower().endswith(".wav"):  # the standard library: plain PCM WAV only
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
        f"no audio decoder available for {path} (native libmediadec failed "
        f"to build and file is not a PCM .wav)"
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

"""Frame IO: video readers, per-timestep generators, and multi-camera blocks
staged to the card.

Counterpart of the JAX package's ``io/frames.py``:

- `VideoReader`: one video through the port's libav decoder
  (`native.load_mediadec`, a background decode thread) where the library
  builds, else OpenCV (``cv2``, imported when a video is opened);
- `frame_generator` / `load_frames` / `load_image_frames`: per-timestep
  lists of frames (BGR by default, as cv2 gives them);
- `BatchedFramePipeline`: a producer thread decodes (block, C, H, W, 3)
  uint8 host blocks while the previous block runs (with the library, its
  block assembler: one decode thread per camera writing into its slice of
  the block); the last partial block is zero-padded and reported with its
  true length;
- `stage_blocks`: host blocks to the card through a ring of pinned buffers
  (filled by a producer thread) copied on a stream of their own, so that
  the copy of block N+1 overlaps the compute of block N (the counterpart
  of ``jax.device_put``).
"""

from __future__ import annotations

import ctypes
import itertools
import os
import threading
import time
from queue import Empty, Queue

import numpy as np
import torch

from ..native import load_mediadec
from ..utils.profiling import span, tracing

__all__ = ["VideoReader", "frame_generator", "load_frames", "load_image_frames",
           "write_keypoints_to_disk", "BatchedFramePipeline", "stage_blocks"]


def _ubyte_ptr(arr: np.ndarray, offset: int = 0):
    return ctypes.cast(arr.ctypes.data + offset, ctypes.POINTER(ctypes.c_ubyte))


def _info(fn, handle) -> tuple:
    """(width, height, fps, n_frames) from ``md_info`` / ``mda_info``."""
    w, h, fps, nf = ctypes.c_int(), ctypes.c_int(), ctypes.c_double(), ctypes.c_longlong()
    fn(handle, w, h, fps, nf)
    return w.value, h.value, fps.value, int(nf.value)


class VideoReader:
    """Sequential RGB frame reader: the libav decoder where it is
    available (decoding ``prefetch`` frames ahead on a thread of its own;
    0 decodes on demand), else OpenCV.

    ``read_block(n)`` returns (m, H, W, 3) uint8 RGB (m ≤ n; 0 rows at the
    end).  ``bgr=True`` returns BGR order instead (cv2's).
    """

    def __init__(self, path: str, prefetch: int = 16, bgr: bool = False):
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        self.path = path
        self.bgr = bgr
        self._lib = load_mediadec()
        self._handle = None
        self._cap = None
        if self._lib is not None:
            self._handle = self._lib.md_open(path.encode())
        if self._handle:
            self.width, self.height, self.fps, self.n_frames = _info(self._lib.md_info,
                                                                     self._handle)
            self._prefetching = prefetch > 0
            if self._prefetching:
                self._lib.md_start_prefetch(self._handle, prefetch)
            return
        import cv2

        self._cap = cv2.VideoCapture(path)
        if not self._cap.isOpened():
            raise IOError(f"cannot open video: {path}")
        self.width = int(self._cap.get(cv2.CAP_PROP_FRAME_WIDTH))
        self.height = int(self._cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
        self.fps = float(self._cap.get(cv2.CAP_PROP_FPS))
        self.n_frames = int(self._cap.get(cv2.CAP_PROP_FRAME_COUNT))

    def _read_native(self, n: int) -> np.ndarray:
        buf = np.empty((n, self.height, self.width, 3), np.uint8)
        if not self._prefetching:
            return buf[:self._lib.md_read_frames(self._handle, _ubyte_ptr(buf), n)]
        # md_next_frames pops what the ring holds (at least 1 unless the
        # stream ended): drain until the block is full or the stream ends.
        frame_bytes = self.height * self.width * 3
        got = 0
        while got < n:
            m = self._lib.md_next_frames(self._handle, _ubyte_ptr(buf, got * frame_bytes), n - got)
            if m == 0:
                break
            got += m
        return buf[:got]

    def read_block(self, n: int) -> np.ndarray:
        if self._handle:
            out = self._read_native(n)
        else:
            frames = []
            for _ in range(n):
                ok, frame = self._cap.read()
                if not ok:
                    break
                frames.append(frame[..., ::-1])  # cv2 gives BGR; store RGB
            out = (np.stack(frames) if frames
                   else np.empty((0, self.height, self.width, 3), np.uint8))
        return out[..., ::-1] if self.bgr else out

    def __iter__(self):
        while True:
            block = self.read_block(1)
            if block.shape[0] == 0:
                return
            yield block[0]

    def close(self):
        if self._handle:
            self._lib.md_close(self._handle)
            self._handle = None
        if self._cap is not None:
            self._cap.release()
            self._cap = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def frame_generator(video_paths, bgr: bool = True):
    """Yield ``[frame_cam0, frame_cam1, ...]`` per timestep until any video
    ends (BGR by default)."""
    readers = [VideoReader(p, bgr=bgr) for p in video_paths]
    try:
        while True:
            frames = []
            for r in readers:
                block = r.read_block(1)
                if block.shape[0] == 0:
                    return
                frames.append(block[0])
            yield frames
    finally:
        for r in readers:
            r.close()


def load_frames(video_paths=None, frames_folder=None, bgr: bool = True):
    """A per-timestep generator over videos, or over a folder of
    ``frame<i>.jpg`` files."""
    if video_paths is not None:
        return frame_generator(video_paths, bgr=bgr)
    if frames_folder is not None:
        return load_image_frames(frames_folder, bgr=bgr)
    raise ValueError("provide video_paths or frames_folder")


def load_image_frames(frames_folder: str, bgr: bool = True):
    """Generator over ``frame<i>.jpg`` files in index order."""
    import cv2

    names = [n for n in os.listdir(frames_folder) if n.startswith("frame")]
    order = sorted(names, key=lambda n: int("".join(c for c in n if c.isdigit()) or 0))
    for name in order:
        img = cv2.imread(os.path.join(frames_folder, name))
        if img is None:
            continue
        yield [img if bgr else img[..., ::-1]]


def write_keypoints_to_disk(path: str, keypoints) -> None:
    """Text dump, one line per frame of flattened keypoints."""
    arr = np.asarray(keypoints)
    with open(path, "w") as f:
        for row in arr.reshape(arr.shape[0], -1):
            f.write(" ".join(f"{v}" for v in row) + "\n")


def _fill_ring(host_blocks, free: Queue, filled: Queue, buffers: list, copied: list,
               stop: threading.Event) -> None:
    """`stage_blocks`' producer: each host block into a free slot of the
    pinned ring, once that slot's last H2D copy has completed; hands
    ``(slot, n_valid)`` on, then None at the end (or the exception raised).
    Returns early once ``stop`` is set.  Spans (``block``: the block's index
    in ``host_blocks``): ``mc3d.stage.slot_wait`` from the block's arrival
    through its slot's last copy, ``mc3d.stage.fill`` the copy into pinned
    memory."""
    try:
        for i, (block, n_valid) in enumerate(host_blocks):
            with span("mc3d.stage.slot_wait", block=i):
                slot = free.get()
                if stop.is_set():
                    return
                if copied[slot] is not None:
                    copied[slot].synchronize()
            if buffers[slot] is None or tuple(buffers[slot].shape) != block.shape:
                buffers[slot] = torch.empty(block.shape, dtype=torch.uint8, pin_memory=True)
            with span("mc3d.stage.fill", block=i):
                np.copyto(buffers[slot].numpy(), block)
            filled.put((slot, n_valid))
        filled.put(None)
    except BaseException as e:  # handed to the consumer, which raises it
        filled.put(e)


def stage_blocks(host_blocks, device, depth: int = 2, copy_events: list | None = None):
    """Stage ``(block, n_valid)`` host blocks (uint8 numpy arrays) to
    ``device``; yields ``(device_block, n_valid)``.

    On the card: a producer thread writes each block into a ring of
    ``depth + 1`` pinned host buffers, off the thread that launches the
    work; each buffer is copied ``non_blocking`` on a dedicated copy
    stream, the copy records an event, the compute stream (the current
    stream) waits on it, and the device block is marked as used there
    (``record_stream``).  A buffer is refilled only after its last copy's
    event has completed.  With ``copy_events`` (a list), each copy's
    (start, end) timing events are appended to it.  On ``device="cpu"``
    the host block is yielded as a tensor and nothing is pinned.

    Spans (`utils.profiling.span`; ``block``: the block's index in
    ``host_blocks``), besides the producer's: ``mc3d.stage.input_wait``
    while this thread waits for a filled slot, ``mc3d.stage.h2d`` around
    the copy's launch, its device time from the copy's own events.
    """
    device = torch.device(device)
    if device.type == "cpu":
        for block, n_valid in host_blocks:
            yield torch.as_tensor(block), n_valid
        return
    if device.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(f"stage_blocks: no CUDA device for {device}")
    copy_stream = torch.cuda.Stream(device)
    buffers: list = [None] * (depth + 1)  # the pinned ring
    copied: list = [None] * (depth + 1)  # each slot's last copy's event
    free: Queue = Queue()
    filled: Queue = Queue()
    for slot in range(depth + 1):
        free.put(slot)
    stop = threading.Event()
    producer = threading.Thread(target=_fill_ring, daemon=True,
                                args=(host_blocks, free, filled, buffers, copied, stop))
    producer.start()
    try:
        for i in itertools.count():
            with span("mc3d.stage.input_wait", block=i):
                item = filled.get()
            if item is None:
                return
            if isinstance(item, BaseException):
                raise item
            slot, n_valid = item
            timing = copy_events is not None or tracing()
            start = torch.cuda.Event(enable_timing=timing)
            end = torch.cuda.Event(enable_timing=timing)
            with span("mc3d.stage.h2d", block=i, device=(start, end)), \
                    torch.cuda.stream(copy_stream):
                dev_block = torch.empty(buffers[slot].shape, dtype=torch.uint8, device=device)
                start.record(copy_stream)
                dev_block.copy_(buffers[slot], non_blocking=True)
                end.record(copy_stream)
            copied[slot] = end
            free.put(slot)
            if copy_events is not None:
                copy_events.append((start, end))
            compute = torch.cuda.current_stream(device)
            compute.wait_event(end)
            dev_block.record_stream(compute)
            yield dev_block, n_valid
    finally:
        stop.set()
        free.put(None)  # wakes a producer waiting for a slot
        producer.join(timeout=10.0)


class BatchedFramePipeline:
    """Multi-camera block reader with background decode.

    Iterating yields ``(block, n_valid)``: (block_size, n_cams, H, W, 3)
    uint8 blocks, staged to ``device`` by `stage_blocks` (or host numpy
    blocks with ``stage_to_device=False``).  The last partial block is
    zero-padded to block_size, ``n_valid`` its true length.  With
    ``native_assembler`` (and the libav library), the library's block
    assembler decodes every camera on a thread of its own straight into
    its slice of the block; else one `VideoReader` per camera and a
    Python producer thread.
    """

    def __init__(self, video_paths, block_size: int = 16, device="cuda",
                 queue_depth: int = 2, stage_to_device: bool = True,
                 native_assembler: bool = True):
        self._asm = None
        self._asm_lib = None
        self.readers = []
        if native_assembler and all(os.path.exists(str(p)) for p in video_paths):
            lib = load_mediadec()
            if lib is not None:
                paths = (ctypes.c_char_p * len(video_paths))(*[str(p).encode()
                                                               for p in video_paths])
                handle = lib.mda_open(paths, len(video_paths))
                if handle:
                    self._asm, self._asm_lib = handle, lib
                    self.width, self.height, _, _ = _info(lib.mda_info, handle)
        if self._asm is None:
            self.readers = [VideoReader(p) for p in video_paths]
            hw = {(r.height, r.width) for r in self.readers}
            if len(hw) != 1:
                for r in self.readers:
                    r.close()
                raise ValueError(f"cameras disagree on frame size: {hw}")
            self.height, self.width = hw.pop()
        self.block_size = block_size
        self.n_cams = len(video_paths)
        self.device = device
        self.stage_to_device = bool(stage_to_device)
        self._q: Queue = Queue(maxsize=queue_depth)
        self._closing = False
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    def _next_block(self):
        """The next (block, n) from the decoders; n == 0 at the end."""
        B = self.block_size
        if self._asm is not None:
            out = np.empty((B, self.n_cams, self.height, self.width, 3), np.uint8)
            n = self._asm_lib.mda_next_block(self._asm, _ubyte_ptr(out), B)
            out[n:] = 0  # rows past n are not written by the assembler
            return out, n
        blocks = [r.read_block(B) for r in self.readers]
        n = min(b.shape[0] for b in blocks)
        out = np.zeros((B, self.n_cams, self.height, self.width, 3), np.uint8)
        for c, b in enumerate(blocks):
            out[:n, c] = b[:n]
        return out, n

    def _producer(self):
        while not self._closing:
            out, n = self._next_block()
            if n == 0:
                self._q.put(None)
                return
            self._q.put((out, n))
            if n < self.block_size:
                self._q.put(None)
                return

    def _host_blocks(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            yield item

    def __iter__(self):
        if not self.stage_to_device:
            return self._host_blocks()
        return stage_blocks(self._host_blocks(), self.device)

    def close(self):
        """Stop the producer, then free the decoders.  The producer may be
        inside ``mda_next_block`` or blocked on a full queue: the queue is
        drained until the thread exits, and the native handle is freed
        only then (never under a decode in flight)."""
        self._closing = True
        deadline = time.monotonic() + 10.0
        while self._thread.is_alive() and time.monotonic() < deadline:
            try:
                self._q.get(timeout=0.05)
            except Empty:
                pass
        if not self._thread.is_alive():
            while True:  # what the producer left, so that the end marker fits
                try:
                    self._q.get_nowait()
                except Empty:
                    break
            self._q.put(None)  # ends a consumer still waiting for a block
            if self._asm is not None:
                self._asm_lib.mda_close(self._asm)
                self._asm = None
            for r in self.readers:
                r.close()

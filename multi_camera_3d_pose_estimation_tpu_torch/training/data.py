"""Training data: COCO keypoints parsing and the batched crop loader.

Counterpart of the JAX package's ``training/data.py`` (no downloads: the
parser reads a local COCO person_keypoints JSON and image directory):

- `parse_coco_keypoints`: JSON -> per-instance records (image path, box,
  (K, 2) keypoints, COCO visibility);
- `make_crop_batch`: one batch on the trainer's device through the same
  `models.topdown.preprocess_crops` the inference path uses, with the
  optional flip and the family's targets;
- `KeypointBatcher`: a producer thread decodes images with cv2 (imported
  when a record is read) and assembles the next batch while the current
  one trains.
"""

from __future__ import annotations

import json
import os
import threading
from queue import Full, Queue

import numpy as np
import torch

from ..models.topdown import preprocess_crops
from .augment import apply_flip_pose, draw_flip_mask, flip_permutation
from .targets import render_heatmap_targets, render_simcc_targets

__all__ = ["parse_coco_keypoints", "KeypointBatcher", "make_crop_batch"]


def parse_coco_keypoints(annotations_json: str, images_dir: str, min_keypoints: int = 1):
    """COCO person_keypoints JSON -> list of instance records.

    Record: {"image_path", "bbox" (x0, y0, x1, y1), "keypoints" (K, 2),
    "visibility" (K,)}.  Crowd annotations and instances with fewer than
    ``min_keypoints`` labeled joints are dropped.
    """
    with open(annotations_json) as f:
        coco = json.load(f)
    images = {img["id"]: img for img in coco.get("images", [])}
    records = []
    for ann in coco.get("annotations", []):
        if ann.get("iscrowd", 0):
            continue
        kp = np.asarray(ann.get("keypoints", []), np.float32).reshape(-1, 3)
        if (kp[:, 2] > 0).sum() < min_keypoints:
            continue
        img = images.get(ann["image_id"])
        if img is None:
            continue
        x, y, w, h = ann["bbox"]
        records.append({"image_path": os.path.join(images_dir, img["file_name"]),
                        "bbox": np.asarray([x, y, x + w, y + h], np.float32),
                        "keypoints": kp[:, :2], "visibility": kp[:, 2]})
    return records


def make_crop_batch(images, bboxes, keypoints, visibility, input_size=(192, 256),
                    target: str = "heatmap", heatmap_stride: int = 4, sigma: float = 2.0,
                    simcc_split_ratio: float = 2.0, flip_generator: torch.Generator | None = None,
                    flip_mask=None, connectivity_type: str = "coco", device="cuda") -> dict:
    """One training batch on ``device`` through the inference preprocessing.

    - ``images`` (B, H, W, 3): float in [0, 1], or uint8 (divided by 255 on
      the device: the same f32 values as on the host);
    - ``bboxes`` (B, 4), ``keypoints`` (B, K, 2) in image pixels,
      ``visibility`` (B, K);
    - flip: ``flip_mask`` (B,) bool, or a mask drawn from
      ``flip_generator`` (p = 0.5); neither: no flip.

    Returns heatmap -> {"images", "targets", "weights"}; simcc ->
    {"images", "lx", "ly", "w"}; ``images`` are the normalised crops
    (B, in_h, in_w, 3) f32.
    """
    images = torch.as_tensor(images, device=device)
    if images.dtype == torch.uint8:
        images = images.float() / 255.0
    crops, scale, offset = preprocess_crops(
        images, torch.as_tensor(bboxes, dtype=torch.float32, device=device), input_size)
    kp_crop = (torch.as_tensor(keypoints, device=device) - offset[:, None]) * scale[:, None]
    vis = torch.as_tensor(visibility, device=device)
    if flip_generator is not None:
        flip_mask = draw_flip_mask(flip_generator, crops.shape[0], device=device)
    if flip_mask is not None:
        crops, kp_crop, vis = apply_flip_pose(flip_mask, crops, kp_crop, vis,
                                              flip_permutation(connectivity_type))
    in_w, in_h = input_size
    if target == "heatmap":
        hm_size = (in_h // heatmap_stride, in_w // heatmap_stride)
        targets, w = render_heatmap_targets(kp_crop / heatmap_stride, vis, hm_size, sigma=sigma,
                                            device=device)
        return {"images": crops, "targets": targets, "weights": w}
    if target == "simcc":
        lx, ly, w = render_simcc_targets(kp_crop, vis, input_size, split_ratio=simcc_split_ratio,
                                         device=device)
        return {"images": crops, "lx": lx, "ly": ly, "w": w}
    raise ValueError(f"unknown target '{target}'")


class KeypointBatcher:
    """Background host loader: records -> training batches on ``device``.

    Decodes images with cv2, resized to a common ``image_size`` (W, H) so
    batch shapes stay fixed and kept uint8 (`make_crop_batch` scales them
    on the device), shuffles each epoch (numpy ``default_rng(seed)``,
    the JAX package's order), and assembles batches with `make_crop_batch`
    while the previous batch trains; the flips come from
    ``torch.Generator(seed)``.  An error in the producer is raised by the
    iterator.  ``close()`` stops the producer.
    """

    def __init__(self, records, batch_size: int = 32, input_size=(192, 256),
                 image_size=(512, 512), target: str = "heatmap", seed: int = 0,
                 augment: bool = True, queue_depth: int = 2, device="cuda", **batch_kwargs):
        if len(records) < batch_size:
            raise ValueError(f"{len(records)} training records, fewer than a batch of {batch_size}")
        self.records = list(records)
        self.batch_size = batch_size
        self.input_size = tuple(input_size)
        self.image_size = tuple(image_size)
        self.target = target
        self.augment = augment
        self.device = device
        self.batch_kwargs = batch_kwargs
        self._rng = np.random.default_rng(seed)
        self._flips = torch.Generator().manual_seed(seed)
        self._q: Queue = Queue(maxsize=queue_depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    def _load_record(self, rec):
        import cv2

        img = cv2.imread(rec["image_path"])
        if img is None:
            raise FileNotFoundError(rec["image_path"])
        h0, w0 = img.shape[:2]
        wt, ht = self.image_size
        sx, sy = wt / w0, ht / h0
        img = cv2.resize(img, (wt, ht))[..., ::-1]  # BGR -> RGB
        bbox = rec["bbox"] * np.asarray([sx, sy, sx, sy], np.float32)
        kp = rec["keypoints"] * np.asarray([sx, sy], np.float32)
        return img, bbox, kp, rec["visibility"]

    def _put(self, item) -> bool:
        """Queue ``item`` unless stopped first; returns whether it was queued."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except Full:
                continue
        return False

    def _producer(self):
        B = self.batch_size
        try:
            while not self._stop.is_set():
                order = self._rng.permutation(len(self.records))
                for start in range(0, len(order) - B + 1, B):
                    loaded = [self._load_record(self.records[i]) for i in order[start:start + B]]
                    imgs, boxes, kps, vises = (np.stack(x) for x in zip(*loaded))
                    batch = make_crop_batch(
                        imgs, boxes, kps, vises, input_size=self.input_size, target=self.target,
                        flip_generator=self._flips if self.augment else None, device=self.device,
                        **self.batch_kwargs)
                    if not self._put(batch):
                        return
        except Exception as exc:  # handed to the consumer, which raises it
            self._put(exc)

    def __iter__(self):
        while True:
            item = self._q.get()
            if isinstance(item, Exception):
                raise item
            yield item

    def close(self):
        self._stop.set()
        self._thread.join(timeout=10)

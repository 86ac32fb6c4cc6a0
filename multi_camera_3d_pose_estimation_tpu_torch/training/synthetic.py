"""Synthetic COCO-17 scenes: a walking stick person, a calibrated rig, rendered frames.

The port's copy of the JAX package's ``training/synthetic.py`` (numpy and
cv2, no JAX; cv2 is imported where a frame is drawn or written): the same
seed gives the same frames, projections and datasets on both sides.  The
accuracy harness (`training.harness`) trains and scores the models on these
scenes, and `write_coco_dataset` writes the COCO-format set the train CLI
reads.

Rendering rules chosen so top-down conventions transfer:
- left/right joint pairs share a colour (appearance is mirror-symmetric,
  so flip-test TTA semantics match real imagery: a mirrored left shoulder
  looks like a right shoulder);
- the person occupies a sub-region of the frame and translates over time,
  so the person detector does real work (crop ≠ full frame).
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "coco17_pose",
    "make_rig",
    "project_oracle",
    "render_frame",
    "person_bbox",
    "SyntheticSceneConfig",
    "make_scaled_scene",
    "write_coco_dataset",
]

# COCO-17 order: 0 nose, 1/2 l/r eye, 3/4 l/r ear, 5/6 l/r shoulder,
# 7/8 l/r elbow, 9/10 l/r wrist, 11/12 l/r hip, 13/14 l/r knee,
# 15/16 l/r ankle.
_LIMBS = [
    (5, 7), (7, 9), (6, 8), (8, 10),       # arms
    (11, 13), (13, 15), (12, 14), (14, 16),  # legs
    (5, 6), (11, 12), (5, 11), (6, 12),     # torso
    (0, 1), (0, 2), (1, 3), (2, 4),         # face
]

# Colour per joint TYPE — left/right pairs share it (see module docstring).
_TYPE_COLORS = {
    "nose": (250, 250, 250),
    "eye": (250, 210, 60),
    "ear": (80, 200, 250),
    "shoulder": (250, 80, 80),
    "elbow": (80, 250, 80),
    "wrist": (250, 80, 250),
    "hip": (80, 80, 250),
    "knee": (250, 150, 60),
    "ankle": (60, 250, 200),
}
_JOINT_TYPES = ["nose", "eye", "eye", "ear", "ear", "shoulder", "shoulder",
                "elbow", "elbow", "wrist", "wrist", "hip", "hip",
                "knee", "knee", "ankle", "ankle"]


def coco17_pose(t: float, origin=(0.0, 0.0, 300.0), scale: float = 1.0):
    """A walking 17-joint skeleton at phase ``t`` (radians); world units cm.

    Y grows downward (image-like convention shared with the projector).
    """
    s, c = np.sin(t), np.cos(t)
    swing = 18.0 * s
    p = np.zeros((17, 3))
    # torso anchors
    p[5] = [-16, -55, 0]   # l shoulder
    p[6] = [16, -55, 0]    # r shoulder
    p[11] = [-11, -5, 0]   # l hip
    p[12] = [11, -5, 0]    # r hip
    # head
    p[0] = [0, -74, -6]
    p[1] = [-4, -78, -4]
    p[2] = [4, -78, -4]
    p[3] = [-8, -76, 2]
    p[4] = [8, -76, 2]
    # arms (counter-swing)
    p[7] = p[5] + [-4, 26, -swing * 0.5]
    p[8] = p[6] + [4, 26, swing * 0.5]
    p[9] = p[7] + [-2, 25, -swing]
    p[10] = p[8] + [2, 25, swing]
    # legs (swing)
    p[13] = p[11] + [0, 40, swing * 0.6]
    p[14] = p[12] + [0, 40, -swing * 0.6]
    p[15] = p[13] + [0, 40, swing]
    p[16] = p[14] + [0, 40, -swing]
    # bob + lean
    p[:, 1] += 2.0 * np.abs(c)
    return p * scale + np.asarray(origin)


# A realistic webcam-lens distortion profile (pronounced barrel + slight
# tangential, the wide-FOV-webcam regime): the default whenever a
# synthetic rig asks for distortion.  Strong enough that the working
# volume sees multi-pixel displacement (so skipping undistortion would
# visibly hurt), still comfortably within the fixed-point inverse's
# convergence region.
DEFAULT_DISTORTION = np.array([-0.35, 0.08, 2e-3, -1.2e-3, 1.2e-2])


def make_rig(n_cams: int = 2, width: int = 256, height: int = 256,
             focal: float = 300.0, spread_deg: float = 50.0,
             baseline: float = 260.0, distortion=None):
    """Calibrated ring of cameras aimed at the working volume.

    Returns a list of [K, R, T, dist] (the `io.stack_camera_params` input
    layout).  ``distortion``: None → zero coefficients (closed-form
    pinhole oracle); True → `DEFAULT_DISTORTION` on every camera; or a
    (5,) / (n_cams, 5) array of OpenCV-ordered [k1, k2, p1, p2, k3]
    coefficients.  With nonzero coefficients `project_oracle` applies the
    full forward model in float64, so the rendered pixels and the labels
    exercise the same lens the real reference pipeline undistorts
    (reference utils.py:1314-1315).
    """
    if distortion is None:
        dists = np.zeros((n_cams, 5))
    elif distortion is True:
        dists = np.tile(DEFAULT_DISTORTION, (n_cams, 1))
    else:
        d = np.asarray(distortion, np.float64)
        dists = np.tile(d, (n_cams, 1)) if d.ndim == 1 else d
    cams = []
    for c in range(n_cams):
        K = np.array([[focal, 0, width / 2], [0, focal, height / 2], [0, 0, 1.0]])
        frac = c / max(n_cams - 1, 1)
        th = np.deg2rad(-spread_deg / 2 + spread_deg * frac)
        R = np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0],
                      [-np.sin(th), 0, np.cos(th)]])
        pos = np.array([-baseline / 2 + baseline * frac, 0.0, -20.0])
        T = -R @ pos
        cams.append([K, R, T, dists[c].copy()])
    return cams


def project_oracle(pts3d: np.ndarray, K, R, T, dist=None) -> np.ndarray:
    """Float64 projection (..., 3) → (..., 2) with the OpenCV 5-coefficient
    distortion model (k1, k2, p1, p2, k3) — the numpy mirror of
    `ops.geometry.project_points`, kept independent so the oracle
    never shares code with the implementation under test."""
    shape = pts3d.shape[:-1]
    cam = pts3d.reshape(-1, 3) @ np.asarray(R).T + np.asarray(T).reshape(3)
    x = cam[:, 0] / cam[:, 2]
    y = cam[:, 1] / cam[:, 2]
    if dist is not None and np.any(np.asarray(dist)):
        k1, k2, p1, p2, k3 = np.asarray(dist, np.float64).reshape(5)
        r2 = x * x + y * y
        radial = 1.0 + k1 * r2 + k2 * r2 * r2 + k3 * r2 * r2 * r2
        x_d = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        y_d = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        x, y = x_d, y_d
    u = K[0, 0] * x + K[0, 2]
    v = K[1, 1] * y + K[1, 2]
    return np.stack([u, v], -1).reshape(*shape, 2)


def _draw_person(frame: np.ndarray, proj2d: np.ndarray, radius: int = 3,
                 limb_color=(120, 120, 120)) -> None:
    import cv2

    pts = np.round(proj2d).astype(int)
    for a, b in _LIMBS:
        cv2.line(frame, tuple(pts[a]), tuple(pts[b]), limb_color, 1)
    for j in range(17):
        color = _TYPE_COLORS[_JOINT_TYPES[j]]
        cv2.circle(frame, tuple(pts[j]), radius, color, -1)


def _hard_background(width: int, height: int,
                     rng: np.random.Generator) -> np.ndarray:
    """Cluttered textured background: blurred colour field + random
    shapes/lines whose palette overlaps the joint colours (hard negatives
    for both the detector and the pose model)."""
    import cv2

    bg = rng.integers(0, 160, (height // 8, width // 8, 3)).astype(np.uint8)
    bg = cv2.resize(bg, (width, height), interpolation=cv2.INTER_LINEAR)
    palette = list(_TYPE_COLORS.values()) + [(200, 200, 200), (30, 30, 30)]
    for _ in range(int(rng.integers(6, 14))):
        color = palette[int(rng.integers(len(palette)))]
        kind = int(rng.integers(3))
        p0 = (int(rng.integers(width)), int(rng.integers(height)))
        if kind == 0:
            cv2.circle(bg, p0, int(rng.integers(2, 12)), color, -1)
        elif kind == 1:
            p1 = (int(rng.integers(width)), int(rng.integers(height)))
            cv2.line(bg, p0, p1, color, int(rng.integers(1, 3)))
        else:
            p1 = (p0[0] + int(rng.integers(4, 30)), p0[1] + int(rng.integers(4, 30)))
            cv2.rectangle(bg, p0, p1, color, -1)
    noise = rng.integers(0, 25, (height, width, 3)).astype(np.uint8)
    return cv2.add(bg, noise)


def _draw_occluder(frame: np.ndarray, proj2d: np.ndarray,
                   rng: np.random.Generator) -> None:
    """A random opaque rectangle/ellipse overlapping the person."""
    import cv2

    j = int(rng.integers(17))
    cx, cy = float(proj2d[j, 0]), float(proj2d[j, 1])
    w = float(rng.uniform(6, 22))
    h = float(rng.uniform(6, 22))
    color = tuple(int(v) for v in rng.integers(0, 255, 3))
    if rng.uniform() < 0.5:
        cv2.rectangle(frame, (int(cx - w / 2), int(cy - h / 2)),
                      (int(cx + w / 2), int(cy + h / 2)), color, -1)
    else:
        cv2.ellipse(frame, (int(cx), int(cy)), (int(w / 2) + 1, int(h / 2) + 1),
                    float(rng.uniform(0, 180)), 0, 360, color, -1)


def render_frame(proj2d: np.ndarray, width: int, height: int,
                 rng: np.random.Generator, noise: int = 45,
                 radius: int = 3, hard: bool = False,
                 distractor2d: np.ndarray | None = None,
                 n_occluders: int = 0) -> np.ndarray:
    """Render one camera view of the person; uint8 (H, W, 3).

    Easy mode (default): dark noise background, grey limb segments,
    joint-type-coloured disks.  ``hard=True`` switches to the cluttered
    textured background (VERDICT r2 weak #4); ``distractor2d`` renders a
    second unlabeled person (exercises the detector's top-1 selection,
    reference mmpose_pose_estimation.py:242-248); ``n_occluders`` draws
    that many opaque shapes OVER the main person.
    """
    if hard:
        frame = _hard_background(width, height, rng)
    else:
        frame = rng.integers(0, noise, (height, width, 3)).astype(np.uint8)
    if distractor2d is not None:
        _draw_person(frame, distractor2d, radius=max(radius - 1, 1),
                     limb_color=(100, 100, 100))
    _draw_person(frame, proj2d, radius=radius)
    for _ in range(n_occluders):
        _draw_occluder(frame, proj2d, rng)
    return frame


def person_bbox(proj2d: np.ndarray, width: int, height: int,
                margin: float = 8.0) -> np.ndarray:
    """Tight joint bbox + margin, clipped to the frame; (4,) xyxy."""
    x0 = max(float(proj2d[:, 0].min()) - margin, 0.0)
    y0 = max(float(proj2d[:, 1].min()) - margin, 0.0)
    x1 = min(float(proj2d[:, 0].max()) + margin, float(width))
    y1 = min(float(proj2d[:, 1].max()) + margin, float(height))
    return np.array([x0, y0, x1, y1], np.float32)


class SyntheticSceneConfig:
    """Scene sampler: moving person + rig; yields frames/labels on demand.

    ``distortion``: see `make_rig` — nonzero coefficients put real lens
    curvature into both the rendered pixels and the labels, so the
    deployed pipeline's iterative undistortion (`ops/undistort.py`, the
    reference's utils.py:1314-1315 step) does real work in the accuracy
    harness.

    ``hard=True`` is the hard domain (VERDICT r2 weak #4): cluttered
    textured backgrounds, per-sample person-scale variation
    (``scale_range``), random opaque occluders over the person
    (``occluder_prob``), and a second unlabeled distractor person
    (``distractor_prob``, rendered smaller/behind) that the detector's
    top-1 selection must reject.
    """

    def __init__(self, n_cams: int = 2, width: int = 256, height: int = 256,
                 seed: int = 0, scale: float = 0.8, distortion=None,
                 hard: bool = False, scale_range: tuple = (0.55, 1.05),
                 occluder_prob: float = 0.5, distractor_prob: float = 0.5):
        self.width, self.height = width, height
        self.cams = make_rig(n_cams, width, height, distortion=distortion)
        self.rng = np.random.default_rng(seed)
        self.scale = scale
        self.hard = bool(hard)
        self.scale_range = tuple(scale_range)
        self.occluder_prob = float(occluder_prob)
        self.distractor_prob = float(distractor_prob)

    def trajectory(self, n_frames: int):
        """(T, 17, 3) world trajectory: walk cycle + lateral drift."""
        traj = np.zeros((n_frames, 17, 3))
        scale = (self.rng.uniform(*self.scale_range) if self.hard else self.scale)
        for i in range(n_frames):
            t = 2.0 * np.pi * i / max(n_frames / 3, 1)
            ox = 60.0 * np.sin(2 * np.pi * i / max(n_frames, 1))
            oz = 320.0 + 40.0 * np.sin(2 * np.pi * i / max(n_frames * 2, 1))
            traj[i] = coco17_pose(t, origin=(ox, 10.0, oz), scale=scale)
        return traj

    def _sample_distractor(self):
        """A smaller, farther person (unlabeled)."""
        t = self.rng.uniform(0, 2 * np.pi)
        ox = self.rng.uniform(-90, 90)
        oz = self.rng.uniform(420, 520)  # behind the main person
        s = self.scale * self.rng.uniform(0.45, 0.65)
        return coco17_pose(t, origin=(ox, 5.0, oz), scale=s)

    def _render_one(self, proj, K, R, T, dist, distractor3d):
        d2d = None
        if distractor3d is not None:
            d2d = project_oracle(distractor3d, K, R, T, dist)
        n_occ = (int(self.rng.uniform() < self.occluder_prob)
                 + int(self.rng.uniform() < self.occluder_prob * 0.4)
                 if self.hard else 0)
        return render_frame(proj, self.width, self.height, self.rng,
                            hard=self.hard, distractor2d=d2d,
                            n_occluders=n_occ)

    def render_views(self, pts3d: np.ndarray):
        """One timestep → (frames (C,H,W,3) uint8, proj (C,17,2), boxes (C,4))."""
        distractor3d = None
        if self.hard and self.rng.uniform() < self.distractor_prob:
            distractor3d = self._sample_distractor()
        frames, projs, boxes = [], [], []
        for K, R, T, dist in self.cams:
            proj = project_oracle(pts3d, K, R, T, dist)
            frames.append(self._render_one(proj, K, R, T, dist, distractor3d))
            projs.append(proj)
            boxes.append(person_bbox(proj, self.width, self.height))
        return np.stack(frames), np.stack(projs), np.stack(boxes)

    def sample_pose(self):
        """Random standalone pose for training batches: (17,3) world."""
        t = self.rng.uniform(0, 2 * np.pi)
        ox = self.rng.uniform(-70, 70)
        oy = self.rng.uniform(-10, 25)
        oz = self.rng.uniform(270, 380)
        scale = (self.rng.uniform(*self.scale_range) if self.hard else self.scale)
        return coco17_pose(t, origin=(ox, oy, oz), scale=scale)

    def render_training_view(self, pts3d: np.ndarray, cam):
        """One training image of ``pts3d`` through ``cam`` with the scene's
        domain settings (hard clutter/occluders/distractor when enabled).
        Returns (frame uint8, proj (17,2))."""
        K, R, T, dist = cam
        proj = project_oracle(pts3d, K, R, T, dist)
        distractor3d = None
        if self.hard and self.rng.uniform() < self.distractor_prob:
            distractor3d = self._sample_distractor()
        frame = self._render_one(proj, K, R, T, dist, distractor3d)
        return frame, proj


def make_scaled_scene(width: int, height: int, seed: int = 0,
                      n_cams: int = 1) -> "SyntheticSceneConfig":
    """A scene whose rig is re-framed for the given resolution.

    The default rig frames the person for 256px images; scaling the focal
    length with the frame keeps every joint in view at any resolution
    (the train/eval contract `write_coco_dataset` and the convergence
    benchmarks share).
    """
    scene = SyntheticSceneConfig(n_cams=n_cams, width=width, height=height,
                                 seed=seed)
    scene.cams = make_rig(n_cams=n_cams, width=width, height=height,
                          focal=300.0 * min(width, height) / 256.0)
    return scene


def write_coco_dataset(out_dir, n_images: int = 128, width: int = 256,
                       height: int = 256, seed: int = 0):
    """Render a synthetic COCO person_keypoints dataset to disk.

    Produces the exact input surface `cli/train.py` consumes
    (`training.data.parse_coco_keypoints`): an ``images/`` directory of
    PNGs plus a ``person_keypoints.json`` with per-instance bbox
    (COCO xywh) and flattened (x, y, v) keypoints.  This closes the
    train-CLI loop on generated data with no downloads: the reference's
    MMPose-zoo training capability (SURVEY.md §2.2 rows 8-9) exercised
    end to end in a zero-egress environment.

    Returns ``(annotations_json_path, images_dir)``.
    """
    import json
    import os

    import cv2

    scene = make_scaled_scene(width, height, seed=seed)
    K, R, T, _ = scene.cams[0]
    images_dir = os.path.join(str(out_dir), "images")
    os.makedirs(images_dir, exist_ok=True)

    images, annotations = [], []
    for i in range(n_images):
        pts3d = scene.sample_pose()
        proj = project_oracle(pts3d, K, R, T)
        frame = render_frame(proj, width, height, scene.rng)
        fname = f"img{i:05d}.png"
        # Frames are RGB in memory; cv2 writes BGR files, and the loader
        # (KeypointBatcher._load_record) flips imread's BGR back to RGB.
        cv2.imwrite(os.path.join(images_dir, fname), frame[..., ::-1])
        x0, y0, x1, y1 = person_bbox(proj, width, height)
        kps = []
        for j in range(17):
            kps += [float(proj[j, 0]), float(proj[j, 1]), 2]
        images.append({"id": i, "file_name": fname,
                       "width": width, "height": height})
        annotations.append({
            "id": i, "image_id": i, "category_id": 1, "iscrowd": 0,
            "bbox": [float(x0), float(y0), float(x1 - x0), float(y1 - y0)],
            "keypoints": kps, "num_keypoints": 17,
        })

    ann_path = os.path.join(str(out_dir), "person_keypoints.json")
    with open(ann_path, "w") as f:
        json.dump({
            "images": images,
            "annotations": annotations,
            "categories": [{"id": 1, "name": "person",
                            "keypoints": _JOINT_TYPES}],
        }, f)
    return ann_path, images_dir

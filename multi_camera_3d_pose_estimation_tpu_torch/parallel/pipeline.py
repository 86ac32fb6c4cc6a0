"""Multi-camera block pipeline over a rank mesh, clip batches, and the
data-parallel refinement step.

Counterpart of the JAX package's ``parallel/pipeline.py``:

- `ShardedPosePipeline`: a (T, C, H, W, 3) frame block goes through the
  person detector (optional), crop, the 2D model and decode as one batch of
  T·C crops, joints under the confidence threshold become NaN, and each
  joint is triangulated from its best two views (``triangulation="top2"``)
  or from all finite views by the robust n-view solve (``"nview"``).
  Outputs keep the reference's wire layouts: kpts_2d (T, K, 3, C),
  heatmaps_2d (T, C, K, 6), kpts_3d (T, K, 3).  With a mesh
  (`parallel.make_mesh`), every rank is given the whole block, runs its
  own frames (`mesh.local_rows`) and returns the whole block's outputs
  (`mesh.gather_rows`): detection, flip-TTA and triangulation are per frame.
  Consistent selection is not: its temporal window crosses the shards, so
  the ranks gather the top-k candidates (a few KB) and each selects over
  the whole block, as JAX's global program does.
- `run_clips_batched`: synchronized clips folded into time, one block.
- `sharded_refine_step`: one synchronous Adam step over all refinement
  windows, each rank differentiating its own windows.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.detector import clip_boxes, decode_top1, decode_topk, select_consistent_boxes
from ..models.topdown import _predict
from ..ops.triangulation import triangulate_nview, triangulate_top2
from ..refine.costs import likelihood_cost, smoothness_cost
from ..refine.optimizer import RefineConfig, _clip_adam_step
from ..utils.profiling import span
from .mesh import all_reduce_sum, check_mesh, gather_rows, local_rows

__all__ = ["ShardedPosePipeline", "sharded_refine_step", "run_clips_batched"]


class ShardedPosePipeline:
    """2D + 3D estimation of frame blocks, on one device or over a rank mesh.

    - ``estimator``: a `models.TopDownEstimator`.
    - ``cam_stack``: {"K" (C,3,3), "R" (C,3,3), "T" (C,3), "dist" (C,5)}.
    - ``mesh``: a mesh of `parallel.make_mesh` or `parallel.make_clip_mesh`
      whose device type is ``device``'s; None runs on one device.  The
      block's frame count must be a multiple of the mesh size.
    - ``detector``: a `models.SinglePersonDetector` (or None).  With a model,
      ``run(frames)`` detects on the bf16 [0, 1] full frames (no ImageNet
      normalisation) and crops to its box, top-1 or by consistent selection
      (its ``select``), where the score passes its ``bbox_thr``; elsewhere
      the full frame.  ``run(frames, bboxes)`` with boxes skips it.
    - ``donate_frames``: accepted, as in JAX, and changes nothing.
    - ``triangulation``: "top2" (the reference's best two views) or "nview"
      (`ops.triangulate_nview`).
    """

    def __init__(self, estimator, cam_stack: dict, mesh=None, conf_threshold: float = 0.3,
                 detector=None, donate_frames: bool = False, triangulation: str = "top2",
                 device="cuda"):
        if triangulation not in ("top2", "nview"):
            raise ValueError(f"unknown triangulation '{triangulation}'")
        self.triangulation = triangulation
        self.device = torch.device(device)
        for part in (estimator, detector):
            if part is not None and part.device != self.device:
                raise ValueError(f"{type(part).__name__} is on {part.device}, "
                                 f"pipeline on {self.device}")
        check_mesh(mesh, self.device)
        self.mesh = mesh
        self.donate_frames = bool(donate_frames)
        self.estimator = estimator
        self.detector = detector
        self.conf_threshold = float(conf_threshold)
        self.cam_stack = {k: torch.as_tensor(v, dtype=torch.float32, device=self.device)
                          for k, v in cam_stack.items()}

    @property
    def has_detector(self) -> bool:
        return self.detector is not None and self.detector.model is not None

    def _rows(self, x):
        """This rank's frames of ``x`` on the pipeline's device (all of them
        without a mesh); host arrays copy only these rows."""
        if self.mesh is not None:
            x = local_rows(x, self.mesh)
        return torch.as_tensor(x, device=self.device)

    def _full_frame(self, frames: torch.Tensor) -> torch.Tensor:
        T, C, H, W = frames.shape[:4]
        return torch.tensor([0.0, 0.0, float(W), float(H)], device=self.device).expand(T, C, 4)

    @torch.inference_mode()
    def run(self, frames, bboxes=None) -> dict:
        """frames (T, C, H, W, 3) uint8 or float, bboxes (T, C, 4) or None.
        Spans (`utils.profiling.span`): ``mc3d.pipeline.run`` around the
        call, ``mc3d.pipeline.detect`` around the detector inside it."""
        with span("mc3d.pipeline.run"):
            frames = self._rows(frames)
            use_detector = bboxes is None and self.has_detector
            bboxes = self._full_frame(frames) if bboxes is None else self._rows(bboxes).float()
            frames = _pixels(frames)
            if use_detector:
                with span("mc3d.pipeline.detect"):
                    bboxes = _detect_boxes(self.detector, frames, bboxes, self.cam_stack,
                                           self.mesh)[0]
            out = _pipeline_fn(self.estimator, self.conf_threshold, self.triangulation, frames,
                               bboxes, self.cam_stack)
            if self.mesh is not None:
                out = {k: gather_rows(v, self.mesh) for k, v in out.items()}
            return out

    @torch.inference_mode()
    def detect(self, frames) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The boxes ``run(frames)`` crops to: (boxes (T, C, 4), the selected
        candidate's score (T, C), kept (T, C): score > ``bbox_thr``, else the
        full frame).  Needs a detector with a model."""
        frames = _pixels(self._rows(frames))
        boxes, score = _detect_boxes(self.detector, frames, self._full_frame(frames),
                                     self.cam_stack, self.mesh)
        if self.mesh is not None:
            boxes, score = gather_rows(boxes, self.mesh), gather_rows(score, self.mesh)
        return boxes, score, score > self.detector.bbox_thr


def _pixels(frames: torch.Tensor) -> torch.Tensor:
    """bf16 [0, 1] frames: the pixel path's compute dtype (cast, detector,
    crop resample, normalize); boxes, decode and triangulation stay f32."""
    if frames.dtype == torch.uint8:
        return frames.to(torch.bfloat16) / 255.0
    if frames.dtype == torch.float32:
        return frames.to(torch.bfloat16)
    return frames


def _detect_boxes(det, frames: torch.Tensor, bboxes: torch.Tensor, cam: dict, mesh=None):
    """The detector on the bf16 frames (T, C, H, W, 3): the selected boxes
    clipped to the frame where their score passes ``det.bbox_thr``, else
    ``bboxes``; returns (boxes (T, C, 4), score (T, C)).  On a mesh the
    frames are this rank's, and consistent selection runs over every rank's
    candidates."""
    T, C, H, W, _ = frames.shape
    out = det.model(frames.reshape(T * C, H, W, 3).permute(0, 3, 1, 2))
    if det.select == "consistent":
        # The top-k candidates, clipped, then re-picked by cross-view and
        # temporal consistency of the subject's 3-D centre.
        boxes_k, scores_k = decode_topk(out, k=det.topk)
        boxes_k = clip_boxes(boxes_k, W, H).reshape(T, C, det.topk, 4)
        scores_k = scores_k.reshape(T, C, det.topk)
        if mesh is not None:
            boxes_k, scores_k = gather_rows(boxes_k, mesh), gather_rows(scores_k, mesh)
        boxes, score = select_consistent_boxes(
            boxes_k, scores_k, cam, det_thr=det.bbox_thr, frame_wh=(W, H),
            window=det.select_window, lam=det.select_lam)
        if mesh is not None:
            boxes, score = local_rows(boxes, mesh), local_rows(score, mesh)
    else:
        boxes, score = decode_top1(out)
        boxes, score = clip_boxes(boxes, W, H).reshape(T, C, 4), score.reshape(T, C)
    keep = score > det.bbox_thr
    return torch.where(keep[..., None], boxes, bboxes), score


def _pipeline_fn(est, conf_thr: float, triangulation: str, frames: torch.Tensor,
                 bboxes: torch.Tensor, cam: dict) -> dict:
    T, C, H, W, _ = frames.shape
    out = _predict(est, frames.reshape(T * C, H, W, 3), bboxes.reshape(T * C, 4))
    with span("mc3d.pipeline.triangulate", device=frames.is_cuda):
        kpts = out["keypoints"].reshape(T, C, -1, 3)
        gauss = out["gaussians"].reshape(T, C, -1, 6)

        conf = kpts[..., 2]  # (T, C, K)
        # Low-confidence joints -> NaN, the pipeline's missing-data mechanism.
        xy = torch.where(conf[..., None] > conf_thr, kpts[..., :2],
                         torch.full_like(kpts[..., :2], float("nan")))
        xy_jc = xy.transpose(1, 2)  # (T, K, C, 2)
        conf_jc = conf.transpose(1, 2)  # (T, K, C)
        tri = triangulate_nview if triangulation == "nview" else triangulate_top2
        kpts_3d = tri(xy_jc, conf_jc, cam["K"], cam["dist"], cam["R"], cam["T"])
        kpts_2d = torch.cat([xy_jc, conf_jc[..., None]], dim=-1).transpose(-1, -2)  # (T, K, 3, C)
    return {"kpts_2d": kpts_2d, "heatmaps_2d": gauss, "kpts_3d": kpts_3d}


def run_clips_batched(pipeline: ShardedPosePipeline, clips_frames, bboxes=None,
                      split: bool = True):
    """Synchronized clips (n_clips, T, C, H, W, 3) through ``pipeline`` as
    one block of n_clips·T frames (on a `make_clip_mesh`, sharded
    clips-major, as in JAX).  ``split=True``: a list of per-clip result
    dicts; ``split=False``: one dict with a leading (n_clips, T) per key.
    ``bboxes``: (n_clips, T, C, 4) or None."""
    if not isinstance(clips_frames, (torch.Tensor, np.ndarray)):
        clips_frames = np.asarray(clips_frames)
    n_clips, T = clips_frames.shape[:2]
    flat = clips_frames.reshape((n_clips * T,) + tuple(clips_frames.shape[2:]))
    if bboxes is not None:
        bboxes = bboxes.reshape((n_clips * T,) + tuple(bboxes.shape[2:]))
    out = pipeline.run(flat, bboxes)
    stacked = {k: v.reshape((n_clips, T) + tuple(v.shape[1:])) for k, v in out.items()}
    if not split:
        return stacked
    return [{k: v[i] for k, v in stacked.items()} for i in range(n_clips)]


class _RefineAdam:
    """`sharded_refine_step`'s optimizer: ``init(params)`` gives the state
    ``step_fn`` takes, Adam's moments (of this rank's trajectory windows,
    as the JAX state is sharded with them, and of the extrinsics) and the
    update count."""

    def __init__(self, mesh):
        self.mesh = mesh

    def init(self, params: dict) -> dict:
        leaves = [local_rows(params["traj"], self.mesh), params["rvecs"], params["tvecs"]]
        return {"count": 0, "mu": [torch.zeros_like(p) for p in leaves],
                "nu": [torch.zeros_like(p) for p in leaves]}


def sharded_refine_step(mesh, lr: float = 1e-3, betas=(0.9, 0.999), lambda_smooth: float = 1.0,
                        grad_clip: float = 1.0):
    """Build (step_fn, tx) for the data-parallel refinement step.

    ``step_fn(params, opt_state, batch) -> (params, opt_state, loss)``, every
    rank given and returning the global dicts:

    - ``params``: ``traj`` (N, B, J, 3) trajectory windows, ``rvecs`` /
      ``tvecs`` (C, 3) the cameras' extrinsics, all learnable;
    - ``batch``: ``means`` (N, B, C, J, 2), ``cov_inv`` (N, B, C, J, 2, 2),
      ``Ks`` (C, 3, 3), ``dists`` (C, 5);
    - ``loss``: the mean over the N windows of the likelihood plus
      ``lambda_smooth`` × the smoothness.

    Each rank differentiates its own windows (N a multiple of the mesh
    size).  One all-reduce sums the extrinsics' gradients, the squared norm
    of the trajectory's and the loss; clip-by-global-norm then scales by the
    global norm, and Adam (optax's ``scale_by_adam`` → ``scale(−lr)``)
    updates each rank's windows and the extrinsics, the same on every rank.
    The windows are gathered back on every rank.
    """
    cfg = RefineConfig(lr=lr, betas=tuple(betas), grad_clip=grad_clip)

    def step_fn(params: dict, opt_state: dict, batch: dict):
        n = params["traj"].shape[0]
        traj = local_rows(params["traj"], mesh).detach().requires_grad_(True)
        rvecs, tvecs = (params[k].detach().requires_grad_(True) for k in ("rvecs", "tvecs"))
        means, cov_inv = local_rows(batch["means"], mesh), local_rows(batch["cov_inv"], mesh)
        with torch.enable_grad():
            local = sum(likelihood_cost(traj[i], means[i], cov_inv[i], batch["Ks"], rvecs, tvecs,
                                        batch["dists"]) + lambda_smooth * smoothness_cost(traj[i])
                        for i in range(traj.shape[0])) / n
            g_traj, g_r, g_t = torch.autograd.grad(local, [traj, rvecs, tvecs])
        total = all_reduce_sum(torch.cat([g_r.flatten(), g_t.flatten(),
                                          (g_traj * g_traj).sum()[None], local.detach()[None]]),
                               mesh)
        k = g_r.numel()
        g_r, g_t = total[:k].view_as(g_r), total[k:2 * k].view_as(g_t)
        g_norm = torch.sqrt(total[-2] + (g_r * g_r).sum() + (g_t * g_t).sum())
        count = opt_state["count"] + 1
        leaves, mu, nu = _clip_adam_step(cfg, [traj.detach(), rvecs.detach(), tvecs.detach()],
                                         [g_traj, g_r, g_t], opt_state["mu"], opt_state["nu"],
                                         count, g_norm=g_norm)
        params = {"traj": gather_rows(leaves[0], mesh), "rvecs": leaves[1], "tvecs": leaves[2]}
        return params, {"count": count, "mu": mu, "nu": nu}, total[-1]

    return step_fn, _RefineAdam(mesh)

"""The port's block pipeline with a person detector, and with RTMPose (SimCC),
against the JAX pipeline.

T=4 frames x C=2 cameras of 64x96 on the synthetic rig; the detector is
``test_rtmdet_micro`` (its ``rtm_reg`` biases shifted by +3 so that random
boxes have a size), the pose model HRNet ``test_tiny`` at input (32, 64), or
RTMPose at widen 0.125 and input (64, 96) (its ``cls_x``/``cls_y`` kernels
x6 so that random joints pass the 0.3 gate).  As in
``test_torch_port_pipeline.py``, held in layers:

1. the models on the pipeline's own bf16 inputs: the detector's head outputs
   and RTMPose's logits at 5e-2 of their largest value;
2. given the same detector outputs (RTMDet's flat candidates or CenterNet
   maps, with ties and scores on both sides of ``bbox_thr``) and the same
   heatmaps or SimCC logits: the boxes the pipeline crops to bit for bit
   equal to JAX's (top-1 and consistent selection), and kpts_2d /
   heatmaps_2d / kpts_3d at 1e-4 (f32 decode, pushforward and
   triangulation, sums in another order), with and without flip-TTA;
3. end to end on the same uint8 block and weights (the detector in f32, so
   that the same candidate gives the same box): kpts_3d within 1e-3
   relative / 1e-2 where both sides cropped to the same box (within 1e-2
   px) and decoded the same peaks, with the shares asserted.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_camera_3d_pose_estimation_tpu.models import HRNet as JHRNet
from multi_camera_3d_pose_estimation_tpu.models import TopDownEstimator as JEstimator
from multi_camera_3d_pose_estimation_tpu.models import detector as jdet
from multi_camera_3d_pose_estimation_tpu.models.rtmdet import RTMDet as JRTMDet
from multi_camera_3d_pose_estimation_tpu.models.rtmpose import RTMPose as JRTMPose
from multi_camera_3d_pose_estimation_tpu.parallel import ShardedPosePipeline as JPipeline
from multi_camera_3d_pose_estimation_tpu_torch.entry import build_pipeline, synthetic_rig
from multi_camera_3d_pose_estimation_tpu_torch.models import (HRNet, RTMDet, RTMPose,
                                                               SinglePersonDetector,
                                                               TopDownEstimator)
from multi_camera_3d_pose_estimation_tpu_torch.models.convert import load_rtmdet_from_flax
from multi_camera_3d_pose_estimation_tpu_torch.models.registry import DETECTOR_REGISTRY
from multi_camera_3d_pose_estimation_tpu_torch.models.topdown import center_scale_from_bbox
from multi_camera_3d_pose_estimation_tpu_torch.parallel import ShardedPosePipeline

from tests._torch_port_util import random_variables
from tests.conftest import project_np
from tests.test_torch_port_pipeline import TINY, _FixedHeatmaps

SHAPE = (4, 2, 64, 96, 3)
T, C, H, W = SHAPE[:4]
HR_INPUT = (32, 64)
RTM_CFG = {"widen": 0.125, "deepen": 0.167, "embed": 32}
RTM_INPUT = (64, 96)
DET_CFG = DETECTOR_REGISTRY["test_rtmdet_micro"]["cfg"]
SELECT = dict(topk=4, select_window=9, select_lam=4.0)


@pytest.fixture(scope="module")
def frames():
    return np.random.default_rng(0).integers(0, 256, SHAPE, dtype=np.uint8)


@pytest.fixture(scope="module")
def weights():
    hr = random_variables(JHRNet(num_joints=17, cfg=TINY), (1, HR_INPUT[1], HR_INPUT[0], 3), 0)
    det = random_variables(JRTMDet(**DET_CFG), (1, H, W, 3), 1)
    for lvl in range(3):
        det["params"]["head"][f"rtm_reg_{lvl}"]["bias"] = (
            det["params"]["head"][f"rtm_reg_{lvl}"]["bias"] + 3.0)
    rtm = random_variables(JRTMPose(cfg=RTM_CFG, input_size=RTM_INPUT),
                           (1, RTM_INPUT[1], RTM_INPUT[0], 3), 2)
    for key in ("cls_x", "cls_y"):
        rtm["params"][key]["kernel"] = rtm["params"][key]["kernel"] * 6.0
    return hr, det, rtm


def _bf16_frames(frames):
    return jnp.asarray(frames.reshape(T * C, H, W, 3), jnp.bfloat16) / 255.0


def _rel(out, ref):
    out = out.float().numpy() if torch.is_tensor(out) else np.asarray(out)
    return float(np.abs(out - np.asarray(ref, np.float32)).max() / np.abs(ref).max())


def test_detector_outputs_match_bf16(weights, frames):
    """Layer 1: RTMDet on the pipeline's bf16 frames."""
    _, det, _ = weights
    ref = jax.jit(JRTMDet(**DET_CFG).apply)(det, _bf16_frames(frames))
    model = load_rtmdet_from_flax(RTMDet(**DET_CFG, device="cpu"), det).eval()
    x = torch.from_numpy(np.array(_bf16_frames(frames).astype(jnp.float32))).to(torch.bfloat16)
    with torch.no_grad():
        out = model(x.permute(0, 3, 1, 2))
    for o_lvl, r_lvl in zip(out["raw"], ref["raw"]):
        for o, r in zip(o_lvl, r_lvl):
            print("head output error / scale:", _rel(o, r))
            assert _rel(o, r) <= 5e-2


def test_rtmpose_logits_match_bf16(weights, frames):
    """Layer 1: RTMPose on the pipeline's bf16 crops of the full frames."""
    from multi_camera_3d_pose_estimation_tpu.models.topdown import preprocess_crops

    _, _, rtm = weights
    boxes = jnp.tile(jnp.float32([0, 0, W, H]), (T * C, 1))
    crops, _, _ = preprocess_crops(_bf16_frames(frames), boxes, RTM_INPUT)
    ref = jax.jit(JRTMPose(cfg=RTM_CFG, input_size=RTM_INPUT).apply)(rtm, crops)
    port = build_pipeline(RTM_CFG, RTM_INPUT, SHAPE, device="cpu", variables=rtm,
                          family="rtmpose")
    x = torch.from_numpy(np.array(crops.astype(jnp.float32))).to(torch.bfloat16)
    with torch.no_grad():
        out = port.estimator.model(x.permute(0, 3, 1, 2))
    for o, r in zip(out, ref):
        print("logit error / scale:", _rel(o, r))
        assert _rel(o, r) <= 5e-2


# Layer 2: fixed model outputs on both sides.

class _FixedDetector(torch.nn.Module):
    """Stands in for a detector: returns given outputs (numpy) on both sides."""

    def __init__(self, outputs):
        super().__init__()
        self.outputs = outputs

    def apply(self, variables, frames):  # the JAX side's call
        return {k: jnp.asarray(v) for k, v in self.outputs.items()}

    def forward(self, frames):  # the port's call
        return {k: torch.from_numpy(v) for k, v in self.outputs.items()}


def _converging_rig():
    """Two cameras yawed ±15° about the origin at distance 300, f = 100 px,
    mild distortion: points near the origin are seen by both."""
    Ks, Rs = [], []
    for th in np.deg2rad([-15.0, 15.0]):
        Ks.append([[100.0, 0, W / 2], [0, 100.0, H / 2], [0, 0, 1]])
        Rs.append([[np.cos(th), 0, np.sin(th)], [0, 1, 0], [-np.sin(th), 0, np.cos(th)]])
    return {"K": np.asarray(Ks, np.float32), "R": np.asarray(Rs, np.float32),
            "T": np.tile(np.float32([0, 0, 300]), (2, 1)),
            "dist": np.float32([[-0.05, 0.01, 0, 0, 0], [0.04, 0, 0, 0, 0]])}


def _scene(rng, rig):
    """A subject near the origin per frame: its centre's and its 17 joints'
    projections (T, C, 2) and (T, C, 17, 2)."""
    centre = rng.uniform([-15, -10, -15], [15, 10, 15], (T, 3))
    joints = centre[:, None] + rng.normal(0, 8, (T, 17, 3))
    cams = [tuple(rig[k][c].astype(float) for k in ("K", "R", "T", "dist")) for c in range(C)]
    c2d = np.stack([project_np(centre, *cam) for cam in cams], 1)
    j2d = np.stack([project_np(joints.reshape(-1, 3), *cam).reshape(T, 17, 2) for cam in cams], 1)
    return c2d, j2d


def _flat_outputs(rng, c2d):
    """RTMDet-style candidates (T·C, 30): boxes of 28-48 px around the
    subject's projection, scores with ties and on both sides of 0.3."""
    n = 30
    ctr = c2d.reshape(T * C, 1, 2) + rng.uniform(-4, 4, (T * C, n, 2))
    half = rng.uniform(14, 24, (T * C, n, 2))
    scores = rng.uniform(0.35, 0.7, (T * C, n))
    scores[0, [3, 11]] = 0.9  # tied top-1: the first wins
    scores[1] = np.round(scores[1] * 3) / 3  # many ties
    scores[2] = 0.1  # nothing kept: the full frame
    return {"boxes_all": np.concatenate([ctr - half, ctr + half], -1).astype(np.float32),
            "scores_all": scores.astype(np.float32)}


def _centernet_outputs(rng, c2d):
    """CenterNet maps whose boxes (100-120 px, clipped) all hold the subject."""
    center = rng.normal(-1.0, 1.5, (T * C, H // 16, W // 16)).astype(np.float32)
    center[3, 1, 1] = center[3, 2, 4] = 3.0  # tied peaks
    center[5] = -5.0  # nothing kept: the full frame
    return {"center": center,
            "wh": rng.uniform(100, 120, (T * C, H // 16, W // 16, 2)).astype(np.float32),
            "offset": rng.uniform(-0.5, 0.5, (T * C, H // 16, W // 16, 2)).astype(np.float32)}


def _jax_boxes(det_out, mode, thr, cam):
    """The boxes JAX's `_pipeline_fn` crops to, from the detector outputs."""
    full = jnp.tile(jnp.float32([0, 0, W, H]), (T * C, 1))
    lim = jnp.asarray([W, H, W, H], jnp.float32)
    if mode == "consistent":
        bk, sk = jdet.decode_topk(det_out, k=SELECT["topk"])
        sel = jax.jit(functools.partial(jdet.select_consistent_boxes, det_thr=thr,
                                        frame_wh=(W, H), window=SELECT["select_window"],
                                        lam=SELECT["select_lam"]))
        b, s = sel(jnp.clip(bk, 0.0, lim).reshape(T, C, -1, 4), sk.reshape(T, C, -1),
                   {k: jnp.asarray(v) for k, v in cam.items()})
        b, s = b.reshape(T * C, 4), s.reshape(T * C)
    else:
        b, s = jdet.decode_top1(det_out)
        b = jnp.clip(b, 0.0, lim)
    return np.asarray(jnp.where((s > thr)[:, None], b, full)).reshape(T, C, 4)


def _crop_coords(j2d, boxes, input_size):
    """Image points (T, C, 17, 2) -> crop pixels of the (T, C) boxes."""
    in_w, in_h = input_size
    centre, size = center_scale_from_bbox(torch.tensor(boxes.reshape(-1, 4)), in_w / in_h)
    centre, size = centre.numpy().reshape(T, C, 1, 2), size.numpy().reshape(T, C, 1, 2)
    return (j2d - (centre - size * 0.5)) * (np.float32([in_w, in_h]) / size)


def _peaked_heatmaps(rng, j2d, boxes):
    """Heatmaps (T·C, 17, 16, 8) peaked at the joints' projections, with
    amplitudes on both sides of the 0.3 gate."""
    hm = (_crop_coords(j2d, boxes, HR_INPUT) / 4.0).reshape(T * C, 17, 2)
    ys, xs = np.mgrid[0:16, 0:8]
    amp = rng.uniform(0.1, 1.5, (T * C, 17))
    return (amp[..., None, None] * np.exp(-((xs - hm[..., 0:1, None]) ** 2
                                            + (ys - hm[..., 1:2, None]) ** 2) / 2.0)
            ).astype(np.float32)


def _cov_atol(boxes):
    """Per (T, C) crop, the bound of the port's single-pass heatmap decode's
    covariances against the JAX decode's centred ones (layer 2 of
    ``test_torch_port_pipeline.py``): 8 f32 ulps of (h-1)² heatmap px²,
    times (stride · box size / crop size)² to image px²."""
    _, size = center_scale_from_bbox(torch.tensor(boxes.reshape(-1, 4)),
                                     HR_INPUT[0] / HR_INPUT[1])
    px = (4.0 * size.numpy()[:, 1] / HR_INPUT[1]).reshape(T, C, 1, 1)
    return 8 * float(np.finfo(np.float32).eps) * 15 ** 2 * px ** 2


def _compare_outputs(out, ref, boxes=None):
    """``boxes``: the (T, C) crops of a heatmap pipeline, whose covariances
    are held to `_cov_atol`; everything else at 1e-4."""
    for key in ("kpts_2d", "heatmaps_2d", "kpts_3d"):
        r, o = np.asarray(ref[key]), out[key].numpy()
        assert o.shape == r.shape and o.dtype == np.float32
        np.testing.assert_array_equal(np.isnan(o), np.isnan(r))
        if key == "heatmaps_2d" and boxes is not None:
            gap = np.abs(o[..., 2:] - r[..., 2:])
            assert np.all((gap <= _cov_atol(boxes)) | np.isnan(gap)), key
            o, r = o[..., :2], r[..., :2]
        np.testing.assert_allclose(o, r, rtol=1e-4, atol=1e-4, err_msg=key)
    finite = np.isfinite(out["kpts_3d"].numpy()).all(-1)
    assert 0.2 < finite.mean() < 1.0  # the gate dropped some joints, not all


@pytest.mark.parametrize("mode", ["top1", "consistent"])
@pytest.mark.parametrize("kind", ["flat", "centernet"])
def test_same_detections_give_same_boxes_and_outputs(weights, frames, mode, kind):
    """Layer 2 for the detector path: fixed detections and heatmaps."""
    hr, _, _ = weights
    rng = np.random.default_rng(3 + len(kind))
    rig = _converging_rig()
    c2d, j2d = _scene(rng, rig)
    det_out = _flat_outputs(rng, c2d) if kind == "flat" else _centernet_outputs(rng, c2d)
    fake_det = _FixedDetector(det_out)
    est = TopDownEstimator(HRNet(17, TINY, device="cpu"), HR_INPUT, device="cpu")
    pipe = ShardedPosePipeline(est, rig, device="cpu", detector=SinglePersonDetector(
        fake_det, bbox_thr=0.3, select=mode, device="cpu", **SELECT))
    boxes, _, kept = pipe.detect(frames)
    jboxes = _jax_boxes({k: jnp.asarray(v) for k, v in det_out.items()}, mode, 0.3, rig)
    np.testing.assert_array_equal(boxes.numpy(), jboxes)
    assert 0 < kept.float().mean() < 1  # boxes kept and frames falling back
    fake_hm = _FixedHeatmaps(_peaked_heatmaps(rng, j2d, jboxes))
    est.model = fake_hm
    ref = JPipeline(JEstimator(fake_hm, hr, input_size=HR_INPUT), rig,
                    detector=jdet.SinglePersonDetector(fake_det, {}, bbox_thr=0.3, select=mode,
                                                       **SELECT)).run(frames)
    _compare_outputs(pipe.run(frames), ref, jboxes)
    if (mode, kind) != ("top1", "flat"):
        return
    # Explicit boxes bypass the detector on both sides.
    given = np.tile(np.float32([4, 2, 92, 62]), (T, C, 1))
    est.model = fake_hm = _FixedHeatmaps(_peaked_heatmaps(rng, j2d, given))
    _compare_outputs(pipe.run(frames, given), JPipeline(
        JEstimator(fake_hm, hr, input_size=HR_INPUT), rig,
        detector=jdet.SinglePersonDetector(fake_det, {})).run(frames, given), given)


class _FixedLogits(torch.nn.Module):
    """Stands in for RTMPose: returns given SimCC logits, the direct pair on
    even calls and the mirrored pair on odd ones (flip-TTA's second pass)."""

    def __init__(self, pairs):
        super().__init__()
        self.pairs, self.calls = pairs, 0
        self.num_joints = 17

    def _next(self):
        pair = self.pairs[self.calls % len(self.pairs)]
        self.calls += 1
        return pair

    def apply(self, variables, crops):  # the JAX side's call
        return tuple(jnp.asarray(a) for a in self._next())

    def forward(self, crops):  # the port's call
        return tuple(torch.from_numpy(a) for a in self._next())


def _peaked_logits(rng, j2d):
    """SimCC logits (T·C, 17, bins) peaked at the bins of the joints'
    projections in the full frame's crop, N(0, 1) elsewhere, peak heights
    on both sides of the 0.3 gate."""
    full = np.tile(np.float32([0, 0, W, H]), (T, C, 1))
    bins = np.rint(_crop_coords(j2d, full, RTM_INPUT) * 2.0).astype(int).reshape(T * C, 17, 2)
    height = rng.uniform(2.0, 9.0, (T * C, 17))
    out = []
    for axis, n in ((0, 2 * RTM_INPUT[0]), (1, 2 * RTM_INPUT[1])):
        logits = rng.normal(0, 1, (T * C, 17, n)).astype(np.float32)
        np.put_along_axis(logits, np.clip(bins[..., axis:axis + 1], 0, n - 1),
                          height[..., None].astype(np.float32), -1)
        out.append(logits)
    return out


@pytest.mark.parametrize("flip", [False, True])
def test_same_logits_give_same_outputs(weights, frames, flip):
    """Layer 2 for the SimCC path: fixed logits, with and without flip-TTA
    (the mirrored pass's logits mirrored and joint-swapped, plus noise)."""
    from multi_camera_3d_pose_estimation_tpu_torch.training.augment import flip_permutation

    _, _, rtm = weights
    rng = np.random.default_rng(10 + flip)
    rig = _converging_rig()
    _, j2d = _scene(rng, rig)
    sx, sy = _peaked_logits(rng, j2d)
    sx[0, 0, [5, 90]] = 12.0  # tied peak: the first wins
    perm = np.asarray(flip_permutation("coco"))
    noise = lambda a: (a + rng.normal(0, 0.3, a.shape)).astype(np.float32)  # noqa: E731
    pairs = [(sx, sy), (noise(sx[:, perm, ::-1]), noise(sy[:, perm]))]
    ref = JPipeline(JEstimator(_FixedLogits(pairs), rtm, input_size=RTM_INPUT, decode="simcc",
                               flip_test=flip), rig).run(frames)
    model = RTMPose(cfg=RTM_CFG, input_size=RTM_INPUT, device="cpu")
    est = TopDownEstimator(model, RTM_INPUT, decode="simcc", flip_test=flip, device="cpu")
    est.model = _FixedLogits(pairs)
    _compare_outputs(ShardedPosePipeline(est, rig, device="cpu").run(frames), ref)


def _end_to_end_share(out, ref, same_box):
    """Joints decoded at the same peaks in both views of frames whose boxes
    agree, with kpts_3d finite on both sides."""
    same = np.abs(out["kpts_2d"][:, :, :2] - ref["kpts_2d"][:, :, :2]) < 1e-2
    same = (same.all(axis=2) & same_box[:, None, :]).all(-1)  # (T, K)
    return same & np.isfinite(out["kpts_3d"]).all(-1) & np.isfinite(ref["kpts_3d"]).all(-1)


@pytest.mark.parametrize("mode", ["top1", "consistent"])
def test_detector_pipeline_end_to_end(weights, frames, mode):
    """Layer 3 for the detector path: both whole pipelines, HRNet in bf16 and
    RTMDet in f32 on the bf16 frames (in bf16, its distances differ by a
    bf16 step, ~0.1 px, and no kept box would be the same on both sides)."""
    hr, det, _ = weights
    rig = synthetic_rig(C, H, W)
    jdet_model = JRTMDet(**DET_CFG, dtype=jnp.float32)
    out_j = jax.jit(jdet_model.apply)(det, _bf16_frames(frames))
    thr = float(np.median(np.asarray(out_j["scores_all"]).max(-1)))  # half the frames kept
    jpipe = JPipeline(JEstimator(JHRNet(num_joints=17, cfg=TINY), hr, input_size=HR_INPUT), rig,
                      detector=jdet.SinglePersonDetector(jdet_model, det, bbox_thr=thr,
                                                         select=mode, **SELECT))
    ref = {k: np.asarray(v) for k, v in jpipe.run(frames).items()}
    port_det = SinglePersonDetector(
        load_rtmdet_from_flax(RTMDet(**DET_CFG, dtype=torch.float32, device="cpu"), det),
        bbox_thr=thr, select=mode, device="cpu", **SELECT)
    port = build_pipeline(TINY, HR_INPUT, SHAPE, device="cpu", variables=hr, detector=port_det)
    out = {k: v.numpy() for k, v in port.run(frames).items()}
    boxes = port.detect(frames)[0].numpy()
    same_box = (np.abs(boxes - _jax_boxes(out_j, mode, thr, rig)) < 1e-2).all(-1)  # (T, C)
    both = _end_to_end_share(out, ref, same_box)
    print("same boxes", same_box.mean(), "joints compared", both.sum())
    assert same_box.mean() >= 0.5 and both.sum() >= 5
    np.testing.assert_allclose(out["kpts_3d"][both], ref["kpts_3d"][both], rtol=1e-3, atol=1e-2)


@pytest.mark.parametrize("flip", [False, True])
def test_simcc_pipeline_end_to_end(weights, frames, flip):
    """Layer 3 for the SimCC path: both whole pipelines, RTMPose bf16."""
    _, _, rtm = weights
    rig = synthetic_rig(C, H, W)
    jpipe = JPipeline(JEstimator(JRTMPose(cfg=RTM_CFG, input_size=RTM_INPUT), rtm,
                                 input_size=RTM_INPUT, decode="simcc", flip_test=flip), rig)
    ref = {k: np.asarray(v) for k, v in jpipe.run(frames).items()}
    port = build_pipeline(RTM_CFG, RTM_INPUT, SHAPE, device="cpu", variables=rtm,
                          family="rtmpose", flip_test=flip)
    out = {k: v.numpy() for k, v in port.run(frames).items()}
    both = _end_to_end_share(out, ref, np.ones((T, C), bool))
    print("joints compared", both.sum(), "of", both.size)
    assert both.sum() >= 5
    np.testing.assert_allclose(out["kpts_3d"][both], ref["kpts_3d"][both], rtol=1e-3, atol=1e-2)

"""The block pipeline's constants come from the device, with the values
they had as per-call host copies.

The DLT start vector (``ops.triangulation._smallest_eigvec_4x4``) and the
full-frame box (``ops.crop_resample.full_frame_boxes``, used by
``ShardedPosePipeline.run``/``detect`` and ``TopDownEstimator.predict_batch``)
are made once per device and key by ``ops.device_tables.device_table``.  Held
here, on the CPU: results bit for bit equal to the per-call
``torch.tensor(...)`` form, in f32 and f64; ``bboxes=None`` equal to the
explicit full-frame box; and a table first made under
``torch.inference_mode()`` serves a later call that autograd follows.  (That
``run`` holds no host wait is held on the card, in
``tests/test_torch_port_cuda.py``.)
"""

import numpy as np
import pytest
import torch

from multi_camera_3d_pose_estimation_tpu_torch.entry import build_pipeline
from multi_camera_3d_pose_estimation_tpu_torch.ops import device_tables
from multi_camera_3d_pose_estimation_tpu_torch.ops import triangulation as tri
from multi_camera_3d_pose_estimation_tpu_torch.ops.crop_resample import full_frame_boxes
from multi_camera_3d_pose_estimation_tpu_torch.ops.geometry import projection_matrix

TINY = {"widths": (8, 16, 32, 64), "modules": (1, 1, 1, 1), "stem": 16}
SHAPE = (4, 2, 96, 80, 3)
INPUT = (32, 64)
DTYPES = [torch.float32, torch.float64]


def _host_copy_eigvec(B, n_squarings=12):
    """`_smallest_eigvec_4x4` as it was: the start vector copied from the host at every call."""
    c = torch.diagonal(B, dim1=-2, dim2=-1).sum(-1)[..., None, None]
    M = c * torch.eye(4, dtype=B.dtype, device=B.device) - B
    for _ in range(n_squarings):
        M = torch.matmul(M, M)
        scale = M.abs().amax(dim=(-2, -1), keepdim=True)
        M = M / torch.clamp(scale, min=1e-30)
    v0 = torch.tensor([0.9, 0.5, 0.5, 0.5], dtype=B.dtype, device=B.device)
    v = torch.matmul(M, v0)
    n = torch.sqrt(torch.clamp((v * v).sum(-1, keepdim=True), min=1e-30))
    return v / n


def _same(a, b):
    torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)


def _cameras(dtype, n_cams=3, seed=0):
    rng = np.random.default_rng(seed)
    Ks, Rs, Ts = [], [], []
    for c in range(n_cams):
        th = np.deg2rad(-20.0 + 20.0 * c)
        Ks.append([[500.0 + 10 * c, 0, 320.0], [0, 505.0, 240.0], [0, 0, 1]])
        Rs.append([[np.cos(th), 0, np.sin(th)], [0, 1, 0], [-np.sin(th), 0, np.cos(th)]])
        Ts.append([rng.uniform(-5, 5), rng.uniform(-5, 5), 400.0])
    dists = 0.02 * rng.standard_normal((n_cams, 5))
    return [torch.as_tensor(np.asarray(a), dtype=dtype) for a in (Ks, dists, Rs, Ts)]


def _points(dtype, shape, seed=1):
    gen = torch.Generator().manual_seed(seed)
    pts = 640.0 * torch.rand(shape, generator=gen, dtype=torch.float64)
    pts.view(-1, 2)[::7] = float("nan")  # some missing views
    return pts.to(dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_smallest_eigvec_equals_host_copy_form(dtype):
    gen = torch.Generator().manual_seed(0)
    A = torch.randn(64, 6, 4, generator=gen, dtype=torch.float64).to(dtype)
    B = torch.matmul(A.transpose(-1, -2), A)
    B[0] = torch.eye(4, dtype=dtype)  # the masked points' system
    B[1] = torch.diag(torch.tensor([3.0, 2.0, 1.0, 0.0], dtype=dtype))  # an exact null vector
    _same(tri._smallest_eigvec_4x4(B), _host_copy_eigvec(B))


@pytest.mark.parametrize("dtype", DTYPES)
def test_triangulate_dlt_equals_host_copy_form(dtype, monkeypatch):
    Ks, _, Rs, Ts = _cameras(dtype, n_cams=2)
    Ps = projection_matrix(Ks, Rs, Ts)
    pts = _points(dtype, (5, 17, 2, 2))
    new = tri.triangulate_dlt(pts[..., 0, :], pts[..., 1, :], Ps[0], Ps[1])
    monkeypatch.setattr(tri, "_smallest_eigvec_4x4", _host_copy_eigvec)
    old = tri.triangulate_dlt(pts[..., 0, :], pts[..., 1, :], Ps[0], Ps[1])
    assert torch.isfinite(new).any() and torch.isnan(new).any()
    _same(new, old)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("method", ["top2", "nview"])
def test_triangulate_equals_host_copy_form(dtype, method, monkeypatch):
    Ks, dists, Rs, Ts = _cameras(dtype)
    fn = tri.triangulate_top2 if method == "top2" else tri.triangulate_nview
    pts = _points(dtype, (6, 17, 3, 2), seed=2)
    conf = torch.rand((6, 17, 3), generator=torch.Generator().manual_seed(3),
                      dtype=torch.float64).to(dtype)
    new = fn(pts, conf, Ks, dists, Rs, Ts)
    monkeypatch.setattr(tri, "_smallest_eigvec_4x4", _host_copy_eigvec)
    _same(new, fn(pts, conf, Ks, dists, Rs, Ts))


def test_dlt_after_inference_mode_serves_autograd(monkeypatch):
    """A start vector first made under ``torch.inference_mode()`` (as inside
    ``run``) is no inference tensor: a later solve that autograd follows
    saves it for backward and differentiates."""
    monkeypatch.setattr(device_tables, "_DEVICE_TABLES", {})
    Ks, _, Rs, Ts = _cameras(torch.float64, n_cams=2)
    Ps = projection_matrix(Ks, Rs, Ts)
    pts = 300.0 + 40.0 * torch.rand((8, 2, 2), generator=torch.Generator().manual_seed(4),
                                    dtype=torch.float64)
    with torch.inference_mode():
        first = tri.triangulate_dlt(pts[:, 0], pts[:, 1], Ps[0], Ps[1])
    v0 = device_tables.device_table(tri._dlt_start, device=pts.device, dtype=pts.dtype)
    assert not v0.is_inference()
    a = pts[:, 0].clone().requires_grad_(True)
    X = tri.triangulate_dlt(a, pts[:, 1], Ps[0], Ps[1])
    X.sum().backward()
    assert torch.isfinite(a.grad).all() and (a.grad != 0).any()
    _same(X.detach(), first)


def test_full_frame_boxes_are_made_once():
    a = full_frame_boxes((4, 2), 96, 80, "cpu")
    b = full_frame_boxes((3,), 96, 80, "cpu")
    assert a.shape == (4, 2, 4) and b.shape == (3, 4) and a.dtype == torch.float32
    _same(a, torch.tensor([0.0, 0.0, 80.0, 96.0]).expand(4, 2, 4))
    assert a.data_ptr() == b.data_ptr()  # one table, expanded
    assert full_frame_boxes((1,), 480, 640, "cpu")[0].tolist() == [0.0, 0.0, 640.0, 480.0]


@pytest.fixture(scope="module")
def frames():
    return np.random.default_rng(5).integers(0, 256, SHAPE, dtype=np.uint8)


@pytest.mark.parametrize("triangulation", ["top2", "nview"])
def test_run_without_boxes_equals_explicit_full_frame(frames, triangulation):
    pipe = build_pipeline(TINY, INPUT, SHAPE, device="cpu", triangulation=triangulation)
    T, C, H, W, _ = SHAPE
    box = np.tile(np.float32([0, 0, W, H]), (T, C, 1))
    implicit, explicit = pipe.run(frames), pipe.run(frames, box)
    assert torch.isfinite(implicit["kpts_3d"]).any()
    for k in ("kpts_2d", "heatmaps_2d", "kpts_3d"):
        _same(implicit[k], explicit[k])


def test_predict_batch_without_boxes_equals_explicit_full_frame(frames):
    pipe = build_pipeline(TINY, INPUT, SHAPE, device="cpu", seed=1)
    flat = frames.reshape((-1,) + SHAPE[2:])
    box = np.tile(np.float32([0, 0, SHAPE[3], SHAPE[2]]), (flat.shape[0], 1))
    implicit = pipe.estimator.predict_batch(flat)
    explicit = pipe.estimator.predict_batch(flat, box)
    for k in ("keypoints", "gaussians"):
        _same(implicit[k], explicit[k])


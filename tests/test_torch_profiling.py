"""The port's ``utils``: profiling and keypoint conversion against the JAX
package's, on the CPU.

- `StepTimer`: the report's lines in the JAX format for the same totals,
  JAX's ``block_jax=False`` keyword, the stage counts and order;
- `trace`: a Chrome trace under ``log_dir`` that parses as JSON and names
  the aten ops of a test_tiny block;
- `profile_refinement_costs`: the JAX function's keys, in its order, with
  and without body lengths, and its "Proportional cost times:" line; each
  cost it times evaluates to the JAX cost on the same window;
- `convert_keypoint_definition`: bit for bit the JAX function's for every
  pair of datasets it accepts (float32 and float64, 2 and 3 columns, numpy
  arrays and CPU tensors), and the same errors for the others.
"""

import glob
import json
import time

import numpy as np
import pytest
import torch

from multi_camera_3d_pose_estimation_tpu.refine import PoseRefiner as JPoseRefiner
from multi_camera_3d_pose_estimation_tpu.utils import keypoint_convert as jkc
from multi_camera_3d_pose_estimation_tpu.utils import profiling as jprof
from multi_camera_3d_pose_estimation_tpu_torch import utils as putils
from multi_camera_3d_pose_estimation_tpu_torch.refine import PoseRefiner
from multi_camera_3d_pose_estimation_tpu_torch.utils import profiling as pprof

from tests.test_torch_port_refine import BODY, make_scene

DET = ["TopDownH36MDataset", "TopDownCocoDataset", "TopDownPoseTrack18Dataset",
       "TopDownPoseTrack18VideoDataset", "TopDownAicDataset", "TopDownCrowdPoseDataset"]
LIFT = ["Body3DH36MDataset", "Body3DMpiInf3dhpDataset"]


def test_utils_exports_the_jax_names():
    from multi_camera_3d_pose_estimation_tpu import utils as jutils

    assert putils.__all__ == jutils.__all__
    assert all(hasattr(putils, n) for n in putils.__all__)


def test_step_timer_report_matches_jax(capsys):
    j, p = jprof.StepTimer(block_jax=False), pprof.StepTimer(block_jax=False)
    assert p.synchronize is False and pprof.StepTimer().synchronize is True
    assert pprof.StepTimer(synchronize=False, block_jax=True).synchronize is True
    for name, t, n in (("decode", 0.0125, 3), ("model", 0.25, 2), ("drain", 1e-4, 7)):
        for timer in (j, p):
            timer.totals[name], timer.counts[name] = t, n
    want = j.report()
    assert p.report() == want
    assert want.splitlines()[0] == "model: 0.250s (95.2%), 2 calls, 125.00 ms/call"
    out = capsys.readouterr().out
    assert out == want + "\n" + want + "\n"
    timer = pprof.StepTimer(block_jax=False)
    for name in ("decode", "model", "model"):
        with timer.stage(name):
            time.sleep(0.01 if name == "decode" else 0.02)
    lines = timer.report().splitlines()
    assert lines[0].startswith("model: ") and "2 calls" in lines[0]
    assert lines[1].startswith("decode: ") and "1 calls" in lines[1]
    assert timer.totals["model"] >= 0.04


def test_trace_writes_a_chrome_trace_of_a_tiny_block(tmp_path):
    from multi_camera_3d_pose_estimation_tpu_torch.entry import build_pipeline
    from multi_camera_3d_pose_estimation_tpu_torch.models.registry import MODEL_REGISTRY

    cfg = MODEL_REGISTRY["test_tiny"]["cfg"]
    pipe = build_pipeline(cfg, (32, 64), (2, 2, 48, 40, 3), device="cpu")
    frames = np.random.default_rng(0).integers(0, 256, (2, 2, 48, 40, 3), dtype=np.uint8)
    with putils.trace(str(tmp_path / "tb")) as prof:
        out = pipe.run(frames)
    assert out["kpts_2d"].shape == (2, 17, 3, 2)
    files = glob.glob(str(tmp_path / "tb" / "*.pt.trace.json"))
    assert files == [prof.trace_path]
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"aten::conv2d", "aten::batch_norm"} & names or "aten::convolution" in names, names
    assert any(n and n.startswith("aten::") for n in names)
    assert {"aten::conv2d", "aten::convolution"} & {e.key for e in prof.key_averages()}


def _refiners(body_lengths, window=12):
    traj, cams, gauss, rng = make_scene(3, T=window, J=17, n_cams=3)
    noisy = traj + rng.normal(0, 2.0, traj.shape)
    j = JPoseRefiner(gauss, noisy, cams, body_lengths=body_lengths)
    p = PoseRefiner(gauss, noisy, cams, body_lengths=body_lengths, dtype=torch.float64,
                    device="cpu")
    return j, p


@pytest.mark.parametrize("body_lengths", [None, BODY])
def test_profile_refinement_costs_matches_jax(body_lengths, capsys, monkeypatch):
    j, p = _refiners(body_lengths)
    want = jprof.profile_refinement_costs(j, window=10, n_iters=2)
    jline = capsys.readouterr().out
    values = {}

    def record(fn):  # the cost's value on the first call (the warm-up)
        def wrapped(*args):
            out = fn(*args)
            values.setdefault(name_of[fn], float(out))
            return out
        return wrapped

    from multi_camera_3d_pose_estimation_tpu_torch.refine import costs as pcosts

    name_of = {}
    for name in ("likelihood_cost", "body_length_cost"):
        fn = getattr(pcosts, name)
        name_of[fn] = name
        monkeypatch.setattr(pcosts, name, record(fn))
    got = pprof.profile_refinement_costs(p, window=10, n_iters=2)
    pline = capsys.readouterr().out
    assert list(got) == list(want) == (["likelihood_cost", "smoothness_cost"]
                                       + (["body_length_cost"] if body_lengths else []))
    assert all(v > 0 and np.isfinite(v) for v in got.values())
    assert pline.startswith("Proportional cost times: likelihood_cost: ") and pline.endswith("%\n")
    assert [s.split(":")[0] for s in pline.split(": ", 1)[1].split(", ")] == list(got)
    assert jline.split(": ", 1)[0] == pline.split(": ", 1)[0]

    # The values timed: the JAX costs on the same window (float64 both sides).
    import jax.numpy as jnp

    from multi_camera_3d_pose_estimation_tpu.refine import costs as jcosts
    from multi_camera_3d_pose_estimation_tpu.utils.skeleton import body_length_edges

    g = jnp.asarray(j.gaussians[:10], jnp.float64)
    traj = jnp.asarray(j.initial_trajectory[:10], jnp.float64)
    Ks, Rs, Ts, ds = (jnp.asarray(a, jnp.float64) for a in j._stacked_cams())
    from multi_camera_3d_pose_estimation_tpu.ops.geometry import rodrigues_vector

    rvecs = jnp.stack([rodrigues_vector(R) for R in Rs])
    ll = jcosts.likelihood_cost(traj, g[..., :2], jcosts.precompute_cov_inverse(g), Ks, rvecs,
                                Ts, ds)
    np.testing.assert_allclose(values["likelihood_cost"], float(ll), rtol=1e-9)
    if body_lengths:
        e_s, e_e, e_t = body_length_edges(body_lengths)
        bl = jcosts.body_length_cost(traj, jnp.asarray(e_s), jnp.asarray(e_e),
                                     jnp.asarray(e_t, jnp.float64))
        np.testing.assert_allclose(values["body_length_cost"], float(bl), rtol=1e-9)


def _inputs(cols, dtype):
    return np.random.default_rng(cols).uniform(-50, 400, (17, cols)).astype(dtype)


@pytest.mark.parametrize("lift", LIFT)
@pytest.mark.parametrize("det", DET)
def test_keypoint_conversion_bit_for_bit(det, lift):
    supported = not (det == "TopDownH36MDataset" and lift == "Body3DMpiInf3dhpDataset")
    for cols in (2, 3):
        for dtype in (np.float32, np.float64):
            x = _inputs(cols, dtype)
            if not supported:
                for arg in (x, torch.from_numpy(x)):
                    with pytest.raises(NotImplementedError, match="unsupported conversion"):
                        putils.convert_keypoint_definition(arg, det, lift)
                with pytest.raises(NotImplementedError):
                    jkc.convert_keypoint_definition(x, det, lift)
                continue
            want = jkc.convert_keypoint_definition(x, det, lift)
            got = putils.convert_keypoint_definition(x, det, lift)
            assert isinstance(got, np.ndarray) and got.dtype == want.dtype == dtype
            assert got.shape == want.shape == (17, cols)
            np.testing.assert_array_equal(got, want)
            t = putils.convert_keypoint_definition(torch.from_numpy(x), det, lift)
            assert isinstance(t, torch.Tensor) and t.dtype == torch.from_numpy(x).dtype
            np.testing.assert_array_equal(t.numpy(), want)
            assert putils.convert_keypoint_definition(list(map(list, x)), det, lift).shape == \
                want.shape


def test_keypoint_conversion_errors():
    x = _inputs(3, np.float32)
    for fn in (putils.convert_keypoint_definition, jkc.convert_keypoint_definition):
        with pytest.raises(ValueError, match="pose_lift_dataset must be"):
            fn(x, "TopDownCocoDataset", "Body3DOtherDataset")
        for lift in LIFT:
            with pytest.raises(NotImplementedError, match="unsupported conversion"):
                fn(x, "TopDownMpiiDataset", lift)
    same = putils.convert_keypoint_definition(torch.from_numpy(x), "TopDownH36MDataset", LIFT[0])
    assert torch.equal(same, torch.from_numpy(x)) and same.data_ptr() != \
        torch.from_numpy(x).data_ptr()

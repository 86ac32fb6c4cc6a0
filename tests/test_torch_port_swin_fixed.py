"""The port's fixed-order Swin stage layout against the JAX package's.

``MC3D_SWIN_FIXED`` keeps a stage's tokens in shift-0 window order, each crop
padded to P = ⌈Hp·Wp / 8⌉·8 rows (TPU kernels #5 ``fused_swin_block_fixed``
and #6 ``fused_swin_stage_fixed``).  The port reads a shifted block's windows
through a row table, `window_roll_perm(H, W, win, 0, shift)`, where the
Pallas kernels add a full (P, P) table; these tests hold the two equal:

- the geometry exactly: `fixed_geom` equals ``_fixed_geom``, and the row
  table regroups the fixed order into the shifted windows that ``_fixed_geom``
  describes (ws, ks, reg), on the four Swin-B stage maps (window 7, shift 3)
  and the JAX tests' window-5 and window-3 maps;
- the row-mode attention (plain version) against a dense (P, P) softmax
  through ``_fixed_table``, in f32 at 2e-5 (the attention tests' tolerance);
- the block and the stage (plain versions, as the wrappers run them on the
  CPU) against the Pallas functions in interpret mode, on the raw (B·P, C)
  output with padding and alignment rows: f32 at 2e-4 (the JAX package holds
  its kernel against flax at 2e-4: f32 sums in another order, a 1.5e-7 erf
  approximation), bf16 at 2e-2 of the largest output (bf16 roundings at the
  same points, sums in another order);
- the model: ``MC3D_SWIN_FIXED`` = "1", "32" and "0" sends the same stages
  through the fixed layout as in JAX, and the heatmaps match JAX's;
- the small Swin pipeline in fixed order against the JAX pipeline, at the
  tolerances of ``test_torch_port_swin_pipeline.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_camera_3d_pose_estimation_tpu.models import swin as jswin
from multi_camera_3d_pose_estimation_tpu.models.swin import SwinBlock as JSwinBlock
from multi_camera_3d_pose_estimation_tpu.models.swin import SwinPose as JSwinPose
from multi_camera_3d_pose_estimation_tpu.ops.pallas import swin_block as jsb
from multi_camera_3d_pose_estimation_tpu_torch.models import swin as port_swin
from multi_camera_3d_pose_estimation_tpu_torch.models.convert import load_swin_from_flax
from multi_camera_3d_pose_estimation_tpu_torch.models.swin import SwinBlock, SwinPose
from multi_camera_3d_pose_estimation_tpu_torch.ops import swin_block as sb
from multi_camera_3d_pose_estimation_tpu_torch.ops import swin_geometry as geo
from multi_camera_3d_pose_estimation_tpu_torch.ops import window_attention as wa

from tests._torch_port_util import random_variables

# (H, W, win, shift): the Swin-B stage maps at input 192x256, the JAX tests'
# window-5 map (P = 400 = nW·n) and window-3 map (nW·n = 36, P = 40).
GEOMS = [(64, 48, 7, 3), (32, 24, 7, 3), (16, 12, 7, 3), (8, 6, 7, 3), (16, 18, 5, 2),
         (6, 6, 3, 1)]
# (shift, H, W, win, C, heads) of the block tests.
BLOCKS = [(0, 16, 18, 5, 32, 2), (2, 16, 18, 5, 32, 2), (1, 6, 6, 3, 16, 2)]
B, RATIO = 2, 2


@pytest.mark.parametrize("H,W,win,shift", GEOMS + [(16, 18, 5, 0), (6, 6, 3, 0)])
def test_fixed_geom_and_row_table(H, W, win, shift):
    got, want = geo.fixed_geom(H, W, win, shift), jsb._fixed_geom(H, W, win, shift)
    for g, w in zip(got[:4], want[:4]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert got[4] == want[4] == geo.fixed_rows(H, W, win)
    np.testing.assert_array_equal(geo.fixed_valid(H, W, win), want[3])
    ws, ks, reg, _, _ = want
    Hp, Wp = geo.padded_dims(H, W, win)
    n = win * win
    rows = geo.window_roll_perm(H, W, win, 0, shift)
    q = np.arange(Hp * Wp)
    np.testing.assert_array_equal(ws[rows], q // n)
    np.testing.assert_array_equal(ks[rows], q % n)
    if shift:
        np.testing.assert_array_equal(reg[rows], jswin._shift_regions(Hp, Wp, win, shift).ravel())
    else:
        np.testing.assert_array_equal(rows, q)


@pytest.mark.parametrize("H,W,win", [(16, 18, 5), (6, 6, 3), (8, 6, 7)])
def test_fixed_partition_and_reverse(H, W, win):
    x = np.random.default_rng(H * W).normal(size=(B, H, W, 8)).astype(np.float32)
    want = np.asarray(jsb.fixed_partition(jnp.asarray(x), win))
    got = geo.fixed_partition(torch.from_numpy(x), win)
    assert tuple(got.shape) == want.shape == (B * geo.fixed_rows(H, W, win), 8)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(geo.fixed_reverse(got, B, H, W, win).numpy(), x)


@pytest.mark.parametrize("H,W,win,shift", [(16, 18, 5, 2), (6, 6, 3, 1), (6, 6, 3, 0)])
def test_rows_attention_matches_dense_fixed_table(H, W, win, shift):
    """The row-mode attention is the Pallas kernels' dense (P, P) softmax
    over ``_fixed_table`` (bias, −100 across regions, −1e5 across windows)."""
    heads, d = 2, 8
    C = heads * d
    ws, ks, reg, _, P = jsb._fixed_geom(H, W, win, shift)
    rng = np.random.default_rng(P + shift)
    table = rng.normal(size=((2 * win - 1) ** 2, heads)).astype(np.float32)
    qkv = rng.normal(size=(B * P, 3 * C)).astype(np.float32)
    t = np.asarray(jsb._fixed_table({"attn": {"bias_table": table}}, win, ws, ks, reg, 1))
    q, k, v = (qkv.reshape(B, P, 3, heads, d)[:, :, i].transpose(0, 2, 1, 3) for i in range(3))
    s = np.einsum("bhqd,bhkd->bhqk", q, k) * d ** -0.5 + t[None]
    p = np.exp(s - s.max(-1, keepdims=True))
    want = np.einsum("bhqk,bhkd->bqhd", p / p.sum(-1, keepdims=True), v).reshape(B * P, C)

    n = win * win
    bias = table[geo.rel_position_index(win).reshape(-1)].reshape(n, n, heads).transpose(2, 0, 1)
    Hp, Wp = geo.padded_dims(H, W, win)
    mask = torch.from_numpy(geo.shift_mask(Hp, Wp, win, shift)) if shift else None
    rows = torch.from_numpy(geo.window_roll_perm(H, W, win, 0, shift).astype(np.int32))
    launches = wa.window_attention_rows.launches
    got = wa.window_attention_rows(torch.from_numpy(qkv), torch.from_numpy(bias.copy()), mask,
                                   heads, rows, P)
    assert wa.window_attention_rows.launches == launches  # CPU: the plain version
    assert got.dtype == torch.float32 and tuple(got.shape) == (B * P, C)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    if P > Hp * Wp:  # alignment rows: exactly their own v
        v_rows = qkv.reshape(B, P, 3 * C)[:, Hp * Wp:, 2 * C:]
        np.testing.assert_array_equal(got.numpy().reshape(B, P, C)[:, Hp * Wp:], v_rows)


def test_rows_attention_checks_its_table():
    qkv = torch.zeros(2 * 40, 3 * 16)
    bias = torch.zeros(2, 9, 9)
    rows = torch.arange(36, dtype=torch.int32)
    with pytest.raises(ValueError, match="crops"):
        wa.window_attention_rows(qkv[:-8], bias, None, 2, rows, 40)
    with pytest.raises(ValueError, match="windows"):
        wa.window_attention_rows(qkv, bias, torch.zeros(3, 9, 9), 2, rows, 40)


def _block_pair(shift, H, W, win, C, heads, seed):
    jm = JSwinBlock(heads=heads, window=win, shift=shift, mlp_ratio=RATIO, dtype=jnp.float32)
    params = random_variables(jm, (1, H, W, C), seed=seed)["params"]
    port = SwinBlock(C, heads, win, shift, RATIO, dtype=torch.float32)
    load_swin_from_flax(port, {"params": params})
    return params, port


def _fixed_input(H, W, win, C, seed):
    x = np.random.default_rng(seed).normal(size=(B, H, W, C)).astype(np.float32)
    return np.array(jsb.fixed_partition(jnp.asarray(x), win))


@pytest.mark.parametrize("shift,H,W,win,C,heads", BLOCKS)
def test_fixed_block_matches_pallas_f32(shift, H, W, win, C, heads):
    params, port = _block_pair(shift, H, W, win, C, heads, seed=H + shift)
    xw = _fixed_input(H, W, win, C, seed=shift)
    kw = dict(heads=heads, window=win, shift=shift, mlp_ratio=RATIO, geom=(B, H, W))
    want = np.asarray(jsb.fused_swin_block_fixed(jnp.asarray(xw), params, interpret=True, **kw))
    launches = (sb.swin_gemm.launches, wa.window_attention_rows.launches)
    got = sb.fused_swin_block_fixed(torch.from_numpy(xw), sb.prepare_swin_block(
        port, torch.float32), **kw)
    assert (sb.swin_gemm.launches, wa.window_attention_rows.launches) == launches
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-4)
    pads = geo.fixed_valid(H, W, win) == 0
    if pads.any():  # map padding / alignment rows are not zeroed on output
        assert np.abs(got.numpy().reshape(B, -1, C)[:, pads]).min(-1).max() > 0


def test_fixed_block_alignment_rows_do_not_reach_real_tokens():
    """6x6, window 3: 4 alignment rows per crop set to 1e3 move no real
    token (they attend only to themselves and enter qkv masked)."""
    shift, H, W, win, C, heads = BLOCKS[2]
    params, port = _block_pair(shift, H, W, win, C, heads, seed=12)
    p = sb.prepare_swin_block(port, torch.float32)
    kw = dict(heads=heads, window=win, shift=shift, mlp_ratio=RATIO, geom=(B, H, W))
    xw = _fixed_input(H, W, win, C, seed=12)
    P = geo.fixed_rows(H, W, win)
    bad = xw.reshape(B, P, C).copy()
    bad[:, 36:] = 1e3
    bad = bad.reshape(-1, C)
    clean = sb.fused_swin_block_fixed(torch.from_numpy(xw), p, **kw)
    got = sb.fused_swin_block_fixed(torch.from_numpy(bad), p, **kw)
    want = np.asarray(jsb.fused_swin_block_fixed(jnp.asarray(bad), params, interpret=True, **kw))
    real = geo.fixed_reverse(got, B, H, W, win).numpy()
    np.testing.assert_array_equal(real, geo.fixed_reverse(clean, B, H, W, win).numpy())
    np.testing.assert_allclose(real, np.asarray(jsb.fixed_reverse(jnp.asarray(want), B, H, W, win)),
                               rtol=0, atol=2e-4)


def test_fixed_block_matches_pallas_bf16():
    shift, H, W, win, C, heads = BLOCKS[1]
    params, port = _block_pair(shift, H, W, win, C, heads, seed=3)
    xw = _fixed_input(H, W, win, C, seed=3)
    kw = dict(heads=heads, window=win, shift=shift, mlp_ratio=RATIO, geom=(B, H, W))
    want = np.asarray(jsb.fused_swin_block_fixed(jnp.asarray(xw, jnp.bfloat16), params,
                                                 interpret=True, **kw).astype(jnp.float32))
    got = sb.fused_swin_block_fixed(torch.from_numpy(xw).to(torch.bfloat16),
                                    sb.prepare_swin_block(port, torch.bfloat16), **kw)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    err = np.abs(got.float().numpy() - want).max() / np.abs(want).max()
    print("bf16 fixed block error / scale:", err)
    assert err <= 2e-2


def test_fixed_block_checks_shapes():
    _, port = _block_pair(*BLOCKS[2], seed=0)
    p = sb.prepare_swin_block(port, torch.float32)
    with pytest.raises(ValueError, match=r"fixed-order tokens must be \(80, 16\)"):
        sb.fused_swin_block_fixed(torch.zeros(72, 16), p, heads=2, window=3, shift=1,
                                  mlp_ratio=RATIO, geom=(B, 6, 6))


def test_fixed_stage_matches_pallas_stage():
    """Shifts [0, 2, 0] at 16x18, window 5; the JAX stage in groups of 2
    (``group`` and ``cp`` are TPU program sizes, ignored by the port)."""
    H, W, win, C, heads = 16, 18, 5, 32, 2
    shifts = [0, 2, 0]
    pairs = [_block_pair(s, H, W, win, C, heads, seed=20 + j) for j, s in enumerate(shifts)]
    xw = _fixed_input(H, W, win, C, seed=21)
    kw = dict(heads=heads, window=win, shifts=shifts, mlp_ratio=RATIO, geom=(B, H, W))
    want = np.asarray(jsb.fused_swin_stage_fixed(jnp.asarray(xw), [pp for pp, _ in pairs],
                                                 group=2, interpret=True, **kw))
    plist = [sb.prepare_swin_block(port, torch.float32) for _, port in pairs]
    got = sb.fused_swin_stage_fixed(torch.from_numpy(xw), plist, group=2, cp=1, **kw)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-4)
    torch.testing.assert_close(sb.swin_stage_fixed_plain(torch.from_numpy(xw), plist, **kw), got,
                               rtol=0, atol=0)
    with pytest.raises(ValueError, match="align"):
        sb.fused_swin_stage_fixed(torch.from_numpy(xw), plist, **dict(kw, shifts=[0, 2]))


SMALL = {"embed": 16, "depths": (2, 2), "heads": (2, 4), "window": 5, "mlp_ratio": 2,
         "deconv": (16,)}


@pytest.fixture(scope="module")
def small_model():
    v = random_variables(JSwinPose(num_joints=17, cfg=SMALL), (1, 64, 64, 3), seed=13)
    x = np.random.default_rng(13).normal(size=(2, 64, 64, 3)).astype(np.float32)
    port = load_swin_from_flax(SwinPose(17, SMALL, dtype=torch.float32, device="cpu"), v).eval()
    return v, x, port


def _spy(monkeypatch, module, name, calls):
    orig = getattr(module, name)

    def spy(*a, **k):
        calls.append(a[0].shape[-1])
        return orig(*a, **k)

    monkeypatch.setattr(module, name, spy)


@pytest.mark.parametrize("env,fixed", [("1", [16, 32]), ("32", [32]), ("0", [])])
def test_model_env_picks_the_same_fixed_stages(small_model, monkeypatch, env, fixed):
    """The spies record the channel width of each fixed stage (and of each
    chained block); the heatmaps match the JAX model's, f32, both through
    their block kernels (JAX in interpret mode; the port's by the kernel
    rule, `runs_kernels`, patched to hold in f32)."""
    v, x, port = small_model
    monkeypatch.setenv("MC3D_SWIN_FIXED", env)
    monkeypatch.setattr(port_swin, "runs_kernels", lambda *a, **k: True)
    calls = {k: [] for k in ("jax_fixed", "jax_chained", "fixed", "chained")}
    _spy(monkeypatch, jsb, "fused_swin_stage_fixed", calls["jax_fixed"])
    _spy(monkeypatch, jsb, "fused_swin_block", calls["jax_chained"])
    _spy(monkeypatch, sb, "fused_swin_stage_fixed", calls["fixed"])
    _spy(monkeypatch, sb, "fused_swin_block", calls["chained"])
    ref = JSwinPose(num_joints=17, cfg=SMALL, dtype=jnp.float32,
                    use_pallas_attention="block").apply(v, jnp.asarray(x))
    ref = np.moveaxis(np.asarray(ref), -1, 1)
    with torch.no_grad():
        out = port(torch.from_numpy(x))
    assert calls["fixed"] == calls["jax_fixed"] == fixed
    chained = [C for C in (16, 32) if C not in fixed]
    assert sorted(set(calls["chained"])) == sorted(set(calls["jax_chained"])) == chained
    assert len(calls["chained"]) == 2 * len(chained)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=2e-4 * np.abs(ref).max())


def test_fixed_pipeline_matches_jax(monkeypatch):
    """The small window-7 Swin pipeline (both stages padded, shifted and, at
    stage 0, with alignment rows: 28x21 -> P = 592) in fixed order against
    the JAX pipeline (flax's einsum path), as
    ``test_torch_port_swin_pipeline.py::test_pipeline_end_to_end_matches_jax``."""
    from tests.test_torch_port_swin_pipeline import INPUT, SHAPE
    from tests.test_torch_port_swin_pipeline import SMALL as PIPE_SMALL
    from multi_camera_3d_pose_estimation_tpu.models import TopDownEstimator as JEstimator
    from multi_camera_3d_pose_estimation_tpu.parallel import ShardedPosePipeline as JPipeline
    from multi_camera_3d_pose_estimation_tpu_torch.entry import build_pipeline, synthetic_rig

    monkeypatch.setenv("MC3D_SWIN_FIXED", "1")
    model = JSwinPose(num_joints=17, cfg=PIPE_SMALL)
    variables = random_variables(model, (1, INPUT[1], INPUT[0], 3), seed=0)
    rig = synthetic_rig(2, 96, 80)
    frames = np.random.default_rng(0).integers(0, 256, SHAPE, dtype=np.uint8)
    ref = {k: np.asarray(v) for k, v in JPipeline(JEstimator(model, variables, input_size=INPUT),
                                                  rig).run(frames).items()}
    calls = []
    _spy(monkeypatch, sb, "fused_swin_stage_fixed", calls)
    port = build_pipeline(PIPE_SMALL, INPUT, SHAPE, device="cpu", variables=variables,
                          family="swin")
    out = {k: v.numpy() for k, v in port.run(frames).items()}
    assert calls == [64, 128]
    same = np.abs(out["kpts_2d"][:, :, :2] - ref["kpts_2d"][:, :, :2]) < 1e-2
    same = same.all(axis=2).all(axis=-1) | (np.isnan(out["kpts_2d"][:, :, 0]).all(-1)
                                           & np.isnan(ref["kpts_2d"][:, :, 0]).all(-1))
    print("share of joints with the same peaks:", same.mean())
    assert same.mean() >= 0.5, same.mean()
    both = same & np.isfinite(out["kpts_3d"]).all(-1) & np.isfinite(ref["kpts_3d"]).all(-1)
    assert both.sum() >= 5
    np.testing.assert_allclose(out["kpts_3d"][both], ref["kpts_3d"][both], rtol=1e-3, atol=1e-2)

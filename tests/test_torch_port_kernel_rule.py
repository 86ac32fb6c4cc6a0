"""One rule picks every kernel of the port (`models.batchnorm.runs_kernels`).

A call runs a kernel's op where it is the kernel's function: eval mode,
outside `calibrating_batch_norm` and `synced_batch_norm`, bf16, and no
input or parameter that autograd follows.  The op then dispatches by
device (on the CPU its plain form), and every other call takes the plain
model path.  On the CPU, with spies on the ops:

- HRNet (stage 1 through `ops.bottleneck`) and Swin (every block through
  `ops.swin_block.fused_swin_block`), with the ConvBN epilogue in both:
  bf16 inference routes to the ops, and f32, train mode, autograd on the
  weights or on the input, calibration and a data-parallel step route to
  the plain path;
- HRNet's folded stage 1 is made again after a stage-1 weight or statistic
  is written, and only then; a model made under `torch.inference_mode`
  (no version counters) folds at every forward and runs;
- the default decode is `ops.fused_heatmap_decode`, DARK is
  `heatmap_dark_decode` + `heatmap_moments`;
- `build_estimator` takes the four keywords that once chose kernels and
  selects nothing with them; ``use_pallas_attention`` on HRNet raises;
- the estimate CLI's pipeline built with no ``estimator_kwargs`` routes as
  the benchmark configurations' ``estimator_kwargs`` build it.
"""

import contextlib
import json
import os

import numpy as np
import pytest
import torch

from multi_camera_3d_pose_estimation_tpu_torch import io as pio
from multi_camera_3d_pose_estimation_tpu_torch.cli.estimate import build_estimate_pipeline
from multi_camera_3d_pose_estimation_tpu_torch.models import registry, topdown
from multi_camera_3d_pose_estimation_tpu_torch.models.batchnorm import (cached_by_tensors,
                                                                       calibrating_batch_norm,
                                                                       synced_batch_norm)
from multi_camera_3d_pose_estimation_tpu_torch.ops import bn_epilogue as be
from multi_camera_3d_pose_estimation_tpu_torch.ops import bottleneck as bn
from multi_camera_3d_pose_estimation_tpu_torch.ops import swin_block as sb

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = {"hrnet": "test_tiny", "swin": "test_swin_128"}
INPUTS = {"hrnet": (2, 3, 64, 32), "swin": (2, 64, 64, 3)}  # NCHW crops, NHWC crops


def _spy(monkeypatch, module, name, counts, key):
    """Count the calls of ``module.name`` under ``counts[key]``."""
    fn = getattr(module, name)

    def counted(*a, **k):
        counts[key] += 1
        return fn(*a, **k)

    monkeypatch.setattr(module, name, counted)


@pytest.fixture
def counts(monkeypatch):
    """Calls of each kernel op the models and the decode reach."""
    c = dict.fromkeys(("stage1", "swin_block", "epilogue", "decode", "dark", "moments"), 0)
    _spy(monkeypatch, bn, "fused_stage1_chain", c, "stage1")
    _spy(monkeypatch, sb, "fused_swin_block", c, "swin_block")
    _spy(monkeypatch, be, "bn_epilogue", c, "epilogue")
    _spy(monkeypatch, topdown, "fused_heatmap_decode", c, "decode")
    _spy(monkeypatch, topdown, "heatmap_dark_decode", c, "dark")
    _spy(monkeypatch, topdown, "heatmap_moments", c, "moments")
    return c


def _model(family, dtype=torch.bfloat16):
    spec = registry.MODEL_REGISTRY[SMALL[family]]
    return registry.build_model(family, spec["cfg"], "cpu", seed=1, dtype=dtype)


CONDITIONS = ("bf16_inference", "f32", "train", "grad", "input_grad", "calibrating", "synced")


@pytest.mark.parametrize("condition", CONDITIONS)
@pytest.mark.parametrize("family", ["hrnet", "swin"])
def test_rule_routes_each_call(family, condition, counts):
    model = _model(family, torch.float32 if condition == "f32" else torch.bfloat16)
    x = torch.randn(INPUTS[family], generator=torch.Generator().manual_seed(2))
    grad = condition in ("grad", "input_grad")
    if condition == "train":
        model.train()
    if condition == "input_grad":
        model.requires_grad_(False)
        x.requires_grad_(True)
    scope = {"calibrating": calibrating_batch_norm(),
             "synced": synced_batch_norm(lambda t: t, 1.0)}.get(condition,
                                                                 contextlib.nullcontext())
    with scope, torch.set_grad_enabled(grad):
        out = model(x)
    assert torch.isfinite(out).all()
    kernel = "stage1" if family == "hrnet" else "swin_block"
    if condition == "bf16_inference":
        assert counts[kernel] == (1 if family == "hrnet" else 2)  # Swin: one call a block
        assert counts["epilogue"] > 0
    else:
        assert counts[kernel] == counts["epilogue"] == 0, counts


@pytest.mark.parametrize("write", ["conv_weight", "bn_running_var", "bn_weight",
                                   "load_state_dict"])
def test_folded_stage1_is_made_again_after_a_write(write):
    model = _model("hrnet")
    blocks = model.stage1_blocks()
    assert model.stage1_blocks() is blocks  # cached while nothing changes
    convbn = model.Bottleneck_1.ConvBN_1
    with torch.no_grad():
        if write == "conv_weight":
            convbn.Conv_0.weight.mul_(2.0)
        elif write == "bn_running_var":
            convbn.BatchNorm_0.running_var.mul_(4.0)
        elif write == "bn_weight":
            convbn.BatchNorm_0.weight.mul_(0.5)
        else:
            state = {k: v.clone() for k, v in model.state_dict().items()}
            state["Bottleneck_1.ConvBN_1.BatchNorm_0.bias"] += 1.0
            model.load_state_dict(state)
    fresh = [bn.prepare_block(bn.fold_bottleneck_params(getattr(model, f"Bottleneck_{i}")),
                              model.dtype, "cpu") for i in range(4)]
    again = model.stage1_blocks()
    assert again is not blocks
    for new, old, want in zip(again, blocks, fresh):
        assert all(torch.equal(new[k], want[k]) for k in want)
    assert any(not torch.equal(again[1][k], blocks[1][k]) for k in blocks[1])
    assert model.stage1_blocks() is again


@pytest.mark.parametrize("family", ["hrnet", "swin"])
def test_model_made_under_inference_mode_runs_the_kernels(family, counts):
    """Inference tensors keep no version counter: a model made under
    `torch.inference_mode` folds its kernels' weights at every forward
    (`cached_by_tensors`) and computes what a model made outside does."""
    x = torch.randn(INPUTS[family], generator=torch.Generator().manual_seed(2))
    with torch.inference_mode():
        model = _model(family)
        assert all(p.is_inference() for p in model.parameters())
        out, again = model(x), model(x)
    with torch.no_grad():
        ref = _model(family)(x)
    kernel, per_forward = ("stage1", 1) if family == "hrnet" else ("swin_block", 2)
    assert counts[kernel] == 3 * per_forward
    assert torch.equal(out, ref) and torch.equal(again, ref)


def test_cached_by_tensors_keys_on_storage_and_version():
    owner, made = torch.nn.Module(), []
    t = torch.zeros(3)

    def make():
        made.append(1)
        return len(made)

    assert cached_by_tensors(owner, "_c", [t], make) == 1
    assert cached_by_tensors(owner, "_c", [t], make) == 1
    t.add_(1.0)
    assert cached_by_tensors(owner, "_c", [t], make) == 2
    assert cached_by_tensors(owner, "_c", [t.clone()], make) == 3
    assert cached_by_tensors(owner, "_c", [t], make, extra=(1e-5,)) == 4
    with torch.inference_mode():
        u = torch.zeros(3)
    assert cached_by_tensors(owner, "_d", [u], make) == 5
    assert cached_by_tensors(owner, "_d", [u], make) == 6


@pytest.mark.parametrize("decode_mode", ["default", "dark"])
def test_decode_mode_picks_the_decode(decode_mode, counts):
    est = registry.build_estimator("test_tiny", device="cpu", seed=1, decode_mode=decode_mode)
    frames = np.random.default_rng(0).integers(0, 256, (3, 80, 64, 3), dtype=np.uint8)
    out = est.predict_batch(frames)
    assert out["gaussians"].shape == (3, 17, 6)
    want = ({"decode": 1, "dark": 0, "moments": 0} if decode_mode == "default"
            else {"decode": 0, "dark": 1, "moments": 1})
    assert {k: counts[k] for k in want} == want


@pytest.mark.parametrize("family", ["hrnet", "swin"])
def test_build_estimator_takes_the_old_kernel_keywords(family):
    """They select nothing: the same model, the same outputs."""
    name = SMALL[family]
    frames = np.random.default_rng(1).integers(0, 256, (2, 80, 64, 3), dtype=np.uint8)
    plain = registry.build_estimator(name, device="cpu", seed=2).predict_batch(frames)
    kw = {"use_fused_stage1": True, "use_fused_decode": True, "use_pallas_stage1": True}
    if family == "swin":
        kw["use_pallas_attention"] = "block"
    else:
        with pytest.raises(ValueError, match="swin"):
            registry.build_estimator(name, device="cpu", use_pallas_attention=False)
    for value in (True, False):
        est = registry.build_estimator(name, device="cpu", seed=2,
                                       **{k: v if k == "use_pallas_attention" else value
                                          for k, v in kw.items()})
        out = est.predict_batch(frames)
        assert all(torch.equal(out[k], plain[k]) for k in plain)


def _project(root):
    K = np.array([[300.0, 0, 48.0], [0, 300.0, 40.0], [0, 0, 1]])
    names = ["cam0", "cam1"]
    for c, name in enumerate(names):
        th = np.deg2rad(-10.0 + 20.0 * c)
        R = np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0], [-np.sin(th), 0, np.cos(th)]])
        pio.save_camera_intrinsics(K, np.zeros((1, 5)), name, root_path=root)
        pio.save_extrinsic_calibration_parameters(R, np.array([[20.0 * c - 10], [0.0], [0.0]]),
                                                  name, root_dir=root)
    pio.save_camera_names(dict(enumerate(names)), names[0], root)


@pytest.mark.parametrize("config", ["hrnet_w32_coco_256x192", "swin_b_coco_256x192"])
def test_estimate_pipeline_routes_like_the_benchmark(config, counts, tmp_path):
    """The estimate CLI's pipeline with no ``estimator_kwargs`` launches what
    the benchmark configuration's ``estimator_kwargs`` build (on a small
    model of the same family): the same ops, the same outputs."""
    with open(os.path.join(ROOT, "port_bench", "configs", f"{config}.json")) as f:
        cfg = json.load(f)
    _project(str(tmp_path))
    block = np.random.default_rng(3).integers(0, 256, (2, 2, 80, 96, 3), dtype=np.uint8)
    seen = {}
    for way, kw in (("cli", None), ("benchmark", cfg["estimator_kwargs"])):
        pipe = build_estimate_pipeline(str(tmp_path), pose_estimation_model=SMALL[cfg["family"]],
                                       estimator_kwargs=kw, device="cpu")
        for k in counts:
            counts[k] = 0
        seen[way] = ({k: v.clone() for k, v in pipe.run(block).items()}, dict(counts))
    (cli, cli_counts), (bench, bench_counts) = seen["cli"], seen["benchmark"]
    kernel = "stage1" if cfg["family"] == "hrnet" else "swin_block"
    assert cli_counts == bench_counts
    assert cli_counts[kernel] > 0 and cli_counts["decode"] == 1 and cli_counts["epilogue"] > 0
    assert all(np.array_equal(cli[k].numpy(), bench[k].numpy(), equal_nan=True) for k in bench)

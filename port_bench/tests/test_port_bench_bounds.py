"""The benchmark's frozen yardstick: the kernels' bounds from shapes and the
2D models' operation counts, held against the kernel table's bounds and
against counts written out by hand."""

import json
import math
import os

import pytest
import torch

from port_bench import bounds
from port_bench.reference import build_model

from conftest import ROOT


def _cfg(name):
    with open(os.path.join(ROOT, "port_bench", "configs", f"{name}.json")) as f:
        return json.load(f)


W32 = _cfg("hrnet_w32_coco_256x192")
SWIN_B = _cfg("swin_b_coco_256x192")


def test_stage1_bound_reproduces_the_kernel_table():
    b = bounds.stage1_bound(W32, 512)
    assert b.by == "operations"
    assert round(b.seconds * 1e3, 4) == 0.8989


def test_swin_products_bound_reproduces_the_kernel_table():
    assert round(bounds.swin_products_bound(SWIN_B, 256) * 1e3, 4) == 9.8451


def test_swin_attention_bound_reproduces_the_kernel_table():
    # The kernel table sums depth x the stage's shifted block (its mask
    # read); the benchmark sums every block with its own tables.
    table = sum(depth * bounds.swin_block_bounds(SWIN_B, 256, stage, 1)[1].seconds
                for stage, depth in enumerate(SWIN_B["depths"]))
    assert round(table * 1e3, 4) == 2.2448
    exact = bounds.swin_attention_bound(SWIN_B, 256)
    assert exact < table and round(exact * 1e3, 4) == 2.2444


@pytest.mark.parametrize("crops", [2, 64, 512])
def test_bounds_grow_with_the_crops_and_read_weights_once(crops):
    one = bounds.stage1_bound(W32, 1)
    many = bounds.stage1_bound(W32, crops)
    assert many.flops == pytest.approx(crops * one.flops)
    assert one.nbytes < many.nbytes <= crops * one.nbytes
    for fn in (bounds.swin_products_bound, bounds.swin_attention_bound):
        assert fn(SWIN_B, 1) <= fn(SWIN_B, crops) <= crops * fn(SWIN_B, 1)


def _hrnet_macs(cfg):
    in_w, in_h = cfg["input_size"]
    w, st = cfg["widths"], cfg["stem"]
    res = [(in_h // 4 >> b) * (in_w // 4 >> b) for b in range(4)]
    macs = st * 27 * (in_h // 2) * (in_w // 2) + st * st * 9 * res[0]
    cin = st
    for _ in range(4):
        macs += (cin * 64 + 64 * 64 * 9 + 64 * 256 + (cin * 256 if cin != 256 else 0)) * res[0]
        cin = 256
    macs += 256 * w[0] * 9 * res[0] + 256 * w[1] * 9 * res[1]
    for stage, n_br in ((1, 2), (2, 3), (3, 4)):
        if stage > 1:
            macs += w[n_br - 2] * w[n_br - 1] * 9 * res[n_br - 1]
        for m in range(cfg["modules"][stage]):
            last = stage == 3 and m == cfg["modules"][3] - 1
            macs += sum(4 * 2 * w[b] * w[b] * 9 * res[b] for b in range(n_br))
            for i in range(1 if last else n_br):
                for j in range(n_br):
                    if j > i:
                        macs += w[j] * w[i] * res[j]
                    for k in range(i - j):
                        cout = w[i] if k == i - j - 1 else w[j]
                        macs += w[j] * cout * 9 * res[j + k + 1]
    return macs + w[0] * cfg["num_joints"] * res[0]


def _swin_macs(cfg):
    in_w, in_h = cfg["input_size"]
    win, ratio, e = cfg["window"], cfg["mlp_ratio"], cfg["embed"]
    H, W = in_h // 4, in_w // 4
    macs = 3 * 16 * e * H * W
    for i, depth in enumerate(cfg["depths"]):
        C = e * 2 ** i
        h, w = H >> i, W >> i
        padded = math.ceil(h / win) * win * math.ceil(w / win) * win
        # qkv, q.k, attn.v and proj on every (padded) window token; the MLP
        # on the real tokens.
        macs += depth * (padded * (3 * C * C + 2 * win * win * C + C * C)
                         + h * w * 2 * ratio * C * C)
        if i < len(cfg["depths"]) - 1:
            macs += (h // 2) * (w // 2) * 4 * C * 2 * C
    C, h, w = e * 2 ** (len(cfg["depths"]) - 1), H >> 3, W >> 3
    for out in cfg["deconv"]:
        macs += C * out * 16 * h * w
        C, h, w = out, 2 * h, 2 * w
    return macs + C * cfg["num_joints"] * h * w


@pytest.mark.parametrize("cfg,macs", [(W32, _hrnet_macs), (SWIN_B, _swin_macs)],
                         ids=["hrnet_w32", "swin_b"])
def test_flop_counter_matches_the_count_by_hand(cfg, macs):
    model = build_model(cfg, "meta")
    in_w, in_h = cfg["input_size"]
    flops = bounds.model_flops_per_crop(
        lambda: model(torch.empty((1, 3, in_h, in_w), device="meta")))
    assert flops == 2 * macs(cfg)


def test_hrnet_w32_count_against_the_paper():
    # The HRNet paper quotes 7.1 G multiply-adds for W32 at 256x192; the
    # count here, every convolution of MMPose's model, is 7.645 G: within 8%.
    macs = _hrnet_macs(W32)
    assert macs == pytest.approx(7.645e9, rel=1e-3)
    assert macs == pytest.approx(7.1e9, rel=0.08)

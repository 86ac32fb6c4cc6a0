"""The yardstick's arithmetic: the card's peaks, the least time of the
kernels' layers from the configuration's shapes, and the 2D model's
operations per crop.

Each bound counts what the layer must do for its inputs, whatever
implements it: its bf16 tensor-core operations against one read of every
input byte (activations, weights, biases and tables) and one write of
every output byte, over the peaks below; the larger of the two is the
bound, and `Bound.by` says which.  Window padding needs no work: only the
real tokens of a Swin map count, and the attention counts the n keys of
each real query's window.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

__all__ = ["PEAK_BF16_FLOPS", "PEAK_BYTES_S", "Bound", "stage1_bound", "swin_block_bounds",
           "swin_products_bound", "swin_attention_bound", "model_flops_per_crop"]

# One NVIDIA H100 SXM (NVIDIA's data sheet): dense bf16 tensor-core
# operations, HBM3 bandwidth.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_S = 3.35e12

BF16, F32 = 2, 4


@dataclass(frozen=True)
class Bound:
    flops: float
    nbytes: float

    @property
    def seconds(self) -> float:
        return max(self.flops / PEAK_BF16_FLOPS, self.nbytes / PEAK_BYTES_S)

    @property
    def by(self) -> str:
        return "operations" if self.flops / PEAK_BF16_FLOPS >= self.nbytes / PEAK_BYTES_S \
            else "bytes"


def _stem_hw(cfg: dict) -> tuple[int, int]:
    in_w, in_h = cfg["input_size"]
    return in_h // 4, in_w // 4


def stage1_bound(cfg: dict, crops: int) -> Bound:
    """HRNet's stage 1 (the Bottleneck chain at stride 4) over ``crops``
    crops, as one fused computation: the stem's output read once, the
    chain's output written once (bf16), every kernel (bf16) and folded
    BatchNorm shift (f32) read once."""
    h, w = _stem_hw(cfg)
    planes, stem = 64, cfg["stem"]
    out = planes * 4
    weights = biases = 0
    cin = stem
    for i in range(cfg.get("blocks", (4,))[0]):
        weights += cin * planes + planes * planes * 9 + planes * out
        biases += planes + planes + out
        if cin != out:
            weights += cin * out
            biases += out
        cin = out
    pixels = crops * h * w
    return Bound(2.0 * pixels * weights,
                 pixels * (stem + out) * BF16 + weights * BF16 + biases * F32)


def _swin_maps(cfg: dict):
    """Per stage: (C, heads, depth, H, W, Hp, Wp) of one crop's map."""
    in_w, in_h = cfg["input_size"]
    win = cfg["window"]
    out = []
    for i, (depth, heads) in enumerate(zip(cfg["depths"], cfg["heads"])):
        H, W = in_h // 4 >> i, in_w // 4 >> i
        out.append((cfg["embed"] * 2 ** i, heads, depth, H, W,
                    math.ceil(H / win) * win, math.ceil(W / win) * win))
    return out


def swin_block_bounds(cfg: dict, crops: int, stage: int, block: int):
    """(the four products' bounds, the attention's bound) of one SwinBlock
    over ``crops`` crops.

    Products: qkv (LN1 prologue), proj (+ residual), fc1 (LN2 prologue,
    GELU), fc2 (+ residual), each on its own: its real rows' operand read
    and output written in bf16 (the residual read too), its kernel (bf16),
    bias and LN affine (f32) and the pad-row table (f32, one per window
    position, where the map is padded: on the qkv, and on fc2 when the next
    block of the stage takes the tokens in window order) read once.
    Attention: each real query's window of n keys; the real q and ctx in
    bf16, every window token's k and v (pad tokens are keys), the (heads, n,
    n) bias and, on shifted blocks, the (nW, n, n) mask, in f32."""
    C, heads, depth, H, W, Hp, Wp = _swin_maps(cfg)[stage]
    win = cfg["window"]
    n, ratio = win * win, cfg["mlp_ratio"]
    real = crops * H * W
    nW = (Hp // win) * (Wp // win)
    valid = nW * n * F32 if (Hp, Wp) != (H, W) else 0
    emit = block < depth - 1

    def product(K, N, res: bool, ln: bool, table: bool) -> Bound:
        return Bound(2.0 * real * N * K,
                     real * (K + N * (2 if res else 1)) * BF16 + N * K * BF16 + N * F32
                     + (2 * K * F32 if ln else 0) + (valid if table else 0))

    products = [product(C, 3 * C, False, True, True), product(C, C, True, False, False),
                product(C, ratio * C, False, True, False), product(ratio * C, C, True, False, emit)]
    shifted = block % 2 == 1
    attention = Bound(4.0 * real * n * C,
                      real * C * BF16 * 2 + crops * nW * n * 2 * C * BF16
                      + heads * n * n * F32 + (nW * n * n * F32 if shifted else 0))
    return products, attention


def _blocks(cfg: dict, crops: int):
    for stage, (_, _, depth, *_rest) in enumerate(_swin_maps(cfg)):
        for block in range(depth):
            yield swin_block_bounds(cfg, crops, stage, block)


def swin_products_bound(cfg: dict, crops: int) -> float:
    """Seconds: the four token products of every SwinBlock over ``crops``
    crops, each product bounded on its own (they are separate passes over
    memory)."""
    return sum(p.seconds for products, _ in _blocks(cfg, crops) for p in products)


def swin_attention_bound(cfg: dict, crops: int) -> float:
    """Seconds: the window attention of every SwinBlock over ``crops`` crops."""
    return sum(attention.seconds for _, attention in _blocks(cfg, crops))


def model_flops_per_crop(model_fn) -> float:
    """The 2D model's operations for one crop: ``model_fn()`` runs the
    reference model on one crop of meta tensors, under torch's FLOP counter
    (2 per multiply-add of every convolution, transposed convolution and
    matrix product)."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        model_fn()
    return float(counter.get_total_flops())

"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips where ``torch.cuda.is_available()`` is
false (no card, or a CPU build of PyTorch).  On a machine with a card:

    python -m pytest tests/test_torch_port_cuda.py -m cuda -p no:cacheprovider

Tolerances: the Bottleneck kernel sums bf16 products in f32 in another
order than the plain version, so an output may round to the neighbouring
bf16 value (2^-8 relative): held at 8e-3 of the largest output, with under
1% of outputs off by more than one bf16 step.  The decode kernel's f32 sums
are held to 1e-5 relative to |value| + 1; its peak and argmax exactly.
"""

import pytest
import torch

from multi_camera_3d_pose_estimation_tpu_torch.ops import bottleneck as bn
from multi_camera_3d_pose_estimation_tpu_torch.ops import fused_decode as fd

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _block(gen, cin, down, device):
    f = {"W1": torch.randn(1, 1, cin, 64, generator=gen) / cin ** 0.5,
         "b1": 0.1 * torch.randn(64, generator=gen),
         "W2": torch.randn(3, 3, 64, 64, generator=gen) / 24.0,
         "b2": 0.1 * torch.randn(64, generator=gen),
         "W3": torch.randn(1, 1, 64, 256, generator=gen) / 8.0,
         "b3": 0.1 * torch.randn(256, generator=gen)}
    if down:
        f["Wd"] = torch.randn(1, 1, cin, 256, generator=gen) / cin ** 0.5
        f["bd"] = 0.1 * torch.randn(256, generator=gen)
    return bn.prepare_block(f, torch.bfloat16, device)


@pytest.mark.parametrize("B,H,W,cin,down", [(2, 64, 48, 64, True), (2, 64, 48, 256, False),
                                            (3, 16, 8, 16, True), (1, 13, 12, 256, False)])
def test_bottleneck_kernel_matches_plain(card, B, H, W, cin, down):
    gen = torch.Generator().manual_seed(cin + H)
    p = _block(gen, cin, down, card)
    x = torch.randn(B, H, W, cin, generator=gen).to(card, torch.bfloat16)
    n = bn.fused_bottleneck_block.launches
    out = bn.fused_bottleneck_block(x, p)
    torch.cuda.synchronize()
    assert bn.fused_bottleneck_block.launches == n + 1
    ref = bn.bottleneck_block_plain(x, p).float()
    d = (out.float() - ref).abs()
    assert d.max() <= 8e-3 * ref.abs().max()
    assert (d > ref.abs() * 2 ** -7 + 1e-6).float().mean() < 0.01


def test_bottleneck_kernel_refuses_f32(card):
    p = _block(torch.Generator().manual_seed(0), 64, True, card)
    with pytest.raises(TypeError):
        bn.fused_bottleneck_block(torch.zeros(1, 4, 4, 64, device=card), p)


def test_decode_kernel_matches_plain(card):
    gen = torch.Generator().manual_seed(0)
    hm = torch.rand(300, 64 * 48, generator=gen)
    hm[0] = 0.0  # empty map
    hm[1, 5] = hm[1, 100] = 2.0  # tied peak: the first wins
    hm[2] = torch.round(hm[2] * 4) / 4  # many ties
    hm = hm.to(card)
    out = fd.heatmap_decode_raw(hm, 48, 0.01)
    torch.cuda.synchronize()
    ref = fd.heatmap_decode_raw_plain(hm, 48, 0.01)
    assert ((out - ref).abs() / (ref.abs() + 1)).max() <= 1e-5
    assert torch.equal(out[:, 6:8], ref[:, 6:8]) and out[1, 7] == 5

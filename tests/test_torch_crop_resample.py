"""The crop wrapper (`ops.crop_resample`) on the CPU.

On the CPU `preprocess_crops` runs the plain form: `crop_frames` and the
normalize in the frames' dtype, bit for bit as they are called by hand, and
no kernel launch.  The launcher refuses bad arguments before it loads the
kernel.  The card's kernel is held to the plain form computed in f32 and
rounded once in ``tests/test_torch_port_cuda.py``.
"""

import numpy as np
import pytest
import torch

from multi_camera_3d_pose_estimation_tpu_torch.models import topdown as ttd
from multi_camera_3d_pose_estimation_tpu_torch.ops import crop_resample as cr

BOXES = [
    [0.0, 0.0, 80.0, 96.0],  # whole frame, downscales (antialiased)
    [8.0, 4.0, 72.0, 92.0],  # downscales
    [30.0, 40.0, 42.0, 52.0],  # small box: upscales
    [-20.0, 60.0, 50.0, 130.0],  # crosses the image edge
    [70.0, -10.0, 95.0, 20.0],  # crosses two edges
]


def _case(name):
    """(frames (B, H, W, 3) f32 in [0, 1], boxes (B, 4) f32, input_size (w, h))."""
    shape, boxes, size = {
        "boxes": ((5, 96, 80), BOXES, (32, 64)),
        "boxes_40x56": ((5, 96, 80), BOXES, (56, 40)),
        # The benchmark's crop (two frames here: the plain form's second
        # product copies its broadcast weights, ~0.3 GB at this size).
        "vga": ((2, 480, 640), [[0.0, 0.0, 640.0, 480.0]] * 2, (192, 256)),
        "uhd": ((1, 2160, 3840), [[0.0, 0.0, 3840.0, 2160.0]], (192, 256)),
        "outside": ((2, 96, 80), [[200.0, 300.0, 260.0, 400.0], [-90.0, -90.0, -10.0, -10.0]],
                    (32, 64)),
        "one": ((1, 96, 80), [[8.0, 4.0, 72.0, 92.0]], (32, 64)),
    }[name]
    rng = np.random.default_rng(len(name))
    frames = rng.uniform(0, 1, shape + (3,)).astype(np.float32)
    return torch.from_numpy(frames), torch.tensor(boxes, dtype=torch.float32), size


CASES = ["boxes", "boxes_40x56", "vga", "uhd", "outside", "one"]


def _by_hand(frames, boxes, size):
    in_w, in_h = size
    center, box_size = ttd.center_scale_from_bbox(boxes, in_w / in_h, 1.25)
    crops, scale, offset = ttd.crop_frames(frames, center, box_size, (in_h, in_w))
    mean = torch.as_tensor(ttd.IMAGENET_MEAN).to(crops.dtype)
    std = torch.as_tensor(ttd.IMAGENET_STD).to(crops.dtype)
    return (crops - mean) / std, scale, offset


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", CASES)
def test_preprocess_crops_on_the_cpu_is_the_plain_form(name, dtype):
    frames, boxes, size = _case(name)
    frames = frames.to(dtype)
    n = cr.crop_resample.launches
    out = ttd.preprocess_crops(frames, boxes, size)
    assert cr.crop_resample.launches == n
    assert out[0].dtype == dtype and out[0].shape == (len(boxes), size[1], size[0], 3)
    for o, r in zip(out, _by_hand(frames, boxes, size)):
        assert torch.equal(o, r)


def test_plain_form_of_a_box_outside_the_frame_is_minus_mean_over_std():
    """No tap in the frame: every f32 output is -mean/std, as the kernel
    writes it."""
    frames, boxes, size = _case("outside")
    crops = cr.crop_and_normalize(frames, boxes, size)[0]
    const = torch.from_numpy(-cr.IMAGENET_MEAN / cr.IMAGENET_STD)
    assert torch.equal(crops, const.expand_as(crops))


def _bad_launch(what):
    """Arguments the kernel's launcher refuses, and the error it raises."""
    frames, boxes, size = _case("one")
    return {
        "uint8 frames": ((frames * 255).to(torch.uint8), boxes, TypeError),
        "f64 frames": (frames.double(), boxes, TypeError),
        "f64 boxes": (frames, boxes.double(), TypeError),
        "4 channels": (torch.cat([frames, frames[..., :1]], -1), boxes, ValueError),
        "boxes of another batch": (frames, boxes.expand(2, 4), ValueError),
        "boxes on another device": (frames, boxes.to("meta"), ValueError),
    }[what] + (size,)


@pytest.mark.parametrize("what", ["uint8 frames", "f64 frames", "f64 boxes", "4 channels",
                                  "boxes of another batch", "boxes on another device"])
def test_launcher_refuses_bad_arguments_before_any_launch(what):
    """The launcher checks dtypes, shapes and devices before it loads the
    kernel library, so no card is needed to see the refusal."""
    frames, boxes, err, size = _bad_launch(what)
    n = cr.crop_resample.launches
    with pytest.raises(err):
        cr._launch(frames, boxes, size, 1.25)
    assert cr.crop_resample.launches == n


def test_crop_resample_refuses_other_devices():
    frames, boxes, size = _case("one")
    with pytest.raises(ValueError, match="unsupported device"):
        cr.crop_resample(frames.to("meta"), boxes.to("meta"), size)

"""Models of the port: HRNet, the flax weight converter and the top-down estimator."""

from .convert import hrnet_state_dict_from_flax, load_hrnet_from_flax
from .hrnet import HRNET_W32, HRNET_W48, HRNet
from .topdown import TopDownEstimator, center_scale_from_bbox, crop_frames, preprocess_crops

__all__ = [
    "HRNET_W32",
    "HRNET_W48",
    "HRNet",
    "TopDownEstimator",
    "center_scale_from_bbox",
    "crop_frames",
    "hrnet_state_dict_from_flax",
    "load_hrnet_from_flax",
    "preprocess_crops",
]

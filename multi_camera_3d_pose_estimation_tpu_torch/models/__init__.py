"""Models of the port: HRNet, Swin, the flax weight converter, the registry
and the top-down estimator."""

from .convert import (hrnet_state_dict_from_flax, load_hrnet_from_flax, load_swin_from_flax,
                      swin_state_dict_from_flax)
from .hrnet import HRNET_W32, HRNET_W48, HRNet
from .registry import MODEL_REGISTRY, build_estimator
from .swin import SWIN_B, SWIN_L, SWIN_T, SwinPose
from .topdown import TopDownEstimator, center_scale_from_bbox, crop_frames, preprocess_crops

__all__ = [
    "HRNET_W32",
    "HRNET_W48",
    "HRNet",
    "MODEL_REGISTRY",
    "SWIN_B",
    "SWIN_L",
    "SWIN_T",
    "SwinPose",
    "TopDownEstimator",
    "build_estimator",
    "center_scale_from_bbox",
    "crop_frames",
    "hrnet_state_dict_from_flax",
    "load_hrnet_from_flax",
    "load_swin_from_flax",
    "preprocess_crops",
    "swin_state_dict_from_flax",
]

"""Models of the port: HRNet and Swin (heatmap), RTMPose (SimCC), the person
detectors (CenterNet, RTMDet, YOLOX), the weight converters (flax trees,
the JAX package's ``.npz``, MMPose/MMDet ``.pth`` in `convert`), the
checkpoint drill (`checkpoint_verify`) with its MMPose mirrors
(`mirrors`), the registry and the top-down estimator."""

from .convert import (centernet_state_dict_from_flax, hrnet_state_dict_from_flax,
                      load_centernet_from_flax, load_hrnet_from_flax, load_rtmdet_from_flax,
                      load_rtmpose_from_flax, load_swin_from_flax, load_yolox_from_flax,
                      rtmdet_state_dict_from_flax, rtmpose_state_dict_from_flax,
                      swin_state_dict_from_flax, yolox_state_dict_from_flax)
from .detector import (CenterNetDetector, SinglePersonDetector, decode_top1, decode_topk,
                       full_frame_bboxes, select_consistent_boxes)
from .hrnet import HRNET_W32, HRNET_W48, HRNet
from .registry import (DETECTOR_REGISTRY, MODEL_REGISTRY, build_detector, build_estimator,
                       resolve_model_name)
from .rtmdet import RTMDET_M, RTMDET_TINY, RTMDet
from .rtmpose import RTMPOSE_M, RTMPOSE_S, RTMPOSE_T, CSPNeXt, RTMPose
from .swin import SWIN_B, SWIN_L, SWIN_T, SwinPose, SwinTransformer
from .topdown import (IMAGENET_MEAN, IMAGENET_STD, TopDownEstimator, center_scale_from_bbox,
                      crop_frames, preprocess_crops)
from .yolox import YOLOX, YOLOX_S, YOLOX_TINY

__all__ = [
    "CSPNeXt",
    "CenterNetDetector",
    "DETECTOR_REGISTRY",
    "HRNET_W32",
    "HRNET_W48",
    "HRNet",
    "IMAGENET_MEAN",
    "IMAGENET_STD",
    "MODEL_REGISTRY",
    "RTMDET_M",
    "RTMDET_TINY",
    "RTMDet",
    "RTMPOSE_M",
    "RTMPOSE_S",
    "RTMPOSE_T",
    "RTMPose",
    "SWIN_B",
    "SWIN_L",
    "SWIN_T",
    "SinglePersonDetector",
    "SwinPose",
    "SwinTransformer",
    "TopDownEstimator",
    "YOLOX",
    "YOLOX_S",
    "YOLOX_TINY",
    "build_detector",
    "build_estimator",
    "center_scale_from_bbox",
    "centernet_state_dict_from_flax",
    "crop_frames",
    "decode_top1",
    "decode_topk",
    "full_frame_bboxes",
    "hrnet_state_dict_from_flax",
    "load_centernet_from_flax",
    "load_hrnet_from_flax",
    "load_rtmdet_from_flax",
    "load_rtmpose_from_flax",
    "load_swin_from_flax",
    "load_yolox_from_flax",
    "preprocess_crops",
    "resolve_model_name",
    "rtmdet_state_dict_from_flax",
    "rtmpose_state_dict_from_flax",
    "select_consistent_boxes",
    "swin_state_dict_from_flax",
    "yolox_state_dict_from_flax",
]

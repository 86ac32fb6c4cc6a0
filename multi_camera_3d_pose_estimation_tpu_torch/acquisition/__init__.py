"""Multi-camera recording + live capture (host, cv2 imported where a camera
is opened), as the JAX package's ``acquisition/``."""

from .record import record_from_cameras, identify_cameras, select_webcam_names
from .live import LiveCaptureSource, LiveStereoCaptureSource, live_sync_frame_picker

__all__ = [
    "record_from_cameras",
    "identify_cameras",
    "select_webcam_names",
    "LiveCaptureSource",
    "LiveStereoCaptureSource",
    "live_sync_frame_picker",
]

"""LIO-SAM LiDAR-inertial odometry on PyTorch (port of
``msst_tpu.models.liosam``): ``LioSam(params, device=...).process_scan``."""

from .params import LioParams  # noqa: F401
from .pipeline import LioSam  # noqa: F401

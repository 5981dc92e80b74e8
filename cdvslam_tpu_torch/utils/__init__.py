"""Utilities (port of ``cdvslam_tpu.utils``)."""
from .timer import Timer, ALL_TIMES  # noqa: F401

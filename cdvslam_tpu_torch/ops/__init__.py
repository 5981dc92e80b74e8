"""Correlation, patch gathers, segment sums and the CUDA kernel wrappers."""
from .corr import corr, corr_cl_plain, corr_pyramid_plain  # noqa: F401
from .patchify import patchify  # noqa: F401
from .scatter import SegmentPlan, neighbors_np  # noqa: F401

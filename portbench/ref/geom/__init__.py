# Frozen copy of cdvslam_tpu_torch/geom/__init__.py at commit 8ea54d8, part of the
# benchmark's plain reference: it stays as it is when the program changes.
"""Projective geometry (port of ``cdvslam_tpu.geom``)."""
from .projective import flow_mag, iproj, point_cloud, proj, transform  # noqa: F401

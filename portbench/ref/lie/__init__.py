# Frozen copy of cdvslam_tpu_torch/lie/__init__.py at commit 8ea54d8, part of the
# benchmark's plain reference: it stays as it is when the program changes.
"""The Lie groups on torch tensors (port of ``cdvslam_tpu.lie``)."""
from .groups import (  # noqa: F401
    SE3, Sim3, rxso3_act, rxso3_adj, rxso3_adjT, rxso3_calcW, rxso3_calcWinv, rxso3_exp,
    rxso3_identity, rxso3_inv, rxso3_log, rxso3_matrix3, rxso3_mul, se3_act, se3_act4,
    se3_adj, se3_adjT, se3_exp, se3_identity, se3_inv, se3_log, se3_matrix, se3_mul,
    se3_retr, se3_scale, se3_to_sim3, sim3_act, sim3_act4, sim3_adj, sim3_adjT, sim3_exp,
    sim3_identity, sim3_inv, sim3_log, sim3_matrix, sim3_mul, sim3_retr, so3_adj, so3_adjT,
)
from .quaternion import (  # noqa: F401
    hat, qconj, qmat, qmul, qnormalize, qrot, quat_exp, quat_log,
)

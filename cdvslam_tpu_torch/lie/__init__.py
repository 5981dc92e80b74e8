"""SE3 Lie group on torch tensors (port of ``cdvslam_tpu.lie``)."""
from .groups import (  # noqa: F401
    SE3, se3_act, se3_act4, se3_adj, se3_adjT, se3_exp, se3_identity,
    se3_inv, se3_log, se3_matrix, se3_mul, se3_retr, se3_scale,
)
from .quaternion import (  # noqa: F401
    hat, qconj, qmat, qmul, qnormalize, qrot, quat_exp, quat_log,
)

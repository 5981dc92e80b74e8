"""Evaluation (port of ``cdvslam_tpu.eval``): the ATE, the harness and,
as ``python -m cdvslam_tpu_torch.eval.<name>``, the six dataset
evaluations (euroc, tum, tartan, kitti, icl_nuim, nuscene)."""
from .ate import ate_rmse, umeyama_alignment, associate_timestamps  # noqa: F401

"""Bundle adjustment (port of ``cdvslam_tpu.ba.ba_solve``, scatter assembly)."""
from .ba import INFERENCE_PARAMS, TRAINING_PARAMS, BAParams, ba_solve  # noqa: F401

"""Bundle adjustment of the reference."""
from .ba import INFERENCE_PARAMS, BAParams, ba_solve  # noqa: F401

"""The reference's correlation: the plain version only (the program's
``ops/corr_cuda.py`` launches its CUDA kernel on the card)."""
from .corr import corr_pyramid_plain as corr_pyramid_cl  # noqa: F401

"""Networks of the port (port of ``cdvslam_tpu.models``): CDVNet for the CDV
paths, VONet for DPVO."""
from .cdvnet import CDVNet  # noqa: F401
from .update import UpdateAux, UpdateCDV, UpdateDPV, build_update_aux  # noqa: F401
from .vonet import VONet  # noqa: F401

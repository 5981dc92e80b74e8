"""The reference's networks: CDVNet and VONet, plain PyTorch."""
from .cdvnet import CDVNet  # noqa: F401
from .update import UpdateAux, UpdateCDV, UpdateDPV, build_update_aux  # noqa: F401
from .vonet import VONet  # noqa: F401

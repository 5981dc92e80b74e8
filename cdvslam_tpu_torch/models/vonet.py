"""VONet, the DPVO-compatible network (port of ``cdvslam_tpu.models.vonet``).

Two stride-4 CNN encoders give the matching features (``patchify.fnet``,
instance norm, 128 channels) and the context features (``patchify.inet``,
no norm, 384 channels), both divided by 4; the update operator is
``UpdateDPV``. The module tree follows the reference's state dict
(``patchify.fnet.*``, ``patchify.inet.*``, ``update.*``).
"""
from __future__ import annotations

from torch import nn

from .encoder import BasicEncoder4
from .update import UpdateDPV

DIM = 384


class Patchify(nn.Module):
    def __init__(self, dimf: int, dim: int):
        super().__init__()
        self.fnet = BasicEncoder4(output_dim=dimf, norm_fn="instance")
        self.inet = BasicEncoder4(output_dim=dim, norm_fn="none")


class VONet(nn.Module):
    P = 3
    DIM = DIM
    DIMF = 128
    RES = 4

    def __init__(self):
        super().__init__()
        self.patchify = Patchify(self.DIMF, self.DIM)
        self.update = UpdateDPV(self.P)

    def forward(self, method: str, *args, **kwargs):
        """``self.<method>(*args, **kwargs)``: lets ``torch.func.functional_call``
        run any method on substituted weights (the bf16 rollout)."""
        return getattr(self, method)(*args, **kwargs)

    @staticmethod
    def preprocess(img):
        """uint8-valued (..., H, W, 3) float image -> DPVO's input range,
        2 (x / 255) - 0.5."""
        return 2.0 * (img / 255.0) - 0.5

    def features(self, images):
        """images (N, H, W, 3), preprocessed -> matching features
        (N, 128, H/4, W/4) and context features (N, 384, H/4, W/4), both
        divided by 4."""
        x = images.permute(0, 3, 1, 2)
        return self.patchify.fnet(x) / 4.0, self.patchify.inet(x) / 4.0

"""CDVNet (port of ``cdvslam_tpu.models.cdvnet``).

Matching features come from XFeat blocks 1-2 (24 channels, 1/4 res);
context features are DINOv2 ViT-S/14 tokens of the last tapped block
(taps [2, 5, 8, 11]) with the final norm; the update operator is the gated
linear-attention variant with learnable-Fourier rotary encodings.

The module tree follows the reference's state dict: ``patchify.dino.*``,
``patchify.xfeat.*``, ``update.*`` and ``posenc.Wr``, and with
``compute_score`` the score head ``patchify.score.*`` (Linear, ReLU,
Linear, sigmoid over the normalized tokens), with ``dino_adapt`` the
bias-free ``patchify.dino_adapter`` on the gathered context vectors.
Neither the SLAM runtime nor the trainer builds those two, as in the JAX
package. ``net.update(...)`` and ``net.posenc(...)`` call those submodules,
as the JAX package's ``CDVNet.update`` and ``CDVNet.posenc`` methods do.
"""
from __future__ import annotations

from torch import nn

from .attention import LearnableFourierPositionalEncoding
from .dinov2 import DinoVisionTransformer, pad_to_multiple
from .update import UpdateCDV
from .xfeat import XFeat, xfeat_f

DIMI = 384
DIMF = 24
SCALEI = 14


class Patchify(nn.Module):
    def __init__(self, compute_score: bool = False, dino_adapt: bool = False):
        super().__init__()
        self.dino = DinoVisionTransformer()
        self.xfeat = XFeat()
        if compute_score:
            self.score = nn.Sequential(nn.Linear(DIMI, DIMI // 3), nn.ReLU(),
                                       nn.Linear(DIMI // 3, 1), nn.Sigmoid())
        if dino_adapt:
            self.dino_adapter = nn.Linear(DIMI, DIMI, bias=False)


class CDVNet(nn.Module):
    P = 3
    DIM = DIMI
    DIMF = DIMF
    RES = 4

    def __init__(self, compute_score: bool = False, dino_adapt: bool = False):
        super().__init__()
        self.compute_score = compute_score
        self.dino_adapt = dino_adapt
        self.patchify = Patchify(compute_score, dino_adapt)
        self.update = UpdateCDV(self.P)
        self.posenc = LearnableFourierPositionalEncoding(2, DIMI // 8)

    def forward(self, method: str, *args, **kwargs):
        """``self.<method>(*args, **kwargs)``: lets ``torch.func.functional_call``
        run any method on substituted weights (the bf16 rollout)."""
        return getattr(self, method)(*args, **kwargs)

    def features_f(self, images):
        """Matching features scaled by 1/4: images (N, H, W, 3) in [0, 1] ->
        (N, 24, H/4, W/4)."""
        return xfeat_f(self.patchify.xfeat, images) / 4.0

    def features_i(self, images):
        """Context tokens: pad to a multiple of 14, DINOv2 taps, final norm
        of the last tap -> token map (N, 384, h, w) scaled by 1/4. Also
        returns the normalized tokens (N, h*w, 384), the raw last-layer
        tokens and cls, and the score map (N, h, w) (None without
        ``compute_score``)."""
        return self.features_i_taps(images)[:5]

    def features_i_taps(self, images):
        """``features_i``'s five outputs plus the four raw (pre-norm) taps
        for the DPT depth head: a list of (token map (N, h, w, 384), cls
        (N, 384)) pairs in tap order. DINO runs once."""
        imgs = pad_to_multiple(images, SCALEI)
        N, Hp, Wp, _ = imgs.shape
        taps = self.patchify.dino(imgs.permute(0, 3, 1, 2), taps=(2, 5, 8, 11))
        last = taps[-1]
        tokens_norm = self.patchify.dino.norm(last)[:, 1:]
        h, w = Hp // SCALEI, Wp // SCALEI
        tmap = tokens_norm.reshape(N, h, w, DIMI).permute(0, 3, 1, 2) / 4.0
        score_map = None
        if self.compute_score:
            score_map = self.patchify.score(tokens_norm).reshape(N, h, w)
        tap_pairs = [(t[:, 1:].reshape(N, h, w, DIMI), t[:, 0]) for t in taps]
        return tmap, tokens_norm, last[:, 1:], last[:, 0], score_map, tap_pairs

    def adapt(self, ictx):
        """The DINO adapter on gathered context vectors (identity without
        ``dino_adapt``)."""
        return self.patchify.dino_adapter(ictx) if self.dino_adapt else ictx

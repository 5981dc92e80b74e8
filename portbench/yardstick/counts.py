"""Operations and bytes that the work needs, computed from shapes.

Operations are multiply-adds counted twice, of the products alone (linear
layers, convolutions, attention, the correlation's dot products): norms,
activations, gathers and the BA's small solves are left out. They count
what the inputs need, never what an implementation pads: the update is
counted over the real edges.

``corr_bytes`` and ``attn_flops`` are frozen copies of ``chip_smoke.py``'s
``_corr_bytes`` and ``_attn_flops`` (commit 8ea54d8).
"""
from __future__ import annotations

DINO = dict(dim=384, depth=12, heads=6, mlp=1536, patch=14)
UPDATE_DIM = 384


def linear_flops(rows, fan_in, fan_out):
    return 2 * rows * fan_in * fan_out


def conv_flops(h_out, w_out, c_in, c_out, k):
    return 2 * h_out * w_out * c_in * c_out * k * k


def attn_flops(B, L, h=6, d=64):
    """Multiply-adds counted twice: S = Q K^T and P V, 2 L^2 d each."""
    return 4 * L * L * d * h * B


def dino_tokens(ht, wd, patch=14):
    """Tokens of DINOv2 over an image padded to multiples of the patch,
    the cls token included."""
    return -(-ht // patch) * -(-wd // patch) + 1


def dino_flops(ht, wd):
    """DINOv2 ViT-S/14 over one (ht, wd) image: the patch embedding and 12
    blocks (qkv, attention, projection, MLP)."""
    D, p = DINO["dim"], DINO["patch"]
    L = dino_tokens(ht, wd, p)
    embed = conv_flops(L - 1, 1, 3, D, p)
    block = (linear_flops(L, D, 3 * D) + attn_flops(1, L, DINO["heads"], D // DINO["heads"])
             + linear_flops(L, D, D) + linear_flops(L, D, DINO["mlp"])
             + linear_flops(L, DINO["mlp"], D))
    return embed + DINO["depth"] * block


def xfeat_flops(ht, wd):
    """XFeat blocks 1-2 (24 channels at 1/4) over one gray image."""
    h2, w2, h4, w4 = ht // 2, wd // 2, ht // 4, wd // 4
    return (conv_flops(ht, wd, 1, 4, 3) + conv_flops(h2, w2, 4, 8, 3)
            + conv_flops(h2, w2, 8, 8, 3) + conv_flops(h4, w4, 8, 24, 3)
            + conv_flops(h4, w4, 1, 24, 1) + 2 * conv_flops(h4, w4, 24, 24, 3))


def encoder_flops(ht, wd, out_dim):
    """DPVO's BasicEncoder4 over one RGB image."""
    h2, w2, h4, w4 = ht // 2, wd // 2, ht // 4, wd // 4
    return (conv_flops(h2, w2, 3, 32, 7) + 4 * conv_flops(h2, w2, 32, 32, 3)
            + conv_flops(h4, w4, 32, 64, 3) + conv_flops(h4, w4, 64, 64, 3)
            + conv_flops(h4, w4, 32, 64, 1) + 2 * conv_flops(h4, w4, 64, 64, 3)
            + conv_flops(h4, w4, 64, out_dim, 1))


def corr_flops(E, C, P=3, radius=3):
    """Both levels' dot products: each of the P*P pixels of an edge's patch
    against a (2R+2)^2 window of C channels."""
    return 2 * 2 * E * P * P * (2 * radius + 2) ** 2 * C


def update_flops(network, E, n_patches, n_groups, M, P=3):
    """One update operator call over E real edges, ``n_patches`` distinct
    patches and ``n_groups`` distinct (i, j) frame pairs among them."""
    D = UPDATE_DIM
    cdim = 2 * 49 * P * P
    trunk = (linear_flops(E, cdim, D) + 2 * linear_flops(E, D, D)     # corr MLP
             + 4 * linear_flops(E, D, D)                               # c1, c2
             + 2 * linear_flops(E, D, D) + linear_flops(n_patches, D, D)  # agg_kk
             + 2 * linear_flops(E, D, 2))                              # d, w heads
    if network == "dpv":
        return (trunk + 2 * linear_flops(E, D, D) + linear_flops(n_groups, D, D)   # agg_ij
                + 2 * 3 * linear_flops(E, D, D))                       # two gated residuals
    heads, hd = 8, D // 8
    G = E // M
    # the normaliser Z (one dot product per token and head), then K^T V and
    # Q (K^T V), each hd x hd per token and head
    lin_attn = 2 * G * M * heads * hd + 2 * 2 * G * M * heads * hd * hd
    return (trunk + linear_flops(E, 2, D // 16)                        # Fourier encoding
            + linear_flops(E, D, D)                                    # gate
            + 4 * linear_flops(E, D, D)                                # q, k, v, merge
            + linear_flops(E, 2 * D, 2 * D) + linear_flops(E, 2 * D, D)  # encoder MLP
            + lin_attn)


def frame_flops(network, ht, wd, E, n_patches, n_groups, M, C):
    """One steady-state frame: the networks over the new image, and one
    update (the correlation and the update operator) over E real edges."""
    if network == "dpv":
        nets = encoder_flops(ht, wd, 128) + encoder_flops(ht, wd, UPDATE_DIM)
    else:
        nets = xfeat_flops(ht, wd) + dino_flops(ht, wd)
    return nets + corr_flops(E, C) + update_flops(network, E, n_patches, n_groups, M)


def heads_flops(ht, wd, M, score, seg, depth):
    """CDVO++'s linear heads over one frame: under SCORE selection the seg
    head (384 -> 150 ADE20K classes) over every patch token, the seg head
    over the M chosen patches, and the linear depth head over every patch
    token ([token; cls], 768 -> 256 bins, then the bins' dot product); the
    seg head's BatchNorm and the depth map's resize are left out."""
    D, L, classes, bins = DINO["dim"], dino_tokens(ht, wd) - 1, 150, 256
    return (score * linear_flops(L, D, classes) + seg * linear_flops(M, D, classes)
            + depth * (linear_flops(L, 2 * D, bins) + linear_flops(L, bins, 1)))


def _levels(coords):
    """The coordinates at pyramid levels 1 and 2."""
    return coords, coords / 4.0


def corr_bytes(gmap, fmap1, fmap2, coords, ii, jj):
    """Bytes the call must move: output, coords, indices, and each gmap row
    and each fmap tap row of either level it touches, once."""
    import torch
    es = gmap.element_size()
    E_ = coords.shape[0]
    taps = 0
    for c, fmap in zip(_levels(coords), (fmap1, fmap2)):
        _, H, W, Cc = fmap.shape
        x0 = torch.floor(c[:, 0]).long()[..., None, None]             # (E,3,3,1,1)
        y0 = torch.floor(c[:, 1]).long()[..., None, None]
        d = torch.arange(8, device=c.device) - 3
        ys = (y0 + d[:, None]).expand(-1, -1, -1, 8, 8)
        xs = (x0 + d[None, :]).expand(-1, -1, -1, 8, 8)
        inb = (ys >= 0) & (ys < H) & (xs >= 0) & (xs < W)
        f = jj.long()[:, None, None, None, None].expand_as(ys)
        taps += torch.unique(((f * H + ys) * W + xs)[inb]).numel() * Cc * es
    rows = torch.unique(ii).numel()
    return (E_ * 49 * 9 * 2 * es + coords.numel() * 4 + 2 * E_ * 4
            + rows * gmap.shape[1] * 9 * es + taps)


def bound_s(flops, nbytes, peaks, dtype="bf16"):
    """The least time the chip could take: the larger of operations over
    the type's peak and bytes over the memory bandwidth."""
    return max(flops / peaks["flops"][dtype], nbytes / peaks["bytes_per_s"])

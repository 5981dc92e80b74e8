"""Proximity loop closure, the DPV-SLAM backend
(port of ``cdvslam_tpu.loop.proximity``).

Candidate long-range edges run from the patches of old frames to recent
frames; a pair is kept when its predicted flow is small, then greedy NMS
picks at most 1,000 pairs (reference: cdvslam/patchgraph.py:71-97 and
loop_closure/optim_utils.py:24-60). The flow runs on the device; the NMS
stays host-side numpy.
"""
from __future__ import annotations

import numpy as np
import torch

from ..geom import flow_mag
from ..lie import SE3


def reduce_edges(flow_mags, ii, jj, max_num_edges=1000, nms=1):
    """Greedy NMS edge selection (a copy of the JAX package's)."""
    es = []
    if ii.size == 0:
        return np.zeros((0, 2), np.int64)
    Ni, Nj = ii.max() + 1, jj.max() + 1
    ignore = np.zeros((Ni, Nj), bool)
    for idx in np.argsort(flow_mags):
        if len(es) >= max_num_edges:
            break
        i, j, mag = ii[idx], jj[idx], flow_mags[idx]
        if (j - i) < 30 or mag >= 1000 or ignore[i, j]:
            continue
        es.append((i, j))
        for di in range(-nms, nms + 1):
            if 0 <= i + di < Ni:
                ignore[i + di, j] = True
    return np.asarray(es, np.int64).reshape(-1, 2)


def candidate_flow(poses, centers, intrinsics, ii, jj, kk, M: int):
    """Mean flow magnitude per candidate (i, j) pair: the edges come in
    blocks of M per pair; inf where fewer than 75% of the block is valid.
    centers (K, 3, 1, 1) patch centers; returns (E / M,)."""
    fm, val = flow_mag(SE3(poses[None]), centers[None], intrinsics[None],
                       ii, jj, kk, beta=0.5)
    fm, val = fm[0, :, 0, 0], val[0, :, 0, 0]
    fm_sum = torch.sum((fm * val).reshape(-1, M), dim=1)
    n_val = torch.sum(val.reshape(-1, M), dim=1)
    mean = fm_sum / n_val.clamp(min=1)
    return torch.where(n_val > M * 0.75, mean, torch.full_like(mean, float("inf")))


def edges_loop(pg, cfg):
    """Loop-closure candidate edges of the patch graph ``pg`` (reference
    patchgraph.py:71-97): (kk, jj) host arrays, M edges per selected pair."""
    M, n = pg.M, pg.n
    empty = np.zeros(0, np.int64), np.zeros(0, np.int64)
    l = n - cfg.REMOVAL_WINDOW
    if l <= 0:
        return empty
    jj_r = np.arange(max(n - cfg.GLOBAL_OPT_FREQ, 0), n - cfg.KEYFRAME_INDEX)
    kk_r = np.arange(max(l - cfg.MAX_EDGE_AGE, 0) * M, l * M)
    if len(jj_r) == 0 or len(kk_r) == 0:
        return empty

    jj_c, kk_c = (a.reshape(-1) for a in np.meshgrid(jj_r, kk_r, indexing="ij"))
    ii_c = kk_c // M
    dev = pg.poses_.device

    def dt(a):
        return torch.as_tensor(a, device=dev)

    fm = candidate_flow(pg.poses_, pg.patches_[:, :, 1:2, 1:2], pg.intrinsics_,
                        dt(ii_c), dt(jj_c), dt(kk_c), M).cpu().numpy()
    good = fm < cfg.BACKEND_THRESH
    es = reduce_edges(fm[good], ii_c[::M][good], jj_c[::M][good], max_num_edges=1000, nms=1)
    if len(es) == 0:
        return empty
    kk_new = (es[:, 0:1] * M + np.arange(M)[None, :]).reshape(-1)
    return kk_new, np.repeat(es[:, 1], M)

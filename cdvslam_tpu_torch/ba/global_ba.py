"""Global bundle adjustment with block-sparse pose-depth coupling
(port of ``cdvslam_tpu.ba.global_ba``).

The pose-depth matrix E has nonzeros only in (frame-pair entry) x (patch
slot) blocks: an edge (i, j, k) touches the entry (i, j) through its Jj
block and the self entry (i, i) through its Ji block, at slot k % M of
source frame i. So E is never built densely (at 1,000 keyframes it would
be 6N x 96,000); instead

  E Q E^T = sum over source frames i, over ordered pairs (g1, g2) of
            entries of i:  E[g1] diag(Q_i) E[g2]^T

summed per "combo" (g1, g2), and E (Q u) and E^T dX go through the
entries. Every segment sum is a ``SegmentPlan`` (stable sort + ordered
reduce), so two solves on the same inputs are bitwise equal.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..lie import se3_retr
from ..ops.scatter import SegmentPlan
from .ba import INFERENCE_PARAMS, BAParams, _edge_terms


class GlobalIndex(NamedTuple):
    """Index arrays of one global solve (numpy on the host, or tensors)."""
    ii: object          # (E,) source frame
    jj: object          # (E,) target frame
    kk: object          # (E,) patch row
    entry_x: object     # (E,) entry (i, j) of each edge's Jj block
    entry_s: object     # (E,) self entry (i, i) of each edge's Ji block
    slot: object        # (E,) kk % M
    g_i: object         # (G,) source frame of each entry
    g_j: object         # (G,) pose block of each entry
    combo_g1: object    # (C,) ordered pairs of entries sharing a source frame
    combo_g2: object

    def to(self, device):
        return GlobalIndex(*(torch.as_tensor(np.asarray(a, np.int64), device=device)
                             for a in self))


def build_global_indices(ii, jj, kk, M) -> GlobalIndex:
    """Entries and combos of an edge list, on the host; the JAX package's
    ``build_global_indices`` without its bucket padding (the combos in the
    same order: source frames ascending, each frame's pairs row-major)."""
    ii = np.asarray(ii, np.int64)
    jj = np.asarray(jj, np.int64)
    kk = np.asarray(kk, np.int64)
    E = len(ii)
    n_frames = int(max(ii.max(), jj.max())) + 1 if E else 1

    # entries: unique (i, j) pairs plus self entries (i, i)
    keys = np.concatenate([ii * n_frames + jj, ii * n_frames + ii])
    uniq, inverse = np.unique(keys, return_inverse=True)
    g_i, g_j = uniq // n_frames, uniq % n_frames

    # combos: per source frame (run of the stably sorted g_i), all ordered
    # pairs of its entries
    order = np.argsort(g_i, kind="stable")
    _, starts, sizes = np.unique(g_i[order], return_index=True, return_counts=True)
    grp = np.repeat(np.arange(len(sizes)), sizes * sizes)
    p = np.arange(len(grp)) - np.repeat(np.cumsum(sizes * sizes) - sizes * sizes,
                                        sizes * sizes)
    s, base = sizes[grp], starts[grp]
    return GlobalIndex(ii, jj, kk, inverse[:E], inverse[E:], kk % M, g_i, g_j,
                       order[base + p // s], order[base + p % s])


def global_ba_solve(poses, patches, intrinsics, target, weight, idx: GlobalIndex,
                    t0: int, *, N: int, M: int, iterations: int = 2,
                    params: BAParams = INFERENCE_PARAMS):
    """Damped Gauss-Newton over poses [t0, t0 + N) and the inverse depths of
    the K = patches.shape[0] patch rows (K a multiple of M; kk indexes them
    directly). ``idx``: a ``GlobalIndex`` of tensors on the poses' device.
    Returns new (poses, patches); the inputs are not modified. A failed
    factorization gives a zero pose step, and patches no edge touches keep
    their depth."""
    cx, cy = intrinsics[2], intrinsics[3]
    dtype, dev = poses.dtype, poses.device
    NP, K = poses.shape[0], patches.shape[0]
    KF = K // M
    ii, jj = idx.ii.clamp(0, NP - 1), idx.jj.clamp(0, NP - 1)
    kid = idx.kk.clamp(0, K - 1)
    G = idx.g_i.shape[0]
    bad = N * N

    # segment ids do not change between iterations: plan every sum once
    ix, jx = ii - t0, jj - t0
    vi, vj = ix >= 0, jx >= 0

    def bid(a, b, va, vb):
        return torch.where(va & vb, a.clamp(0, N - 1) * N + b.clamp(0, N - 1),
                           torch.full_like(a, bad))

    def vid(a, va):
        return torch.where(va, a.clamp(0, N - 1), torch.full_like(a, N))

    plan_b = SegmentPlan(torch.cat([bid(ix, ix, vi, vi), bid(jx, jx, vj, vj),
                                    bid(ix, jx, vi, vj), bid(jx, ix, vj, vi)]), bad)
    plan_g = SegmentPlan(torch.cat([idx.entry_x * M + idx.slot,
                                    idx.entry_s * M + idx.slot]), G * M)
    plan_k = SegmentPlan(kid, K)
    plan_v = SegmentPlan(torch.cat([vid(ix, vi), vid(jx, vj)]), N)
    # E Q E^T per combo, summed into pose blocks (p1, p2)
    src_i = idx.g_i[idx.combo_g1].clamp(0, KF - 1)
    p1, p2 = idx.g_j[idx.combo_g1] - t0, idx.g_j[idx.combo_g2] - t0
    plan_c = SegmentPlan(bid(p1, p2, p1 >= 0, p2 >= 0), bad)
    # E (Q u) per entry into pose blocks; E^T dX per entry into patch rows
    gp = idx.g_j - t0
    gvalid = gp >= 0
    plan_gp = SegmentPlan(vid(gp, gvalid), N)
    g_src = idx.g_i.clamp(0, KF - 1)
    plan_p = SegmentPlan((g_src[:, None] * M + torch.arange(M, device=dev)).reshape(-1), K)
    touched = plan_k.sum(torch.ones_like(kid, dtype=dtype)) > 0
    win = torch.arange(t0, t0 + max(min(N, NP - t0), 0), device=dev)

    for _ in range(iterations):
        r, Ji, Jj, Jz, (x1, y1, Z) = _edge_terms(
            poses, patches, intrinsics, target, ii, jj, kid, params.z_min)
        rn = torch.sqrt(torch.sum(r * r, dim=-1))
        m = params.bounds_margin
        ok = ((rn < params.res_thresh) & (Z > params.z_min)
              & (x1 > -m) & (y1 > -m) & (x1 < 2 * cx + m) & (y1 < 2 * cy + m))[:, None]
        w = weight * ok.to(dtype)
        r = torch.where(ok, r, torch.zeros_like(r))

        def blk(Ja, Jb):
            return torch.einsum("er,eri,erj->eij", w, Ja, Jb)

        Bii, Bjj, Bij = blk(Ji, Ji), blk(Jj, Jj), -blk(Ji, Jj)
        B = plan_b.sum(torch.cat([Bii, Bjj, Bij, Bij.transpose(1, 2)], 0))
        B = B.reshape(N, N, 6, 6).permute(0, 2, 1, 3).reshape(6 * N, 6 * N)

        ei = -torch.einsum("er,eri,er->ei", w, Ji, Jz)
        ej = torch.einsum("er,eri,er->ei", w, Jj, Jz)
        E_g = plan_g.sum(torch.cat([ej, ei], 0)).reshape(G, M, 6)

        C = plan_k.sum(torch.sum(w * Jz * Jz, -1))
        u = plan_k.sum(torch.sum(w * r * Jz, -1))
        Q = 1.0 / (C + params.lmbda)

        vi_vec = -torch.einsum("er,eri->ei", w * r, Ji)
        vj_vec = torch.einsum("er,eri->ei", w * r, Jj)
        v = plan_v.sum(torch.cat([vi_vec, vj_vec], 0)).reshape(6 * N)

        qrow = Q.reshape(KF, M)[src_i]                                   # (C, M)
        blocks = torch.einsum("cka,ckb->cab", E_g[idx.combo_g1] * qrow[..., None],
                              E_g[idx.combo_g2])                         # (C, 6, 6)
        EQEt = plan_c.sum(blocks).reshape(N, N, 6, 6).permute(0, 2, 1, 3)
        qu_g = (Q * u).reshape(KF, M)[g_src]                             # (G, M)
        EQu = plan_gp.sum(torch.einsum("gk,gki->gi", qu_g, E_g)).reshape(6 * N)

        S = B - EQEt.reshape(6 * N, 6 * N)
        y = v - EQu
        S = S + torch.diag(params.lm * torch.diagonal(S) + params.ep)
        L, info = torch.linalg.cholesky_ex(S)
        dX_flat = torch.cholesky_solve(y[:, None], L)[:, 0]
        failed = (info != 0) | torch.isnan(dX_flat).any()
        dX_flat = torch.where(failed, torch.zeros_like(dX_flat), dX_flat)
        dX = dX_flat.reshape(N, 6)

        dxg = torch.where(gvalid[:, None], dX[gp.clamp(0, N - 1)], torch.zeros_like(dX[:1]))
        EtdX = plan_p.sum(torch.einsum("gki,gi->gk", E_g, dxg).reshape(-1))
        dZ = Q * (u - EtdX)

        poses = poses.clone()
        poses[win] = se3_retr(poses[win], dX[: win.shape[0]].to(dtype))

        d_old = patches[:, 2, 0, 0]
        d_new = d_old + dZ.to(dtype)
        # reset exploded depths, floor at 1e-4 (the local BA's clamps)
        d_new = torch.where(d_new > 20.0, torch.ones_like(d_new), d_new)
        d_new = torch.where(touched, d_new.clamp(min=1e-4), d_old)
        patches = patches.clone()
        patches[:, 2] = d_new[:, None, None]
    return poses, patches

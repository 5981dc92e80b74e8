# Frozen copy of cdvslam_tpu_torch/models/update.py at commit 8ea54d8, part of the
# benchmark's plain reference: it stays as it is when the program changes.
"""The update operators (port of ``cdvslam_tpu.models.update``).

Both share a trunk: the corr MLP, temporal messages and SoftAgg over
patches. ``UpdateCDV`` is the 'pa' variant: then per-(i,j)-group gated
linear attention with Fourier RoPE. ``UpdateDPV`` is DPVO's: then SoftAgg
over (i,j) groups and two gated residual units. Both end in the delta /
weight heads. Index bookkeeping (temporal neighbours, patch segments, the
(i,j) groups and the CDV group permutation) is built on the host by
``build_update_aux`` and passed in as tensors.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from ..ops.scatter import neighbors_np
from .attention import GatedAttention
from .blocks import MLP2, GatedResidual, LayerNorm, SoftAgg, gradient_clip

DIM = 384


class UpdateAux(NamedTuple):
    """Index arrays for one update call (numpy from ``build_update_aux``;
    ``to_torch`` moves them to a device).

    ix, jx:    (E,) temporal predecessor/successor edge index, -1 if none
    kseg:      (E,) patch segment ids in [0, n_kseg); padding -> n_kseg
    gseg:      (E,) (i,j)-group segment ids
    perm:      (G, M) edge indices grouping each (i,j) pair contiguously
    inv_perm:  (E,) inverse of perm.flatten()
    mask:      (E,) valid-edge mask, or None when every edge is valid
    """
    ix: object
    jx: object
    kseg: object
    gseg: Optional[object]
    perm: Optional[object]
    inv_perm: Optional[object]
    mask: object

    def to_torch(self, device) -> "UpdateAux":
        def cv(a, dtype=torch.long):
            if a is None:
                return None
            return torch.as_tensor(np.asarray(a), device=device).to(dtype)
        return UpdateAux(cv(self.ix), cv(self.jx), cv(self.kseg), cv(self.gseg),
                         cv(self.perm), cv(self.inv_perm), cv(self.mask, torch.bool))


class _UpdateTrunk(nn.Module):
    """The shared trunk and heads. Attribute names follow the reference's
    torch state dict (``update.corr.0``, ``update.agg_kk.f``, ``update.d.1``,
    ...). A subclass builds its own layers, then calls ``_build_heads``, so
    that seeded inits draw the parameters in the reference's order."""

    def __init__(self, p: int):
        super().__init__()
        cdim = 2 * 49 * p * p
        self.corr = nn.Sequential(
            nn.Linear(cdim, DIM), nn.ReLU(), nn.Linear(DIM, DIM),
            LayerNorm(DIM), nn.ReLU(), nn.Linear(DIM, DIM))
        self.norm = LayerNorm(DIM)
        self.c1 = MLP2(DIM)
        self.c2 = MLP2(DIM)
        self.agg_kk = SoftAgg(DIM)

    def _build_heads(self):
        self.d = nn.Sequential(nn.ReLU(), nn.Linear(DIM, 2))
        self.w = nn.Sequential(nn.ReLU(), nn.Linear(DIM, 2))

    def trunk(self, net, inp, corr, aux: UpdateAux, n_kseg: int):
        """net, inp (1, E, DIM); corr (1, E, 2*49*P*P) -> net (1, E, DIM)."""
        net = self.norm(net + inp + self.corr(corr))
        mask_ix = (aux.ix >= 0).to(net.dtype)[None, :, None]
        mask_jx = (aux.jx >= 0).to(net.dtype)[None, :, None]
        net = net + self.c1(mask_ix * net[:, aux.ix.clamp(min=0)])
        # c2 gathers from the net after the c1 message was added
        net = net + self.c2(mask_jx * net[:, aux.jx.clamp(min=0)])
        return net + self.agg_kk(net, aux.kseg, n_kseg, mask=aux.mask)

    def heads(self, net):
        """(delta, weight), each (1, E, 2)."""
        return gradient_clip(self.d(net)), torch.sigmoid(gradient_clip(self.w(net)))


class UpdateCDV(_UpdateTrunk):
    """CDV 'pa' update operator."""

    def __init__(self, p: int = 3):
        super().__init__(p)
        self.norm2 = LayerNorm(DIM)
        self.gatten = GatedAttention(DIM)
        self._build_heads()

    def forward(self, net, inp, corr, aux: UpdateAux, n_kseg: int, posenc=None):
        """net, inp (1, E, DIM); corr (1, E, 2*49*P*P); aux on net's device.
        Returns (net, d, w) with d, w of shape (1, E, 2)."""
        net = self.trunk(net, inp, corr, aux, n_kseg)
        G, M = aux.perm.shape
        E = net.shape[1]
        perm = aux.perm.reshape(-1).clamp(0, E - 1)
        tokens = self.norm2(net[0, perm].reshape(G, M, DIM))
        enc = None
        if posenc is not None:
            # (2, 1, 1, E, F) per edge -> group layout (2, G, 1, M, F)
            enc = posenc[:, 0, 0][:, perm].reshape(2, G, M, -1)[:, :, None]
        tokens = self.gatten(tokens, encoding=enc)
        net = tokens.reshape(G * M, DIM)[aux.inv_perm.clamp(0, G * M - 1)][None]
        return (net, *self.heads(net))


class UpdateDPV(_UpdateTrunk):
    """DPVO update operator: the trunk, SoftAgg over the (i,j) groups
    (``agg_ij``), then LayerNorm -> GatedResidual -> LayerNorm ->
    GatedResidual (``gru.0``-``gru.3``)."""

    def __init__(self, p: int = 3):
        super().__init__(p)
        self.agg_ij = SoftAgg(DIM)
        self.gru = nn.Sequential(LayerNorm(DIM), GatedResidual(DIM),
                                 LayerNorm(DIM), GatedResidual(DIM))
        self._build_heads()

    def forward(self, net, inp, corr, aux: UpdateAux, n_kseg: int, n_gseg: int):
        """As ``UpdateCDV.forward``, with aux.gseg the (i,j) group of each
        edge in [0, n_gseg). Returns (net, d, w)."""
        net = self.trunk(net, inp, corr, aux, n_kseg)
        net = net + self.agg_ij(net, aux.gseg, n_gseg, mask=aux.mask)
        net = self.gru(net)
        return (net, *self.heads(net))


def build_update_aux(ii, jj, kk, k0, n_kseg, M=None, n_gseg=None, E_pad=None):
    """Host-side (numpy) construction of UpdateAux from edge arrays; a copy
    of the JAX package's ``build_update_aux`` (``as_numpy=True`` form).

    ii/jj/kk: active edges (E,). k0: patch-window base. E_pad: pad to this
    many edges. M: patches per (i,j) group.
    """
    ii = np.asarray(ii)
    jj = np.asarray(jj)
    kk = np.asarray(kk)
    E = len(ii)
    E_pad = E_pad or E

    ix, jx = neighbors_np(kk, jj)

    kseg = np.clip(kk - k0, 0, None).astype(np.int32)
    kseg = np.where((kk - k0 >= 0) & (kk - k0 < n_kseg), kseg, n_kseg)

    gid_keys = ii.astype(np.int64) * 12345 + jj.astype(np.int64)
    uniq, gseg = np.unique(gid_keys, return_inverse=True)

    pad = E_pad - E

    def pade(a, fill):
        return np.concatenate([a, np.full(pad, fill, a.dtype)]) if pad else a

    mask = pade(np.ones(E, bool), False)
    ix = pade(ix, -1)
    jx = pade(jx, -1)
    kseg = pade(kseg.astype(np.int64), n_kseg)
    gseg_p = pade(gseg.astype(np.int64), (n_gseg if n_gseg else len(uniq)))

    perm = inv_perm = None
    if M is not None:
        if E % M != 0:
            raise ValueError(f"edge count {E} not a multiple of group size {M}")
        order = np.argsort(gid_keys, kind="stable")
        perm_v = np.sort(order.reshape(-1, M), axis=-1)
        Gv = perm_v.shape[0]
        G_pad = E_pad // M
        if G_pad > Gv:
            dummy = np.full((G_pad - Gv, M), E if pad else 0, np.int64)
            perm_p = np.concatenate([perm_v, dummy], 0)
        else:
            perm_p = perm_v
        inv = np.zeros(E_pad, np.int64)
        inv[perm_v.reshape(-1)] = np.arange(E)
        if pad:
            inv[E:] = np.arange(E, E_pad)
        perm, inv_perm = perm_p, inv

    return UpdateAux(
        ix=ix.astype(np.int32), jx=jx.astype(np.int32),
        kseg=kseg.astype(np.int32), gseg=gseg_p.astype(np.int32),
        perm=perm.astype(np.int32) if perm is not None else None,
        inv_perm=inv_perm.astype(np.int32) if inv_perm is not None else None,
        mask=mask,
    )

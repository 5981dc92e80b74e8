"""SLAM state: device buffers plus host edge bookkeeping
(port of ``cdvslam_tpu.slam.state``).

Everything is pre-allocated. Edge lists (ii/jj/kk) stay host-side numpy;
the per-edge hidden state ``net`` lives on the device, aligned with the
host edge order. The frame pyramids are stored channels-last
``(mem, H, W, C)``, the layout the correlation kernel reads.

Under loop closure (``keep_targets``) the graph also keeps each active
edge's last update target and weight, aligned the same way, and an
inactive store: the edges retired from the optimization window (host
indices, device target/weight), which the global BA solves over.
"""
from __future__ import annotations

import numpy as np
import torch


class PatchGraph:
    def __init__(self, cfg, P, DIM, DIMF, pmem, mem, ht4, wd4, device,
                 fdtype=torch.float32, gdtype=torch.float32, keep_targets=False):
        self.DIM = DIM
        self.M = M = cfg.PATCHES_PER_FRAME
        N = cfg.BUFFER_SIZE
        self.n = 0        # number of keyframes
        self.m = 0        # number of patches
        self.counter = 0  # all processed frames

        # geometry in gdtype, features and hidden state in fdtype
        fg = dict(dtype=gdtype, device=device)
        ff = dict(dtype=fdtype, device=device)
        self.tstamps_ = np.zeros(N, dtype=np.int64)
        self.poses_ = torch.zeros((N, 7), **fg)
        self.poses_[:, 6] = 1.0
        # frame f owns patch rows [f*M, (f+1)*M)
        self.patches_ = torch.zeros((N * M, 3, P, P), **fg)
        self.intrinsics_ = torch.zeros((N, 4), **fg)
        # feature ring buffers, indexed through the runtime's slot tables
        self.imap_ = torch.zeros((pmem * M, DIM), **ff)
        self.gmap_ = torch.zeros((pmem * M, DIMF, P, P), **ff)
        self.fmap1_ = torch.zeros((mem, ht4, wd4, DIMF), **ff)
        self.fmap2_ = torch.zeros((mem, ht4 // 4, wd4 // 4, DIMF), **ff)

        # active edges (host) and their hidden state (device)
        self.ii = np.zeros(0, np.int64)
        self.jj = np.zeros(0, np.int64)
        self.kk = np.zeros(0, np.int64)
        self.net = torch.zeros((0, DIM), **ff)

        # last update's target and weight per active edge, as (E, 4)
        # [target | weight], and the retired edges (loop closure only)
        self.keep_targets = keep_targets
        self.tw = torch.zeros((0, 4), **fg) if keep_targets else None
        self.ii_inac = np.zeros(0, np.int64)
        self.jj_inac = np.zeros(0, np.int64)
        self.kk_inac = np.zeros(0, np.int64)
        self._tw_inac = [torch.zeros((0, 4), **fg)] if keep_targets else []

        # relative poses of removed frames: t -> (t0, dP (7,) tensor)
        self.delta = {}

    @property
    def E(self):
        return len(self.ii)

    @property
    def tw_inac(self):
        """(E_inac, 4) [target | weight] of the inactive store."""
        if len(self._tw_inac) > 1:
            self._tw_inac = [torch.cat(self._tw_inac)]
        return self._tw_inac[0]

    def append_edges(self, ii, jj, kk):
        """Append edges; their hidden state (and target/weight) starts at 0."""
        self.ii = np.concatenate([self.ii, np.asarray(ii, np.int64)])
        self.jj = np.concatenate([self.jj, np.asarray(jj, np.int64)])
        self.kk = np.concatenate([self.kk, np.asarray(kk, np.int64)])
        pad = self.E - self.net.shape[0]
        self.net = torch.cat([self.net, self.net.new_zeros((pad, self.DIM))])
        if self.keep_targets:
            self.tw = torch.cat([self.tw, self.tw.new_zeros((pad, 4))])

    def remove_edges(self, gone, ii_post, jj_post, kk_post, retire=None):
        """Drop the edges where ``gone``; (ii/jj/kk)_post are the indices of
        every current edge after a keyframe removal's renumbering. Under
        ``keep_targets`` the edges where ``retire`` (a subset of ``gone``)
        move to the inactive store with their post indices."""
        gone = np.asarray(gone, bool)
        if self.keep_targets and retire is not None and retire.any():
            self.ii_inac = np.concatenate([self.ii_inac, ii_post[retire]])
            self.jj_inac = np.concatenate([self.jj_inac, jj_post[retire]])
            self.kk_inac = np.concatenate([self.kk_inac, kk_post[retire]])
            rows = torch.as_tensor(np.nonzero(retire)[0], device=self.tw.device)
            self._tw_inac.append(self.tw[rows])
        keep = np.nonzero(~gone)[0]
        self.ii, self.jj, self.kk = ii_post[keep], jj_post[keep], kk_post[keep]
        if len(keep) != self.net.shape[0]:
            rows = torch.as_tensor(keep, device=self.net.device)
            self.net = self.net[rows]
            if self.keep_targets:
                self.tw = self.tw[rows]

    def reindex_inactive(self, k):
        """Renumber the inactive store after keyframe row k is removed."""
        shift = self.ii_inac > k
        self.kk_inac = np.where(shift, self.kk_inac - self.M, self.kk_inac)
        self.ii_inac = np.where(shift, self.ii_inac - 1, self.ii_inac)
        self.jj_inac = np.where(self.jj_inac > k, self.jj_inac - 1, self.jj_inac)

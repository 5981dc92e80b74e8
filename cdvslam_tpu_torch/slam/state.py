"""SLAM state: device buffers plus host edge bookkeeping
(port of ``cdvslam_tpu.slam.state``).

Everything is pre-allocated, and every device buffer is written in place
and never replaced (``state()``), so that a captured CUDA graph keeps
reading and writing the live state. Edge lists (ii/jj/kk) stay host-side
numpy. The per-edge device state lives in buffers of ``cap`` rows, the
largest edge bucket so far (``bucket``: ``EDGE_BUCKETS``, then steps of
1,024, as the JAX package pads): the hidden state ``net`` and the last
update's target and weight ``tw_buf``. An update reads edge e's hidden
state from row ``net_src[e]`` (a new edge, -1, starts at 0) and writes
every edge's to row e. The frame pyramids are stored channels-last
``(mem, H, W, C)``, the layout the correlation kernel reads.

Under loop closure (``keep_targets``) the graph also keeps an inactive
store: the edges retired from the optimization window (host indices,
device target/weight), which the global BA solves over.
"""
from __future__ import annotations

import numpy as np
import torch

# the device buffers of ``PatchGraph.state``
STATE_BUFFERS = ("poses_", "patches_", "intrinsics_", "seg_", "colors_dev", "scale_",
                 "score_", "imap_", "gmap_", "fmap1_", "fmap2_", "net", "tw_buf")


class PatchGraph:
    def __init__(self, cfg, P, DIM, DIMF, pmem, mem, ht4, wd4, device,
                 fdtype=torch.float32, gdtype=torch.float32, keep_targets=False):
        self.DIM = DIM
        self.EDGE_BUCKETS = tuple(cfg.EDGE_BUCKETS)
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
        # per-patch seg class, per-frame depth anchor (the mean centre
        # inverse depth of the frame's new patches) and per-patch selection
        # score; the SLAM writes each only where its head or strategy is on
        self.seg_ = torch.zeros((N, M), dtype=torch.uint8, device=device)
        # per-patch colours: the network input's value at the patch centre
        # (device), and uint8 RGB on the host, filled by terminate()
        self.colors_dev = torch.zeros((N, M, 3), **fg)
        self.colors_ = np.zeros((N, M, 3), np.uint8)
        self.scale_ = torch.zeros(N, **fg)
        self.score_ = torch.ones(N * M, **fg)
        # feature ring buffers, indexed through the runtime's slot tables
        self.imap_ = torch.zeros((pmem * M, DIM), **ff)
        self.gmap_ = torch.zeros((pmem * M, DIMF, P, P), **ff)
        self.fmap1_ = torch.zeros((mem, ht4, wd4, DIMF), **ff)
        self.fmap2_ = torch.zeros((mem, ht4 // 4, wd4 // 4, DIMF), **ff)

        # active edges (host); their hidden state and the last update's
        # [target | weight] (device, cap rows); the net row of each edge
        self.ii = np.zeros(0, np.int64)
        self.jj = np.zeros(0, np.int64)
        self.kk = np.zeros(0, np.int64)
        self.net_src = np.zeros(0, np.int64)
        self.cap = 0
        self.net = torch.zeros((0, DIM), **ff)
        self.tw_buf = torch.zeros((0, 4), **fg)
        self.weights_current = False   # tw_buf holds the active edges' last update

        # the retired edges (loop closure only)
        self.keep_targets = keep_targets
        self.ii_inac = np.zeros(0, np.int64)
        self.jj_inac = np.zeros(0, np.int64)
        self.kk_inac = np.zeros(0, np.int64)
        self._tw_inac = [torch.zeros((0, 4), **fg)] if keep_targets else []

        # relative poses of removed frames: t -> (t0, dP (7,) tensor)
        self.delta = {}

    @property
    def E(self):
        return len(self.ii)

    def bucket(self, E):
        """The padded edge count of E edges: the first of EDGE_BUCKETS that
        holds them, else E rounded up to a multiple of 1,024."""
        for b in self.EDGE_BUCKETS:
            if E <= b:
                return b
        return -(E // -1024) * 1024

    def _grow(self, cap):
        """Make the per-edge buffers hold ``cap`` rows (they only grow; a
        new buffer has new addresses, so graphs over the old one are
        captured again)."""
        if cap <= self.cap:
            return
        for name in ("net", "tw_buf"):
            old = getattr(self, name)
            new = old.new_zeros((cap, old.shape[1]))
            new[: self.cap] = old
            setattr(self, name, new)
        self.cap = cap

    def state(self):
        """The device buffers a SLAM step reads and writes, by attribute
        name: written in place, never replaced (but ``_grow``)."""
        return {name: getattr(self, name) for name in STATE_BUFFERS}

    @property
    def weight(self):
        """The last update's (E, 2) weights while the edges are those it
        ran on (the web viewer reads them), else None."""
        return self.tw_buf[: self.E, 2:] if self.weights_current else None

    @property
    def tw(self):
        """Under ``keep_targets``: the last update's (E, 4) [target | weight]
        of the active edges (read after an update); else None."""
        return self.tw_buf[: self.E] if self.keep_targets else None

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
        self.net_src = np.concatenate([self.net_src, np.full(len(ii), -1, np.int64)])
        self.weights_current = False
        self._grow(self.bucket(self.E))

    def remove_edges(self, gone, ii_post, jj_post, kk_post, retire=None):
        """Drop the edges where ``gone``; (ii/jj/kk)_post are the indices of
        every current edge after a keyframe removal's renumbering. Under
        ``keep_targets`` the edges where ``retire`` (a subset of ``gone``)
        move to the inactive store with their post indices."""
        gone = np.asarray(gone, bool)
        if gone.any():
            self.weights_current = False
        if self.keep_targets and retire is not None and retire.any():
            self.ii_inac = np.concatenate([self.ii_inac, ii_post[retire]])
            self.jj_inac = np.concatenate([self.jj_inac, jj_post[retire]])
            self.kk_inac = np.concatenate([self.kk_inac, kk_post[retire]])
            src = self.net_src[retire]
            dev = self.tw_buf.device
            tw = self.tw_buf[torch.as_tensor(np.maximum(src, 0), device=dev)]
            if (src < 0).any():          # never updated: target and weight 0
                tw = torch.where(torch.as_tensor(src >= 0, device=dev)[:, None], tw, 0.0)
            self._tw_inac.append(tw)
        keep = np.nonzero(~gone)[0]
        self.ii, self.jj, self.kk = ii_post[keep], jj_post[keep], kk_post[keep]
        self.net_src = self.net_src[keep]

    def reindex_inactive(self, k):
        """Renumber the inactive store after keyframe row k is removed."""
        shift = self.ii_inac > k
        self.kk_inac = np.where(shift, self.kk_inac - self.M, self.kk_inac)
        self.ii_inac = np.where(shift, self.ii_inac - 1, self.ii_inac)
        self.jj_inac = np.where(self.jj_inac > k, self.jj_inac - 1, self.jj_inac)

"""The SLAM runtime (port of ``cdvslam_tpu.slam.runtime``).

``slam = SLAM(cfg, network, ht, wd); slam(t, image, intrinsics);
poses, tstamps = slam.terminate()``.

The port keeps the JAX runtime's semantics and leaves its TPU transport
behind: one update per steady-state frame, the keyframe decision applied
two frames after it was measured (keyed by physical frame id), the
12-update initialization at 8 frames, edge retirement, keyframe removal
with the relative-pose delta chain, and the 12-update termination with
pose interpolation. With ``LOOP_CLOSURE`` (the proximity backend) it also
adds loop edges every ``GLOBAL_OPT_FREQ`` keyframes, keeps the retired
edges, and runs the block-sparse global BA after an update that holds
long-range edges. Heavy work runs on ``device`` (the card unless the
caller asks for the CPU); edge lists and control flow stay on the host.

The seg and depth heads (``SEG_HEAD``, ``DEPTH_HEAD``: linear or DPT)
run on the frame's DINO tokens: under ``CENTROID_SEL_STRAT="SCORE"`` the
seg head's dynamic-class mask steers patch selection, under
``FILTER_DYNAMIC_CLASS`` edges on dynamic-class patches are down-weighted,
and a depth head initializes the patch depths and anchors the monocular
scale after each update.

``network="dpv"`` runs DPVO: the ``VONet`` encoders, RANDOM or
GRADIENT_BIAS selection, the ``UpdateDPV`` operator and K1 at 128
channels, with or without the proximity loop closure (DPV-SLAM). It has
no DINO tokens, so the heads are refused.

With ``CLASSIC_LOOP_CLOSURE`` the classical backend
(``loop.long_term.LongTermLoopClosure``: ORB + BoW retrieval, triplet
triangulation, a Sim3 PGO) indexes every frame and tries a closure after
each update; a backend that cannot be built raises. ``prefetch(image)``
starts a frame's upload to the device ahead of its ``__call__``.

Each frame also gathers its patches' colours into ``pg.colors_dev``
(converted to uint8 RGB in ``pg.colors_`` by ``terminate()``), and
``points()`` gives the patch-centre point cloud, which the writers of
``viz.plot`` and the viewers read. ``viz="snapshot"`` attaches the
headless ``viz.viewer.SnapshotViewer``, any other true ``viz`` the
browser viewer ``viz.web_viewer.WebViewer``; a viewer that cannot start
raises.

Tracing (``utils.trace``, on unless ``trace=False``): each ``__call__`` is
one ``frame`` span; on a steady frame its children are ``keyframe`` (the
lagged decision, edge retirement and the new edges; its child ``wait`` is
the host blocked on an earlier frame's motion), ``prepare`` (slots and the
index and float blocks), ``launch`` (the upload and the graph replay) or
``capture``, and ``after``. The device stamps the replay's stages and the
upload itself; the stamps are read at the end of each steady frame, once
their copy to the host has landed (the keyframe wait has already waited
for later work), and at ``terminate()``: no synchronisation of their own. ``stats`` counts
besides the aux-row cache's hits and misses, the keyframe shifts folded
into a replay or run eagerly, and the launches in the SLAM's calls of the
segment-sum kernel (``segsum_launches``) and of the BA iteration's kernels
(``ba_edges_launches``: a linearization and an update an iteration); a
replay adds what its capture launched; 0 on the CPU.
"""
from __future__ import annotations

import threading
from pathlib import Path
from warnings import warn

import numpy as np
import torch

from ..ba.global_ba import build_global_indices, global_ba_solve
from ..config import get_cfg
from ..geom import point_cloud
from ..lie import SE3, se3_identity, se3_inv, se3_mul
from ..loop.long_term import LongTermLoopClosure
from ..loop.proximity import edges_loop
from ..models import CDVNet, VONet, build_update_aux
from ..models.datamaps import ADE20K_INDEX_FILT
from ..models.dpt import DPTHead, resize
from ..models.heads import DepthHeadFlatten, SegHeadFlatten
from ..models.patchifier import (
    coords_grid_with_index, extract_patches, pyramidify, random_candidates, seg_binary_score,
    select_gradient_bias, select_random, select_random_grid, select_score,
)
from ..ops import ba_cuda, segsum_cuda
from ..ops.patchify import patchify
from ..utils import trace as tracing
from .fused import FrameInputs, FusedKey, FusedStep
from .kernels import (
    BLOCK_ROWS, SCALARS, dynamic_class_weight, edge_index, median, motion_extrapolate,
    scale_adjustment, shift_rows, update_body,
)
from .state import PatchGraph

# the heads' counters in ``SLAM.stats`` (a SLAM with a seg or depth head):
# SCORE's tokens and those of a dynamic class, the real edges the
# dynamic-class filter weighed and those it down-weighted, the scale
# adjustments and those whose rotation gate opened (rate not 1)
HEAD_COUNTERS = ("tokens", "dynamic_tokens", "edges", "edges_downweighted", "scale_calls",
                 "scale_gate_open")


def _unsupported(cfg, network):
    if network not in ("cdv", "dpv"):
        return f"network={network!r} (the port runs 'cdv' and 'dpv')"
    return None


def _head_set(value):
    """A SEG_HEAD / DEPTH_HEAD value that asks for a head."""
    return bool(value) and value != "None"


def _load_head(head, path):
    """A reference .pth (optionally a {"state_dict": ...} wrapper, keys
    optionally under ``decode_head.``) into ``head``."""
    if not Path(path).exists():
        raise FileNotFoundError(f"head checkpoint not found: {path}")
    ckpt = torch.load(path, map_location="cpu")
    if "state_dict" in ckpt:
        ckpt = ckpt["state_dict"]
    head.load_state_dict({k.removeprefix("decode_head."): v for k, v in ckpt.items()})


def resolve_device(device):
    """``device`` or, when None, the card; raises if there is no card."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on the CPU")
    return torch.device("cuda")


def _put(buf, rows, src):
    """buf[rows] = src in place, in buf's type (rows a 1-D index tensor)."""
    buf.index_copy_(0, rows, src.to(buf.dtype))


def _alloc_slot(table, n, cap):
    """A feature slot for frame row n: any slot not held by the last cap-1
    rows, rotating from the previous row's slot (a plain ring when no
    keyframe is removed)."""
    used = set(table[max(0, n - cap + 1): n].tolist())
    s = (int(table[n - 1]) + 1) % cap if n > 0 else 0
    while s in used:
        s = (s + 1) % cap
    return s


class SLAM:
    def __init__(self, cfg=None, network="cdv", ht=480, wd=640, viz=False,
                 seed=0, device=None, state_dict=None, patch_sampler=None,
                 dtype=None, score_noise=None, viewer_port=8642, trace=True):
        """``network``: "cdv" (CDVNet) or "dpv" (DPVO's VONet).
        ``state_dict``: the network's weights (e.g. ``models.convert.
        load_flax_params`` or ``vonet_state``); random weights from
        ``seed`` when None.
        ``patch_sampler(counter) -> (candidates (K, 2), init_depth (M,))``
        replaces the seeded draw of the patch centres (x, y) and the
        pre-init random depths: the M centres under RANDOM_GRID and RANDOM,
        the 3M candidates GRADIENT_BIAS picks from (under SCORE only its
        depths are used). Selection follows the JAX package: under "cdv"
        SCORE, RANDOM, and RANDOM_GRID for anything else; under "dpv"
        GRADIENT_BIAS, and RANDOM for anything else.
        ``score_noise(counter) -> (hi*wi,) uniforms in [1e-12, 1)``
        replaces the seeded draw of SCORE's Gumbel noise.
        ``viewer_port``: the web viewer's loopback port (0 takes a free one).
        ``trace``: keep this SLAM's spans, counters and device stamps
        (``utils.trace``); False records nothing.
        ``dtype``: one float type for the networks and the geometry, on the
        CPU only (float64 gives a high-precision run to hold float32 runs
        against); None: bfloat16 networks under MIXED_PRECISION, else
        float32, and float32 geometry; the heads run in the geometry's type.

        Heads: SEG_HEAD / DEPTH_HEAD name a reference checkpoint (.pth), or
        "random" (and, for the depth head, "dpt" or "dpt_random") for
        seeded random weights; a DEPTH_HEAD containing "dpt" is the DPT
        head. A missing checkpoint raises ``FileNotFoundError``. SCORE
        needs the seg head (``ValueError`` without it). Under "dpv" a head
        or FILTER_DYNAMIC_CLASS raises ``ValueError``."""
        self.cfg = cfg if cfg is not None else get_cfg()
        why = _unsupported(self.cfg, network)
        if why is not None:
            raise NotImplementedError(f"not in the ported slice: {why}")
        if ht % 16 or wd % 16:
            raise ValueError("image dims must be multiples of 16")
        self.device = resolve_device(device)
        if self.device.type == "cuda" and dtype is not None:
            raise NotImplementedError("dtype is only ported for the CPU")
        self.trace = tracing.new_record(self, self.device) if trace else tracing.OFF
        with self.trace.span("construct"):
            self._construct(network, ht, wd, viz, seed, state_dict, patch_sampler, dtype,
                            score_noise, viewer_port)

    def _construct(self, network, ht, wd, viz, seed, state_dict, patch_sampler, dtype,
                   score_noise, viewer_port):
        self.trace.start_stamps(self.device)
        self.network = network
        self.ht, self.wd = ht, wd
        self.is_initialized = False

        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            model = CDVNet() if network == "cdv" else VONet()
        if state_dict is None:
            warn("Network initialized with RANDOM weights (no checkpoint).")
        else:
            model.load_state_dict(state_dict)
        self.fdtype = dtype or (torch.bfloat16 if self.cfg.MIXED_PRECISION else torch.float32)
        self.gdtype = dtype or torch.float32
        self.model = model.to(device=self.device, dtype=self.fdtype).eval()

        self.P, self.DIM, self.DIMF, self.RES = model.P, model.DIM, model.DIMF, model.RES
        self.M = self.cfg.PATCHES_PER_FRAME
        self.N = self.cfg.BUFFER_SIZE
        self.pmem = self.mem = 36
        if self.cfg.LOOP_CLOSURE:
            # loop edges reach MAX_EDGE_AGE frames back into the patch rings
            self.pmem = min(self.cfg.MAX_EDGE_AGE, self.N)
        self.ht4, self.wd4 = ht // self.RES, wd // self.RES
        self.hi, self.wi = -(-ht // 14), -(-wd // 14)
        self.pg = PatchGraph(self.cfg, self.P, self.DIM, self.DIMF, self.pmem,
                             self.mem, self.ht4, self.wd4, self.device, self.fdtype,
                             self.gdtype, keep_targets=self.cfg.LOOP_CLOSURE)
        self.KWIN = (self.cfg.REMOVAL_WINDOW + 6) * self.M
        self.NW = self.cfg.POSE_WINDOW
        # frame row -> feature ring slot (fmap pyramids; imap/gmap patch rows)
        self.fslot_rows = np.zeros(self.N, np.int64)
        self.pslot_rows = np.zeros(self.N, np.int64)

        self.generator = torch.Generator().manual_seed(seed)
        self.patch_sampler = patch_sampler or self._sample_patches
        self.score_noise = score_noise or self._score_noise
        self._setup_heads()
        self.tlist = []
        self.stats = {"updates": 0, "keyframe_removals": 0, "loop_edges": 0,
                      "global_ba": 0, "lc_attempts": 0, "lc_applied": 0,
                      "prep_cache_hits": 0, "prep_cache_misses": 0,
                      "shifts_deferred": 0, "shifts_eager": 0, "segsum_launches": 0,
                      "ba_edges_launches": 0}
        if self._tally is not None:
            self.stats.update(dict.fromkeys(HEAD_COUNTERS, 0))
        if self.trace.on:
            self.trace.stats = self.stats
        self._kf_queue = []   # lagged keyframe decisions (frame id, mm)
        # a keyframe removal whose device rows have not moved yet:
        # (row k, frame count before it, its id, the id of row k - 1)
        self._pending_shift = None
        self._prep_cache = {}         # _prepare_update's shift-invariant rows
        self.fused = FusedStep(self)
        self.last_global_ba = -1000   # n when loop edges were last added
        self.ran_global_ba = set()    # keyframe counts n that ran a global BA
        self._prefetched = {}         # id(image) -> (image, device frame, upload event)
        self._prefetch_lock = threading.Lock()
        self._upload_stream = None
        self._prefetched_frame = None   # whether the last frame taken was prefetched
        # the JAX package warns and runs without a backend it cannot build;
        # the port raises (a missing cv2, a failed build of the library)
        self.long_term_lc = (LongTermLoopClosure(self.cfg, self)
                             if self.cfg.CLASSIC_LOOP_CLOSURE else None)
        # the JAX package falls back to snapshots when the web viewer
        # fails to start; the port raises
        self.viewer = None
        if viz == "snapshot":
            from ..viz.viewer import SnapshotViewer
            self.viewer = SnapshotViewer(self)
        elif viz:
            from ..viz.web_viewer import WebViewer
            self.viewer = WebViewer(self, port=viewer_port)

    def _setup_heads(self):
        """The seg and depth heads, in the geometry's type on the device:
        seeded random weights or a reference checkpoint. The seg seed (14)
        gives about a fifth of the tokens a dynamic class on the random
        network's tokens at 480 x 752; seed 11 gives none."""
        cfg = self.cfg
        self.seg_head = self.depth_head = self.filt_index = self._tally = None
        self.depth_is_dpt = _head_set(cfg.DEPTH_HEAD) and "dpt" in cfg.DEPTH_HEAD
        if self.network == "dpv":
            # the JAX package sets the heads up for CDV only and ignores them here
            if _head_set(cfg.SEG_HEAD) or _head_set(cfg.DEPTH_HEAD) or cfg.FILTER_DYNAMIC_CLASS:
                raise ValueError("the DPVO network has no DINO tokens: SEG_HEAD, DEPTH_HEAD "
                                 "and FILTER_DYNAMIC_CLASS need network='cdv'")
            return
        if cfg.CENTROID_SEL_STRAT == "SCORE" and not _head_set(cfg.SEG_HEAD):
            raise ValueError("SCORE selection needs a seg head (SEG_HEAD); the port "
                             "builds no score head")
        heads = []
        if _head_set(cfg.SEG_HEAD):
            heads.append(("seg_head", SegHeadFlatten, cfg.SEG_HEAD, ("random",), 14))
        if _head_set(cfg.DEPTH_HEAD):
            heads.append(("depth_head", DPTHead if self.depth_is_dpt else DepthHeadFlatten,
                          cfg.DEPTH_HEAD, ("dpt", "dpt_random") if self.depth_is_dpt
                          else ("random",), 12))
        for attr, cls, value, random_names, head_seed in heads:
            with torch.random.fork_rng(devices=[]):
                torch.manual_seed(head_seed)
                head = cls()
            if value not in random_names:
                _load_head(head, value)
            setattr(self, attr, head.to(device=self.device, dtype=self.gdtype).eval())
        if self.seg_head is not None:
            self.filt_index = torch.tensor(ADE20K_INDEX_FILT, device=self.device)
        if self.depth_head is not None:
            self.scale_factor = self.depth_head.max_depth / 4.0
        if heads:
            # HEAD_COUNTERS as device tallies: added to inside the step (a
            # replay adds them again), read at terminate()
            self._tally = torch.zeros(len(HEAD_COUNTERS), dtype=torch.int64, device=self.device)

    # ------------------------------------------------------------------
    def _score_noise(self, counter):
        return torch.rand(self.hi * self.wi, generator=self.generator).clamp(min=1e-12)

    def _sample_patches(self, counter):
        """The seeded draw of the frame's candidate centres (see
        ``patch_sampler``) and pre-init depths."""
        strat, M = self.cfg.CENTROID_SEL_STRAT, self.M
        if self.network == "dpv" or strat == "RANDOM":
            K = 3 * M if self.network == "dpv" and strat == "GRADIENT_BIAS" else M
            coords = select_random(*random_candidates(self.generator, 1, K, self.ht4,
                                                      self.wd4))[0]
        else:
            coords = select_random_grid(
                self.generator, 1, M, self.hi, self.wi, self.P, 4.0 / 14.0,
                self.cfg.CENTROID_SAMPLE_STRAT == "UPPERLEFT")[0]
        return coords, torch.rand(M, generator=self.generator)

    def _alloc_frame_slots(self, n):
        fs = _alloc_slot(self.fslot_rows, n, self.mem)
        ps = _alloc_slot(self.pslot_rows, n, self.pmem)
        self.fslot_rows[n], self.pslot_rows[n] = fs, ps
        return fs, ps

    def _patches_cdv(self, st, img, cand, n, noise):
        """CDVNet's features and patches of one frame (img (H, W, 3) float on
        the device, cand the sampler's centres, noise SCORE's uniforms):
        the fmap (1, 24, h, w), the context rows (1, M, 384), gmap (1, M, 24,
        P, P), the patch row (M, 3, P, P) and the patch colours (1, M, 3)
        bilinear from the network's input image at full resolution; writes
        the seg and score rows of frame row n (a 0-d tensor) into ``st``."""
        cfg, M, P = self.cfg, self.M, self.P
        dev, gd = self.device, self.gdtype
        image_f32 = (img / 255.0)[None]
        image_c = image_f32.to(self.fdtype)
        fmap = self.model.features_f(image_c)                        # (1,C,hf,wf)
        tmap, tokens, raw, cls, _, taps = self.model.features_i_taps(image_c)
        _, _, hf, wf = fmap.shape
        hi, wi = tmap.shape[2:]

        upperleft = cfg.CENTROID_SAMPLE_STRAT == "UPPERLEFT"
        coords = cand
        if cfg.CENTROID_SEL_STRAT == "SCORE":
            # seg-filtered selection: static interior tokens score 1
            self._stamp(8)
            dyn = self.seg_head.filt_mask(tokens[0].to(gd), self.filt_index)
            self._count("tokens", dyn.numel())
            self._count("dynamic_tokens", dyn.sum())
            coords, score_row = select_score(noise.reshape(1, hi * wi),
                                             seg_binary_score(dyn, 1, hi, wi), M, 4.0 / 14.0,
                                             upperleft)
            _put(st["score_"], n * M + torch.arange(M, device=dev), score_row)
            self._stamp(9)
        coords = coords.reshape(1, M, 2)
        ictx = patchify(tmap, (4.0 / 14.0) * coords, 0,
                        mode="upperleft" if upperleft else "bilinear")[..., 0, 0]
        ictx = self.model.adapt(ictx)
        if self.seg_head is not None:
            self._stamp(10)
            _put(st["seg_"], n.reshape(1), self.seg_head.seg_class((ictx[0] * 4.0).to(gd))[None])
            self._stamp(11)
        gmap = patchify(fmap, coords, P // 2, mode="bilinear")
        clr = patchify(image_f32.permute(0, 3, 1, 2), 4 * (coords + 0.5), 0,
                       mode="bilinear")[..., 0, 0]
        if self.depth_head is not None:
            self._stamp(12)
            if self.depth_is_dpt:
                dm = self.depth_head([(t.to(gd), c.to(gd)) for t, c in taps])[:, 0]
            else:
                # the linear head reads the raw last-layer tokens and cls
                tok = torch.cat([raw[0].to(gd), cls.to(gd).expand(hi * wi, -1)], -1)
                dm = self.depth_head(tok)[:, 0].reshape(1, hi, wi)
            dm = (dm / self.scale_factor).clamp(min=1e-3)
            disps = resize((1.0 / dm)[None], (hf, wf))[0]
        else:
            disps = torch.ones((1, hf, wf), dtype=gd, device=dev)
        grid = coords_grid_with_index(disps[None])[0]
        patch_row = patchify(grid, coords, P // 2, mode="bilinear")[0]
        if self.depth_head is not None:
            self._stamp(13)
        return fmap, ictx, gmap, patch_row, clr

    def _patches_dpv(self, img, cand):
        """VONet's features and patches of one frame, as ``_patches_cdv``
        (128 matching channels). The gradient and the gathers run in the
        networks' type, as in the JAX package (the grid's x and y are
        exact there: integer centres, coordinates below 256)."""
        M, P = self.M, self.P
        image = VONet.preprocess(img)[None].to(self.fdtype)
        fmap, imap = self.model.features(image)
        if self.cfg.CENTROID_SEL_STRAT == "GRADIENT_BIAS":
            coords = select_gradient_bias(cand[None, :, 0].long(), cand[None, :, 1].long(),
                                          image[None], M)
        else:
            coords = cand.reshape(1, M, 2)
        disps = torch.ones((1, *fmap.shape[2:]), dtype=fmap.dtype, device=self.device)
        gmap, ictx, clr, patches = extract_patches(fmap, imap, image, disps, coords, P)
        return fmap, ictx, gmap, patches[0].to(self.gdtype), clr

    def prefetch(self, image):
        """Start the upload of a future frame: a copy to the device on an
        upload stream, which waits only for that copy, where the plain call's
        copy waits for all the frame work queued before it. CUDA stages
        the pageable array itself: a copy into pinned memory first costs
        the host more than the whole plain upload. Pass the same array
        to ``__call__`` later; it may be called from another thread than
        ``__call__`` (a reader thread). At most 4 uploads are kept, keyed by
        ``id(image)`` (each entry holds the array, so its id is not reused
        while it waits); on the CPU it is a plain copy."""
        with self.trace.span("prefetch"):
            host = torch.from_numpy(np.asarray(image))
            if self.device.type != "cuda":
                frame, ready = host.clone(), None
            else:
                if self._upload_stream is None:
                    self._upload_stream = torch.cuda.Stream(self.device)
                with torch.cuda.stream(self._upload_stream):
                    frame = host.to(self.device, non_blocking=True)
                    ready = torch.cuda.Event()
                    ready.record()
            with self._prefetch_lock:
                self._prefetched[id(image)] = (image, frame, ready)
                if len(self._prefetched) > 4:
                    self._prefetched.pop(next(iter(self._prefetched)))

    def _frame_on_device(self, image):
        """The frame as a tensor on the device: its prefetched upload (the
        main stream waits on it), else a copy made now. The device stamps
        the upload (slots 6 and 7 of the frame's row): the plain copy, or
        the main stream's wait on the prefetched one."""
        tr = self.trace
        with tr.span("upload") as sp:
            with self._prefetch_lock:
                _, frame, ready = self._prefetched.pop(id(image), (None, None, None))
            self._prefetched_frame = frame is not None
            sp.set(prefetched=self._prefetched_frame)
            self._stamp(6)
            if frame is None:
                frame = torch.as_tensor(np.asarray(image)).to(self.device)
            elif ready is not None:
                main = torch.cuda.current_stream(self.device)
                main.wait_event(ready)
                frame.record_stream(main)
            self._stamp(7)
        return frame

    def _n_candidates(self):
        """Centres the patch sampler draws: 3M under DPVO's GRADIENT_BIAS,
        else M."""
        gb = self.network == "dpv" and self.cfg.CENTROID_SEL_STRAT == "GRADIENT_BIAS"
        return 3 * self.M if gb else self.M

    def _host_floats(self, intrinsics, fac, counter):
        """The frame's float inputs, drawn on the host, as one float64
        array: intrinsics / RES (4), MOTION_DAMPING * fac, the sampler's
        centres and pre-init depths, and SCORE's uniforms (in that order,
        the order the generator draws them)."""
        cand, drand = self.patch_sampler(counter)
        parts = [np.asarray(intrinsics, np.float64) / self.RES,
                 [self.cfg.MOTION_DAMPING * fac],
                 np.asarray(cand, np.float32).reshape(-1),
                 np.asarray(drand, np.float32).reshape(-1)]
        if self.network == "cdv" and self.cfg.CENTROID_SEL_STRAT == "SCORE":
            parts.append(np.asarray(self.score_noise(counter), np.float32).reshape(-1))
        return np.concatenate([np.asarray(a, np.float64).reshape(-1) for a in parts])

    @staticmethod
    def _host_ints(rows, **scalars):
        """One flat int32 array: the index rows, then ``SCALARS`` (0 where
        not given)."""
        tail = np.array([scalars.get(name, 0) for name in SCALARS], np.int32)
        return np.concatenate([rows.reshape(-1).astype(np.int32), tail])

    def _upload(self, a):
        """A host array on the device (through pinned memory, not waiting,
        on the card)."""
        t = torch.from_numpy(a)
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _insert_frame(self, st, inp: FrameInputs, initialized):
        """Features, patch selection and gathers, the heads, motion model,
        depth init, and the writes of frame row n into the state dict
        ``st``. Every row and slot comes from ``inp`` as a device scalar, so
        the steady-state step runs this inside its CUDA graph."""
        cfg, M, P = self.cfg, self.M, self.P
        dev, gd = self.device, self.gdtype
        ints = inp.ints[-len(SCALARS):].long()
        n, fs, ps = (ints[SCALARS.index(name)] for name in ("n", "fs", "ps"))
        n1 = n.reshape(1)
        K = self._n_candidates()
        fl = inp.floats
        intr, dfac = fl[:4].to(gd), fl[4].to(gd)
        cand = fl[5:5 + 2 * K].to(torch.float32).view(K, 2)
        drand = fl[5 + 2 * K:5 + 2 * K + M].to(torch.float32)
        noise = fl[5 + 2 * K + M:].to(torch.float32)
        img = inp.image.float()
        if self.network == "dpv":
            fmap, ictx, gmap, patch_row, clr = self._patches_dpv(img, cand)
        else:
            fmap, ictx, gmap, patch_row, clr = self._patches_cdv(st, img, cand, n, noise)
        self._stamp(2)
        _put(st["colors_dev"], n1, clr)
        _put(st["intrinsics_"], n1, intr[None])
        _put(st["poses_"], n1, motion_extrapolate(st["poses_"], n, dfac)[None])
        if self.depth_head is not None:
            _put(st["scale_"], n1, patch_row[:, 2, P // 2, P // 2].mean()[None])
        elif initialized:
            # median inverse depth of the last three frames
            three = torch.minimum((n - 3).clamp(min=0) + torch.arange(3, device=dev),
                                  (n - 1).clamp(min=0))
            rows = (three[:, None] * M + torch.arange(M, device=dev)).reshape(-1)
            patch_row[:, 2] = median(st["patches_"].index_select(0, rows)[:, 2].reshape(-1))
        else:
            patch_row[:, 2] = drand[:, None, None]
        arange_m = torch.arange(M, device=dev)
        _put(st["patches_"], n * M + arange_m, patch_row)
        _put(st["imap_"], ps * M + arange_m, ictx[0])
        _put(st["gmap_"], ps * M + arange_m, gmap[0])
        fs1 = fs.reshape(1)
        _put(st["fmap1_"], fs1, fmap.permute(0, 2, 3, 1))
        _put(st["fmap2_"], fs1, pyramidify(fmap, (4,))[0].permute(0, 2, 3, 1))
        self._stamp(3)

    # ------------------------------------------------------------------
    def _edges_forw(self):
        r, n, M = self.cfg.PATCH_LIFETIME, self.pg.n, self.M
        kk = np.arange(M * max(n - r, 0), M * max(n - 1, 0))
        return kk, np.full(len(kk), n - 1)

    def _edges_back(self):
        r, n, M = self.cfg.PATCH_LIFETIME, self.pg.n, self.M
        kk, jj = np.meshgrid(np.arange(M * max(n - 1, 0), M * n),
                             np.arange(max(n - r, 0), n), indexing="ij")
        return kk.reshape(-1), jj.reshape(-1)

    def _append_factors(self):
        for kk, jj in (self._edges_forw(), self._edges_back()):
            self.pg.append_edges(kk // self.M, jj, kk)

    def _add_loop_edges(self):
        """Loop-closure candidates every GLOBAL_OPT_FREQ keyframes (after a
        deferred keyframe shift has landed: edges_loop reads frame rows)."""
        cfg, pg = self.cfg, self.pg
        if not cfg.LOOP_CLOSURE or pg.n - self.last_global_ba < cfg.GLOBAL_OPT_FREQ:
            return
        self._apply_pending_shift()
        kk, jj = edges_loop(pg, cfg)
        if len(kk):
            self.last_global_ba = pg.n
            self.stats["loop_edges"] += len(kk)
            pg.append_edges(kk // self.M, jj, kk)

    def _kwin_for_span(self, span_frames):
        """Patch-window rows: the default for local edges, a power-of-two
        number of frames (at least 64, at most the buffer) once loop edges
        widen the span."""
        if span_frames <= self.cfg.REMOVAL_WINDOW + 6:
            return self.KWIN
        b = 64
        while b < span_frames + 2:
            b *= 2
        return min(b, self.N) * self.M

    def patch_window(self, kk):
        """(k0, KWIN): the first patch row and the row count of the window
        that holds every patch in kk. KWIN is chosen first, so clamping k0
        to the buffer's end never pushes an edge's patch out of it."""
        M = self.M
        k0 = int(kk.min()) // M * M
        KWIN = self._kwin_for_span((int(kk.max()) - k0) // M + 1)
        return min(k0, self.N * M - KWIN), KWIN

    def _prepare_update(self, ii, jj, kk, E_pad, net_src):
        """Host index prep of one update over E_pad padded edges: (k0, KWIN,
        rows), rows the (len(BLOCK_ROWS), E_pad) int32 block. Padded edges
        read row 0 everywhere, are masked (``mask``), drop out of the
        patch and group segments, and start from a zero hidden state.

        The sort- and unique-heavy rows (neighbours, segments, the CDV
        group permutation, the mask) are cached under a key that does not
        change when the whole edge pattern moves by whole frames, as the
        JAX package's ``_prepare_update`` does; the frame, window and slot
        rows are rebuilt every call."""
        M = self.M
        k0, KWIN = self.patch_window(kk)
        E = len(ii)
        rel = np.stack([ii - ii[0], jj - jj[0], kk - kk[0]])
        key = (E_pad, KWIN, int(kk.min()) - k0, rel.tobytes())
        aux_rows = self._prep_cache.get(key)
        self.stats["prep_cache_hits" if aux_rows is not None else "prep_cache_misses"] += 1
        if aux_rows is None:
            cdv = self.network == "cdv"
            aux = build_update_aux(ii, jj, kk, k0, KWIN, M=M if cdv else None, n_gseg=E_pad,
                                   E_pad=E_pad)
            # the group permutation fills (E_pad // M) * M entries
            perm = np.zeros(E_pad, np.int32)
            if cdv:
                perm[: aux.perm.size] = aux.perm.reshape(-1)
            aux_rows = np.stack([aux.ix, aux.jx, aux.kseg, aux.gseg, perm,
                                 aux.inv_perm if cdv else np.zeros(E_pad, np.int32),
                                 aux.mask]).astype(np.int32)
            if len(self._prep_cache) >= 64:       # at most 64 edge patterns
                self._prep_cache.pop(next(iter(self._prep_cache)))
            self._prep_cache[key] = aux_rows

        def padded(a, fill=0):
            return np.concatenate([a, np.full(E_pad - E, fill, np.int64)])

        rows = np.empty((len(BLOCK_ROWS), E_pad), np.int32)
        rows[0], rows[1], rows[2] = padded(ii), padded(jj), padded(kk - k0)
        rows[3] = padded(self.pslot_rows[kk // M] * M + kk % M)
        rows[4] = padded(self.fslot_rows[jj])
        rows[5:12] = aux_rows
        rows[12] = padded(net_src, -1)
        return k0, KWIN, rows

    def _update_step(self, st, inp: FrameInputs, key: FusedKey):
        """One update over the edges of ``inp`` (update_body), written back
        into ``st``: the poses, the patch window, each edge's hidden state
        and its target and weight. The weights take the dynamic-class
        factors (under FILTER_DYNAMIC_CLASS with a seg head) and the patch
        scores (under SCORE). Returns mm."""
        E_pad, KWIN, dev = key.E_pad, key.KWIN, self.device
        idx, s = edge_index(inp.ints, E_pad, self.M if self.network == "cdv" else None)
        win = s["k0"] + torch.arange(KWIN, device=dev)
        src = idx.net_src
        net = st["net"].index_select(0, src.clamp(min=0))
        net = torch.where((src >= 0)[:, None], net, torch.zeros_like(net))
        weight_mul = score_win = None
        if self.cfg.FILTER_DYNAMIC_CLASS and self.seg_head is not None:
            weight_mul = dynamic_class_weight(st["seg_"], self.filt_index,
                                              idx.kk_local + s["k0"])
            self._count("edges", idx.aux.mask.sum())
            self._count("edges_downweighted", ((weight_mul[:, 0] < 1) & idx.aux.mask).sum())
        if self.network == "cdv" and self.cfg.CENTROID_SEL_STRAT == "SCORE":
            score_win = st["score_"].index_select(0, win)
        poses, patches_win, net, target, weight, _, mm = update_body(
            self.model, st["poses_"], st["patches_"].index_select(0, win), st["intrinsics_"],
            st["imap_"], st["gmap_"], st["fmap1_"], st["fmap2_"], net, idx, s["t0"],
            float(self.ht4), float(self.wd4), (s["mi"], s["mj"]), weight_mul, score_win,
            NW=self.NW, KWIN=KWIN, iterations=key.iterations, stamp=self._stamp)
        st["poses_"].copy_(poses)
        _put(st["patches_"], win, patches_win)
        st["net"][:E_pad] = net
        st["tw_buf"][:E_pad] = torch.cat([target, weight], 1)
        return mm

    def _stamp(self, slot, advance=False):
        """The tracer's device stamp (``utils.trace``), except in a run of
        the step that is not the program's (``FusedStep.off_path``)."""
        if not self.fused.off_path:
            self.trace.stamp(slot, advance)

    def _count(self, name, value):
        """Add ``value`` (an int or a 0-d device tensor) to the heads'
        device tally ``name`` (``HEAD_COUNTERS``), except off the path."""
        if not self.fused.off_path:
            self._tally[HEAD_COUNTERS.index(name)].add_(value)

    def _row_stages(self, kind, key=None):
        """The device stages of a row of ``kind`` (``utils.trace.
        row_stages``): the heads' where this SLAM runs them, the scale
        adjustment in a replay whose key runs no global BA after it."""
        return tracing.row_stages(
            kind, select=self.cfg.CENTROID_SEL_STRAT == "SCORE" and self.seg_head is not None,
            seg=self.seg_head is not None, depth=self.depth_head is not None,
            scale=self.depth_head is not None and key is not None and key.iterations > 0)

    def _adjust_scale(self, st, t0, n):
        """The depth head's scale adjustment over frames [t0, n) of the
        state dict ``st`` (``kernels.scale_adjustment``, its window the
        OPTIMIZATION_WINDOW frames an update's t0 leaves), counted."""
        _, _, rate = scale_adjustment(st["poses_"], st["patches_"], st["scale_"], t0, n, 0.2,
                                      self.M, self.cfg.OPTIMIZATION_WINDOW)
        self._count("scale_calls", 1)
        self._count("scale_gate_open", rate != 1)

    def _key(self, E_pad, KWIN, iterations, shift_span=0):
        return FusedKey(E_pad, KWIN, iterations, shift_span, self.network, self.fdtype)

    def _long_range(self):
        """Loop edges in the active set and no global BA yet at this
        keyframe count: the update runs no local BA, the global BA follows."""
        pg = self.pg
        return (bool((pg.ii < pg.n - self.cfg.REMOVAL_WINDOW - 1).any())
                and pg.n not in self.ran_global_ba)

    def _after_update(self, t0, long_range, scaled=False):
        """The edges now hold the update's state; then the global BA (long
        range) or, with a depth head, the scale adjustment, eagerly (unless
        ``scaled``: the steady step ran it)."""
        pg = self.pg
        pg.net_src = np.arange(pg.E)
        pg.weights_current = True
        if long_range:
            self._run_global_ba()
        elif self.depth_head is not None and not scaled:
            self._adjust_scale(pg.state(), t0, pg.n)

    def update(self):
        """One eager update of the active edges (the initialization's and
        termination's; steady-state frames run ``_fused_frame_update``);
        returns the keyframe motion magnitudes (2,) measured on the poses
        after the local BA. With long-range (loop) edges and no global BA
        yet at this keyframe count, the update runs no local BA and the
        global BA follows it; otherwise, with a depth head, the scale
        adjustment follows it."""
        cfg, pg, tr = self.cfg, self.pg, self.trace
        if pg.E == 0:
            return None
        with tr.span("update"):
            self.stats["updates"] += 1
            t0 = max(pg.n - cfg.OPTIMIZATION_WINDOW, 1)
            long_range = self._long_range()
            E_pad = pg.bucket(pg.E)
            k0, KWIN, rows = self._prepare_update(pg.ii, pg.jj, pg.kk, E_pad, pg.net_src)
            ints = self._host_ints(rows, t0=t0, k0=k0, mi=pg.n - cfg.KEYFRAME_INDEX - 1,
                                   mj=pg.n - cfg.KEYFRAME_INDEX + 1)
            self._stamp(0)
            mm = self._update_step(pg.state(), FrameInputs(None, self._upload(ints), None),
                                   self._key(E_pad, KWIN, 0 if long_range else 2))
            self._stamp(5, advance=True)
            tr.row_done("update", pg.counter)
            self._after_update(t0, long_range)
        return mm

    def _fused_frame_update(self, image, n_row, fac, intrinsics, counter):
        """The steady-state step of frame row n_row (edges already
        appended): the deferred keyframe shift, the frame insert and the
        update (and, with a depth head and no global BA to follow, the scale
        adjustment) as ``fused.fused_body``, in one CUDA graph replay on the
        card (``fused.FusedStep``); then, eagerly, the global BA. Returns mm."""
        cfg, pg, tr = self.cfg, self.pg, self.trace
        with tr.span("prepare"):
            self.stats["updates"] += 1
            t0 = max(pg.n - cfg.OPTIMIZATION_WINDOW, 1)
            long_range = self._long_range()
            span, shift_k, pend = 0, 0, self._pending_shift
            if pend is not None:
                k, n_before, t1, t0d = pend
                if 1 <= n_before - 1 - k <= cfg.KEYFRAME_INDEX + 2:
                    span, shift_k, self._pending_shift = n_before - 1 - k, k, None
                    self.stats["shifts_deferred"] += 1
                else:
                    self._apply_pending_shift()     # out of band: eagerly, as JAX does
            fs, ps = self._alloc_frame_slots(n_row)
            E_pad = pg.bucket(pg.E)
            k0, KWIN, rows = self._prepare_update(pg.ii, pg.jj, pg.kk, E_pad, pg.net_src)
            ints = self._host_ints(rows, n=n_row, fs=fs, ps=ps, t0=t0, k0=k0,
                                   mi=pg.n - cfg.KEYFRAME_INDEX - 1,
                                   mj=pg.n - cfg.KEYFRAME_INDEX + 1, shift_k=shift_k)
            floats = self._host_floats(intrinsics, fac, counter)
            key = self._key(E_pad, KWIN, 0 if long_range else 2, span)
        captures = self.fused.captures
        with tr.span("launch") as sp:
            mm, dP = self.fused.run(key, self._frame_on_device(image), ints, floats)
            if self.fused.captures != captures:
                sp.rename("capture")
        tr.root().set(steady=self.fused.captures == captures, E=pg.E, E_pad=E_pad)
        with tr.span("after"):
            if span:
                pg.delta[t1] = (t0d, dP.clone())
            self._after_update(t0, long_range, scaled=True)
            return self._keep_mm(mm, counter)

    def _keep_mm(self, mm, frame):
        """mm kept for the lagged keyframe decision: on the card a pinned
        host copy made without waiting, the event that marks it done (the
        graph's output is overwritten by the next replay) and the frame."""
        if self.device.type != "cuda":
            return mm
        host = torch.empty(mm.shape, dtype=mm.dtype, pin_memory=True)
        host.copy_(mm, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return host, done, frame

    # ------------------------------------------------------------------
    def normalize(self):
        """Mean inverse depth of the kept patches to 1 and pose 0 to the
        identity; the delta chain's translations scale with the depths."""
        pg, n, M = self.pg, self.pg.n, self.M
        if n == 0:
            return
        s = float(pg.patches_[: n * M, 2].mean())
        if not np.isfinite(s) or s <= 0:
            return
        pg.patches_[: n * M, 2] /= s
        pg.poses_[:n, :3] *= s
        for t, (t0, dP) in list(pg.delta.items()):
            dP = dP.clone()
            dP[:3] *= s
            pg.delta[t] = (t0, dP)
        pg.poses_[:n] = se3_mul(pg.poses_[:n], se3_inv(pg.poses_[0])[None])

    def _run_global_ba(self):
        """Global BA over the active and the inactive edges with their last
        targets and weights, after normalize(); poses from the oldest active
        edge's source frame on, and the first K patch rows, are solved."""
        with self.trace.span("global_ba"):
            self._global_ba()

    def _global_ba(self):
        cfg, pg, M = self.cfg, self.pg, self.M
        self.stats["global_ba"] += 1
        n = pg.n
        idx = build_global_indices(np.concatenate([pg.ii_inac, pg.ii]),
                                   np.concatenate([pg.jj_inac, pg.jj]),
                                   np.concatenate([pg.kk_inac, pg.kk]), M)
        tw = torch.cat([pg.tw_inac, pg.tw])
        self.normalize()
        t0 = int(pg.ii.min())
        buckets = cfg.GLOBAL_POSE_BUCKETS
        N = next((b for b in buckets if n - t0 <= b), buckets[-1])
        K = min(next((b for b in buckets if n <= b), buckets[-1]), self.N) * M
        poses, patches = global_ba_solve(
            pg.poses_, pg.patches_[:K], pg.intrinsics_[0], tw[:, :2], tw[:, 2:],
            idx.to(self.device), t0, N=N, M=M, iterations=2)
        pg.poses_.copy_(poses)
        pg.patches_[:K] = patches
        self.ran_global_ba.add(n)

    def motion_probe(self):
        """Median update delta of the newest frame's patches against the
        frame being inserted, with fresh hidden state and no BA (its M edges
        padded to a bucket, as the JAX package's probe)."""
        pg, M = self.pg, self.M
        kk = np.arange(pg.m - M, pg.m)
        jj = np.full(M, pg.n)
        E_pad = pg.bucket(M)
        k0, KWIN, rows = self._prepare_update(kk // M, jj, kk, E_pad, np.full(M, -1))
        idx, _ = edge_index(self._upload(self._host_ints(rows)), E_pad,
                            M if self.network == "cdv" else None)
        net = torch.zeros((E_pad, self.DIM), dtype=self.fdtype, device=self.device)
        *_, delta_norm, _ = update_body(
            self.model, pg.poses_, pg.patches_[k0:k0 + KWIN], pg.intrinsics_, pg.imap_,
            pg.gmap_, pg.fmap1_, pg.fmap2_, net, idx, 1, float(self.ht4), float(self.wd4),
            NW=self.NW, KWIN=KWIN, iterations=0)
        return float(torch.quantile(delta_norm[:M].float(), 0.5))

    # ------------------------------------------------------------------
    def _decide_row(self, pid, mm):
        """A queued keyframe decision: physical frame id -> current row, or
        None if the motion test passes or the row is gone. The host waits
        here for the frame whose motion it reads (span ``wait``)."""
        pg = self.pg
        with self.trace.span("wait"):
            if isinstance(mm, tuple):           # a pinned copy on its way
                mm, done, frame = mm
                done.synchronize()
                self.trace.observed(frame)
            motion = float(mm.sum()) / 2
        if motion >= self.cfg.KEYFRAME_THRESH:
            return None
        rows = np.nonzero(pg.tstamps_[: pg.n] == pid)[0]
        if len(rows) != 1 or rows[0] < 1:
            return None
        return int(rows[0])

    def _kf_apply(self, k, defer_shift=False):
        """Remove keyframe row k (or nothing for None), then retire the
        edges that left the optimization window, in one compaction. Under
        loop closure the retired edges go to the inactive store, and loop
        edges into the last OPTIMIZATION_WINDOW frames stay active. The
        host rows move at once; with ``defer_shift`` the device rows move
        in the next steady-state step (``_pending_shift``)."""
        cfg, pg, M = self.cfg, self.pg, self.M
        self._apply_pending_shift()
        if k is not None:
            self.stats["keyframe_removals"] += 1
            drop = (pg.ii == k) | (pg.jj == k)
            kk_post = np.where(pg.ii > k, pg.kk - M, pg.kk)
            ii_post = np.where(pg.ii > k, pg.ii - 1, pg.ii)
            jj_post = np.where(pg.jj > k, pg.jj - 1, pg.jj)
            pg.reindex_inactive(k)
            n_after = pg.n - 1
        else:
            drop = np.zeros(pg.E, bool)
            ii_post, jj_post, kk_post = pg.ii, pg.jj, pg.kk
            n_after = pg.n
        retire = (kk_post // M) < n_after - cfg.REMOVAL_WINDOW
        if cfg.LOOP_CLOSURE:
            retire &= ~(((jj_post - ii_post) > 30)
                        & (jj_post > n_after - cfg.OPTIMIZATION_WINDOW))
        pg.remove_edges(drop | retire, ii_post, jj_post, kk_post, retire & ~drop)
        if k is None:
            return
        n = pg.n
        t0, t1 = int(pg.tstamps_[k - 1]), int(pg.tstamps_[k])
        for table in (pg.tstamps_, self.fslot_rows, self.pslot_rows):
            table[k:n - 1] = table[k + 1:n].copy()
        self._pending_shift = (k, n, t1, t0)
        if not defer_shift:
            self._apply_pending_shift()
        pg.n -= 1
        pg.m -= M

    def _apply_pending_shift(self):
        """Move the device rows of a deferred keyframe removal now
        (``kernels.shift_rows``) and enter its delta."""
        if self._pending_shift is None:
            return
        k, n, t1, t0 = self._pending_shift
        self._pending_shift = None
        self.stats["shifts_eager"] += 1
        self.pg.delta[t1] = (t0, shift_rows(self.pg.state(), k, n - 1 - k, self.M))

    # ------------------------------------------------------------------
    def _motion_fac(self, n):
        if n > 1 and self.cfg.MOTION_MODEL == "DAMPED_LINEAR":
            *_, a, b, c = [1] * 3 + self.tlist
            return float((c - b) / max(b - a, 1e-9))
        return 0.0

    @torch.no_grad()
    def __call__(self, tstamp, image, intrinsics):
        pg = self.pg
        if pg.n + 1 >= self.N:
            raise RuntimeError(
                f"The buffer size is too small. You can increase it using "
                f'"--opts BUFFER_SIZE={self.N * 2}"')
        launches = self._launches()
        with self.trace.span("frame", frame=pg.counter, steady=False):
            if self.is_initialized:
                out = self._call_fused(tstamp, image, intrinsics)
            else:
                out = self._call_init(tstamp, image, intrinsics)
        self._count_launches(launches)
        return out

    @staticmethod
    def _launches():
        return segsum_cuda.LAUNCHES.count, ba_cuda.LAUNCHES.count

    def _count_launches(self, before):
        """Add the kernel launches since ``before`` (``_launches()``) to stats."""
        for key, now, then in zip(("segsum_launches", "ba_edges_launches"), self._launches(),
                                  before):
            self.stats[key] += now - then

    def _call_init(self, tstamp, image, intrinsics):
        """A frame before the initialization: the eager insert, the motion
        probe, the new edges, and at 8 frames the 12 initializing updates."""
        cfg, pg, tr = self.cfg, self.pg, self.trace
        n = pg.n
        if self.long_term_lc is not None:
            self.long_term_lc(image, n)
        self.tlist.append(tstamp)
        pg.tstamps_[n] = pg.counter
        with tr.span("insert"):
            fs, ps = self._alloc_frame_slots(n)
            ints = self._host_ints(np.zeros(0, np.int32), n=n, fs=fs, ps=ps)
            inp = FrameInputs(self._frame_on_device(image), self._upload(ints),
                              self._upload(self._host_floats(intrinsics, self._motion_fac(n),
                                                             pg.counter)))
            self._stamp(0)
            self._insert_frame(pg.state(), inp, False)
            self._stamp(5, advance=True)
            tr.row_done("insert", pg.counter, prefetched=self._prefetched_frame,
                        stages=self._row_stages("insert"))
        pg.counter += 1
        if n > 0 and cfg.MOTION_PROBE_THR >= 0:
            with tr.span("probe"):
                still = self.motion_probe() < cfg.MOTION_PROBE_THR
            if still:
                pg.delta[pg.counter - 1] = (pg.counter - 2, se3_identity(
                    dtype=self.gdtype, device=self.device))
                return "Not keyframe"
        pg.n += 1
        pg.m += self.M
        self._add_loop_edges()
        self._append_factors()
        if pg.n == 8:
            self.is_initialized = True
            with tr.span("init"):
                for _ in range(12):
                    self.update()
            self._attempt_loop_closure()
        self._show(image)
        return "Is keyframe"

    def _call_fused(self, tstamp, image, intrinsics):
        """Steady state: apply the keyframe decision measured two frames
        ago (its device shift deferred into this frame's step), append the
        frame's edges on the host, then insert the frame and run one update
        in one step (``_fused_frame_update``), and queue this frame's
        decision."""
        cfg, pg = self.cfg, self.pg
        with self.trace.span("keyframe"):
            if len(self._kf_queue) >= 2:
                self._kf_apply(self._decide_row(*self._kf_queue.pop(0)), defer_shift=True)
            else:
                self._kf_apply(None)
            n = pg.n
            if self.long_term_lc is not None:
                self.long_term_lc(image, n)
            self.tlist.append(tstamp)
            pg.tstamps_[n] = pg.counter
            fac = self._motion_fac(n)
            pg.counter += 1
            pg.n += 1
            pg.m += self.M
            self._add_loop_edges()
            self._append_factors()
        mm = self._fused_frame_update(image, n, fac, intrinsics, pg.counter - 1)
        if pg.n - cfg.KEYFRAME_INDEX >= 1:
            self._kf_queue.append((int(pg.tstamps_[pg.n - cfg.KEYFRAME_INDEX]), mm))
        self._attempt_loop_closure()
        self._show(image)
        # the device's rows whose copies have landed (the keyframe wait
        # above has already waited for later work)
        self.trace.collect()
        return "Is keyframe"

    def _show(self, image):
        """Hand a kept frame to the viewer."""
        if self.viewer is not None:
            self.viewer.update_image(image)

    def _attempt_loop_closure(self):
        """The classical backend's closure attempt for the newest frame and
        the write-back of any finished PGO."""
        if self.long_term_lc is not None:
            self.long_term_lc.attempt_loop_closure(self.pg.n)
            self.long_term_lc.lc_callback()

    # ------------------------------------------------------------------
    @torch.no_grad()
    def terminate(self):
        """Drain the keyframe queue, let the classical backend make its
        last attempt and apply its PGO, add a last round of loop edges (under
        loop closure), run 12 updates (each followed by a global BA while
        loop edges are active), and return the (F, 7) camera-to-world poses
        of every frame (removed frames interpolated through the delta
        chain) and their timestamps. It also converts the patch colours to
        uint8 RGB in ``pg.colors_`` and joins the viewer. The tracer keeps
        this SLAM's record from here on (``utils.trace.ended``)."""
        launches = self._launches()
        with self.trace.span("terminate"):
            out = self._terminate()
        self._count_launches(launches)
        self.trace.end()
        return out

    def _terminate(self):
        pg = self.pg
        if not self.is_initialized:
            warn(f"SLAM terminates without initialization! Frame count: {pg.counter}")
            poses = np.tile(np.array([0, 0, 0, 0, 0, 0, 1.0]), (pg.counter, 1))
            if self.viewer is not None:
                self.viewer.join()
            return poses, np.array(self.tlist, np.float64)
        while self._kf_queue:
            self._kf_apply(self._decide_row(*self._kf_queue.pop(0)))
        if self.long_term_lc is not None:
            self.long_term_lc.terminate(pg.n)
        if self.cfg.LOOP_CLOSURE:
            kk, jj = edges_loop(pg, self.cfg)
            if len(kk):
                pg.append_edges(kk // self.M, jj, kk)
        for _ in range(12):
            self.ran_global_ba.discard(pg.n)
            self.update()

        poses_np = pg.poses_.cpu()
        traj = {int(pg.tstamps_[i]): poses_np[i] for i in range(pg.n)}
        delta = {t: (t0, dP.cpu()) for t, (t0, dP) in pg.delta.items()}

        def get_pose(t):
            if t not in traj:
                t0, dP = delta[t]
                traj[t] = se3_mul(dP, get_pose(t0))
            return traj[t]

        poses = torch.stack([get_pose(t) for t in range(pg.counter)])
        if self._tally is not None:
            self.stats.update(zip(HEAD_COUNTERS, self._tally.tolist()))
        c = pg.colors_dev.cpu().numpy()
        pg.colors_[:] = np.clip((c[:, :, [2, 1, 0]] + 0.5) * (255.0 / 2), 0, 255).astype(np.uint8)
        if self.viewer is not None:
            self.viewer.join()
        return se3_inv(poses).numpy(), np.array(self.tlist, np.float64)

    @property
    def n(self):
        return self.pg.n

    @property
    def m(self):
        return self.pg.m

    @torch.no_grad()
    def points(self):
        """(m, 3) numpy world coordinates of the kept patches' centres."""
        pg, P = self.pg, self.P
        ix = torch.arange(pg.m, device=self.device) // self.M
        pts = point_cloud(SE3(pg.poses_[None]), pg.patches_[None, :pg.m], pg.intrinsics_[None],
                          ix)[0, :, P // 2, P // 2]
        return (pts[:, :3] / pts[:, 3:]).cpu().numpy()

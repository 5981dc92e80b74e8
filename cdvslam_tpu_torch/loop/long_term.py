"""Classical long-term loop closure, the DPV-SLAM++ backend
(port of ``cdvslam_tpu.loop.long_term``).

BoW place recognition with a repetition check -> triplet 3D keypoints
(ORB matches across (i-1, i, i+1), a structure-only BA triangulation,
residual filtering) -> RANSAC-Umeyama Sim3 between the two local point
clouds -> Sim3 pose-graph optimization -> pose, depth and delta-chain
rewrite (reference: cdvslam/loop_closure/long_term.py).

Host control flow and the small point-cloud fits run in numpy; the
triangulation BA, the PGO and the rewrite run on the SLAM's device in its
geometry type. The PGO runs in a worker thread unless
``CLASSIC_LOOP_SYNC`` is set. On the card the worker has a CUDA stream of
its own: it waits on an event recorded after the main stream has copied
the poses, and ``lc_callback`` makes the main stream wait on the worker's
event before it writes the result back, so the worker neither queues
behind a frame nor races one. A PGO that raises in the worker raises
again in ``lc_callback``.
"""
from __future__ import annotations

import contextlib
import queue
import threading

import numpy as np
import torch

from ..ba import ba_solve
from ..ba.pgo import run_pgo
from ..geom import iproj, transform
from ..lie import SE3, se3_to_sim3, sim3_inv, sim3_mul
from .retrieval import RetrievalBoW


def umeyama_sim3(x, y):
    """Sim3 (R, t, s) aligning x -> y, (N,3) each (optim_utils.py:63-116)."""
    mx, my = x.mean(0), y.mean(0)
    xc, yc = x - mx, y - my
    sigma_x = (xc ** 2).sum() / len(x)
    cov = yc.T @ xc / len(x)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    c = np.trace(np.diag(D) @ S) / max(sigma_x, 1e-12)
    t = my - c * R @ mx
    return R, t, c


def ransac_umeyama(x, y, iters=200, thresh=0.1, seed=0):
    """RANSAC wrapper (optim_utils.py:118-151)."""
    rng = np.random.RandomState(seed)
    best = None
    best_inl = -1
    n = len(x)
    if n < 4:
        return None
    for _ in range(iters):
        sel = rng.choice(n, 3, replace=False)
        try:
            R, t, c = umeyama_sim3(x[sel], y[sel])
        except np.linalg.LinAlgError:
            continue
        err = np.linalg.norm((c * (R @ x.T)).T + t - y, axis=1)
        inl = int((err < thresh).sum())
        if inl > best_inl:
            best_inl = inl
            best = err < thresh
    if best is None or best.sum() < 4:
        return None
    R, t, c = umeyama_sim3(x[best], y[best])
    return R, t, c, int(best.sum())


def _row(pg, fid):
    """The last patch-graph row holding frame id ``fid``, or None."""
    rows = np.nonzero(pg.tstamps_[: pg.n] == fid)[0]
    return int(rows[-1]) if len(rows) else None


class LongTermLoopClosure:
    """The classical loop-closure backend, hooked into the SLAM runtime
    like the reference (slam.py:615-616, 722-730)."""

    def __init__(self, cfg, slam):
        self.cfg = cfg
        self.slam = slam
        self.retrieval = RetrievalBoW(rad=cfg.get("LOOP_RETR_RADIUS", 50),
                                      thresh=cfg.LOOP_RETR_THRESH)
        self.result_q = queue.Queue()
        self.worker = None
        self.stream = None          # the worker's CUDA stream, made at first use
        self.lc_count = 0
        # accumulated loop measurements (reference long_term.py:37-38,
        # 248-257: every PGO run sees ALL prior loop edges, re-measured
        # from the current -- already corrected -- estimates); keyed by
        # global frame id so keyframe removal cannot invalidate them
        self.loop_pairs = []        # [(fid_i, fid_j)]

    # -- per-frame hooks ------------------------------------------------
    def __call__(self, image, n):
        """Index the incoming frame under the id ``pg.counter`` (reference
        long_term.py:61-68); ``n`` is the keyframe count, unused."""
        import cv2

        g = cv2.cvtColor(np.asarray(image), cv2.COLOR_RGB2GRAY)
        self.retrieval.insert_image(g, self.slam.pg.counter)

    # -- loop attempt -----------------------------------------------------
    def attempt_loop_closure(self, n):
        fid = self.slam.pg.counter - 1
        hit = self.retrieval.detect_loop(fid)
        if hit is None:
            return
        i, j = hit
        # NMS around already-CLOSED loops (reference retrieval_dbow.py:
        # 14,74-107, NMS=50): without it every frame of a revisit re-fires
        # a near-duplicate closure whose repeated Sim3 applications only
        # churn the trajectory
        nms = self.cfg.get("LOOP_CLOSE_NMS", 50)
        for (a, b) in self.loop_pairs:
            if (i - a) ** 2 + (j - b) ** 2 < nms ** 2:
                return
        if self.worker is not None and self.worker.is_alive():
            return
        self.close_loop(i, j)

    def _keypoints_3d(self, fid):
        """Triplet structure-only triangulation (long_term.py:70-138):
        match ORB keypoints (fid-1, fid+1) -> fid, build a mini patch
        graph, run structure-only BA, keep low-residual points. Returns
        (centers, points in the keyframe's camera, good mask) or None."""
        slam, pg = self.slam, self.slam.pg
        row = _row(pg, fid)
        if row is None:
            self._fail = f"frame {fid} not a keyframe"
            return None

        matches = []
        for nb in (fid - 1, fid + 1):
            a, b = self.retrieval.match(nb, fid)
            if len(a) < 8:
                self._fail = f"too few matches {len(a)} between {nb} and {fid}"
                return None
            matches.append((a, b))

        # form consistent TRACKS across the triplet: a center keypoint must
        # be matched by both neighbors (associate the two match sets on the
        # center-frame keypoint coordinates)
        (ap, bp), (an, bn) = matches
        sel_p, sel_n = [], []
        used = set()
        for ip in range(len(bp)):
            d = np.linalg.norm(bn - bp[ip][None], axis=1)
            inn = int(np.argmin(d))
            if d[inn] < 1.0 and inn not in used:
                used.add(inn)
                sel_p.append(ip)
                sel_n.append(inn)
        if len(sel_p) < 8:
            self._fail = f"only {len(sel_p)} triplet tracks for {fid}"
            return None
        ap, bp = ap[sel_p], bp[sel_p]
        an = an[sel_n]
        K = min(len(bp), 96)
        centers = bp[:K] / slam.RES

        # mini problem: 3 poses (prev, cur, next) from current estimates
        row_p, row_n = _row(pg, fid - 1), _row(pg, fid + 1)
        if row_p is None or row_n is None:
            self._fail = f"triplet neighbors of {fid} not keyframes"
            return None
        dev, gd = pg.poses_.device, pg.poses_.dtype
        poses3 = pg.poses_[[row_p, row, row_n]]

        # The reference runs this mini problem in a scene normalize()d to
        # mean disparity 1 (patchgraph.py:99-104), where its absolute
        # constants -- the 1e-4 depth clamp, the d>20 reset, the z<20
        # point filter, the GN damping -- have their intended meaning.
        # The monocular gauge floats freely, so NORMALIZE the triplet
        # problem locally: rescale the scene so the keyframe's median
        # disparity (long_term.py:108-109) is 1, init structure at 1, and
        # scale the triangulated points back to world units afterwards.
        M = slam.M
        true_disp = float(np.median(pg.patches_[row * M:(row + 1) * M, 2, 1, 1].cpu().numpy()))
        if not np.isfinite(true_disp) or true_disp <= 1e-6:
            true_disp = 1.0
        poses3[:, :3] *= true_disp            # scene scale sigma = true_disp
        patches = torch.zeros((K, 3, 1, 1), dtype=gd, device=dev)
        patches[:, :2, 0, 0] = torch.as_tensor(centers, dtype=gd, device=dev)
        patches[:, 2, 0, 0] = 1.0

        target_np = np.concatenate([ap[:K], an[:K]], 0) / slam.RES
        target = torch.as_tensor(target_np, dtype=gd, device=dev)
        ii = torch.ones(2 * K, dtype=torch.long, device=dev)
        jj = torch.cat([torch.zeros(K, dtype=torch.long), torch.full((K,), 2)]).to(dev)
        kk = torch.arange(K, device=dev).repeat(2)
        intr = pg.intrinsics_[0]
        _, patches_out = ba_solve(
            poses3, patches, intr, target, torch.ones((2 * K, 2), dtype=gd, device=dev),
            ii, jj, kk, None, 3, N=1, K=K, iterations=6, structure_only=True)

        # residual filter (long_term.py:120-137)
        coords = transform(SE3(poses3[None]), patches_out[None], intr.expand(1, 3, 4),
                           ii, jj, kk)
        res = np.linalg.norm(coords[0, :, 0, 0].cpu().numpy() - target.cpu().numpy(), axis=1)
        # residual gate (long_term.py:131-133): the reference uses a fixed
        # 2 px max over the track pair; under drifty local geometry every
        # residual inflates together, so widen to a robust quantile (but
        # never below the reference's 2 px) and drop clamp-collapsed depths
        rmax = np.maximum(res[:K], res[K:])
        thr = max(2.0, 2.5 * float(np.median(rmax)))
        depth = patches_out[:, 2, 0, 0].cpu().numpy()
        # in normalized units this is EXACTLY the reference's z < 20
        # point filter (long_term.py:219) plus a guard just off the BA's
        # 1e-4 depth clamp (collapse marker)
        good = (rmax < thr) & (depth > max(1.02e-4, 1 / 20.0))
        if good.sum() < 6:
            self._fail = f"only {int(good.sum())} triangulated points for {fid}"
            return None

        X = iproj(patches_out[None], intr.expand(1, K, 4))[0, :, 0, 0].cpu().numpy()
        Xc = X[:, :3] / np.clip(X[:, 3:], 1e-6, None)  # normalized units
        return centers, Xc / true_disp, good           # back to world units

    def close_loop(self, i, j):
        """Estimate the Sim3 between loop frames and run the PGO
        (long_term.py:205-266)."""
        slam, pg = self.slam, self.slam.pg
        slam.stats["lc_attempts"] += 1
        out_i = self._keypoints_3d(i)
        out_j = self._keypoints_3d(j)
        if out_i is None or out_j is None:
            return

        # match i <-> j keypoints, then align their 3D point sets
        a, b = self.retrieval.match(i, j)
        if len(a) < 8:
            return
        ci, Xi_c, gi = out_i
        cj, Xj_c, gj = out_j

        # associate by nearest keypoint coordinates
        def assoc(query, bank, good):
            out = np.full(len(query), -1, np.int64)
            for qi, q in enumerate(query):
                d = np.linalg.norm(bank - q[None] / slam.RES, axis=1)
                kbest = int(np.argmin(d))
                if d[kbest] < 2.0 and good[kbest]:
                    out[qi] = kbest
            return out

        ai = assoc(a, ci, gi)
        bj = assoc(b, cj, gj)
        sel = (ai >= 0) & (bj >= 0)
        if sel.sum() < 6:
            return
        Pi = Xi_c[ai[sel]]
        Pj = Xj_c[bj[sel]]

        # scale-invariant inlier threshold: the reference's 0.1 world
        # units (400 iterations, long_term.py:243) assume a normalize()d
        # scene -- mean disparity 1, point norms O(1). The port's scene
        # floats with the monocular gauge, so when the TARGET (Pj) cloud -- whose
        # units the residual is measured in -- has drifted large, scale
        # the threshold with its typical point norm; never tighten below
        # the reference's 0.1.
        s_pts = float(np.median(np.linalg.norm(Pj, axis=1)))
        fit = ransac_umeyama(Pi, Pj, iters=400, thresh=0.1 * max(s_pts / 3.0, 1.0))
        if fit is None:
            return
        R, t, s, _ = fit

        # Sim3 measurement between poses i and j (camera frames)
        from scipy.spatial.transform import Rotation

        q = Rotation.from_matrix(R).as_quat()
        dS = np.concatenate([t, q, [s]])

        ri, rj = _row(pg, i), _row(pg, j)
        if ri is None or rj is None:
            return
        poses = pg.poses_[: pg.n].clone()      # the PGO's snapshot

        # accumulate ALL loop measurements (reference long_term.py:248-257):
        # prior loop pairs enter each new PGO as scale-1 Sim3 constraints
        # re-measured from the CURRENT (already corrected) estimates, so a
        # new closure cannot undo old ones
        dS_rows = [torch.as_tensor(dS, device=poses.device).to(poses.dtype)]
        ii_rows = [max(ri, rj)]
        jj_rows = [min(ri, rj)]
        pred = se3_to_sim3(poses)               # world->cam Sim3
        for (fi, fj) in self.loop_pairs:
            rfi, rfj = _row(pg, fi), _row(pg, fj)
            if rfi is None or rfj is None:
                continue
            hi, lo = max(rfi, rfj), min(rfi, rfj)
            # constraint satisfied at the current estimate:
            # C = G_lo * G_hi^-1 with G = world->cam (the PGO's loop-edge
            # convention, see ba/pgo.py perform_updates)
            dS_rows.append(sim3_mul(pred[lo], sim3_inv(pred[hi])))
            ii_rows.append(hi)
            jj_rows.append(lo)
        self.loop_pairs.append((int(i), int(j)))
        dS_all = torch.stack(dS_rows)
        ii_all = np.asarray(ii_rows)
        jj_all = np.asarray(jj_rows)

        if self.cfg.get("CLASSIC_LOOP_SYNC", False):
            self.result_q.put((*run_pgo(poses, dS_all, ii_all, jj_all, iters=30), None))
            return
        ready, stream = self._record(), self._worker_stream()
        on_stream = torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext()

        def work():
            try:
                with on_stream:
                    if stream is not None:
                        stream.wait_event(ready)
                        for t in (poses, dS_all):
                            t.record_stream(stream)
                    safe_i, corrected = run_pgo(poses, dS_all, ii_all, jj_all, iters=30)
                    done = self._record()
                self.result_q.put((safe_i, corrected, done))
            except Exception as e:  # raised again on the main thread by lc_callback
                self.result_q.put(e)

        self.worker = threading.Thread(target=work, daemon=True)
        self.worker.start()

    def _record(self):
        """An event recorded on the current stream (None off the card)."""
        if self.slam.device.type != "cuda":
            return None
        ev = torch.cuda.Event()
        ev.record()
        return ev

    def _worker_stream(self):
        """The worker's CUDA stream (None off the card)."""
        if self.slam.device.type == "cuda" and self.stream is None:
            self.stream = torch.cuda.Stream(self.slam.device)
        return self.stream

    def lc_callback(self):
        """Apply finished PGO results (long_term.py:189-203); drains the
        queue so a result is never dropped between polls."""
        while True:
            try:
                item = self.result_q.get_nowait()
            except queue.Empty:
                return
            if isinstance(item, Exception):
                raise item
            safe_i, corrected, done = item
            if done is not None:
                main = torch.cuda.current_stream(self.slam.device)
                main.wait_event(done)
                corrected.record_stream(main)
            self._apply_correction(safe_i, corrected)

    def _apply_correction(self, safe_i, corrected):
        slam, pg = self.slam, self.slam.pg
        n, M = pg.n, slam.M
        m = min(safe_i, n)
        # corrected: (m, 8) Sim3 of world->cam; write back the SE3 part and
        # rescale patch depths by the Sim3 scale
        corr = corrected[:m].to(pg.poses_.dtype)
        scales = corr[:, 7]
        pg.poses_[:m] = corr[:, :7]
        pg.patches_[: m * M, 2] *= scales.repeat_interleave(M)[:, None, None]
        # rescale the delta chain (reference long_term.py:176-186 +
        # lc_callback): removed frames' relative poses hang off a live
        # keyframe whose local scene scale just changed; walk each chain
        # to its live root and scale the SE3 translation. `scales` here
        # is the world->cam Sim3 scale (inverse depths multiply by it),
        # so translations scale by 1/scales (the reference's s).
        scales_h = scales.cpu().numpy()
        s_of_t = {int(pg.tstamps_[r]): (float(1.0 / max(scales_h[r], 1e-12)) if r < m else 1.0)
                  for r in range(n)}
        for t, (t0, dP) in list(pg.delta.items()):
            t_src = t
            while t_src in pg.delta:
                t_src = pg.delta[t_src][0]
            s1 = s_of_t.get(int(t_src), 1.0)
            if s1 != 1.0:
                dP = dP.clone()
                dP[:3] *= s1
                pg.delta[t] = (t0, dP)
        # re-fix gauge + unit mean disparity (reference lc_callback tail)
        slam.normalize()
        self.lc_count += 1
        slam.stats["lc_applied"] += 1

    def terminate(self, n):
        self.attempt_loop_closure(n)
        if self.worker is not None:
            self.worker.join(timeout=60)
        self.lc_callback()

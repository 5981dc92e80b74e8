"""ORB + BoW place recognition (copy of ``cdvslam_tpu.loop.retrieval``).

A ctypes wrapper over the native library ``native/retrieval.cpp``: ORB
detection through cv2, an online-vocabulary BoW database in C++, top-k
query with a temporal-radius exclusion, and the 3-consecutive-hit
repetition check. It replaces the reference's DBoW2 stack
(reference: cdvslam/loop_closure/retrieval_dbow.py + DPRetrieval C++).

The library is built with ``g++`` at first use into ``build/native/`` at
the root of the checkout, its file name keyed by a hash of the source and
flags. A missing cv2 or a failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parents[1] / "native" / "retrieval.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_LIB = None


def lib_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(GXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libretrieval-{digest}.so"


def build() -> Path:
    """Build the library unless it is built; returns its path. Raises
    RuntimeError with the compiler's output if the build fails."""
    out = lib_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for {SOURCE.name}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def _load_lib():
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = ctypes.CDLL(str(build()))
    lib.retr_create.restype = ctypes.c_void_p
    lib.retr_create.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_long]
    lib.retr_destroy.argtypes = [ctypes.c_void_p]
    lib.retr_insert.argtypes = [ctypes.c_void_p, ctypes.c_long,
                                ctypes.POINTER(ctypes.c_uint8), ctypes.c_int]
    lib.retr_query.restype = ctypes.c_int
    lib.retr_query.argtypes = [ctypes.c_void_p, ctypes.c_long, ctypes.c_int,
                               ctypes.c_int, ctypes.POINTER(ctypes.c_long),
                               ctypes.POINTER(ctypes.c_float)]
    lib.retr_match.restype = ctypes.c_int
    lib.retr_match.argtypes = [ctypes.c_void_p, ctypes.c_long, ctypes.c_long,
                               ctypes.c_int, ctypes.POINTER(ctypes.c_int),
                               ctypes.c_int]
    lib.retr_num_frames.restype = ctypes.c_int
    lib.retr_num_frames.argtypes = [ctypes.c_void_p]
    lib.retr_trained.restype = ctypes.c_int
    lib.retr_trained.argtypes = [ctypes.c_void_p]
    _LIB = lib
    return lib


class RetrievalBoW:
    """Keyframe place-recognition database.

    Mirrors RetrievalDBOW semantics (reference retrieval_dbow.py:28-125):
    insert every keyframe, query top-4 with |i-j| >= rad exclusion,
    accept a loop only after 3 consecutive frames hit the same target
    region (repetition check, retrieval_dbow.py:79-114).
    """

    def __init__(self, n_features=1000, rad=50, thresh=0.04, K=8, L=3,
                 train_threshold=20000):
        import cv2

        self.lib = _load_lib()
        self.h = self.lib.retr_create(K, L, train_threshold)
        self.orb = cv2.ORB_create(nfeatures=n_features)
        self.rad = rad
        self.thresh = thresh
        self.kps = {}        # frame id -> (N,2) keypoint coords
        self.hit_history = []  # (query_id, best_match_id)

    def __del__(self):
        if getattr(self, "h", None):
            self.lib.retr_destroy(self.h)
            self.h = None

    def insert_image(self, image_gray, frame_id: int):
        kps, descs = self.orb.detectAndCompute(image_gray, None)
        if descs is None or len(descs) == 0:
            descs = np.zeros((1, 32), np.uint8)
            kps = []
        descs = np.ascontiguousarray(descs, np.uint8)
        self.kps[frame_id] = np.array([k.pt for k in kps], np.float32).reshape(-1, 2)
        self.lib.retr_insert(
            self.h, frame_id,
            descs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(descs),
        )

    def query(self, frame_id: int, topk=4):
        ids = (ctypes.c_long * topk)()
        scores = (ctypes.c_float * topk)()
        n = self.lib.retr_query(self.h, frame_id, self.rad, topk, ids, scores)
        return [(int(ids[i]), float(scores[i])) for i in range(n)]

    def detect_loop(self, frame_id: int, thresh=None):
        """Returns (i, j) = (frame_id, loop target) after the repetition
        check, else None."""
        thresh = thresh if thresh is not None else self.thresh
        cands = self.query(frame_id)
        good = [(j, s) for j, s in cands if s > thresh]
        if not good:
            self.hit_history.append(None)
            return None
        best_j = good[0][0]
        self.hit_history.append((frame_id, best_j))
        h = self.hit_history[-3:]
        if len(h) == 3 and all(x is not None for x in h):
            ids = [x[0] for x in h]
            tgts = [x[1] for x in h]
            if ids[2] - ids[0] <= 3 and max(tgts) - min(tgts) <= 10:
                # return the MIDDLE hit so both (i-1, i, i+1) triplet
                # neighbors exist (reference retrieval_dbow.py:79-114
                # also resolves to an older frame)
                return ids[1], tgts[1]
        return None

    def match(self, i: int, j: int, max_dist=64, cap=512):
        """Hamming knn matches -> (pts_i (K,2), pts_j (K,2))."""
        pairs = (ctypes.c_int * (2 * cap))()
        n = self.lib.retr_match(self.h, i, j, max_dist, pairs, cap)
        idx = np.frombuffer(pairs, np.int32, 2 * n).reshape(-1, 2)
        ki, kj = self.kps.get(i), self.kps.get(j)
        if ki is None or kj is None or n == 0:
            return np.zeros((0, 2), np.float32), np.zeros((0, 2), np.float32)
        sel = (idx[:, 0] < len(ki)) & (idx[:, 1] < len(kj))
        idx = idx[sel]
        return ki[idx[:, 0]], kj[idx[:, 1]]

    @property
    def trained(self):
        return bool(self.lib.retr_trained(self.h))

"""Frame-format readers for the aux dataset formats (copy of
``cdvslam_tpu.data.formats``, which imports no JAX).

Behavioral equivalents of the reference's data_readers/frame_utils.py
(reference: cdvslam/data_readers/frame_utils.py:11-164): Middlebury .flo
flow, PFM disparity, KITTI 16-bit png flow, Sintel .dpt depth / .cam
pose, and the read_gen extension dispatch. Pure numpy (+cv2 only for the
KITTI 16-bit png); no torch/PIL.
"""
from __future__ import annotations

import os
import re

import numpy as np

FLO_MAGIC = 202021.25


def read_flow(path):
    """Middlebury .flo: magic f32, w i32, h i32, then h*w*2 f32 (u, v)."""
    with open(path, "rb") as f:
        magic = np.fromfile(f, np.float32, count=1)
        if len(magic) == 0 or magic[0] != np.float32(FLO_MAGIC):
            raise ValueError(f"bad .flo magic in {path}")
        w = int(np.fromfile(f, np.int32, count=1)[0])
        h = int(np.fromfile(f, np.int32, count=1)[0])
        data = np.fromfile(f, np.float32, count=2 * w * h)
    return data.reshape(h, w, 2)


def write_flow(path, flow):
    """Inverse of read_flow."""
    flow = np.asarray(flow, np.float32)
    h, w, c = flow.shape
    assert c == 2
    with open(path, "wb") as f:
        np.array([FLO_MAGIC], np.float32).tofile(f)
        np.array([w], np.int32).tofile(f)
        np.array([h], np.int32).tofile(f)
        flow.tofile(f)


def read_pfm(path):
    """PFM (Pf gray / PF color): header lines, negative scale = little
    endian, rows stored bottom-up."""
    with open(path, "rb") as f:
        header = f.readline().rstrip()
        if header == b"PF":
            color = True
        elif header == b"Pf":
            color = False
        else:
            raise ValueError(f"not a PFM file: {path}")
        m = re.match(rb"^(\d+)\s+(\d+)\s*$", f.readline())
        if not m:
            raise ValueError(f"malformed PFM header in {path}")
        w, h = map(int, m.groups())
        scale = float(f.readline().rstrip())
        endian = "<" if scale < 0 else ">"
        data = np.fromfile(f, endian + "f")
    shape = (h, w, 3) if color else (h, w)
    return np.flipud(data.reshape(shape)).copy()


def read_flow_kitti(path):
    """KITTI 16-bit png flow -> (flow (H, W, 2), valid (H, W))."""
    import cv2

    raw = cv2.imread(path, cv2.IMREAD_ANYDEPTH | cv2.IMREAD_COLOR)
    raw = raw[:, :, ::-1].astype(np.float32)
    flow, valid = raw[:, :, :2], raw[:, :, 2]
    return (flow - 2 ** 15) / 64.0, valid


def read_dpt(path):
    """Sintel .dpt depth: magic f32, w i32, h i32, h*w f32."""
    with open(path, "rb") as f:
        magic = np.fromfile(f, np.float32, count=1)
        if len(magic) == 0 or magic[0] != np.float32(FLO_MAGIC):
            raise ValueError(f"bad .dpt magic in {path}")
        w = int(np.fromfile(f, np.int32, count=1)[0])
        h = int(np.fromfile(f, np.int32, count=1)[0])
        return np.fromfile(f, np.float32, count=-1).reshape(h, w)


def read_cam(path):
    """Sintel .cam: magic f32, 3x3 f64 intrinsics M, 3x4 f64 extrinsics N.
    Returns (pose (7,) [t, q_xyzw], intrinsics (4,) [fx fy cx cy])."""
    from scipy.spatial.transform import Rotation

    with open(path, "rb") as f:
        np.fromfile(f, np.float32, count=1)
        M = np.fromfile(f, np.float64, count=9).reshape(3, 3)
        N = np.fromfile(f, np.float64, count=12).reshape(3, 4)
    kvec = np.array([M[0, 0], M[1, 1], M[0, 2], M[1, 2]])
    q = Rotation.from_matrix(N[:3, :3]).as_quat()
    return np.concatenate([N[:3, 3], q]), kvec


def read_gen(path):
    """Extension-dispatched reader (frame_utils.py:150-164)."""
    ext = os.path.splitext(path)[-1].lower()
    if ext in (".png", ".jpeg", ".jpg", ".ppm"):
        import cv2

        return cv2.imread(path)[:, :, ::-1]
    if ext in (".bin", ".raw", ".npy"):
        return np.load(path)
    if ext == ".flo":
        return read_flow(path).astype(np.float32)
    if ext == ".pfm":
        return read_pfm(path).astype(np.float32)
    if ext == ".dpt":
        return read_dpt(path).astype(np.float32)
    if ext == ".cam":
        return read_cam(path)
    raise ValueError(f"unknown extension {ext}")


def dataset_factory(dataset_list, **kwargs):
    """Combined clip sampler over named datasets (reference
    data_readers/factory.py): currently 'tartan'. Returns an object with
    the TartanAirDataset ``batches`` interface, drawing each batch from a
    uniformly-random member dataset."""
    from .tartan import TartanAirDataset

    dataset_map = {"tartan": TartanAirDataset}
    dbs = [dataset_map[k](**kwargs) for k in dataset_list]
    if len(dbs) == 1:
        return dbs[0]

    class _Concat:
        def __init__(self, dbs):
            self.dbs = dbs
            self._rng = np.random.RandomState(0)

        def batches(self, B, steps):
            gens = [db.batches(B, steps) for db in self.dbs]
            for _ in range(steps):
                g = gens[self._rng.randint(len(gens))]
                yield next(g)

    return _Concat(dbs)

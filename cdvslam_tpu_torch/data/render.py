"""Planar-scene renderer (numpy, cv2 and scipy; the port's counterpart of
``tests/render_plane.py``, which imports the JAX package).

A textured plane z = 0 seen by a pinhole camera: every frame is a warp of
one seeded texture, so ORB keypoints, flow and triangulated points agree
with the ground-truth poses. Poses are world->cam SE3 ``[tx, ty, tz, qx,
qy, qz, qw]``. ``overhead_loop_poses`` and ``random_walk_poses`` follow the
JAX test renderer and ``tools/train_e2e_proof.py`` step for step (the same
quaternion products, in float64); ``loop_path`` is the circling camera of
``chip_smoke.py``.
"""
from __future__ import annotations

import numpy as np


def _pose_rt(pose):
    """(R, t) of a world->cam SE3 [tx, ty, tz, qx, qy, qz, qw]."""
    from scipy.spatial.transform import Rotation
    return Rotation.from_quat(pose[3:7]).as_matrix(), np.asarray(pose[:3], np.float64)


def _se3(R, t):
    from scipy.spatial.transform import Rotation
    return np.concatenate([t, Rotation.from_matrix(R).as_quat()])


def _quat_exp(phi):
    """Unit quaternion (x, y, z, w) of the rotation vector phi."""
    phi = np.asarray(phi, np.float64)
    theta = np.sqrt(phi @ phi)
    if theta < 1e-12:
        return np.array([*(0.5 * phi), 1.0])
    return np.array([*(np.sin(0.5 * theta) / theta * phi), np.cos(0.5 * theta)])


def _qmul(a, b):
    """Hamilton product a * b, scalar last."""
    x1, y1, z1, w1 = a
    x2, y2, z2, w2 = b
    return np.array([w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                     w1 * y2 + y1 * w2 + z1 * x2 - x1 * z2,
                     w1 * z2 + z1 * w2 + x1 * y2 - y1 * x2,
                     w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2])


def _qmat(q):
    x, y, z, w = q
    return np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                     [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                     [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


_DOWN = _quat_exp([np.pi, 0.0, 0.0])    # looking straight down: the cam z axis along -z


def _look_from(q, C):
    """The world->cam pose with rotation q and camera centre C."""
    return np.concatenate([-_qmat(q) @ C, q])


class PlaneScene:
    """The plane z = 0 under a seeded texture spanning [-extent, extent]^2
    world units (``tex_size`` pixels across), seen with full-resolution
    intrinsics ``intr`` (fx, fy, cx, cy) at ht x wd."""

    def __init__(self, intr, ht, wd, tex_size=2048, extent=8.0, seed=0):
        import cv2
        rng = np.random.RandomState(seed)
        tex = (rng.rand(tex_size // 16, tex_size // 16) * 255).astype(np.uint8)
        tex = cv2.resize(tex, (tex_size, tex_size), interpolation=cv2.INTER_NEAREST)
        tex = np.ascontiguousarray(np.stack([cv2.GaussianBlur(tex, (7, 7), 1.2)] * 3, -1))
        for _ in range(400):        # coloured blobs: corners for ORB
            c, r = rng.randint(0, tex_size, 2), rng.randint(4, 24)
            cv2.circle(tex, (int(c[0]), int(c[1])), int(r), rng.randint(0, 255, 3).tolist(), -1)
        self.tex = tex
        self.tex_size, self.extent = tex_size, extent
        self.intr = np.asarray(intr, np.float64)
        self.ht, self.wd = ht, wd

    def _hits(self, pose, u, v, intr):
        """Plane points on the rays through pixels (u, v), and the ray
        lengths."""
        R, t = _pose_rt(pose)
        fx, fy, cx, cy = intr
        d = np.stack([(u - cx) / fx, (v - cy) / fy, np.ones_like(u)], -1) @ R   # R^T r
        C = -R.T @ t
        lam = -C[2] / np.where(np.abs(d[..., 2]) > 1e-9, d[..., 2], 1e-9)
        return C + lam[..., None] * d, lam

    def render(self, pose):
        """(ht, wd, 3) uint8 view from the world->cam pose."""
        import cv2
        u, v = np.meshgrid(np.arange(self.wd, dtype=np.float64),
                           np.arange(self.ht, dtype=np.float64))
        P, lam = self._hits(pose, u, v, self.intr)
        txy = (P[..., :2] + self.extent) / (2 * self.extent) * self.tex_size
        maps = [np.where(lam > 0.05, txy[..., k], -1).astype(np.float32) for k in (0, 1)]
        return cv2.remap(self.tex, maps[0], maps[1], cv2.INTER_LINEAR, borderMode=cv2.BORDER_WRAP)

    def true_inv_depth(self, pose, px, py, res=4):
        """Inverse depths of the plane at the pixels (px, py) of the image
        at 1/res resolution."""
        R, t = _pose_rt(pose)
        P, _ = self._hits(pose, px, py, self.intr / res)
        return 1.0 / np.clip((P @ R.T + t)[..., 2], 0.05, None)


def loop_path(nframes, period):
    """(nframes, 7) world->cam poses of a camera 2 units above the plane
    looking down, circling (radius 0.8) with one turn per ``period`` frames
    (frame period + k revisits frame k) and yawing about its optical axis."""
    from scipy.spatial.transform import Rotation
    down = Rotation.from_euler("x", np.pi).as_matrix()
    out = []
    for f in range(nframes):
        th = 2 * np.pi * f / period
        C = np.array([0.8 * np.cos(th), 0.8 * np.sin(th), 2.0])
        R = Rotation.from_euler("z", 0.3 * np.sin(th)).as_matrix() @ down
        out.append(_se3(R, -R @ C))
    return np.stack(out)


def overhead_loop_poses(F, height=2.0, radius=0.8, seed=0):
    """(F, 7) float32: a camera above the plane looking down, circling once
    per F - 8 frames (frame F - 8 + k revisits frame k) and yawing by 0.3
    sin(angle). ``seed`` is unused, as in the JAX renderer."""
    out = []
    for f in range(F):
        th = 2 * np.pi * f / (F - 8)
        C = np.array([radius * np.cos(th), radius * np.sin(th), height])
        q = _qmul(_quat_exp([0.0, 0.0, 0.3 * np.sin(th)]), _DOWN)
        out.append(_look_from(q, C))
    return np.stack(out).astype(np.float32)


def random_walk_poses(rng, F, height=1.6):
    """(F, 7) float32: a smooth random camera path above the plane, looking
    down and tilting by at most 0.35 rad per axis, drawn from the numpy
    RandomState ``rng`` in the order of ``tools/train_e2e_proof.py``."""
    C = np.array([rng.uniform(-1.5, 1.5), rng.uniform(-1.5, 1.5),
                  height + rng.uniform(-0.3, 0.5)])
    vel = rng.normal(0, 0.10, 3) * np.array([1, 1, 0.3])
    rvec = np.zeros(3)
    rvel = rng.normal(0, 0.02, 3)
    out = []
    for _ in range(F):
        C = C + vel
        vel = 0.9 * vel + rng.normal(0, 0.03, 3) * np.array([1, 1, 0.3])
        C[2] = np.clip(C[2], 1.0, 3.0)
        rvec = rvec + rvel
        rvel = 0.9 * rvel + rng.normal(0, 0.01, 3)
        rvec = np.clip(rvec, -0.35, 0.35)       # keep the plane in view
        out.append(_look_from(_qmul(_quat_exp(rvec), _DOWN), C))
    return np.stack(out).astype(np.float32)

# PlaneScene and loop_path (and the helpers they use): frozen copy of
# cdvslam_tpu_torch/data/render.py at commit 8ea54d8. It stays as it is when
# the program changes; render_batch below is the benchmark's own.
"""The benchmark's traffic source: a textured plane z = 0 seen by a pinhole
camera circling above it (``PlaneScene``, ``loop_path``), and
``render_batch``, which renders the same views on the device.

Poses are world->cam SE3 ``[tx, ty, tz, qx, qy, qz, qw]``.
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


def render_batch(scene: PlaneScene, poses, device, batch=8):
    """(F, ht, wd, 3) uint8 numpy views of ``scene`` from the (F, 7)
    world->cam ``poses``, rendered on ``device`` in batches of ``batch``:
    ``PlaneScene.render``'s rays and plane hits in float64, then a bilinear
    read of the texture with wrapped borders (cv2.remap's INTER_LINEAR with
    BORDER_WRAP, its weights on the same 1/32 grid), rounded to the nearest
    level."""
    import torch
    from scipy.spatial.transform import Rotation
    f64 = dict(dtype=torch.float64, device=device)
    tex = torch.as_tensor(scene.tex, device=device).to(torch.float32)     # (T, T, 3)
    T = scene.tex_size
    fx, fy, cx, cy = scene.intr
    v, u = torch.meshgrid(torch.arange(scene.ht, **f64), torch.arange(scene.wd, **f64),
                          indexing="ij")
    rays = torch.stack([(u - cx) / fx, (v - cy) / fy, torch.ones_like(u)], -1)  # (H, W, 3)
    out = []
    poses = np.asarray(poses, np.float64)
    for b in range(0, len(poses), batch):
        chunk = poses[b:b + batch]
        R = torch.as_tensor(Rotation.from_quat(chunk[:, 3:7]).as_matrix(), **f64)   # (B, 3, 3)
        t = torch.as_tensor(chunk[:, :3], **f64)
        d = torch.einsum("hwk,bkj->bhwj", rays, R)                      # R^T r
        C = -torch.einsum("bkj,bk->bj", R, t)                           # -R^T t
        dz = d[..., 2]
        dz = torch.where(dz.abs() > 1e-9, dz, torch.full_like(dz, 1e-9))
        lam = -C[:, None, None, 2] / dz
        P = C[:, None, None, :2] + lam[..., None] * d[..., :2]
        txy = (P + scene.extent) / (2 * scene.extent) * T
        txy = torch.where((lam > 0.05)[..., None], txy, torch.full_like(txy, -1.0))
        txy = torch.round(txy * 32.0) / 32.0
        x0, y0 = torch.floor(txy[..., 0]), torch.floor(txy[..., 1])
        ax, ay = (txy[..., 0] - x0).to(torch.float32), (txy[..., 1] - y0).to(torch.float32)
        x0, y0 = x0.long() % T, y0.long() % T
        x1, y1 = (x0 + 1) % T, (y0 + 1) % T
        top = tex[y0, x0] * (1 - ax)[..., None] + tex[y0, x1] * ax[..., None]
        bot = tex[y1, x0] * (1 - ax)[..., None] + tex[y1, x1] * ax[..., None]
        img = top * (1 - ay)[..., None] + bot * ay[..., None]
        out.append(torch.round(img).clamp(0, 255).to(torch.uint8).cpu().numpy())
    return np.concatenate(out)

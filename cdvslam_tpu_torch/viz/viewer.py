"""Headless trajectory/point-cloud viewer (port of
``cdvslam_tpu.viz.viewer``).

The reference ships an interactive Open3D window in a separate process
(reference: cdvslam/o3dviewer.py); the same hooks here render periodic
snapshots (camera trajectory + patch point cloud + current frame) to PNG,
usable over SSH and in batch runs. The JAX package draws them with
matplotlib's 3D axes; the port draws the same view (matplotlib's default,
elevation 30 and azimuth -60 degrees, orthographic) with cv2.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from ..lie import se3_inv


class SnapshotViewer:
    """Implements the subset of the O3DViewer surface the runtime calls."""

    def __init__(self, slam, out_dir="viewer_out", every=10):
        self.slam = slam
        self.out = Path(out_dir)
        self.out.mkdir(exist_ok=True, parents=True)
        self.every = every
        self.count = 0
        self.last_image = None

    def update_image(self, image, *args, **kwargs):
        self.last_image = np.asarray(image)
        self.count += 1
        if self.count % self.every == 0:
            self.render(f"{self.out}/frame_{self.count:05d}.png")

    def add_delta(self, *args, **kwargs):
        pass

    def render(self, path, size=400):
        import cv2

        slam = self.slam
        n = slam.pg.n
        if n < 2:
            return
        # camera centers = -R^T t
        centers = se3_inv(slam.pg.poses_[:n]).cpu().numpy()[:, :3]
        pts = slam.points()[: slam.pg.m]
        valid = np.isfinite(pts).all(axis=1)
        sub = pts[valid][:: max(1, len(pts) // 4000)]

        el, az = np.radians(30.0), np.radians(-60.0)
        right = np.array([-np.sin(az), np.cos(az), 0.0])
        up = np.array([-np.sin(el) * np.cos(az), -np.sin(el) * np.sin(az), np.cos(el)])
        both = np.concatenate([sub, centers]) @ np.stack([right, up], 1)
        lo, hi = both.min(axis=0), both.max(axis=0)
        scale = 0.9 * size / max(float((hi - lo).max()), 1e-9)

        def px(xyz):
            uv = (xyz @ np.stack([right, up], 1) - (lo + hi) / 2) * scale + size / 2
            return np.stack([uv[:, 0], size - uv[:, 1]], 1).round().astype(np.int32)
        view = np.full((size, size, 3), 255, np.uint8)
        for x, y in px(sub):
            cv2.circle(view, (int(x), int(y)), 1, (160, 160, 160), -1)
        cv2.polylines(view, [px(centers)], False, (255, 0, 0), 2)
        cv2.circle(view, tuple(int(v) for v in px(centers[-1:])[0]), 5, (0, 0, 255), -1)
        cv2.putText(view, f"n={n} keyframes", (10, 20), cv2.FONT_HERSHEY_SIMPLEX, 0.5,
                    (0, 0, 0), 1)
        panels = [view]
        if self.last_image is not None:
            img = self.last_image[..., ::-1]                   # RGB -> BGR for cv2
            h, w = img.shape[:2]
            panels.append(cv2.resize(np.ascontiguousarray(img), (max(1, w * size // h), size)))
        if not cv2.imwrite(str(path), np.concatenate(panels, axis=1)):
            raise OSError(f"cv2 cannot write {path}")

    def join(self):
        self.render(f"{self.out}/final.png")

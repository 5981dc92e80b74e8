"""Trajectory/plot/export utilities (port of ``cdvslam_tpu.viz.plot``;
reference cdvslam/plot_utils.py).

evo/plyfile-free: TUM-format text, the x-z plot as a vector PDF written
directly (the JAX package uses matplotlib, which the port does not
need), ASCII PLY, COLMAP text export. The writers read a port ``SLAM``:
``points()``, ``pg.colors_`` (uint8 RGB after ``terminate()``),
``pg.poses_`` (a tensor, moved to the host) and ``ht`` / ``wd``.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np


def save_trajectory_tum_format(traj, path):
    poses, tstamps = traj
    with open(path, "w") as f:
        for p, t in zip(poses, tstamps):
            f.write(f"{t} " + " ".join(f"{v:.8f}" for v in p) + "\n")


def _pdf_text(text):
    return text.replace("\\", "\\\\").replace("(", "\\(").replace(")", "\\)")


def write_pdf(path, width, height, lines, texts):
    """A one-page vector PDF without a plotting library. ``lines``: (points
    [(x, y), ...] in PDF points from the lower left, (r, g, b) in [0, 1],
    dashed); ``texts``: (x, y, font size, text) in Helvetica."""
    ops = []
    for pts, (r, g, b), dashed in lines:
        if len(pts) < 2:
            continue
        ops.append(f"{r:.3f} {g:.3f} {b:.3f} RG {'[4 3] 0 d' if dashed else '[] 0 d'} 1 w")
        ops.append(" ".join([f"{pts[0][0]:.2f} {pts[0][1]:.2f} m"]
                            + [f"{x:.2f} {y:.2f} l" for x, y in pts[1:]]) + " S")
    for x, y, size, text in texts:
        ops.append(f"BT /F1 {size} Tf {x:.2f} {y:.2f} Td ({_pdf_text(text)}) Tj ET")
    content = "\n".join(ops).encode("latin-1", "replace")
    objs = [b"<< /Type /Catalog /Pages 2 0 R >>",
            b"<< /Type /Pages /Kids [3 0 R] /Count 1 >>",
            (f"<< /Type /Page /Parent 2 0 R /MediaBox [0 0 {width} {height}] /Contents 4 0 R "
             "/Resources << /Font << /F1 5 0 R >> >> >>").encode(),
            b"<< /Length %d >>\nstream\n" % len(content) + content + b"\nendstream",
            b"<< /Type /Font /Subtype /Type1 /BaseFont /Helvetica >>"]
    out, offsets = bytearray(b"%PDF-1.4\n"), []
    for i, obj in enumerate(objs, 1):
        offsets.append(len(out))
        out += b"%d 0 obj\n" % i + obj + b"\nendobj\n"
    xref = len(out)
    out += b"xref\n0 %d\n0000000000 65535 f \n" % (len(objs) + 1)
    out += b"".join(b"%010d 00000 n \n" % o for o in offsets)
    out += b"trailer\n<< /Size %d /Root 1 0 R >>\nstartxref\n%d\n%%%%EOF\n" % (len(objs) + 1, xref)
    Path(path).write_bytes(bytes(out))


def plot_trajectory(traj, title="", filename="trajectory.pdf", gt_traj=None):
    """The x-z trajectory (and the ground truth's, dashed) at equal scale,
    as a vector PDF: the JAX package draws it with matplotlib, which the
    port does not need."""
    poses, _ = traj
    curves = [(np.asarray(poses, np.float64)[:, [0, 2]], (0.12, 0.47, 0.71), False,
               "estimate")]
    if gt_traj is not None:
        curves.append((np.asarray(gt_traj[0], np.float64)[:, [0, 2]], (1.0, 0.5, 0.05), True,
                       "ground truth"))
    curves = [(c[np.isfinite(c).all(axis=1)], *rest) for c, *rest in curves]
    pts = np.concatenate([c for c, *_ in curves]) if any(len(c) for c, *_ in curves) \
        else np.zeros((1, 2))
    lo, hi = pts.min(axis=0), pts.max(axis=0)
    span = max(float((hi - lo).max()), 1e-9)
    mid = (lo + hi) / 2
    W = H = 432
    x0, y0, side = 60, 50, 330            # the square plot area, in points

    def to_page(c):
        uv = (c - mid) / span * side + side / 2
        return [(x0 + u, y0 + v) for u, v in uv]
    box = [(x0, y0), (x0 + side, y0), (x0 + side, y0 + side), (x0, y0 + side), (x0, y0)]
    lines = [(box, (0, 0, 0), False)] + [(to_page(c), rgb, dashed) for c, rgb, dashed, _ in curves]
    lx, lly = x0 + 10, y0 + side - 16
    texts = [(x0, y0 + side + 12, 12, title),
             (x0 + side / 2 - 15, y0 - 32, 10, "x [m]"), (8, y0 + side / 2, 10, "z [m]"),
             (x0, y0 - 14, 8, f"{mid[0] - span / 2:.3g}"),
             (x0 + side - 30, y0 - 14, 8, f"{mid[0] + span / 2:.3g}"),
             (x0 - 44, y0, 8, f"{mid[1] - span / 2:.3g}"),
             (x0 - 44, y0 + side - 8, 8, f"{mid[1] + span / 2:.3g}")]
    for i, (_, rgb, dashed, label) in enumerate(curves):
        y = lly - 14 * i
        lines.append(([(lx, y + 3), (lx + 20, y + 3)], rgb, dashed))
        texts.append((lx + 26, y, 9, label))
    write_pdf(filename, W, H, lines, texts)


def save_ply(name, slam):
    """ASCII PLY of the patch-center point cloud with colors."""
    pts = slam.points()
    clr = slam.pg.colors_[: slam.pg.n].reshape(-1, 3)[: len(pts)]
    valid = np.isfinite(pts).all(axis=1)
    pts, clr = pts[valid], clr[valid]
    path = Path(f"{name}.ply")
    with open(path, "w") as f:
        f.write(
            "ply\nformat ascii 1.0\n"
            f"element vertex {len(pts)}\n"
            "property float x\nproperty float y\nproperty float z\n"
            "property uchar red\nproperty uchar green\nproperty uchar blue\n"
            "end_header\n"
        )
        for p, c in zip(pts, clr):
            f.write(f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f} {c[0]} {c[1]} {c[2]}\n")


def save_output_for_COLMAP(name, slam, fx, fy, cx, cy):
    """Minimal COLMAP text-model export (cameras/images/points3D)."""
    out = Path(name)
    out.mkdir(exist_ok=True, parents=True)
    poses = slam.pg.poses_[: slam.pg.n].cpu().numpy()
    pts = slam.points()
    with open(out / "cameras.txt", "w") as f:
        f.write(f"1 PINHOLE {slam.wd} {slam.ht} {fx} {fy} {cx} {cy}\n")
    with open(out / "images.txt", "w") as f:
        for i, p in enumerate(poses):
            tx, ty, tz, qx, qy, qz, qw = p
            f.write(f"{i+1} {qw} {qx} {qy} {qz} {tx} {ty} {tz} 1 frame_{i:06d}\n\n")
    with open(out / "points3D.txt", "w") as f:
        clr = slam.pg.colors_[: slam.pg.n].reshape(-1, 3)[: len(pts)]
        for i, (p, c) in enumerate(zip(pts, clr)):
            f.write(f"{i+1} {p[0]} {p[1]} {p[2]} {c[0]} {c[1]} {c[2]} 0\n")

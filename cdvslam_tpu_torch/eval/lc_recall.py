"""Retrieval recall of the classical loop closure on rendered imagery (port
of ``tools/bench_lc_recall.py``).

    python -m cdvslam_tpu_torch.eval.lc_recall [per_loop]

Renders a two-loop overhead orbit over a textured plane
(``data.render``: 192 x 256, ``PlaneScene(seed=3)``, one loop of
``overhead_loop_poses(per_loop)`` traversed twice, so frame per_loop + s
revisits frame s), degrades the second loop with photometric nuisance
(a per-frame gain and bias, then Gaussian pixel noise of sigma, drawn in
the tool's order after ``seed(int(100 sigma) + 1)``) and measures the
ORB + online-vocabulary BoW gate (``loop.retrieval.RetrievalBoW(rad=16,
thresh, train_threshold=2000)``) for each sigma in (0, 2, 5, 10) and
each threshold in (0.04, 0.06, 0.08, 0.10, 0.15):

  recall    = second-loop frames where ``detect_loop`` fires with a valid
              target, over the per_loop - 2 that can (the repetition
              check needs three hits in a row)
  precision = fired detections that are valid (the translation of the
              target's pose within half an inter-frame step of the query's)

It prints the tool's table and returns it as a dict (``rows``: one per
sigma and threshold, with the counts). All of it is host work (cv2's
ORB, the native BoW library), as in the JAX tool: it claims nothing of
the card.
"""
from __future__ import annotations

import sys

import numpy as np

HT, WD = 192, 256
INTR = np.array([220.0, 220.0, 128.0, 96.0], np.float32)
SIGMAS = (0.0, 2.0, 5.0, 10.0)
THRESHES = (0.04, 0.06, 0.08, 0.10, 0.15)


def degrade(img, sigma, rng):
    """A gain in [0.85, 1.15] and a bias in [-12, 12], then N(0, sigma^2)
    pixel noise when sigma > 0, clipped to uint8."""
    g = 1.0 + rng.uniform(-0.15, 0.15)
    b = rng.uniform(-12, 12)
    out = img.astype(np.float32) * g + b
    if sigma > 0:
        out = out + rng.randn(*out.shape) * sigma
    return np.clip(out, 0, 255).astype(np.uint8)


def run(per_loop=48, sigmas=SIGMAS, threshes=THRESHES, scene=None, loop_poses=None, out=None):
    """The recall table: {per_loop, frames, eligible, rows}, one row
    {sigma, thresh, fired, valid, detected, recall, precision} per
    (sigma, thresh). ``scene`` (with ``render(pose)``) and ``loop_poses``
    (per_loop, 7) default to the tool's; the table goes to ``out``
    (stdout by default)."""
    import cv2

    from ..data.render import PlaneScene, overhead_loop_poses
    from ..loop.retrieval import RetrievalBoW

    scene = scene if scene is not None else PlaneScene(INTR, HT, WD, seed=3)
    gt1 = np.asarray(loop_poses if loop_poses is not None else overhead_loop_poses(per_loop))
    gt = np.concatenate([gt1, gt1], axis=0)
    F = 2 * per_loop
    step = np.linalg.norm(gt1[1, :3] - gt1[0, :3])
    eligible = per_loop - 2
    rng = np.random.RandomState(0)
    out = out or sys.stdout
    print(f"{F} frames ({per_loop}/loop), exact revisit alignment; "
          f"rad=16, repetition check ON", file=out, flush=True)
    print(f"{'noise':>6} {'thresh':>7} {'recall':>7} {'precision':>9} {'fired':>6}", file=out)
    rows = []
    for sigma in sigmas:
        rng.seed(int(sigma * 100) + 1)
        imgs = [scene.render(gt[f]) for f in range(F)]
        imgs = [im if f < per_loop else degrade(im, sigma, rng) for f, im in enumerate(imgs)]
        gray = [cv2.cvtColor(im, cv2.COLOR_RGB2GRAY) for im in imgs]
        for thresh in threshes:
            r = RetrievalBoW(rad=16, thresh=thresh, train_threshold=2000)
            fired, valid, detected = 0, 0, set()
            for f in range(F):
                r.insert_image(gray[f], f)
                det = r.detect_loop(f)
                if det is None:
                    continue
                i, j = det
                fired += 1
                if np.linalg.norm(gt[i, :3] - gt[j, :3]) < 0.5 * step:
                    valid += 1
                    if i >= per_loop:       # recall counts true revisits only
                        detected.add(i)
            rec = len(detected) / eligible
            prec = valid / fired if fired else float("nan")
            rows.append({"sigma": sigma, "thresh": thresh, "fired": fired, "valid": valid,
                         "detected": len(detected), "recall": rec, "precision": prec})
            print(f"{sigma:6.1f} {thresh:7.2f} {rec:7.2f} {prec:9.2f} {fired:6d}", file=out,
                  flush=True)
    return {"per_loop": per_loop, "frames": F, "eligible": eligible, "rows": rows}


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("per_loop", nargs="?", type=int, default=48,
                    help="frames per loop (two loops are rendered)")
    return run(ap.parse_args(argv).per_loop)


if __name__ == "__main__":
    main()

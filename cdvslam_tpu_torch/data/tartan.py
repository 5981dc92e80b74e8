"""TartanAir training data reader (numpy and cv2; copy of
``cdvslam_tpu.data.tartan``, which imports no JAX).

Reimplements the reference's RGBDDataset/TartanAir pipeline
(reference: cdvslam/data_readers/base.py, tartan.py): pickled scene_info
with a flow-covisibility frame graph, forward-biased flow-bounded frame
sampling, NED->xyz pose permutation, DEPTH_SCALE=5 depth scaling,
color/scale augmentation, 0.98-quantile disparity normalization
(x0.7). Pure numpy + cv2; batches feed the trainer directly.
"""
from __future__ import annotations

import glob
import os.path as osp
import pickle

import numpy as np

# reference cdvslam/data_readers/tartan.py:17-50
TEST_SPLIT = """abandonedfactory/abandonedfactory/Easy/P011 abandonedfactory/abandonedfactory/Hard/P011
abandonedfactory_night/abandonedfactory_night/Easy/P013 abandonedfactory_night/abandonedfactory_night/Hard/P014
amusement/amusement/Easy/P008 amusement/amusement/Hard/P007 carwelding/carwelding/Easy/P007
endofworld/endofworld/Easy/P009 gascola/gascola/Easy/P008 gascola/gascola/Hard/P009
hospital/hospital/Easy/P036 hospital/hospital/Hard/P049 japanesealley/japanesealley/Easy/P007
japanesealley/japanesealley/Hard/P005 neighborhood/neighborhood/Easy/P021
neighborhood/neighborhood/Hard/P017 ocean/ocean/Easy/P009 ocean/ocean/Hard/P009
office2/office2/Easy/P011 office2/office2/Hard/P010 office/office/Hard/P007
oldtown/oldtown/Easy/P007 oldtown/oldtown/Hard/P008 seasidetown/seasidetown/Easy/P009
seasonsforest/seasonsforest/Easy/P011 seasonsforest/seasonsforest/Hard/P016
seasonsforest_winter/seasonsforest_winter/Easy/P009 seasonsforest_winter/seasonsforest_winter/Hard/P018
soulcity/soulcity/Easy/P012 soulcity/soulcity/Hard/P009 westerndesert/westerndesert/Easy/P013
westerndesert/westerndesert/Hard/P007""".split()

DEPTH_SCALE = 5.0
NED_PERM = [1, 2, 0, 4, 5, 3, 6]


def is_test_scene(scene):
    return any(x in scene for x in TEST_SPLIT)


class ColorJitter:
    """Brightness/contrast/saturation/grayscale/invert augmentation
    (reference augmentation.py:7-22) in numpy."""

    def __init__(self, rng):
        self.rng = rng

    def __call__(self, images):
        # images (F, H, W, 3) float [0,255]
        r = self.rng
        out = images
        out = out * r.uniform(0.6, 1.4)                    # brightness
        mean = out.mean(axis=(1, 2, 3), keepdims=True)
        out = (out - mean) * r.uniform(0.6, 1.4) + mean    # contrast
        gray = out.mean(axis=-1, keepdims=True)
        out = (out - gray) * r.uniform(0.6, 1.4) + gray    # saturation
        if r.rand() < 0.1:
            out = np.repeat(out.mean(-1, keepdims=True), 3, axis=-1)
        if r.rand() < 0.1:
            out = 255.0 - out
        return np.clip(out, 0, 255)


class TartanAirDataset:
    """Iterable clip sampler over a prebuilt scene_info pickle."""

    def __init__(self, datapath="datasets/TartanAir", n_frames=15,
                 crop_size=(480, 640), fmin=10.0, fmax=75.0, aug=True,
                 scene_info_path="datasets/TartanAir.pickle", seed=0):
        self.root = datapath
        self.n_frames = n_frames
        self.crop_size = crop_size
        self.fmin, self.fmax = fmin, fmax
        self.aug = aug
        self.rng = np.random.RandomState(seed)
        self.jitter = ColorJitter(self.rng)

        with open(scene_info_path, "rb") as f:
            self.scene_info = pickle.load(f)[0]

        self.index = []
        for scene in self.scene_info:
            if not is_test_scene(scene):
                graph = self.scene_info[scene]["graph"]
                for i in graph:
                    if i < len(graph) - 65:
                        self.index.append((scene, i))

    def __len__(self):
        return len(self.index)

    def _sample_frames(self, scene_id, ix):
        """Forward-biased flow-bounded frame chain (base.py:99-138)."""
        graph = self.scene_info[scene_id]["graph"]
        images_list = self.scene_info[scene_id]["images"]
        inds = [ix]
        while len(inds) < self.n_frames:
            js, flows = graph[ix]
            k = (flows > self.fmin) & (flows < self.fmax)
            frames = js[k]
            fwd = frames[frames > ix]
            if len(fwd):
                ix = int(self.rng.choice(fwd))
            elif ix + 1 < len(images_list):
                ix = ix + 1
            elif len(frames):
                ix = int(self.rng.choice(frames))
            inds.append(ix)
        return inds

    def __getitem__(self, index):
        import cv2

        scene_id, ix = self.index[index % len(self.index)]
        info = self.scene_info[scene_id]
        inds = self._sample_frames(scene_id, ix)

        images = np.stack([cv2.imread(info["images"][i]) for i in inds]).astype(np.float32)
        depths = np.stack([
            np.load(info["depths"][i]) / DEPTH_SCALE for i in inds
        ]).astype(np.float32)
        depths[~np.isfinite(depths)] = 1.0
        poses = np.stack([info["poses"][i] for i in inds]).astype(np.float32)
        intrinsics = np.stack([info["intrinsics"][i] for i in inds]).astype(np.float32)

        disps = 1.0 / depths

        if self.aug:
            if self.rng.rand() < 0.5:
                images = self.jitter(images)
            images, poses, disps, intrinsics = self._spatial(images, poses, disps, intrinsics)

        # 0.98-quantile disparity normalization (base.py:165-167)
        s = 0.7 * np.quantile(disps, 0.98)
        disps = disps / s
        poses[..., :3] *= s

        return images, poses, disps, intrinsics

    def _spatial(self, images, poses, disps, intrinsics):
        """Random up-scale + center crop (augmentation.py:24-55)."""
        import cv2

        F_, H, W, _ = images.shape
        ch, cw = self.crop_size
        min_scale = np.log2(max((ch + 1) / H, (cw + 1) / W))
        scale = 1.0
        if self.rng.rand() < 0.8:
            scale = 2 ** self.rng.uniform(max(0.0, min_scale), 0.5)
        h1, w1 = int(scale * H), int(scale * W)
        imgs = np.stack([cv2.resize(im, (w1, h1), interpolation=cv2.INTER_CUBIC) for im in images])
        dsp = np.stack([cv2.resize(d, (w1, h1), interpolation=cv2.INTER_NEAREST) for d in disps])
        intrinsics = intrinsics * scale
        y0 = (h1 - ch) // 2
        x0 = (w1 - cw) // 2
        intrinsics = intrinsics - np.array([0.0, 0.0, x0, y0])
        return (imgs[:, y0:y0 + ch, x0:x0 + cw],
                poses, dsp[:, y0:y0 + ch, x0:x0 + cw], intrinsics)

    def batches(self, batch_size, steps):
        """Simple shuffled batch iterator (replaces torch DataLoader)."""
        order = self.rng.permutation(len(self))
        k = 0
        for _ in range(steps):
            items = []
            for _ in range(batch_size):
                if k >= len(order):
                    order = self.rng.permutation(len(self))
                    k = 0
                items.append(self[int(order[k])])
                k += 1
            imgs, poses, disps, intr = zip(*items)
            # disps at 1/4 resolution for the rollout (train_cdvo.py:477)
            disps4 = np.stack(disps)[:, :, 1::4, 1::4]
            yield {
                "images": np.stack(imgs),
                "poses": np.stack(poses),
                "disps": disps4,
                "intrinsics": np.stack(intr)[:, 0],
            }


def build_scene_info(datapath, out_path="datasets/TartanAir.pickle"):
    """Build the scene_info pickle from raw TartanAir (tartan.py:64-88).

    Uses a simple flow-distance matrix like the reference rgbd_utils.
    """
    import cv2

    scene_info = {}
    scenes = sorted(glob.glob(osp.join(datapath, "*/*/*/*")))
    for scene in scenes:
        images = sorted(glob.glob(osp.join(scene, "image_left/*.png")))
        depths = sorted(glob.glob(osp.join(scene, "depth_left/*.npy")))
        if len(images) != len(depths) or not images:
            continue
        poses = np.loadtxt(osp.join(scene, "pose_left.txt"), delimiter=" ")
        poses = poses[:, NED_PERM]
        poses[:, :3] /= DEPTH_SCALE
        intrinsics = [np.array([320.0, 320.0, 320.0, 240.0])] * len(images)
        graph = _frame_graph(poses, depths, intrinsics)
        scene_info[scene] = {
            "images": images, "depths": depths, "poses": poses,
            "intrinsics": intrinsics, "graph": graph,
        }
    with open(out_path, "wb") as f:
        pickle.dump((scene_info,), f)
    return scene_info


def _quat_to_R(q):
    """(..., 4) xyzw quaternion -> (..., 3, 3) rotation matrix."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    n = x * x + y * y + z * z + w * w
    s = np.where(n > 0, 2.0 / np.maximum(n, 1e-12), 0.0)
    R = np.empty(q.shape[:-1] + (3, 3), q.dtype)
    R[..., 0, 0] = 1 - s * (y * y + z * z)
    R[..., 0, 1] = s * (x * y - w * z)
    R[..., 0, 2] = s * (x * z + w * y)
    R[..., 1, 0] = s * (x * y + w * z)
    R[..., 1, 1] = 1 - s * (x * x + z * z)
    R[..., 1, 2] = s * (y * z - w * x)
    R[..., 2, 0] = s * (x * z - w * y)
    R[..., 2, 1] = s * (y * z + w * x)
    R[..., 2, 2] = 1 - s * (x * x + y * y)
    return R


def _frame_graph(poses, depth_files, intrinsics, f=16, max_flow=256,
                 window=None):
    """Bidirectional mean-flow distance matrix between frames
    (reference rgbd_utils.py:103-141 compute_distance_matrix_flow +
    base.py:64-83 build_frame_graph), vectorized numpy.

    Matches the reference semantics: flow magnitudes clamped at
    MAX_FLOW=100, validity = transformed depth > 0.2, pairs with < 70%
    valid points set to inf, both warp directions averaged together,
    final distances scaled by the depth stride ``f``. ``window``
    optionally restricts pairs to |i-j| <= window (the reference does
    all pairs on GPU; a window keeps host building tractable — frames
    further apart than ~window are beyond max_flow anyway).
    """
    MAX_FLOW = 100.0

    def read_disp(fn):
        d = np.load(fn)[f // 2::f, f // 2::f] / DEPTH_SCALE
        d[d < 0.01] = np.mean(d)
        return 1.0 / d

    disps = np.stack([read_disp(fn) for fn in depth_files], 0)
    intr = np.asarray(intrinsics[0], np.float64) / f
    N, h, w = disps.shape
    fx, fy, cx, cy = intr

    # w2c relative transforms from c2w pose vectors (tx ty tz qx qy qz qw)
    t = poses[:, :3].astype(np.float64)
    R = _quat_to_R(poses[:, 3:].astype(np.float64))        # c2w rotation

    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    grid = np.stack([xx, yy], -1).reshape(-1, 2).astype(np.float64)
    # camera-frame points per frame i (f-strided pixel grid)
    Z = 1.0 / disps.reshape(N, -1).astype(np.float64)      # (N, hw)
    X = (grid[None, :, 0] - cx) / fx * Z
    Y = (grid[None, :, 1] - cy) / fy * Z
    Pc = np.stack([X, Y, Z], -1)                           # (N, hw, 3)

    def pair_flow(i, j):
        """(sum of clamped flow * val, sum of val) for warp i->j."""
        # X_j = R_j^T (R_i X_i + t_i - t_j)
        Pj = (Pc[i] @ R[i].T + (t[i] - t[j])) @ R[j]
        z = Pj[:, 2]
        val = z > 0.2
        zc = np.where(val, z, 1.0)
        u = fx * Pj[:, 0] / zc + cx
        v = fy * Pj[:, 1] / zc + cy
        mag = np.minimum(np.hypot(u - grid[:, 0], v - grid[:, 1]), MAX_FLOW)
        return float((mag * val).sum()), int(val.sum())

    d = np.full((N, N), np.inf, np.float32)
    hw = grid.shape[0]
    for i in range(N):
        j0, j1 = (0, N) if window is None else (
            max(0, i - window), min(N, i + window + 1))
        for j in range(j0, j1):
            # both directions, joint validity mean (rgbd_utils.py:123-136)
            s1, n1 = pair_flow(i, j)
            s2, n2 = pair_flow(j, i)
            if n1 + n2 >= 0.7 * 2 * hw:
                d[i, j] = f * (s1 + s2) / (n1 + n2)
    graph = {}
    for i in range(N):
        (j,) = np.where(d[i] < max_flow)
        graph[i] = (j, d[i, j])
    return graph

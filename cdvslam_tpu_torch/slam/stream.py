"""Frame streams: directory-of-images and video readers (a copy of
``cdvslam_tpu.slam.stream``, which imports no JAX).

Mirrors reference cdvslam/stream.py: 4/8/9-number calib files
(fx fy cx cy [k1 k2 p1 p2 [k3]]), cv2 undistortion, crop to multiple of 16,
video path at half resolution; runs in a background thread feeding a
bounded queue.

Unlike the JAX package, a frame that cv2 cannot decode, an image
directory with no image and a video with no frame raise; a reader that
raises in its thread puts the exception on the queue, and
``read_frames`` raises it again in the consumer.
"""
from __future__ import annotations

import queue
import threading
from itertools import chain
from pathlib import Path

import numpy as np


def load_calib(calib_path):
    calib = np.loadtxt(calib_path, delimiter=" ")
    fx, fy, cx, cy = calib[:4]
    K = np.eye(3)
    K[0, 0], K[0, 2], K[1, 1], K[1, 2] = fx, cx, fy, cy
    return calib, K


def image_stream(q, imagedir, calib, stride, skip=0, crop_border=None,
                 use_tstamp_names=False):
    """Image-directory generator feeding queue q (reference stream.py:9-42).

    crop_border=(by, bx): after undistortion, crop ``by`` rows from the
    top/bottom and ``bx`` columns from the left/right and shift the
    principal point accordingly — the reference's TUM distortion-boundary
    crop (reference evaluate_tum.py:44-47). use_tstamp_names: emit the
    float value of the filename stem as the timestamp (TUM-style) instead
    of the frame counter.
    """
    import cv2

    calib, K = load_calib(calib)
    img_exts = ["*.png", "*.jpeg", "*.jpg"]
    image_list = sorted(chain.from_iterable(Path(imagedir).glob(e) for e in img_exts))
    image_list = image_list[skip::stride]
    if not image_list:
        raise FileNotFoundError(f"no .png, .jpeg or .jpg image in {imagedir}")

    for t, imfile in enumerate(image_list):
        image = cv2.imread(str(imfile))
        if image is None:
            raise ValueError(f"cv2 cannot decode {imfile}")
        if len(calib) > 4:
            image = cv2.undistort(image, K, calib[4:])

        intrinsics = np.array([K[0, 0], K[1, 1], K[0, 2], K[1, 2]])
        if crop_border is not None:
            by, bx = crop_border
            image = image[by:-by if by else None, bx:-bx if bx else None]
            intrinsics[2] -= bx
            intrinsics[3] -= by
        h, w, _ = image.shape
        image = image[: h - h % 16, : w - w % 16]

        if use_tstamp_names:
            t = float(imfile.stem)
        q.put((t, image, intrinsics))

    q.put((-1, image, intrinsics))


def video_stream(q, imagedir, calib, stride, skip=0):
    """Video generator at half resolution (reference stream.py:45-89)."""
    import cv2

    calib, K = load_calib(calib)
    cap = cv2.VideoCapture(imagedir)
    if not cap.isOpened():
        raise ValueError(f"cv2 cannot open the video {imagedir}")
    t = 0
    for _ in range(skip):
        cap.read()

    image = intrinsics = None
    while True:
        for _ in range(stride - 1):
            ret, _ = cap.read()
            if not ret:
                break
        ret, image_next = cap.read()
        if not ret:
            break
        image = image_next
        if len(calib) > 4:
            image = cv2.undistort(image, K, calib[4:])
        image = cv2.resize(image, None, fx=0.5, fy=0.5)
        h, w, _ = image.shape
        image = image[: h - h % 16, : w - w % 16]

        intrinsics = np.array([K[0, 0] / 2, K[1, 1] / 2, K[0, 2] / 2, K[1, 2] / 2])
        q.put((t, image, intrinsics))
        t += 1

    cap.release()
    if image is None:
        raise ValueError(f"no frame decoded from the video {imagedir}")
    q.put((-1, image, intrinsics))


def _reader(target, q, args, kwargs):
    try:
        target(q, *args, **kwargs)
    except BaseException as e:   # re-raised by read_frames in the consumer
        q.put((-1, e, None))


def start_reader(target, imagedir, calib, stride=1, skip=0, maxsize=8,
                 **kwargs):
    """Launch the reader thread; returns the queue and the thread."""
    q = queue.Queue(maxsize=maxsize)
    th = threading.Thread(target=_reader,
                          args=(target, q, (imagedir, calib, stride, skip), kwargs),
                          daemon=True)
    th.start()
    return q, th


def read_frames(q):
    """Yield the reader's (t, image, intrinsics) until its end marker;
    raises what the reader thread raised."""
    while True:
        t, image, intrinsics = q.get()
        if isinstance(image, BaseException):
            raise RuntimeError("the frame reader failed") from image
        if t < 0:
            return
        yield t, image, intrinsics

"""A fault of the JAX runtime's patch window that the port does not copy.

``cdvslam_tpu/slam/runtime.py::_prepare_update`` clamps the window base
k0 with the default window (``self.KWIN``), then widens the window to a
power-of-two bucket of frames when loop edges span more. ``update_body``
(``cdvslam_tpu/slam/kernels.py:149-151``) slices the window with
``jax.lax.dynamic_slice``, which moves the start to N*M - KWIN whenever
k0 + KWIN > N*M, while the edges keep their rows kk - k0. The port picks
the window's size first and clamps k0 with it (``SLAM.patch_window``).

Here: a 64-frame buffer of 8 patches, 60 keyframes, local edges over the
last 23 frames and one loop pair from frame 10 to frame 50. The JAX
window is 64 frames from k0 = 80 and starts at row 0 instead, so every
edge reads the patch 80 rows (10 frames) before its own; the port's
window holds every edge's own patch.
"""
import jax
import numpy as np
import torch

from cdvslam_tpu.config import get_cfg as jax_get_cfg
from cdvslam_tpu.slam import SLAM as JaxSLAM
from cdvslam_tpu_torch.config import get_cfg
from cdvslam_tpu_torch.slam import SLAM

torch.set_num_threads(2)
M, N, n = 8, 64, 60


def _cfg(make):
    cfg = make()
    cfg.PATCHES_PER_FRAME, cfg.BUFFER_SIZE, cfg.MIXED_PRECISION = M, N, False
    return cfg


def _edges():
    kk_local, jj_local = np.meshgrid(np.arange((n - 23) * M, n * M), np.arange(n - 3, n),
                                     indexing="ij")
    kk = np.concatenate([10 * M + np.arange(M), kk_local.reshape(-1)])
    jj = np.concatenate([np.full(M, 50), jj_local.reshape(-1)])
    return kk // M, jj, kk


def test_jax_window_clamp_reads_other_patch_rows_than_the_port():
    ii, jj, kk = _edges()
    js = JaxSLAM(_cfg(jax_get_cfg), "cdv", ht=64, wd=96)
    k0, KWIN, packed, _ = js._prepare_update(ii, jj, kk, js.pg.bucket(len(ii)))
    kk_local = js._packed_rows16(packed, js.pg.bucket(len(ii)))[2, : len(ii)]
    assert k0 + KWIN > N * M                               # 80 + 512 > 512
    # the window as update_body slices it, from a buffer whose rows hold
    # their own index
    rows = jax.numpy.arange(N * M, dtype=jax.numpy.float32)[:, None, None, None]
    window = jax.lax.dynamic_slice(jax.numpy.broadcast_to(rows, (N * M, 3, 3, 3)),
                                   (k0, 0, 0, 0), (KWIN, 3, 3, 3))
    jax_rows = np.asarray(window[kk_local, 0, 0, 0]).astype(np.int64)
    np.testing.assert_array_equal(jax_rows, kk - 80)       # every edge: 10 frames early

    ts = SLAM(_cfg(get_cfg), "cdv", ht=64, wd=96, device="cpu")
    t0, twin = ts.patch_window(kk)
    assert twin == KWIN and t0 + twin <= N * M
    port_rows = (torch.arange(N * M)[t0:t0 + twin])[torch.as_tensor(kk - t0)].numpy()
    np.testing.assert_array_equal(port_rows, kk)

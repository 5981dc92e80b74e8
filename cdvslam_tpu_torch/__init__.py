"""CDV-SLAM in PyTorch with hand-written CUDA kernels for the H100.

A port of the JAX package ``cdvslam_tpu``: the CDV odometry main path
(``slam.SLAM``) with the patch-correlation and DINO flash-attention
kernels under ``csrc/``, the proximity loop closure with its
block-sparse global BA (``loop/``, ``ba/global_ba.py``), the seg and depth
heads, and DPVO compatibility (``SLAM(cfg, "dpv", ...)``, ``models/vonet.py``).
It imports torch and numpy, never JAX.
"""

"""The benchmark of the PyTorch and CUDA port (``cdvslam_tpu_torch``)."""

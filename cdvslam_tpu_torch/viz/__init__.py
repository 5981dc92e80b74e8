"""Trajectory and point-cloud writers and the two viewers (port of
``cdvslam_tpu.viz``)."""

"""Loop closure (port of ``cdvslam_tpu.loop``): the proximity backend."""

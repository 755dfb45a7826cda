"""frame_ms_p95: the 95th percentile, over every frame of the window, of the
time between one frame's completion and the next (CUDA events recorded
after each ``step()``, read after the window)."""

import numpy as np


def read(run):
    return float(np.percentile(run.intervals_ms, 95))

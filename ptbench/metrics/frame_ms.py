"""frame_ms: the window's wall time (host clock, to the wait for its last
frame) over the frames completed in it."""


def read(run):
    return run.window_s * 1e3 / run.window_frames

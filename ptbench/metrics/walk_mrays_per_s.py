"""walk_mrays_per_s: exact traced rays a frame (the program's
``count_traced_rays_exact`` over two frames of the traced slice) over the
walks' device time a frame."""


def read(run):
    walk_ms = run.bench.reader("walk_ms_per_frame")(run)
    if not walk_ms:
        return None
    return run.rays_per_frame() / (walk_ms * 1e-3) / 1e6

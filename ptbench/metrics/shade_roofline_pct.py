"""shade_roofline_pct: 100 x the least time of the traced slice's shading
launches, each priced from its record in ``Renderer.frame_records``
(ptbench/shade_bounds.py), over the device time of every
``shade_bounce_kernel`` in the slice; read only where the trace holds one
kernel a recorded launch."""

from ptbench import shade_bounds, spans


def read(run):
    recs = spans.slice_records(run)
    if recs is None:
        return None
    launches = [x for r in recs for x in r["launches"] if x["kernel"]]
    s, n = run.trace.device_s(r"shade_bounce_kernel")
    if not launches or n != len(launches):
        return None
    tables = shade_bounds.table_bytes(run.renderer.scene)
    least = sum(shade_bounds.least_shade_seconds(x, tables) for x in launches)
    return 100.0 * least / s

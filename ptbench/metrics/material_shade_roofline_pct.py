"""material_shade_roofline_pct: 100 x the least time of the traced slice's
shading launches, each priced from its record in ``Renderer.frame_records``
with its materials' work (ptbench/material_shade_bounds.py: the GGX lanes'
lobe evaluation and VNDF sample, the textured lanes' bilinear taps and the
bytes they must read), over the device time of every
``shade_bounce_kernel`` in the slice; read only where the trace holds one
kernel a recorded launch and some launch's scene has a roughness table or
textures (None on a parity slice, and on a program whose records carry no
GGX or texel counts)."""

from ptbench import material_shade_bounds as bounds
from ptbench import spans


def read(run):
    recs = spans.slice_records(run)
    if recs is None:
        return None
    launches = [x for r in recs for x in r["launches"] if x["kernel"]]
    if not any(bounds.has_materials(x) for x in launches):
        return None
    s, n = run.trace.device_s(r"shade_bounce_kernel")
    if n != len(launches):
        return None
    tables = bounds.table_bytes(run.renderer.scene)
    least = sum(bounds.least_material_seconds(x, tables) for x in launches)
    return 100.0 * least / s

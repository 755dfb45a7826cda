"""lane_occupancy_pct: 100 x the live lanes entering the shading launches of
bounces 1.. over the lanes those launches run (the live-prefix ladder's
width), over the traced slice's frames, from ``Renderer.frame_records``
(launches whose live count the ladder did not read are left out)."""

from ptbench import spans


def read(run):
    recs = spans.slice_records(run)
    if recs is None:
        return None
    launches = [x for r in recs for x in r["launches"]
                if x["bounce"] >= 1 and x["live"] is not None]
    if not launches:
        return None
    return 100.0 * sum(x["live"] for x in launches) / sum(x["lanes"] for x in launches)

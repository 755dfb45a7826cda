"""host_reads_per_frame: host transfers that wait for the device, a frame of
the traced slice, as the program counts them (``host_read`` spans: the
camera's three copies of host memory, the sort bounds' two reads, the
ladder's live counts), from ``Renderer.frame_records``."""

from ptbench import spans


def read(run):
    recs = spans.slice_records(run)
    if recs is None:
        return None
    return sum(r["host_reads"] for r in recs) / len(recs)

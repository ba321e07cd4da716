"""Host time in the program's blocking reads of device values, the spans
``gpax.host_read.<site>`` (every read that ``utils.host_syncs`` counts), a
leapfrog step over the profiled segments: the time the host waits on the
device at the tree's stop tests, the factor's ``info`` and the segment's
end. Spans are recorded only while the profiler runs."""

from gpax_torch.utils import monitor


def read(ctx):
    c = ctx["counters"]
    if ctx["trace"] is None or not hasattr(monitor, "spans") or not c.get("profiled_leapfrogs"):
        return None
    rec = monitor.spans()
    reads = [v["host_s"] for k, v in rec.items() if k.startswith("gpax.host_read.")]
    return 1e3 * sum(reads) / c["profiled_leapfrogs"] if reads else None

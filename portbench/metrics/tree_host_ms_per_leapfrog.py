"""Host time of the NUTS transitions (root spans ``gpax.nuts.transition``:
the tree, its bookkeeping and the adaptation's updates) outside the calls of
the potential and its gradient (``gpax.potential_grad``) and outside the
blocking reads (``gpax.host_read.*``), a leapfrog step over the profiled
segments. Spans are recorded only while the profiler runs."""

from gpax_torch.utils import monitor


def read(ctx):
    c = ctx["counters"]
    if ctx["trace"] is None or not hasattr(monitor, "span_time") \
            or not c.get("profiled_leapfrogs"):
        return None
    if "gpax.nuts.transition" not in monitor.spans():
        return None
    s = monitor.span_time("gpax.nuts.transition", ("gpax.potential_grad", "gpax.host_read."))
    return 1e3 * s / c["profiled_leapfrogs"]

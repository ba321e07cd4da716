"""Host time of a call of the potential and its gradient, the span
``gpax.potential_grad`` (forward and backward), less its blocking reads
(``gpax.host_read.*`` under it), over the calls recorded: the host's cost of
the model step, from ``models/gp.py`` to ``ops/fused_density.py``, one call a
leapfrog. Spans are recorded only while the profiler runs."""

from gpax_torch.utils import monitor


def read(ctx):
    if ctx["trace"] is None or not hasattr(monitor, "span_time"):
        return None
    calls = monitor.spans().get("gpax.potential_grad", {}).get("count", 0)
    if not calls:
        return None
    return 1e3 * monitor.span_time("gpax.potential_grad", ("gpax.host_read.",)) / calls

"""Host time of ``ops/chol.py::blocked_trtri``, the span ``gpax.inverse``
(K2's launch, its zero fill of W and the products of W's blocks), over the
calls of the potential and its gradient recorded, one a leapfrog: the
inverse's share of ``grad_host_ms_per_leapfrog``. Spans are recorded only
while the profiler runs."""

from gpax_torch.utils import monitor


def read(ctx):
    if ctx["trace"] is None or not hasattr(monitor, "span_time"):
        return None
    rec = monitor.spans()
    calls = rec.get("gpax.potential_grad", {}).get("count", 0)
    if not calls or "gpax.inverse" not in rec:
        return None
    return 1e3 * monitor.span_time("gpax.inverse") / calls

"""The share of the fit's factorizations (spans ``gpax.factor``) that failed
at the base jitter and were made again with the escalated one (spans
``gpax.factor.retry`` under them), over the profiled segments. Spans are
recorded only while the profiler runs."""

from gpax_torch.utils import monitor


def read(ctx):
    if ctx["trace"] is None or not hasattr(monitor, "spans"):
        return None
    rec = monitor.spans()
    factors = rec.get("gpax.factor", {}).get("count", 0)
    if not factors:
        return None
    return 100.0 * rec.get("gpax.factor.retry", {}).get("count", 0) / factors

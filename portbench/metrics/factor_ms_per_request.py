"""Device time under the span ``gpax.factor`` (``ops/linalg.py::
_chol_tri_factors_ld``: the draws' float64 potrf, any refactorization and the
inverse) an acquisition request, over the profiled requests: the requests
are the ``gpax.acq.EI`` root spans that the program recorded while the
profiler ran.

A span's profiler range is recorded as an operation (``gpax_torch.utils.
monitor.span``), so the trace's table has one entry of its name, the host's,
whose device time counts each kernel launched under the span once, its
children's included, and no device-side mirror of it to take its place."""

from gpax_torch.utils import monitor


def read(ctx):
    t = ctx["trace"]
    if t is None or not hasattr(monitor, "spans"):
        return None
    requests = monitor.spans().get("gpax.acq.EI", {}).get("count", 0)
    s = t.op_device_s.get("gpax.factor", 0.0)
    return 1e3 * s / requests if s > 0 and requests else None

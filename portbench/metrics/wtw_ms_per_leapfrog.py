"""Device time under the span ``gpax.wtw`` (``ops/linalg.py::wtw_compensated``,
the backward's K⁻¹ = WᵀW) a leapfrog step, over the profiled segments.

A span's profiler range is recorded as an operation (``gpax_torch.utils.
monitor.span``), so the trace's table has one entry of its name, the host's,
whose device time counts each kernel launched under the span once, its
children's included, and no device-side mirror of it to take its place."""


def read(ctx):
    t, c = ctx["trace"], ctx["counters"]
    if t is None or not c.get("profiled_leapfrogs"):
        return None
    s = t.op_device_s.get("gpax.wtw", 0.0)
    return 1e3 * s / c["profiled_leapfrogs"] if s > 0 else None

"""Device time under ``torch.linalg.cholesky_ex`` (cuSOLVER's float64
factor, escalations included) a leapfrog step, over the profiled segments."""


def read(ctx):
    t, c = ctx["trace"], ctx["counters"]
    if t is None or not c.get("profiled_leapfrogs"):
        return None
    s = t.op_device_s.get("aten::linalg_cholesky_ex", 0.0)
    return 1e3 * s / c["profiled_leapfrogs"] if s > 0 else None

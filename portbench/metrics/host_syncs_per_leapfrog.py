"""Host reads of device flags (``gpax_torch.utils.host_syncs``) a leapfrog
step, over the whole fit: each drains the launch queue."""


def read(ctx):
    c = ctx["counters"]
    return c["host_syncs"] / c["leapfrogs"] if c.get("leapfrogs") else None

"""Host reads of device flags (``gpax_torch.utils.host_syncs``) a scoring
request, over the window."""


def read(ctx):
    c = ctx["counters"]
    return c["host_syncs"] / c["requests"] if c.get("requests") else None

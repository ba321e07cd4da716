"""The sampling draws' mean tree size: leapfrog steps a draw. With
``leapfrogs_per_s`` it gives the draws a second that the user waits on: a
leapfrog made cheaper at the cost of longer trees shows here."""


def read(ctx):
    c = ctx["counters"]
    return c["draw_leapfrogs"] / c["draws"] if c.get("draws") else None

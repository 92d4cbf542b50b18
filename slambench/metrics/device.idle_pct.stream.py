"""The share of the stream's time in which no operation ran on the card:
the profiled stretch's device busy seconds a frame over the wall seconds a
frame of the untraced stretch before it (the profiler's own host cost
lengthens the profiled stretch's wall time, not its device time)."""


def read(ctx):
    s = ctx.get("summary")
    if s is None or s.busy_s <= 0 or not ctx.get("units"):
        return None
    busy = s.busy_s / ctx["units"]
    return 100.0 * (1.0 - busy / ctx["untraced_s_per_unit"])

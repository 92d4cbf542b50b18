"""Kernel launches the host made inside the front end (``ops/frame.
extract_frame``: ORB, the stereo search) per frame of the profiled
stretch."""


def read(ctx):
    s = ctx.get("summary")
    if s is None or not ctx.get("frames") or not s.launches.get("front_end"):
        return None
    return s.launches["front_end"] / ctx["frames"]

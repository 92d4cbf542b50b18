"""Frames tracked per second over both agents in the traced run's untraced
stretch: every frame the stretch completed over its wall time."""


def read(ctx):
    return ctx.get("frames_per_s") or None

"""The 95th percentile of a frame's time to its pose on the host, over
every frame of the traced run's untraced stretch (nearest rank)."""
from slambench import stats


def read(ctx):
    ms = ctx.get("frame_ms")
    return stats.p95(ms) if ms else None

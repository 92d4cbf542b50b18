"""K3's share of its roofline in the stream: every ``pcg_`` kernel over the
profiled stretch, against the live reduced systems of its BA solves."""
from slambench import roofline


def read(ctx):
    s = ctx.get("summary")
    if s is None:
        return None
    b, f = ctx["work"]["k3"]
    return roofline.share_pct(b, f, s.kernel_s("pcg_"))

"""K3's share of its roofline in the global-BA cells: every ``pcg_`` kernel
of ``csrc/pcg.cu`` over the profiled solves, against the bytes of the live
reduced systems by the problems' own masks (``roofline.k3_work``)."""
from slambench import roofline


def read(ctx):
    s = ctx.get("summary")
    if s is None:
        return None
    b, f = ctx["work"]["k3"]
    return roofline.share_pct(b, f, s.kernel_s("pcg_"))

"""K2's share of its roofline in the stream: the Schur preparation
(``ba_prep_kernel``, not the compaction) over the profiled stretch,
against the bytes of every BA solve in it (local BAs' two stages, and any
global BA) by their problems' masks."""
from slambench import roofline


def read(ctx):
    s = ctx.get("summary")
    if s is None:
        return None
    b, f = ctx["work"]["k2"]
    return roofline.share_pct(b, f, s.kernel_s("ba_prep_kernel",
                                               exclude=("compact",)))

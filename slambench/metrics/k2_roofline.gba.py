"""K2's share of its roofline in the global-BA cells: the Schur preparation
(``csrc/ba_prep.cu``'s ``ba_prep_kernel``, not the compaction) over the
profiled solves, against the bytes those solves need by the problems' own
masks (``roofline.k2_work``: the iterations' builds and the final cost)."""
from slambench import roofline


def read(ctx):
    s = ctx.get("summary")
    if s is None:
        return None
    b, f = ctx["work"]["k2"]
    return roofline.share_pct(b, f, s.kernel_s("ba_prep_kernel",
                                               exclude=("compact",)))

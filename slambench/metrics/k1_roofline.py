"""K1's share of its roofline: the pose optimizer's kernel
(``csrc/pose_opt.cu``'s ``pose_opt_kernel``) over the profiled stretch,
against the operations its calls need by their valid observations
(``roofline.k1_work``)."""
from slambench import roofline


def read(ctx):
    s = ctx.get("summary")
    if s is None or "k1_work" not in ctx:
        return None
    b, f = ctx["k1_work"]
    return roofline.share_pct(b, f, s.kernel_s("pose_opt_kernel",
                                               exclude=("_v1",)))

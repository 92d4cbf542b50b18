"""Device milliseconds of the reduced-system assembly (``optim/ba._assemble``,
banded windows and the overflow pass) per LM build in the global-BA cells:
the kernels launched inside the harness's span around each call."""


def read(ctx):
    s = ctx.get("summary")
    if s is None or not s.span_counts.get("assembly"):
        return None
    dev_s = s.spans["assembly"]
    if dev_s <= 0:
        return None
    return 1e3 * dev_s / s.span_counts["assembly"]

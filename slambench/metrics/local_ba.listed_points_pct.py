"""Points with an active observation slot over the point slots a local BA's
solves carry, over the profiled stretch's local BAs (both stages), from
the problems' own masks."""


def read(ctx):
    return ctx.get("lba_listed_pct")

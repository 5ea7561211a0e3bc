"""Device kernels per fold-batched training step in the profiled slice
(copies and fills not counted; the GAT slice's validation passes and
control included)."""


def read(ctx):
    if not ctx.slice or not ctx.work.get("steps"):
        return None
    return ctx.slice["kernels"] / ctx.work["steps"]

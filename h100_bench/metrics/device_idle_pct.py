"""Share of the profiled slice in which no kernel, copy or fill runs on
the device."""


def read(ctx):
    if not ctx.slice or not ctx.slice["window_s"]:
        return None
    s = ctx.slice
    return 100.0 * (s["window_s"] - s["busy_s"]) / s["window_s"]

"""The profiled slice's least time, the larger of its operations over the
float32 peak and its bytes over the HBM bandwidth (each input read once,
each output written once), as a share of the device's busy time in it."""

from h100_bench.peaks import FP32_FLOPS, HBM_BYTES_PER_S


def read(ctx):
    if not ctx.slice or not ctx.slice["busy_s"]:
        return None
    least = max(ctx.work["flops"] / FP32_FLOPS,
                ctx.work["bytes"] / HBM_BYTES_PER_S)
    return 100.0 * least / ctx.slice["busy_s"]

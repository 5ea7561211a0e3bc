"""Model FLOP utilisation of the window: the operations its whole CV runs
need by the model's equations (``families/<family>.py``), over the
window's seconds, as a share of the card's float32 peak."""

from h100_bench.peaks import FP32_FLOPS


def read(ctx):
    if not ctx.window_s or not ctx.flops:
        return None
    return 100.0 * ctx.flops / ctx.window_s / FP32_FLOPS

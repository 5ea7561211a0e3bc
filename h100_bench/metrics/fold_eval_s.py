"""The fold evaluation's seconds a CV run, as the pipeline's own result
times it (GSR-Net's ``timings["eval"]``, the GAT U-Net's
``timings["predict"]``: the same phase), averaged over the window's runs."""


def read(ctx):
    vals = [r["fold_eval_s"] for r in ctx.runs if r.get("fold_eval_s")]
    return sum(vals) / len(vals) if vals else None

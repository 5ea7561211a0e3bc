"""Seconds a CV run spends making its CUDA graphs: each ``EpochGraph``'s
warm-up, capture and instantiation, as the graph itself counts them,
summed over the graphs a run makes and averaged over the window's runs."""


def read(ctx):
    vals = [sum(sum(g) for g in r["graphs"]) for r in ctx.runs
            if r.get("graphs")]
    return sum(vals) / len(vals) if vals else None

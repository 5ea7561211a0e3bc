"""The evaluation suite: the Kaggle challenge's eight metrics (MAE, PCC,
Jensen-Shannon distance, KL on the weight distributions, and the MAE of
betweenness, eigenvector, PageRank and core-periphery scores), batched on
the card or through the reference's networkx pipeline."""

from fcsr_tpu_torch.evalx.metrics import (  # noqa: F401
    jensen_shannon_distance,
    mae,
    pearson_corr,
    weight_histogram_kl,
)
from fcsr_tpu_torch.evalx.centrality import (  # noqa: F401
    betweenness_centrality,
    core_number,
    eigenvector_centrality,
    pagerank,
    weighted_kcore_scores,
)
from fcsr_tpu_torch.evalx.report import (  # noqa: F401
    evaluate_metrics,
    evaluate_pair_stacks,
    print_metrics,
)

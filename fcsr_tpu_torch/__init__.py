"""fcsr_tpu_torch — the PyTorch / CUDA port of fcsr_tpu for an NVIDIA H100.

Mirrors ``fcsr_tpu``'s layout and names. It imports torch and numpy, never
JAX and nothing of ``fcsr_tpu``. Entry points run on the card by default
(``device="cuda"``) and raise without one unless the caller passes
``device="cpu"``, which runs the plain PyTorch version of every kernel.

Ported so far, from the Kaggle CSVs to ``submission.csv``: CSV ingest
through the anti-vectorize kernel (``data``), the seeded teacher dataset,
k-fold plans, the host spectral precompute, the fold-parallel GSR-Net
trainer whose training step (``models.fused_step.train_step_fused``) runs
on hand-written CUDA kernels (``kernels/csrc``) with checkpoint / resume,
the GSRNet evaluation and test-set forward, the submission writer in both
orderings (``iox``), ``pipelines.run_gsr_cv_fast`` and the command line
(``python -m fcsr_tpu_torch train gsr --fused | predict | submit``).
"""

from fcsr_tpu_torch.data import (kfold_indices, load_dataset,
                                 load_dataset_device, load_or_synthesize,
                                 write_kaggle_csvs)
from fcsr_tpu_torch.iox import save_prediction
from fcsr_tpu_torch.models import GSRNet, train_step_fused
from fcsr_tpu_torch.pipelines import run_gsr_cv_fast
from fcsr_tpu_torch.train import (GSRFoldRunner, GSRTrainConfig,
                                  evaluate_gsr, predict_gsr)
from fcsr_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device

__all__ = ["DEFAULT_DEVICE", "GSRFoldRunner", "GSRNet", "GSRTrainConfig",
           "evaluate_gsr", "kfold_indices", "load_dataset",
           "load_dataset_device", "load_or_synthesize", "predict_gsr",
           "resolve_device", "run_gsr_cv_fast", "save_prediction",
           "train_step_fused", "write_kaggle_csvs"]

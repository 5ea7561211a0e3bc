"""fcsr_tpu_torch — the PyTorch / CUDA port of fcsr_tpu for an NVIDIA H100.

Mirrors ``fcsr_tpu``'s layout and names. It imports torch and numpy, never
JAX and nothing of ``fcsr_tpu``. Entry points run on the card by default
(``device="cuda"``) and raise without one unless the caller passes
``device="cpu"``, which runs the plain PyTorch version of every kernel.

The main path so far: the seeded teacher dataset, k-fold plans, the host
spectral precompute, and the fold-parallel GSR-Net trainer whose training
step (``models.fused_step.train_step_fused``) runs on hand-written CUDA
kernels (``kernels/csrc``), then a GSRNet evaluation forward.
"""

from fcsr_tpu_torch.data import kfold_indices, load_or_synthesize
from fcsr_tpu_torch.models import GSRNet, train_step_fused
from fcsr_tpu_torch.train import GSRFoldRunner, GSRTrainConfig
from fcsr_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device

__all__ = ["DEFAULT_DEVICE", "GSRFoldRunner", "GSRNet", "GSRTrainConfig",
           "kfold_indices", "load_or_synthesize", "resolve_device",
           "train_step_fused"]

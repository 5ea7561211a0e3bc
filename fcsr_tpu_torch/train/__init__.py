from fcsr_tpu_torch.train.fast_loop import GSRFoldRunner, stage_dataset
from fcsr_tpu_torch.train.gsr_loop import GSRTrainConfig, precompute_spectral
from fcsr_tpu_torch.train.losses import gsr_composite_loss, l1

__all__ = ["GSRFoldRunner", "GSRTrainConfig", "gsr_composite_loss", "l1",
           "precompute_spectral", "stage_dataset"]

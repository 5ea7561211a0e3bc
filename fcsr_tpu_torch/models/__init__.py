from fcsr_tpu_torch.models.fused_step import (FlatLayout, train_step_fused,
                                              train_step_plain)
from fcsr_tpu_torch.models.gsr import GSRNet, pool_sizes

__all__ = ["FlatLayout", "GSRNet", "pool_sizes", "train_step_fused",
           "train_step_plain"]

from fcsr_tpu_torch.models.fused_step import (FlatLayout,
                                              gsr_step_loss_fused,
                                              step_loss_pure,
                                              step_value_and_grad_fused,
                                              train_step_fused,
                                              train_step_plain,
                                              unet_forward_rankselect,
                                              unet_fused, unet_fused_fwdbwd,
                                              unet_fused_fwdonly)
from fcsr_tpu_torch.models.fused_tail import (tail_loss_fused,
                                              tail_loss_reference)
from fcsr_tpu_torch.models.gsr import GSRNet, pool_sizes

__all__ = ["FlatLayout", "GSRNet", "gsr_step_loss_fused", "pool_sizes",
           "step_loss_pure", "step_value_and_grad_fused", "tail_loss_fused",
           "tail_loss_reference", "train_step_fused", "train_step_plain",
           "unet_forward_rankselect", "unet_fused", "unet_fused_fwdbwd",
           "unet_fused_fwdonly"]

from fcsr_tpu_torch.models.fused_step import (FlatLayout,
                                              gsr_step_loss_fused,
                                              step_loss_pure,
                                              step_value_and_grad_fused,
                                              train_step_fused,
                                              train_step_plain,
                                              unet_forward_rankselect,
                                              unet_fused, unet_fused_fwdbwd,
                                              unet_fused_fwdonly)
from fcsr_tpu_torch.models.fused_gat import (GATLayout, gat_step_loss,
                                             gat_train_step_fused,
                                             gat_train_step_plain,
                                             gat_val_fused, gat_val_plain)
from fcsr_tpu_torch.models.fused_tail import (tail_loss_fused,
                                              tail_loss_reference)
from fcsr_tpu_torch.models.gat_unet import GATGraphUnet, gat_pool_sizes
from fcsr_tpu_torch.models.gsr import GSRNet, pool_sizes
from fcsr_tpu_torch.models.mlp import (MLPLayout, SNDense, SpectralResMLP,
                                       SuperResMLP, TorchBatchNorm)
from fcsr_tpu_torch.models.upsample import (GCNLayer, GraphSAGEUpsampler,
                                            linear_interp_matrix)

__all__ = ["FlatLayout", "GATGraphUnet", "GATLayout", "GCNLayer", "GSRNet",
           "GraphSAGEUpsampler", "MLPLayout", "SNDense", "SpectralResMLP", "SuperResMLP",
           "TorchBatchNorm", "gat_pool_sizes", "gat_step_loss", "gat_train_step_fused",
           "gat_train_step_plain", "gat_val_fused", "gat_val_plain",
           "gsr_step_loss_fused", "linear_interp_matrix", "pool_sizes",
           "step_loss_pure", "step_value_and_grad_fused", "tail_loss_fused",
           "tail_loss_reference", "train_step_fused", "train_step_plain",
           "unet_forward_rankselect", "unet_fused", "unet_fused_fwdbwd",
           "unet_fused_fwdonly"]

from fcsr_tpu_torch.train.fast_loop import (GSRFoldRunner,
                                            evaluate_gsr_folds,
                                            stage_dataset,
                                            train_gsr_folds_parallel,
                                            trainer_mode)
from fcsr_tpu_torch.train.gat_loop import (GATTrainConfig, init_gat,
                                           precompute_gat_features,
                                           predict_gat, predict_gat_folds,
                                           predict_gat_folds_mae, train_gat,
                                           train_gat_folds_parallel)
from fcsr_tpu_torch.train.generic_loop import (PlateauScheduler, TrainState,
                                               mse_criterion, train_model,
                                               train_model_folds)
from fcsr_tpu_torch.train.gsr_loop import (GSRTrainConfig, evaluate_gsr,
                                           init_gsr, make_train_fn,
                                           precompute_spectral, predict_gsr,
                                           train_gsr_fold)
from fcsr_tpu_torch.train.losses import (gsr_composite_loss,
                                         intermediate_recon_loss, l1,
                                         make_triu_mse_criterion,
                                         offdiag_mse_loss, pack_triu_targets)

__all__ = ["GATTrainConfig", "GSRFoldRunner", "GSRTrainConfig",
           "PlateauScheduler", "TrainState", "evaluate_gsr", "init_gat",
           "intermediate_recon_loss", "offdiag_mse_loss",
           "precompute_gat_features", "predict_gat", "predict_gat_folds",
           "predict_gat_folds_mae", "train_gat", "train_gat_folds_parallel",
           "evaluate_gsr_folds", "gsr_composite_loss", "init_gsr", "l1",
           "make_train_fn", "precompute_spectral", "predict_gsr",
           "stage_dataset", "train_gsr_fold", "train_gsr_folds_parallel",
           "trainer_mode", "make_triu_mse_criterion", "mse_criterion",
           "pack_triu_targets", "train_model", "train_model_folds"]

from fcsr_tpu_torch.train.fast_loop import (GSRFoldRunner,
                                            evaluate_gsr_folds,
                                            stage_dataset,
                                            train_gsr_folds_parallel,
                                            trainer_mode)
from fcsr_tpu_torch.train.gsr_loop import (GSRTrainConfig, evaluate_gsr,
                                           init_gsr, make_train_fn,
                                           precompute_spectral, predict_gsr,
                                           train_gsr_fold)
from fcsr_tpu_torch.train.losses import gsr_composite_loss, l1

__all__ = ["GSRFoldRunner", "GSRTrainConfig", "evaluate_gsr",
           "evaluate_gsr_folds", "gsr_composite_loss", "init_gsr", "l1",
           "make_train_fn", "precompute_spectral", "predict_gsr",
           "stage_dataset", "train_gsr_fold", "train_gsr_folds_parallel",
           "trainer_mode"]

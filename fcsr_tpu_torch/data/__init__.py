from fcsr_tpu_torch.data.datamodule import (ConnectomeDataModule,
                                            contiguous_window_folds,
                                            epoch_permutations,
                                            kfold_indices, train_val_split)
from fcsr_tpu_torch.data.device_pipeline import (ingest_vectors_to_device,
                                                 load_dataset_device)
from fcsr_tpu_torch.data.io import (has_real_csvs, load_csv_vectors,
                                    load_dataset, load_or_synthesize,
                                    matrix_size_for, write_kaggle_csvs)
from fcsr_tpu_torch.data.synthetic import (synthesize_paired_connectomes,
                                           synthesize_teacher_connectomes)

__all__ = ["ConnectomeDataModule", "contiguous_window_folds",
           "epoch_permutations", "kfold_indices", "train_val_split",
           "has_real_csvs", "ingest_vectors_to_device", "load_csv_vectors", "load_dataset", "load_dataset_device",
           "load_or_synthesize", "matrix_size_for",
           "synthesize_paired_connectomes", "synthesize_teacher_connectomes",
           "write_kaggle_csvs"]

from fcsr_tpu_torch.data.datamodule import kfold_indices
from fcsr_tpu_torch.data.device_pipeline import (ingest_vectors_to_device,
                                                 load_dataset_device)
from fcsr_tpu_torch.data.io import (has_real_csvs, load_csv_vectors,
                                    load_dataset, load_or_synthesize,
                                    matrix_size_for, write_kaggle_csvs)
from fcsr_tpu_torch.data.synthetic import synthesize_teacher_connectomes

__all__ = ["kfold_indices", "has_real_csvs", "ingest_vectors_to_device",
           "load_csv_vectors", "load_dataset", "load_dataset_device",
           "load_or_synthesize", "matrix_size_for",
           "synthesize_teacher_connectomes", "write_kaggle_csvs"]

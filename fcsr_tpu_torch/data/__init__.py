from fcsr_tpu_torch.data.datamodule import kfold_indices
from fcsr_tpu_torch.data.io import has_real_csvs, load_or_synthesize
from fcsr_tpu_torch.data.synthetic import synthesize_teacher_connectomes

__all__ = ["kfold_indices", "has_real_csvs", "load_or_synthesize",
           "synthesize_teacher_connectomes"]

from fcsr_tpu_torch.core.normalize import (fill_diagonal, normalize_adj,
                                          normalize_adj_np, pad_hr_adj,
                                          symmetrize, unpad)

__all__ = ["fill_diagonal", "normalize_adj", "normalize_adj_np",
           "pad_hr_adj", "symmetrize", "unpad"]

from fcsr_tpu_torch.core.normalize import (fill_diagonal, normalize_adj,
                                          normalize_adj_np, pad_hr_adj,
                                          symmetric_normalize, symmetrize,
                                          unpad)
from fcsr_tpu_torch.core.triu_kernels import (anti_vectorize_normalize,
                                              normalize_adj_batch,
                                              vectorize_colmajor)
from fcsr_tpu_torch.core.vectorize import (MatrixVectorizer, anti_vectorize,
                                           anti_vectorize_batch,
                                           triu_indices_colmajor,
                                           triu_indices_rowmajor, vec_len,
                                           vectorize, vectorize_batch,
                                           vectorize_rowmajor)

__all__ = ["MatrixVectorizer", "anti_vectorize", "anti_vectorize_batch",
           "anti_vectorize_normalize", "fill_diagonal", "normalize_adj",
           "normalize_adj_batch", "normalize_adj_np", "pad_hr_adj",
           "symmetric_normalize", "symmetrize", "triu_indices_colmajor", "triu_indices_rowmajor",
           "unpad", "vec_len", "vectorize", "vectorize_batch",
           "vectorize_colmajor", "vectorize_rowmajor"]

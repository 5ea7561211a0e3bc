"""What both references share: IEEE float32 with TF32 off, the host
staging they work out again from the raw inputs, and the comparisons.

The references are plain PyTorch and NumPy. They import nothing of the
program and take nothing it has made: they start from the inputs and the
initial weights that the benchmark makes from ``--seed`` and hands to
both sides, and they read the program's outputs only to judge them.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["strict_fp32", "normalize_adj_sym", "spectral_bases", "rel_gap",
           "norm_gaps", "topk_desc"]


def strict_fp32() -> None:
    """Products in IEEE float32 on the card: TF32 off for matmul and
    cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def normalize_adj_sym(mx: np.ndarray) -> np.ndarray:
    """D^-1/2 A D^-1/2 over the trailing two axes, a zero degree giving 0
    (the symmetric adjacencies of staging), in the input's dtype."""
    rowsum = mx.sum(axis=-1)
    with np.errstate(divide="ignore"):
        r = rowsum ** -0.5
    r[np.isinf(r)] = 0.0
    return mx * r[..., None, :] * r[..., :, None]


def spectral_bases(lr: np.ndarray, hr: np.ndarray = None, lr_dim: int = 160):
    """GSR-Net's data-side eigenvectors, by host LAPACK on float32 (the
    signs change the model, so the call is the one the model's users
    make): U_lr of the normalised LR adjacency per subject, and, given the
    labels, the first ``lr_dim`` columns of U_hr of the label with its
    diagonal set to 1."""
    lr = np.asarray(lr, np.float32)
    _, u_lr = np.linalg.eigh(normalize_adj_sym(lr))
    if hr is None:
        return u_lr, None
    hr = np.array(hr, np.float32)
    n = hr.shape[-1]
    hr[:, np.arange(n), np.arange(n)] = 1.0
    _, u_hr = np.linalg.eigh(hr)
    return u_lr, u_hr[..., :, :lr_dim]


def topk_desc(scores: torch.Tensor, k: int):
    """(values, indices) of the k largest scores along the last axis,
    descending, ties to the lower index; and the margin between the last
    kept and the first dropped score: inf where nothing is dropped or the
    two are equal (an exact tie, such as two rows that a ReLU zeroed, falls
    to the lower index on both sides)."""
    order = torch.sort(scores, dim=-1, descending=True, stable=True).indices
    s = torch.gather(scores, -1, order)
    if k >= scores.shape[-1]:
        margin = torch.full(scores.shape[:-1], float("inf"),
                            device=scores.device)
    else:
        margin = s[..., k - 1] - s[..., k]
        margin = torch.where(margin == 0, float("inf"), margin)
    return s[..., :k], order[..., :k], margin


def rel_gap(prog, ref) -> float:
    """Largest |prog - ref| over the entries, over the largest |ref|
    (inf where there is nothing to compare)."""
    if prog.numel() == 0:
        return float("inf")
    prog = torch.as_tensor(prog, dtype=torch.float64)
    ref = torch.as_tensor(ref, dtype=torch.float64)
    return float((prog - ref).abs().max() / ref.abs().max().clamp(min=1e-30))


def norm_gaps(prog_norms: dict, ref_norms: dict, keep=None) -> dict:
    """Each leaf's gap between the program's norm and the reference's,
    over the larger of that leaf's reference norm and the median leaf's;
    ``keep`` names the leaves counted (default all)."""
    names = [k for k in ref_norms if keep is None or k in keep]
    med = float(np.median([ref_norms[k] for k in names]))
    return {k: abs(prog_norms[k] - ref_norms[k]) / max(ref_norms[k], med,
                                                       1e-30)
            for k in names}

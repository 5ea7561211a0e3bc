"""Script forms of the reference notebooks, the port's counterparts of the
JAX package's ``examples/``. Run from the repository root:

    python -m fcsr_tpu_torch.examples.train_gsr [--fast] [--device cpu]
    python -m fcsr_tpu_torch.examples.train_template
    python -m fcsr_tpu_torch.examples.unet_transformer
    python -m fcsr_tpu_torch.examples.three_fold_vis --runs outputs/mlp ...
"""

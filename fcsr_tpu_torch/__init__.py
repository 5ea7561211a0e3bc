"""fcsr_tpu_torch — the PyTorch / CUDA port of fcsr_tpu for an NVIDIA H100.

Mirrors ``fcsr_tpu``'s layout and names. It imports torch and numpy, never
JAX and nothing of ``fcsr_tpu``. Entry points run on the card by default
(``device="cuda"``) and raise without one unless the caller passes
``device="cpu"``, which runs the plain PyTorch version of every kernel.

Ported so far, from the Kaggle CSVs to ``submission.csv``: CSV ingest
through the anti-vectorize kernel (``data``), the seeded teacher dataset,
k-fold plans, the host spectral precompute, every GSR-Net trainer of the
JAX package — the parity trainer (``train.train_gsr_fold``,
``pipelines.run_gsr_cv``) and the fold-parallel ``GSRFoldRunner`` in its
unfused, ``fused_tail``, ``fused_unet``, ``fused_step`` and ``fused_adam``
modes, whose fused entry points (``models.tail_loss_fused``,
``unet_fused_fwdbwd``, ``gsr_step_loss_fused``, ``train_step_fused``, ...)
run on hand-written CUDA kernels (``kernels/csrc``) — with checkpoint /
resume, the GSRNet evaluation and test-set forward, the submission writer
in both orderings (``iox``), ``pipelines.run_gsr_cv_fast`` and the command
line (``python -m fcsr_tpu_torch train gsr [--fast] [--fused-tail]
[--fused] | predict | submit``). The GAT Graph-U-Net family is ported the
same way: ``models.GATGraphUnet``, ``train.train_gat`` and
``train_gat_folds_parallel`` (unfused, or ``fused_step`` / ``fused_val`` on
the kernels of ``models.gat_train_step_fused`` / ``gat_val_fused``, under
host or on-device control), ``pipelines.run_gat_cv`` / ``run_gat_cv_fast``
and ``train gat [--fast] [--fused]``. The evaluation suite (``evalx``: the
challenge's eight metrics on the card or through networkx;
``core/graph.py``) scores saved stacks (``evaluate``) and every fold of a
``--full-metrics`` run. The MLP family: ``models.SpectralResMLP`` (v2) and
``SuperResMLP`` (v1), the fold-parallel generic trainer
(``train.train_model_folds``, ``train_model``; AdamW on the
``adamw_masked`` kernel), ``pipelines.run_mlp_cv`` and ``train mlp``. The
JAX package's flax msgpack files are read and written by the port's own
coder (``iox.msgpack``; ``predict --params *.msgpack``); the GraphSAGE
upsampler (``models.GraphSAGEUpsampler``), the ``lift`` synthetic set,
the ``utils`` helpers and the example drivers
(``python -m fcsr_tpu_torch.examples.<name>``) complete the
single-device modules. ``parallel`` shards the folds of the GSR-Net and
GAT trainers over the cards of a mesh (``GSRFoldRunner(mesh=)``,
``train_gat_folds_parallel(mesh=)``, ``multichip=True``, ``--multichip``)
and holds the data-parallel steps and the ``torch.distributed`` bootstrap.
"""

from fcsr_tpu_torch.data import (kfold_indices, load_dataset,
                                 load_dataset_device, load_or_synthesize,
                                 write_kaggle_csvs)
from fcsr_tpu_torch.iox import save_prediction
from fcsr_tpu_torch.models import (GATGraphUnet, GSRNet, SpectralResMLP,
                                   SuperResMLP, gat_train_step_fused,
                                   gat_val_fused, gsr_step_loss_fused,
                                   tail_loss_fused, train_step_fused,
                                   unet_fused_fwdbwd, unet_fused_fwdonly)
from fcsr_tpu_torch.pipelines import (run_gat_cv, run_gat_cv_fast,
                                      run_gsr_cv, run_gsr_cv_fast,
                                      run_mlp_cv)
from fcsr_tpu_torch.train import (GATTrainConfig, GSRFoldRunner,
                                  GSRTrainConfig, evaluate_gsr, init_gat,
                                  init_gsr, make_train_fn, predict_gat,
                                  predict_gsr, train_gat,
                                  train_gat_folds_parallel, train_gsr_fold,
                                  train_model, train_model_folds)
from fcsr_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device

__all__ = ["DEFAULT_DEVICE", "GATGraphUnet", "GATTrainConfig",
           "GSRFoldRunner", "GSRNet", "GSRTrainConfig", "evaluate_gsr",
           "gat_train_step_fused", "gat_val_fused", "gsr_step_loss_fused",
           "init_gat", "init_gsr", "predict_gat", "run_gat_cv",
           "run_gat_cv_fast", "train_gat", "train_gat_folds_parallel",
           "kfold_indices", "load_dataset", "load_dataset_device",
           "load_or_synthesize", "make_train_fn", "predict_gsr",
           "resolve_device", "run_gsr_cv", "run_gsr_cv_fast", "run_mlp_cv",
           "SpectralResMLP", "SuperResMLP", "train_model",
           "train_model_folds", "save_prediction", "tail_loss_fused", "train_gsr_fold",
           "train_step_fused", "unet_fused_fwdbwd", "unet_fused_fwdonly",
           "write_kaggle_csvs"]

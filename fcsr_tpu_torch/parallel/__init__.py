"""Multi-device training over ``torch.distributed``: the ``('batch',)``
mesh, the data-parallel steps and the multi-process bootstrap. Fold
sharding, the production path, is ``GSRFoldRunner(mesh=)`` and
``train_gat_folds_parallel(mesh=)``."""

from fcsr_tpu_torch.parallel.distributed import (  # noqa: F401
    host_shard_slice,
    maybe_initialize_distributed,
)
from fcsr_tpu_torch.parallel.mesh import (  # noqa: F401
    BatchMesh,
    batch_mesh,
    make_sharded_batch_step,
    make_sharded_generic_step,
    shard_batch,
    virtual_batch_mesh,
)

from fcsr_tpu_torch.utils.compile_cache import enable_persistent_cache
from fcsr_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device
from fcsr_tpu_torch.utils.profiling import PhaseTimer, trace_if_enabled
from fcsr_tpu_torch.utils.reproducibility import seed_everything, set_seed

__all__ = ["DEFAULT_DEVICE", "PhaseTimer", "enable_persistent_cache",
           "resolve_device", "seed_everything", "set_seed",
           "trace_if_enabled"]

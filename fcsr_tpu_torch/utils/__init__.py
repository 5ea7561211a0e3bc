from fcsr_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device

__all__ = ["DEFAULT_DEVICE", "resolve_device"]

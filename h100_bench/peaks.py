"""The table of peaks the shares are taken of: one NVIDIA H100 SXM,
NVIDIA's data sheet, dense rates at the full 700 W. Both configurations
state IEEE float32, so the operation peak is float32 outside the tensor
cores; a mode with products in a lower precision needs its own peak here
before its cells may report against it."""

FP32_FLOPS = 67e12          # float32, CUDA cores
HBM_BYTES_PER_S = 3.35e12   # HBM3

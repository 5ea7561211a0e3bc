from fcsr_tpu_torch.native.csv_reader import (fast_csv_available,
                                              read_csv_float32)

__all__ = ["fast_csv_available", "read_csv_float32"]

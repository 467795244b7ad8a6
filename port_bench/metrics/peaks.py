"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit).  A card set below 700 W runs
slower under load; every run prints its card's `power.limit`."""

FP32_FLOP_S = 67e12  # float32 outside the tensor cores
INT8_OPS_S = 1979e12  # int8 on the tensor cores
HBM_BYTES_S = 3.35e12  # device memory

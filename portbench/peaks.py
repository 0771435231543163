"""Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates at the
700 W limit): the yardstick of every roofline and MFU metric."""
TF32_FLOP_S = 494.7e12      # tensor cores, TF32: the fastest fp32-accurate product
FP32_FLOP_S = 67e12         # CUDA cores, fp32 (elementwise work)
HBM_BYTES_S = 3.35e12       # HBM3 bandwidth

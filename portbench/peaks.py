"""Published dense peaks of one H100 SXM (NVIDIA's data sheet, 700 W), the
same numbers as the port's ``tools/microbench.py``: HBM3 bytes per second,
and operations per second of the tensor cores in bfloat16 and of the CUDA
cores in float32.  Every share of a peak is stated against these, with the
card's power limit beside it (``device.power_limit`` in a run's record)."""

PEAK_BYTES = 3.35e12
PEAK_FLOPS_BF16 = 989e12
PEAK_FLOPS_F32 = 67e12

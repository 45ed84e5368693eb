"""Operation and byte counts of the port's work, computed from shapes and
from the static arrays of a cell's frozen model file, and the published
peaks of one NVIDIA H100 SXM they are held against (NVIDIA's data sheet,
dense rates, at the full 700 W power limit)."""

H100_FP32_FLOPS = 67e12
H100_HBM_BYTES_PER_S = 3.35e12

"""Published peaks of one NVIDIA H100 SXM (80 GB HBM3), dense, at its
700 W limit (NVIDIA's data sheet)."""

HBM_BYTES_PER_S = 3.35e12
FLOPS = {"float32": 67e12, "tf32": 495e12, "bfloat16": 989e12}

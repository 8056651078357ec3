"""Published peaks of one NVIDIA H100 SXM5 80 GB (NVIDIA's data sheet,
dense, no sparsity), at its 700 W power limit."""

FLOPS = {
    "bfloat16": 989e12,
    "float16": 989e12,
    "tf32": 495e12,
    "float32": 67e12,
}
HBM_BYTES_PER_S = 3.35e12


def roofline_s(flops: float, nbytes: float, precision: str = "bfloat16") -> float:
    """The least time the chip could take for this work."""
    return max(flops / FLOPS[precision], nbytes / HBM_BYTES_PER_S)

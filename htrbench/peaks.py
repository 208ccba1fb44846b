"""Published peaks of one NVIDIA H100 SXM (80 GB HBM3), dense rates, at the
full 700 W power limit (NVIDIA's data sheet). A roofline share or an MFU is
stated against these, with the card's power limit beside it."""

HBM_BYTES_PER_S = 3.35e12
BF16_OPS_PER_S = 989e12
INT8_OPS_PER_S = 1979e12
F32_OPS_PER_S = 67e12


def least_seconds(n_bytes: float, n_ops: float, ops_per_s: float) -> float:
    """The least time the card takes to move ``n_bytes`` through HBM and do
    ``n_ops`` operations at ``ops_per_s``: the larger of the two bounds."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / ops_per_s)

"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
at the full 700 W power limit).  Every roofline and MFU share of the
benchmark is taken against these numbers, with the card's power limit
reported beside it."""

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


def least_seconds(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """The least time the card could take for ``n_bytes`` moved and
    ``n_ops`` float32 operations, and which bound sets it."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / FP32_OPS_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "ops")

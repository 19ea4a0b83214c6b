"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
at the full 700 W power limit); the run prints the card's power limit
beside every result."""
BF16_FLOP_PER_S = 989e12
HBM_BYTES_PER_S = 3.35e12


def least_seconds(nbytes: float, flops: float) -> float:
    """The least time of work that moves ``nbytes`` and does ``flops`` in
    bf16 on the tensor cores: the larger of the two bounds."""
    return max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S)

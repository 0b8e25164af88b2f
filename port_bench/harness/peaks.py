"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit). Shares are stated against these,
with the card's power limit recorded beside them."""
BF16_FLOPS = 989e12          # FLOP/s, bf16 / fp16 tensor cores, dense
HBM_BYTES_PER_S = 3.35e12    # bytes/s

"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet: dense
rates without sparsity, at the full 700 W power limit)."""

H100 = {
    "bf16_flops": 989e12,
    "int8_ops": 1979e12,
    "bytes_per_s": 3.35e12,
}

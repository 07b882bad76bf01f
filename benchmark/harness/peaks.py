"""Published peaks of the cards the benchmark runs on (NVIDIA H100 SXM data
sheet: dense rates without sparsity, at the full 700 W power limit)."""

PEAKS = {
    'NVIDIA H100 80GB HBM3': {'bytes_per_s': 3.35e12,
                              'f32_ops_per_s': 67e12},
}


def bound_ms(kind: str, n_bytes: float, n_ops: float) -> float:
    """The least time [ms] the card ``kind`` needs to move ``n_bytes`` and
    do ``n_ops`` float32 operations: the larger of the two."""
    peak = PEAKS[kind]
    return max(n_bytes / peak['bytes_per_s'],
               n_ops / peak['f32_ops_per_s']) * 1e3

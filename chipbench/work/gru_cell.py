"""`gru_cell`: the GRU on M endpoint occurrences (Alg. 1's memory cell)."""


def count(s: dict) -> tuple[float, float]:
    m, dx, d = s["occ"], s["d_msg"], s["d_mem"]
    flops = 2.0 * m * (dx + d) * 3 * d + 10.0 * m * d
    read = 4.0 * (m * dx + m * d + dx * 3 * d + d * 3 * d + 3 * d)
    return flops, read + 4.0 * m * d

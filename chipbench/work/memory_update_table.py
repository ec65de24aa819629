"""`memory_update_table`: the GRU on M endpoint occurrences, the PRES
predict, correct and delta, and the write of W distinct rows."""


def count(s: dict) -> tuple[float, float]:
    m, w, dx, d = s["occ"], s["rows_written"], s["d_msg"], s["d_mem"]
    flops = 2.0 * m * (dx + d) * 3 * d + 16.0 * m * d
    read = 4.0 * (m * dx + w * d + m * d + 4 * m
                  + dx * 3 * d + d * 3 * d + 3 * d)
    write = 4.0 * (3 * m * d + w * d + w)
    return flops, read + write

"""`embed_attn`: one temporal attention layer over R distinct rows of
width ds with nv valid neighbour slots in all (K slots a row), reading U
distinct child rows of width din, time width dtime, E output columns.

The work is the least the layer's mathematics needs: the query
projection, each head's query folded into its key weights (q' = Wk_h q_h,
so a score is one product with a slot's input), the softmax's weighted
sum of the slots' inputs, then its value weights, and one cosine per
slot and time width. Bytes: the rows, the child rows, each slot's index,
time gap and valid flag, the weights, and the output, once each."""


def flops(s: dict) -> float:
    r, nv, ds, c, e, h = (s["rows"], s["valid_slots"], s["ds"],
                          s["din"] + s["dtime"], s["e"], s["heads"])
    return (2.0 * r * ds * e + 4.0 * r * c * e + 4.0 * h * c * nv
            + nv * s["dtime"])


def count(s: dict) -> tuple[float, float]:
    r, k, ds, din, dt, e = (s["rows"], s["k"], s["ds"], s["din"],
                            s["dtime"], s["e"])
    c = din + dt
    read = 4.0 * (r * ds + s["child_rows"] * din + 2 * dt + ds * e
                  + 2 * c * e) + 9.0 * r * k
    return flops(s), read + 4.0 * r * e

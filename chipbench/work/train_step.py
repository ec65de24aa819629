"""One training step's forward FLOPs at its logical sizes: the message
MLP and the GRU on the occurrences, each attention layer over its
distinct rows (work/embed_attn.py) with its output projection, and the
decoder on every scored pair. The step's FLOPs are three times these
(forward, and the backward's two products per forward product)."""
from chipbench.work import embed_attn as _ea


def forward_flops(s: dict) -> float:
    m, dm, dx, dt, de, e = (s["occ"], s["d_mem"], s["d_msg"], s["d_time"],
                            s["d_edge"], s["d_embed"])
    total = 2.0 * m * ((2 * dm + de + dt) * dx + dx * dx)
    total += 2.0 * m * (dx + dm) * 3 * dm
    for call in s["attn"]:
        total += _ea.flops(call) + 2.0 * call["rows"] * (e + call["ds"]) * e
    total += 2.0 * s["pairs"] * (2 * e * e + e)
    return total


def count(s: dict) -> tuple[float, float]:
    return 3.0 * forward_flops(s), 0.0

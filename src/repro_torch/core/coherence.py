"""Memory coherence smoothing (counterpart of `repro/core/coherence.py`,
Eq. 10, Sec. 5.2): the loss adds beta * [1 - cos(S^-(B), S(B))], the cosine
between the flattened previous and new memory rows of the batch."""
from __future__ import annotations

import torch


def coherence_penalty(s_prev, s_new, mask=None, eps: float = 1e-8):
    """1 - cosine between the flattened previous and new rows; in [0, 2]."""
    if mask is not None:
        s_prev = s_prev * mask[:, None]
        s_new = s_new * mask[:, None]
    a = s_prev.float().reshape(-1)
    b = s_new.float().reshape(-1)
    cos = torch.dot(a, b) / (torch.linalg.norm(a) * torch.linalg.norm(b)
                             + eps)
    return 1.0 - cos

"""Memory coherence (counterpart of `repro/core/coherence.py`): the
smoothing term of Eq. 10 (Sec. 5.2), where the loss adds beta * [1 -
cos(S^-(B), S(B))], the cosine between the flattened previous and new
memory rows of the batch; the per-node cosine; and Def. 3's empirical
memory coherence."""
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


def per_node_coherence(s_prev, s_new, mask=None, eps: float = 1e-8):
    """The mean over rows (over the rows of `mask` when given) of the
    cosine between each row of s_prev and of s_new; a diagnostic."""
    num = (s_prev * s_new).sum(dim=-1)
    den = (torch.linalg.norm(s_prev, dim=-1)
           * torch.linalg.norm(s_new, dim=-1) + eps)
    cos = num / den
    if mask is None:
        return cos.mean()
    mask = mask.to(cos.dtype)
    return (cos * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def empirical_memory_coherence(loss_fn, params, s_stale, s_fresh):
    """Def. 3 probe: mu_hat = <g_stale, g_fresh> / ||g_fresh||^2, g_* the
    gradient of `loss_fn(params, s)` (a scalar of the endpoint memory rows
    s (M, D), e.g. the decoder loss of a fixed batch) at the stale and at
    the fresh rows. O(|B|), as the paper notes."""
    def grad_at(s):
        s = s.detach().requires_grad_(True)
        return torch.autograd.grad(loss_fn(params, s), s)[0]
    g_stale, g_fresh = grad_at(s_stale), grad_at(s_fresh)
    num = (g_stale * g_fresh).sum()
    return num / ((g_fresh * g_fresh).sum() + 1e-12)

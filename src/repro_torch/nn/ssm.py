"""Linear-recurrence substrate of the model zoo (counterpart of
`repro/nn/ssm.py`): the chunked (SSD-style) algorithm for

    H_t = a_t * H_{t-1} + k_t v_t^T          (H: N x P matrix state per head)
    y_t = q_t^T H_t

which mLSTM runs (q, k, v projections; a = the forget gate). Each chunk's
quadratic work is one launch of the `ssd_chunk` kernel over the
(batch x heads) groups; the inter-chunk state is carried by a Python loop
over the chunks (JAX's `lax.scan`). Mamba2 waits for zamba2 (ROADMAP
Queue 1 item 19)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops


def chunked_linear_rnn(q, k, v, log_a, *, chunk: int = 256, init_state=None,
                       mode: str | None = None):
    """q, k: (B, S, H, N); v: (B, S, H, P); log_a: (B, S, H) (log of the
    decay in (0, 1]). Returns y (B, S, H, P) and the final state
    (B, H, N, P), both float32.

    S is padded to a multiple of `chunk` with zeros (log_a 0: no decay).
    Within a chunk the kernel weighs the future terms exactly 0, where
    the JAX lax version weighs them by exp(-30) (ROADMAP Queue 3 P22)."""
    b, s, h, n = q.shape
    p = v.shape[-1]
    pad = (-s) % chunk
    if pad:
        q, k, v = (F.pad(x, (0, 0, 0, 0, 0, pad)) for x in (q, k, v))
        log_a = F.pad(log_a, (0, 0, 0, pad))
    nc = q.shape[1] // chunk
    if init_state is None:
        init_state = torch.zeros((b, h, n, p), dtype=torch.float32,
                                 device=q.device)
    state = init_state.float().reshape(b * h, n, p)

    def groups(x, c):
        """Chunk c of a (B, S, H, W) tensor as (B * H, chunk, W) fp32."""
        x = x[:, c * chunk:(c + 1) * chunk].float()
        return x.transpose(1, 2).reshape(b * h, chunk, -1).contiguous()

    ys = []
    for c in range(nc):
        la = log_a[:, c * chunk:(c + 1) * chunk].float()     # (B, L, H)
        lcum = torch.cumsum(la, dim=1).transpose(1, 2).reshape(b * h, chunk)
        y, state = ops.ssd_chunk(groups(q, c), groups(k, c), groups(v, c),
                                 lcum.contiguous(), state, mode=mode)
        ys.append(y.reshape(b, h, chunk, p).transpose(1, 2))
    y = torch.cat(ys, dim=1)[:, :s]
    return y, state.reshape(b, h, n, p)


def linear_rnn_step(state, q, k, v, log_a):
    """One decode step. state: (B, H, N, P); q, k: (B, H, N); v: (B, H, P).
    Returns (state, y (B, H, P))."""
    a = torch.exp(log_a.float())[..., None, None]
    state = state * a + torch.einsum("bhn,bhp->bhnp", k.float(), v.float())
    y = torch.einsum("bhn,bhnp->bhp", q.float(), state)
    return state, y

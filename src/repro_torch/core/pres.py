"""PRES trackers (counterpart of `repro/core/pres.py`, Sec. 5.1): a
per-node, per-event-type 2-component GMM over memory deltas, kept as
running counts and sums (n, xi, psi) and updated online (Eq. 9).

Layout: every tracker tensor has N + 1 rows; row N is a dump row that
masked occurrences add into, so `update_trackers` is one dense
`index_add_` with no data-dependent shapes. The state proper is rows
[:N] (`PresState.rows`)."""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class PresState:
    """GMM trackers with a trailing dump row (see module docstring)."""
    n: torch.Tensor    # (N + 1, w)    event counts
    xi: torch.Tensor   # (N + 1, w, D) running sum of deltas
    psi: torch.Tensor  # (N + 1, w, D) running sum of squared deltas

    @staticmethod
    def init(n_nodes: int, d_mem: int, device,
             n_components: int = 2) -> "PresState":
        z = lambda *s: torch.zeros(s, dtype=torch.float32, device=device)
        return PresState(n=z(n_nodes + 1, n_components),
                         xi=z(n_nodes + 1, n_components, d_mem),
                         psi=z(n_nodes + 1, n_components, d_mem))

    def rows(self) -> "PresState":
        """Views of the N real rows (without the dump row)."""
        return PresState(self.n[:-1], self.xi[:-1], self.psi[:-1])


def gmm(n, xi, psi, eps: float = 1e-6):
    """Per-row GMM parameters from tracker rows n (.., w), xi/psi
    (.., w, D). Returns (alpha, mu, var)."""
    total = n.sum(dim=-1, keepdim=True)
    alpha = torch.where(total > 0, n / torch.clamp(total, min=eps),
                        torch.full_like(n, 1.0 / n.shape[-1]))
    denom = torch.clamp(n, min=1.0)[..., None]
    mu = xi / denom
    var = torch.clamp(psi / denom - mu * mu, min=0.0)
    return alpha, mu, var


def mixture_mean(state: PresState, nodes):
    """E[delta | node] = sum_k alpha_k mu_k for the given nodes, (M, D).

    Gathers the M tracker rows first and computes the GMM on those rows
    only. The math is per row, so this equals the JAX version's whole-table
    `gmm()` followed by a gather, without reading all N rows per ingest."""
    alpha, mu, _ = gmm(state.n[nodes], state.xi[nodes], state.psi[nodes])
    return (alpha[..., None] * mu).sum(dim=1)


def mixture_mean_rows(state: PresState):
    """E[delta | node] of every real node, (N, D), computed on views of
    the N real rows (no gather: at PRODUCTION size the trackers are
    246 MB). The pipelined schedule's staleness fill reads all of them."""
    rows = state.rows()
    alpha, mu, _ = gmm(rows.n, rows.xi, rows.psi)
    return (alpha[..., None] * mu).sum(dim=1)


def predict(state: PresState, s_prev, dt, nodes=None, *, clip: float = 5.0):
    """Eq. 7, the deterministic branch (the mixture mean; JAX's key=None):
    s_hat = s_prev + clip(dt * E[delta | node], -clip, clip), the plain
    route of the `pres_predict` kernel. s_prev: (M, D), dt: (M,), nodes:
    (M,) node ids, or None for all N nodes in order (then M = N and the
    mixture mean comes from views, `mixture_mean_rows`).

    The sampled branch (a draw from the GMM component) is not ported: the
    reference draws with jax.random, whose bits cannot be reproduced
    (ROADMAP Queue 1 item 4)."""
    from repro_torch.kernels import ref
    delta = (mixture_mean_rows(state) if nodes is None
             else mixture_mean(state, nodes))
    return ref.pres_predict_ref(s_prev, delta, dt, clip=clip)


def update_trackers(state: PresState, nodes, delta, etype, mask) -> None:
    """Eq. 9 online update, IN PLACE: every valid occurrence adds its count,
    delta and squared delta to its (node, etype) tracker; masked ones add
    into the dump row. nodes/etype: (M,) int, delta: (M, D), mask: (M,).

    On CUDA, index_add_ sums with float atomics whose order changes from run
    to run, so xi/psi agree with a sequential sum to rounding, not bits."""
    n_rows, w = state.n.shape
    dump = (n_rows - 1) * w
    flat = torch.where(mask, nodes * w + etype, torch.full_like(nodes, dump))
    delta = torch.where(mask[:, None], delta, torch.zeros_like(delta))
    d = delta.shape[-1]
    state.n.view(-1).index_add_(0, flat, mask.to(torch.float32))
    state.xi.view(-1, d).index_add_(0, flat, delta)
    state.psi.view(-1, d).index_add_(0, flat, delta * delta)

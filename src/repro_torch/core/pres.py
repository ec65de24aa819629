"""PRES (counterpart of `repro/core/pres.py`, Sec. 5.1): a per-node,
per-event-type 2-component GMM over memory deltas, kept as running counts
and sums (n, xi, psi) and updated online (Eq. 9); the prediction from it
(Eq. 7, the mixture mean or a draw), the correction (Eq. 8) and the whole
pass over the touched rows (`filter_memory`). With Sec. 5.3's hashed
trackers (`pres_buckets`) a row is a bucket, node % buckets, and the
callers pass bucket ids where the per-node trackers take node ids.

Layout: every tracker tensor has rows + 1 rows; the last is a dump row
that masked occurrences add into, so `update_trackers` is one dense
`index_add_` with no data-dependent shapes. The state proper is the rows
before it (`PresState.rows`)."""
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


def mixture_mean_rows(state: PresState, n_nodes: int | None = None):
    """E[delta | node] of every node 0 .. n_nodes - 1 in order, (N, D).
    The means of the real tracker rows are computed once on views of
    them (no gather: at PRODUCTION size the trackers are 246 MB); with
    hashed trackers (fewer rows than nodes) node i reads bucket
    i % buckets. `n_nodes` defaults to the number of rows."""
    rows = state.rows()
    alpha, mu, _ = gmm(rows.n, rows.xi, rows.psi)
    means = (alpha[..., None] * mu).sum(dim=1)
    n_rows = means.shape[0]
    if n_nodes is None or n_nodes == n_rows:
        return means
    ids = torch.arange(n_nodes, device=means.device) % n_rows
    return means.index_select(0, ids)


def _sample_delta(state: PresState, nodes, n_nodes, generator):
    """One draw of delta from each node's GMM, as jax.random draws it: a
    component by the Gumbel-max of log(alpha + 1e-9) (what
    jax.random.categorical computes), then mu + sqrt(var) * N(0, 1) of that
    component. The generator gives the Gumbel noise's uniforms (in [tiny,
    1), as JAX's), then the normals, in that order and through nothing
    else, so a draw is a function of the generator's state alone; its bits
    are not jax.random's, its distribution is."""
    if nodes is None:
        nodes = torch.arange(n_nodes, device=state.n.device) \
            % (state.n.shape[0] - 1)
    alpha, mu, var = gmm(state.n[nodes], state.xi[nodes], state.psi[nodes])
    u = torch.rand(alpha.shape, generator=generator, device=alpha.device)
    u = torch.clamp(u, min=torch.finfo(u.dtype).tiny)
    gumbel = -torch.log(-torch.log(u))
    comp = torch.argmax(torch.log(alpha + 1e-9) + gumbel, dim=-1,
                        keepdim=True)
    pick = comp[:, :, None].expand(-1, 1, mu.shape[-1])
    mc = torch.gather(mu, 1, pick)[:, 0]
    vc = torch.gather(var, 1, pick)[:, 0]
    noise = torch.randn(mc.shape, generator=generator, device=mc.device)
    return mc + torch.sqrt(vc) * noise


def predict(state: PresState, s_prev, dt, nodes=None, *, generator=None,
            clip: float = 5.0):
    """Eq. 7: s_hat = s_prev + clip(dt * delta, -clip, clip), the plain
    route of the `pres_predict` kernel. s_prev: (M, D), dt: (M,), nodes:
    (M,) tracker ids (node ids, or bucket ids with hashed trackers), or
    None for every node 0 .. M - 1 in order (`mixture_mean_rows`). delta
    is the mixture mean unless a torch.Generator is given, then a draw
    from the GMM (`_sample_delta`)."""
    from repro_torch.kernels import ref
    if generator is not None:
        delta = _sample_delta(state, nodes, s_prev.shape[0], generator)
    elif nodes is None:
        delta = mixture_mean_rows(state, s_prev.shape[0])
    else:
        delta = mixture_mean(state, nodes)
    return ref.pres_predict_ref(s_prev, delta, dt, clip=clip)


def correct(params, s_pred, s_meas):
    """Eq. 8: (1 - gamma) s_pred + gamma s_meas, gamma =
    sigmoid(params["gamma_logit"]) (the `pres` parameter subtree)."""
    gamma = torch.sigmoid(params["gamma_logit"])
    return (1.0 - gamma) * s_pred + gamma * s_meas


def update_trackers(state: PresState, nodes, delta, etype, mask,
                    anchor_mask=None) -> None:
    """Eq. 9 online update, IN PLACE: every valid occurrence adds its count,
    delta and squared delta to its (node, etype) tracker; masked ones add
    into the dump row. nodes/etype: (M,) int, delta: (M, D), mask: (M,).
    With `anchor_mask` ((rows,) bool, Sec. 5.3) only occurrences of
    anchored rows count.

    On CUDA, index_add_ sums with float atomics whose order changes from run
    to run, so xi/psi agree with a sequential sum to rounding, not bits."""
    if anchor_mask is not None:
        mask = mask & anchor_mask[nodes]
    n_rows, w = state.n.shape
    dump = (n_rows - 1) * w
    flat = torch.where(mask, nodes * w + etype, torch.full_like(nodes, dump))
    delta = torch.where(mask[:, None], delta, torch.zeros_like(delta))
    d = delta.shape[-1]
    state.n.view(-1).index_add_(0, flat, mask.to(torch.float32))
    state.xi.view(-1, d).index_add_(0, flat, delta)
    state.psi.view(-1, d).index_add_(0, flat, delta * delta)


def filter_memory(params, pres_state: PresState, *, nodes, s_prev, s_meas,
                  t_prev, t_now, etype, mask, delta_mode: str = "innovation",
                  anchor_mask=None, generator=None):
    """One whole PRES pass over the touched rows (Alg. 2's inner loop):
    predict (Eq. 7, scale max(t_now - t_prev, 0)), correct (Eq. 8), the
    delta rate by `delta_mode` ("innovation": fused - predicted, Eq. 9;
    "transition": fused - s_prev), and the tracker update, IN PLACE on
    `pres_state`. Returns (s_fused (M, D), pres_state)."""
    if delta_mode not in ("innovation", "transition"):
        raise ValueError(delta_mode)
    dt = torch.clamp(t_now - t_prev, min=0.0)
    s_pred = predict(pres_state, s_prev, dt, nodes, generator=generator)
    s_fused = correct(params, s_pred, s_meas)
    base = s_pred if delta_mode == "innovation" else s_prev
    delta = (s_fused - base) / torch.clamp(dt, min=1.0)[:, None]
    update_trackers(pres_state, nodes, delta, etype, mask,
                    anchor_mask=anchor_mask)
    return s_fused, pres_state


def make_anchor_mask(generator: torch.Generator, n_nodes: int,
                     fraction: float, device=None) -> torch.Tensor:
    """Sec. 5.3: a random anchor subset of about `fraction` of the n_nodes
    rows, (n_nodes,) bool, drawn from `generator` (not jax.random's bits)."""
    return torch.rand(n_nodes, generator=generator, device=device) < fraction

"""Token-dropping top-k Mixture-of-Experts with sort-based dispatch
(counterpart of `repro/nn/moe.py`).

Each token's router softmax picks its top-k experts; an assignment's rank
within its expert (in token order) decides whether it fits the expert's
capacity C, and the assignments that do not fit go to a dump slot E * C
that no expert reads. Experts compute as grouped products over (E, C, d),
and the weighted outputs return to their tokens with `index_add_` (JAX's
`segment_sum`). The aux loss is the Switch Transformer's load-balance
term."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.nn.layers import ACTS
from repro_torch.nn.module import ParamBuilder
from repro_torch.train import annotate

# bytes of one cast slice of an expert weight: the experts run a slice at
# a time, so that where the weights are stored in another dtype than the
# activations' one cast slice of each weight is alive beside the stored
# ones (arctic's (128, 7168, 4864) bfloat16 `wi` cast whole to
# float32 is 17.9 GB). Each expert's product is independent of the
# others', so the slicing changes no number.
CAST_BYTES = 1 << 30


def moe_init(b: ParamBuilder, name: str, d_model: int, d_ff: int,
             n_experts: int, gated: bool = True):
    sub = b.sub(name)
    sub.add("router", (d_model, n_experts), ("embed", "expert"))
    sub.add("wi", (n_experts, d_model, d_ff),
            ("expert", "embed", "expert_mlp"))
    if gated:
        sub.add("wg", (n_experts, d_model, d_ff),
                ("expert", "embed", "expert_mlp"))
    sub.add("wo", (n_experts, d_ff, d_model),
            ("expert", "expert_mlp", "embed"))


def _topk_route(logits, k: int):
    """softmax -> top-k -> renormalise. logits: (T, E). Returns (topp,
    topi, probs); topi's k ids come in descending probability."""
    probs = torch.softmax(logits.float(), dim=-1)
    topp, topi = torch.topk(probs, k, dim=-1)
    topp = topp / torch.sum(topp, dim=-1, keepdim=True)
    return topp, topi, probs


def capacity(n_tokens: int, top_k: int, n_experts: int,
             capacity_factor: float) -> int:
    """Slots an expert holds: max(1, round(T k / E * cf)), Python's round
    as in JAX."""
    return int(max(1, round(n_tokens * top_k / n_experts * capacity_factor)))


def dispatch_slots(topi, n_experts: int, cap: int):
    """The slot of each assignment (token-major, (T * k,)): its rank among
    the earlier assignments to the same expert (a stable sort of the
    expert ids, `searchsorted` for each expert's first position), whether
    it fits (`keep`: rank < cap) and its slot `dest`: expert * cap + rank,
    or the dump slot E * cap. Returns (rank, keep, dest)."""
    flat_e = topi.reshape(-1)
    tk = flat_e.shape[0]
    dev = flat_e.device
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    start = torch.searchsorted(sorted_e, torch.arange(n_experts, device=dev))
    rank_sorted = torch.arange(tk, device=dev) - start[sorted_e]
    rank = torch.empty_like(rank_sorted).index_put_((order,), rank_sorted)
    keep = rank < cap
    dest = torch.where(keep, flat_e * cap + rank,
                       torch.full((), n_experts * cap, device=dev))
    return rank, keep, dest


def expert_ffn(params, expert_in, act: str = "silu"):
    """The experts' gated MLP over their slots: expert_in (E, C, d) ->
    (E, C, d) in expert_in's dtype, the weights cast to it a slice of
    experts at a time (`CAST_BYTES`)."""
    act_fn = ACTS[act]
    e, _, d = expert_in.shape
    dt = expert_in.dtype
    wi, wg, wo = params["wi"], params.get("wg"), params["wo"]
    step = max(1, CAST_BYTES // (d * wi.shape[-1] * dt.itemsize))
    outs = []
    for e0 in range(0, e, step):
        sl = slice(e0, e0 + step)
        xin = expert_in[sl]
        h = torch.bmm(xin, wi[sl].to(dt))
        if wg is not None:
            h = act_fn(torch.bmm(xin, wg[sl].to(dt))) * h
        else:
            h = act_fn(h)
        outs.append(torch.bmm(h, wo[sl].to(dt)))
    return outs[0] if len(outs) == 1 else torch.cat(outs)


def moe(params, x, *, top_k: int, capacity_factor: float = 1.25,
        act: str = "silu"):
    """x: (B, S, d). Returns (y (B, S, d) in x's dtype, aux_loss)."""
    b_, s, d = x.shape
    t = b_ * s
    dev = x.device
    xt = x.reshape(t, d)
    n_experts = params["router"].shape[-1]
    logits = xt.float() @ params["router"].float()
    topp, topi, probs = _topk_route(logits, top_k)

    # load balance auxiliary (Switch-style)
    me = torch.mean(probs, dim=0)
    ce = torch.mean(F.one_hot(topi[:, 0], n_experts).float(), dim=0)
    aux_loss = n_experts * torch.sum(me * ce)

    cap = capacity(t, top_k, n_experts, capacity_factor)
    # on local tensors where topi is a DTensor: DTensor has no rule for
    # searchsorted
    _, keep, dest = annotate.local(dispatch_slots, topi, n_experts, cap)

    # dispatch: every token k times into (E * C + 1, d), the dump slot last
    src_token = torch.arange(t, device=dev).repeat_interleave(top_k)
    gathered = xt.index_select(0, src_token)
    slots = torch.zeros((n_experts * cap + 1, d), dtype=x.dtype,
                        device=dev).index_copy(0, dest, gathered)
    expert_in = slots[:n_experts * cap].reshape(n_experts, cap, d)
    expert_out = expert_ffn(params, expert_in, act)

    # combine: back to the assignments (dropped ones read the zero row),
    # weighted, summed over each token's k
    flat_out = torch.cat([expert_out.reshape(n_experts * cap, d),
                          torch.zeros((1, d), dtype=x.dtype, device=dev)])
    per_assign = flat_out.index_select(0, dest)
    w = (topp.reshape(-1) * keep).to(x.dtype)
    combined = torch.zeros((t, d), dtype=x.dtype, device=dev).index_add(
        0, src_token, per_assign * w[:, None])
    return combined.reshape(b_, s, d), aux_loss

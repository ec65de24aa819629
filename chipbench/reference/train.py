"""The reference's lag-one training steps (Alg. 1, or Alg. 2 with PRES):
batch i - 1 updates the memory, then the embeddings score batch i against
its negatives; the loss's gradient reaches every parameter through the
rows the memory stage wrote, and AdamW (b1 0.9, b2 0.95, eps 1e-8, no
weight decay, bias-corrected) updates them. Plain PyTorch, float32."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from chipbench.reference import mdgnn as ref

B1, B2, EPS = 0.9, 0.95, 1e-8


def step_loss(params, cfg: dict, st: ref.State, prev, pos, neg,
              use_pres: bool):
    """(loss, memory info, new table, positive logits, negative logits)
    of one step; `prev`, `pos`, `neg` are (src, dst, t, feat, mask)."""
    mem, info = ref.memory_stage(params, cfg, st, *prev, use_pres=use_pres)
    b = pos[0].shape[0]
    h = ref.embed(params, cfg, mem, st, torch.cat([pos[0], pos[1], neg[0],
                                                   neg[1]]),
                  torch.cat([pos[2], pos[2], neg[2], neg[2]]))
    lp = ref.decode(params, h[:b], h[b:2 * b])
    ln = ref.decode(params, h[2 * b:3 * b], h[3 * b:])
    pm, nm = pos[4].float(), neg[4].float()
    loss = ((F.softplus(-lp) * pm).sum() + (F.softplus(ln) * nm).sum()) \
        / torch.clamp(pm.sum() + nm.sum(), min=1.0)
    if use_pres and cfg["beta"]:
        keep = (info["sel"] & torch.cat([prev[4], prev[4]])).float()[:, None]
        a = (info["s_prev"] * keep).reshape(-1)
        c = (info["fused"] * keep).reshape(-1)
        cos = torch.dot(a, c) / (torch.linalg.norm(a) * torch.linalg.norm(c)
                                 + 1e-8)
        loss = loss + cfg["beta"] * (1.0 - cos)
    return loss, info, mem, lp, ln


def run_steps(params, cfg: dict, batches, negatives, use_pres: bool,
              lr: float):
    """Train from `params` and an empty state over batches[0..n] (n steps,
    negatives[i] scoring batches[i + 1]). Returns per step the loss and
    every leaf's gradient norm, and every leaf's change norm after the n
    steps (all as Python floats), and the logits of each step."""
    st = ref.State(cfg, batches[0][0].device)
    paths = [p for p, _ in ref.leaf_paths(params)]
    leaves = [leaf.detach().clone() for _, leaf in ref.leaf_paths(params)]
    start = [x.clone() for x in leaves]
    mu = [torch.zeros_like(x) for x in leaves]
    nu = [torch.zeros_like(x) for x in leaves]
    losses, grad_norms, logits = [], [], []
    for i in range(len(negatives)):
        for x in leaves:
            x.requires_grad_(True)
        tree = _tree(params, paths, leaves)
        loss, info, mem, lp, ln = step_loss(tree, cfg, st, batches[i],
                                            batches[i + 1], negatives[i],
                                            use_pres)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g
                 for x, g in zip(leaves, grads)]
        losses.append(float(loss.detach()))
        grad_norms.append([float(torch.linalg.norm(g)) for g in grads])
        logits.append((lp.detach(), ln.detach()))
        with torch.no_grad():
            t = i + 1
            bc1, bc2 = 1 - B1 ** t, 1 - B2 ** t
            new = []
            for j, (x, g) in enumerate(zip(leaves, grads)):
                mu[j] = B1 * mu[j] + (1 - B1) * g
                nu[j] = B2 * nu[j] + (1 - B2) * g * g
                new.append(x.detach() - lr * (mu[j] / bc1)
                           / (torch.sqrt(nu[j] / bc2) + EPS))
        leaves = new
        ref.commit(st, mem, info, use_pres, *_event_cols(batches[i]))
        del loss, info, mem, grads
    change = [float(torch.linalg.norm(x - s)) for x, s in zip(leaves, start)]
    return {"loss": losses, "grad_norms": grad_norms, "change": change,
            "logits": logits}


def _event_cols(batch):
    src, dst, t, _, mask = batch
    return src, dst, t, mask


def _tree(params, paths, leaves):
    out: dict = {k: {} for k in params}
    for path, x in zip(paths, leaves):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = x
    return out

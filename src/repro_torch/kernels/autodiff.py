"""Autograd for the kernels: kernel forward, plain-version backward
(counterpart of `repro/kernels/autodiff.py::oracle_vjp`).

The JAX package has no backward Pallas kernel: every kernel's gradient is
`jax.vjp` of its jnp oracle. The port keeps that contract. Each kernel is a
`torch.autograd.Function` whose forward is the route `ops.dispatch`
resolves (the CUDA kernel for CUDA tensors, the plain version for CPU
tensors), run without recording a graph, and whose backward runs
`torch.autograd.grad` through the plain version on the saved inputs. Both
devices go through the same Function, so the CPU tests exercise what the
card runs. With grad mode off (serving, evaluation) the wrappers call the
route directly: nothing is saved and no Function is applied.

`memory_update_table` writes its table in place, which a saved-inputs
backward cannot see through; `table_vjp` is its own Function (below)."""
from __future__ import annotations

import torch


def _grads(outs, grads, leaves):
    """autograd.grad of the outputs that carry a graph; zeros for leaves
    they do not reach."""
    pairs = [(o, g) for o, g in zip(outs, grads) if o.requires_grad]
    got = torch.autograd.grad([o for o, _ in pairs], leaves,
                              [g for _, g in pairs], allow_unused=True)
    return [torch.zeros_like(l) if g is None else g
            for l, g in zip(leaves, got)]


def oracle_vjp(forward, ref_fn, nondiff=()):
    """Differentiable `f(*args, mode=None, **static)`.

    forward(*args, mode=..., **static) is the dispatched route and
    ref_fn(*args, **static) the plain version, with the same outputs.
    Inputs at the positions in `nondiff` (indices, masks) get no gradient,
    and neither does any input that does not ask for one."""

    class OracleVJP(torch.autograd.Function):
        @staticmethod
        def forward(ctx, call, *args):
            mode, static = call
            ctx.static = static
            ctx.save_for_backward(*args)
            return forward(*args, mode=mode, **static)

        @staticmethod
        def backward(ctx, *grads):
            args = ctx.saved_tensors
            diff = [i for i in range(len(args))
                    if ctx.needs_input_grad[i + 1] and i not in nondiff]
            leaves = list(args)
            for i in diff:
                leaves[i] = args[i].detach().requires_grad_(True)
            with torch.enable_grad():
                out = ref_fn(*leaves, **ctx.static)
            outs = out if isinstance(out, tuple) else (out,)
            got = _grads(outs, grads, [leaves[i] for i in diff])
            res = [None] * len(args)
            for i, g in zip(diff, got):
                res[i] = g
            return (None, *res)

    def f(*args, mode=None, **static):
        if not torch.is_grad_enabled():
            return forward(*args, mode=mode, **static)
        return OracleVJP.apply((mode, static), *args)

    return f


def gather_rows(table, idx):
    """table[idx] with zeros for indices >= N (the kernels' masked-read
    slot), detached."""
    g = idx.long()
    n = table.shape[0]
    rows = table.detach().index_select(0, torch.clamp(g, max=n - 1))
    return torch.where((g < n)[:, None], rows,
                       torch.zeros((), dtype=table.dtype, device=table.device))


def table_vjp(forward, update_ref):
    """Differentiable `memory_update_table` (see `ops.memory_update_table`
    for the arguments), whose forward overwrites `table` and `last_t` in
    place.

    forward(*args, mode=..., clip=..., delta_mode=...) is the dispatched
    route; update_ref(x, h, w, u, b, delta_mean, scale, gamma, clip=...,
    delta_mode=...) the plain per-row math (`ref.memory_update_ref`). The
    Function
    (a) saves h = table[gather_idx] (zeros for indices >= N) as it was
        BEFORE the launch: the kernel overwrites those rows, and a backward
        that gathered afterwards would differentiate at the new rows. The
        caller may pass these rows as `h` when it has gathered them
        already (the train step reads them for the coherence penalty);
        they are then taken as given, detached;
    (b) marks table and last_t dirty and returns them, so a caller that
        gathers from the RETURNED table sends its gradient here;
    (c) maps the cotangent of each written table row onto `fused` of the
        occurrence that wrote it (and of `last_t` onto `times`); the table
        rows it overwrote get none, the rows it gathered get the gradient
        of h.
    With a bfloat16 table, h is widened to float32 (the math is float32,
    as in the kernel) and a written row's cotangent reaches `fused` as
    float32, as the cast in JAX's oracle passes it on; the table's own
    cotangent keeps the table's dtype.
    Indices get no gradient."""

    class TableVJP(torch.autograd.Function):
        @staticmethod
        def forward(ctx, call, h, table, last_t, x, gather_idx, write_idx,
                    times, w, u, b, delta_mean, scale, gamma):
            mode, static = call
            ctx.static = static
            ctx.n_rows = table.shape[0]
            ctx.save_for_backward(h, x, gather_idx, write_idx, w, u, b,
                                  delta_mean, scale, gamma)
            outs = forward(table, last_t, x, gather_idx, write_idx, times,
                           w, u, b, delta_mean, scale, gamma, mode=mode,
                           **static)
            ctx.mark_dirty(table, last_t)
            return outs

        @staticmethod
        def backward(ctx, g_table, g_last_t, g_meas, g_fused, g_delta):
            (h, x, gather_idx, write_idx, w, u, b, delta_mean, scale,
             gamma) = ctx.saved_tensors
            need = ctx.needs_input_grad
            n = ctx.n_rows
            wi = write_idx.long()
            sel = wi < n
            wic = torch.clamp(wi, max=n - 1)
            zero = torch.zeros((), dtype=g_table.dtype,
                               device=g_table.device)
            g_fused = g_fused + torch.where(sel[:, None],
                                            g_table[wic].float(), zero)
            # the saved tensors by their position among the Function's
            # inputs; the table's gradient reaches it through h (position
            # 1, which itself takes none)
            val = {4: x, 1: h, 8: w, 9: u, 10: b, 11: delta_mean, 12: scale,
                   13: gamma}
            diff = [i for i in val if need[i] or (i == 1 and need[2])]
            for i in diff:
                val[i] = val[i].detach().requires_grad_(True)
            with torch.enable_grad():
                outs = update_ref(*val.values(), **ctx.static)
            got = dict(zip(diff, _grads(outs, (g_meas, g_fused, g_delta),
                                        [val[i] for i in diff])))
            res = [None] * 14
            for i in (4, 8, 9, 10, 11, 12, 13):
                res[i] = got.get(i)
            # masks by arithmetic, not boolean indexing, so the backward
            # waits for nothing on the host (a CUDA graph of the train step
            # records it: train/scan.py); the sums are the same numbers
            written = None
            if need[2] or need[3]:
                written = torch.zeros(n + 1, dtype=torch.bool,
                                      device=wi.device)
                written.index_fill_(0, torch.where(sel, wi, n), True)
                written = written[:n]
            if need[2]:
                g_tab = torch.where(written[:, None], zero, g_table)
                gi = gather_idx.long()
                ok = gi < n
                g_tab.index_add_(0, torch.clamp(gi, max=n - 1),
                                 torch.where(ok[:, None], got[1],
                                             zero).to(g_tab.dtype))
                res[2] = g_tab
            if need[3]:
                res[3] = torch.where(written, zero, g_last_t)
            if need[7]:
                res[7] = torch.where(sel, g_last_t[wic], zero)
            return tuple(res)

    def f(table, last_t, x, gather_idx, write_idx, times, w, u, b,
          delta_mean, scale, gamma, *, mode=None, clip=5.0,
          delta_mode="innovation", h=None):
        static = {"clip": clip, "delta_mode": delta_mode}
        args = (table, last_t, x, gather_idx, write_idx, times, w, u, b,
                delta_mean, scale, gamma)
        if not torch.is_grad_enabled():
            return forward(*args, mode=mode, **static)
        h = (gather_rows(table, gather_idx) if h is None
             else h.detach()).float()
        return TableVJP.apply((mode, static), h, *args)

    return f

"""zamba2-1.2b: a Mamba2 backbone with one *shared* (single-copy)
attention + MLP block applied after every `attn_every`-th Mamba2 block
(arXiv:2411.15242; counterpart of `repro/archs/zamba.py`).

Structure: n_units = n_layers // attn_every units of (attn_every Mamba2
blocks, then the shared block), and the n_layers % attn_every remaining
Mamba2 blocks at the end (`tail_{j}`). Each Mamba2 block runs one
`ssd_chunk` launch a chunk; the shared block's long-prefill attention
runs `flash_attn`. Decode carries O(1) SSM and conv state per Mamba2
block and one KV cache per unit."""
from __future__ import annotations

import torch

from repro_torch.archs import base
from repro_torch.archs.base import Model, ModelConfig
from repro_torch.device import resolve_device
from repro_torch.nn import attention as attn_lib
from repro_torch.nn import layers, ssm
from repro_torch.nn.module import ParamBuilder, stack_params, unstack


def build(cfg: ModelConfig) -> Model:
    every = cfg.attn_every or cfg.n_layers
    n_units = cfg.n_layers // every
    tail = cfg.n_layers - n_units * every
    stacked = cfg.scan_layers and n_units

    def _init_mamba(b: ParamBuilder, name: str):
        blk = b.sub(name)
        layers.rmsnorm_init(blk, "ln", cfg.d_model)
        ssm.mamba2_init(blk, "cell", cfg.d_model, cfg.ssm_state,
                        expand=cfg.mamba_expand, head_dim=cfg.ssm_head_dim)

    def build_params(gen=None, device=None):
        b = base.builder(cfg, gen, device)
        base.make_embedding(b, cfg)
        # the shared block: one copy, applied after every unit
        sh = b.sub("shared")
        layers.rmsnorm_init(sh, "ln_attn", cfg.d_model)
        attn_lib.attention_init(sh, "attn", cfg.d_model, cfg.n_heads,
                                cfg.n_kv_heads, cfg.head_dim)
        layers.rmsnorm_init(sh, "ln_mlp", cfg.d_model)
        layers.mlp_init(sh, "mlp", cfg.d_model, cfg.d_ff, gated=True)

        def init_unit(ub):
            for j in range(every):
                _init_mamba(ub, f"m{j}")

        base.unit_params(b, "blocks", n_units, init_unit, stacked)
        for j in range(tail):
            _init_mamba(b, f"tail_{j}")
        return b.params, b.axes

    def _mamba_apply(blk, x):
        h = layers.rmsnorm(blk["ln"], x)
        return x + ssm.mamba2(blk["cell"], h, d_state=cfg.ssm_state,
                              head_dim=cfg.ssm_head_dim,
                              mode=cfg.kernels_mode)

    def _shared_apply(sh, x, positions):
        h = layers.rmsnorm(sh["ln_attn"], x)
        h = attn_lib.attention(sh["attn"], h, positions, d_head=cfg.head_dim,
                               causal=True, rope_theta=cfg.rope_theta,
                               chunk=cfg.attn_chunk, mode=cfg.kernels_mode)
        x = x + h
        h = layers.rmsnorm(sh["ln_mlp"], x)
        return x + layers.mlp(sh["mlp"], h, act=cfg.act)

    def trunk(params, batch):
        x = base.embed_tokens(params, cfg, batch["tokens"])
        b_, s, _ = x.shape
        positions = torch.arange(s, device=x.device)[None].expand(b_, s)
        sh = params["shared"]

        def unit(p, h):
            for j in range(every):
                h = _mamba_apply(p[f"m{j}"], h)
            return _shared_apply(sh, h, positions)

        # remat covers the units only; the tail blocks run outside it, as
        # in JAX
        x = base.run_blocks(unit, base.units(params["blocks"], cfg, n_units),
                            x, remat=cfg.remat)
        for j in range(tail):
            x = _mamba_apply(params[f"tail_{j}"], x)
        return x

    forward, prefill = base.heads(cfg, trunk)

    # ----------------------------------------------------------- decode ----
    def init_decode_state(batch_size: int, cache_len: int, device=None):
        """{"units": per unit {m{j}: Mamba2 state, "cache": the shared
        block's KV cache} (stacked on a leading unit dim with
        scan_layers), "tail_{j}": Mamba2 state}."""
        dev = resolve_device(device)
        n_heads_m = (cfg.mamba_expand * cfg.d_model) // cfg.ssm_head_dim
        d_inner = n_heads_m * cfg.ssm_head_dim
        f32 = torch.float32

        def mamba_state():
            # mamba2_decode_init's zeros, the conv ring of width 4 - 1 rows
            return {"ssm": torch.zeros((batch_size, n_heads_m, cfg.ssm_state,
                                        cfg.ssm_head_dim), dtype=f32,
                                       device=dev),
                    "conv": torch.zeros((batch_size, 3,
                                         d_inner + 2 * cfg.ssm_state),
                                        dtype=f32, device=dev)}

        def unit_state():
            st = {f"m{j}": mamba_state() for j in range(every)}
            st["cache"] = attn_lib.init_cache(batch_size, cache_len,
                                              cfg.n_kv_heads, cfg.head_dim,
                                              cfg.dtype, dev)
            return st

        states = [unit_state() for _ in range(n_units)]
        state = {"units": stack_params(states) if stacked else
                 {f"u{i}": st for i, st in enumerate(states)}}
        state.update({f"tail_{j}": mamba_state() for j in range(tail)})
        return state

    def state_axes():
        m_ax = dict(ssm.MAMBA_STATE_AXES)
        unit_ax = {f"m{j}": m_ax for j in range(every)}
        unit_ax["cache"] = dict(attn_lib.CACHE_AXES)
        ax = {"units": base.stacked_state_axes(unit_ax, stacked, n_units)}
        ax.update({f"tail_{j}": m_ax for j in range(tail)})
        return ax

    def _mamba_decode(blk, x, st):
        """x plus the block's output; the block's state in `st` is
        overwritten with the new one."""
        h = layers.rmsnorm(blk["ln"], x)
        out, new = ssm.mamba2_decode(blk["cell"], h, st,
                                     d_state=cfg.ssm_state,
                                     head_dim=cfg.ssm_head_dim)
        for name, t in new.items():
            st[name].copy_(t)
        return x + out

    def _shared_decode(sh, x, cache, pos):
        h = layers.rmsnorm(sh["ln_attn"], x)
        h, _ = attn_lib.decode_attention(sh["attn"], h, cache, pos,
                                         d_head=cfg.head_dim,
                                         rope_theta=cfg.rope_theta)
        x = x + h
        h = layers.rmsnorm(sh["ln_mlp"], x)
        return x + layers.mlp(sh["mlp"], h, act=cfg.act)

    def check_decode_pos(state, pos):
        """decode_step's check of an int pos (the shared attention's)."""
        if not n_units:
            return
        units = state["units"] if stacked else state["units"]["u0"]
        attn_lib.check_pos(pos, units["cache"]["k"].shape[-3])

    def decode_step(params, state, tokens, pos):
        """tokens (B, 1) at position `pos`; the state in `state` is
        written in place. Returns (logits (B, 1, V), state)."""
        x = base.embed_tokens(params, cfg, tokens)
        sh = params["shared"]
        for i, p in enumerate(base.units(params["blocks"], cfg, n_units)):
            st = (unstack(state["units"], i) if stacked
                  else state["units"][f"u{i}"])
            for j in range(every):
                x = _mamba_decode(p[f"m{j}"], x, st[f"m{j}"])
            x = _shared_decode(sh, x, st["cache"], pos)
        for j in range(tail):
            x = _mamba_decode(params[f"tail_{j}"], x, state[f"tail_{j}"])
        return base.lm_logits(params, cfg, x), state

    return Model(cfg=cfg, build_params=build_params, forward=forward,
                 prefill=prefill, loss_fn=base.lm_loss(forward),
                 init_decode_state=init_decode_state, decode_step=decode_step,
                 state_axes=state_axes, check_decode_pos=check_decode_pos)

"""Dense decoder-only family (counterpart of `repro/archs/dense.py`):
qwen3 (qk-norm, GQA) and any config of the same shape, with sliding-window
layers (`window`, `global_every`). The VLM variant (qwen2-vl: patch
embeddings, M-RoPE) raises: it waits for ROADMAP Queue 1 item 19."""
from __future__ import annotations

import torch

from repro_torch.archs import base
from repro_torch.archs.base import Model, ModelConfig
from repro_torch.device import resolve_device
from repro_torch.nn import attention as attn_lib
from repro_torch.nn import layers
from repro_torch.nn.module import ParamBuilder, stack_params, unstack


def unit_pattern(cfg: ModelConfig) -> list[str]:
    if cfg.global_every:
        return ["local"] * (cfg.global_every - 1) + ["global"]
    return ["global" if cfg.window is None else "local"]


def _init_block(b: ParamBuilder, cfg: ModelConfig):
    layers.rmsnorm_init(b, "ln_attn", cfg.d_model)
    attn_lib.attention_init(
        b, "attn", cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
        qkv_bias=cfg.qkv_bias, qk_norm=cfg.qk_norm)
    layers.rmsnorm_init(b, "ln_mlp", cfg.d_model)
    layers.mlp_init(b, "mlp", cfg.d_model, cfg.d_ff, gated=True)


def _block_apply(cfg: ModelConfig, kind: str, p, x, positions):
    h = layers.rmsnorm(p["ln_attn"], x)
    window = cfg.window if kind == "local" else None
    h = attn_lib.attention(
        p["attn"], h, positions, d_head=cfg.head_dim, causal=True,
        window=window, rope_theta=cfg.rope_theta,
        softmax_scale_cap=cfg.attn_softcap, chunk=cfg.attn_chunk,
        mode=cfg.kernels_mode)
    x = x + h
    h = layers.rmsnorm(p["ln_mlp"], x)
    return x + layers.mlp(p["mlp"], h, act=cfg.act)


def build(cfg: ModelConfig) -> Model:
    if cfg.num_patches or cfg.mrope_sections:
        raise NotImplementedError(
            f"{cfg.arch_id}: the VLM variant (patch embeddings, M-RoPE) is "
            f"not ported yet (ROADMAP Queue 1 item 19: VLM, apply_mrope)")
    unit = unit_pattern(cfg)
    n_units = cfg.n_layers // len(unit)
    if n_units * len(unit) != cfg.n_layers:
        raise ValueError(f"{cfg.arch_id}: {cfg.n_layers} layers do not "
                         f"divide into units {unit}")

    def init(gen=None, device=None):
        b = base.builder(cfg, gen, device)
        base.make_embedding(b, cfg)
        trees = []
        for _ in range(n_units):
            ub = ParamBuilder(b.gen, cfg.param_dtype)
            for j in range(len(unit)):
                _init_block(ub.sub(f"b{j}"), cfg)
            trees.append(ub.params)
        b.params["blocks"] = (stack_params(trees) if cfg.scan_layers else
                              {f"u{i}": p for i, p in enumerate(trees)})
        return b.params

    def _unit_apply(p, x, positions):
        for j, kind in enumerate(unit):
            x = _block_apply(cfg, kind, p[f"b{j}"], x, positions)
        return x

    def forward(params, batch):
        x = base.embed_tokens(params, cfg, batch["tokens"])
        b_, s, _ = x.shape
        positions = torch.arange(s, device=x.device)[None].expand(b_, s)
        x = base.run_blocks(lambda p, h: _unit_apply(p, h, positions),
                            base.units(params["blocks"], cfg, n_units), x)
        return base.lm_logits(params, cfg, x)

    def init_decode_state(batch_size: int, cache_len: int, device=None):
        dev = resolve_device(device)

        def unit_cache():
            out = {}
            for j, kind in enumerate(unit):
                length = (min(cfg.window, cache_len) if kind == "local"
                          else cache_len)
                out[f"b{j}"] = attn_lib.init_cache(
                    batch_size, length, cfg.n_kv_heads, cfg.head_dim,
                    cfg.dtype, dev)
            return out

        if cfg.scan_layers:
            return stack_params([unit_cache() for _ in range(n_units)])
        return {f"u{i}": unit_cache() for i in range(n_units)}

    def _unit_decode(p, x, cache, pos):
        for j, kind in enumerate(unit):
            h = layers.rmsnorm(p[f"b{j}"]["ln_attn"], x)
            window = cfg.window if kind == "local" else None
            h, _ = attn_lib.decode_attention(
                p[f"b{j}"]["attn"], h, cache[f"b{j}"], pos,
                d_head=cfg.head_dim, window=window,
                rope_theta=cfg.rope_theta,
                softmax_scale_cap=cfg.attn_softcap)
            x = x + h
            h = layers.rmsnorm(p[f"b{j}"]["ln_mlp"], x)
            x = x + layers.mlp(p[f"b{j}"]["mlp"], h, act=cfg.act)
        return x

    def decode_step(params, state, tokens, pos):
        """tokens (B, 1) at position `pos`; the caches in `state` are
        written in place. Returns (logits (B, 1, V), state)."""
        x = base.embed_tokens(params, cfg, tokens)          # (B, 1, d)
        blocks = base.units(params["blocks"], cfg, n_units)
        for i in range(n_units):
            cache = (unstack(state, i) if cfg.scan_layers
                     else state[f"u{i}"])
            x = _unit_decode(blocks[i], x, cache, pos)
        return base.lm_logits(params, cfg, x), state

    return Model(cfg=cfg, init=init, forward=forward,
                 init_decode_state=init_decode_state, decode_step=decode_step)

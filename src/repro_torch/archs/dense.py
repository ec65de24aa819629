"""Dense decoder-only family (counterpart of `repro/archs/dense.py`):
gemma3 (5:1 sliding-window:global), command-r, qwen2 (QKV bias), qwen3
(qk-norm) and the VLM qwen2-vl (M-RoPE; the vision encoder stubbed to
precomputed patch embeddings, prepended to the text)."""
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


def _block_apply(cfg: ModelConfig, kind: str, p, x, positions,
                 mrope_positions):
    h = layers.rmsnorm(p["ln_attn"], x)
    window = cfg.window if kind == "local" else None
    h = attn_lib.attention(
        p["attn"], h, positions, d_head=cfg.head_dim, causal=True,
        window=window, rope_theta=cfg.rope_theta,
        mrope_sections=cfg.mrope_sections, mrope_positions=mrope_positions,
        softmax_scale_cap=cfg.attn_softcap, chunk=cfg.attn_chunk,
        mode=cfg.kernels_mode)
    x = x + h
    h = layers.rmsnorm(p["ln_mlp"], x)
    return x + layers.mlp(p["mlp"], h, act=cfg.act)


def build(cfg: ModelConfig) -> Model:
    unit = unit_pattern(cfg)
    n_units = cfg.n_layers // len(unit)
    if n_units * len(unit) != cfg.n_layers:
        raise ValueError(f"{cfg.arch_id}: {cfg.n_layers} layers do not "
                         f"divide into units {unit}")

    def build_params(gen=None, device=None):
        b = base.builder(cfg, gen, device)
        base.make_embedding(b, cfg)

        def init_unit(ub):
            for j in range(len(unit)):
                _init_block(ub.sub(f"b{j}"), cfg)

        base.unit_params(b, "blocks", n_units, init_unit, cfg.scan_layers)
        return b.params, b.axes

    def _unit_apply(p, x, positions, mrope_positions):
        for j, kind in enumerate(unit):
            x = _block_apply(cfg, kind, p[f"b{j}"], x, positions,
                             mrope_positions)
        return x

    def trunk(params, batch):
        """The last layer's output at the text positions (B, S, d)."""
        x = base.embed_tokens(params, cfg, batch["tokens"])
        mrope_positions = None
        if cfg.num_patches:
            # VLM stub: precomputed patch embeddings prepended to the text
            patches = batch["patch_embeds"].to(cfg.dtype)
            x = torch.cat([patches, x], dim=1)
            mrope_positions = batch["mrope_positions"]      # (B, 3, S_total)
        b_, s, _ = x.shape
        positions = torch.arange(s, device=x.device)[None].expand(b_, s)
        if cfg.mrope_sections and mrope_positions is None:
            # text-only M-RoPE: the temporal, height and width coordinates
            # all advance with the token index (Qwen2-VL Sec. 3.1)
            mrope_positions = positions[:, None].expand(b_, 3, s)
        x = base.run_blocks(
            lambda p, h: _unit_apply(p, h, positions, mrope_positions),
            base.units(params["blocks"], cfg, n_units), x, remat=cfg.remat)
        return x[:, cfg.num_patches:] if cfg.num_patches else x

    forward, prefill = base.heads(cfg, trunk)

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

    def state_axes():
        per = {f"b{j}": dict(attn_lib.CACHE_AXES) for j in range(len(unit))}
        return base.stacked_state_axes(per, cfg.scan_layers, n_units)

    def _unit_decode(p, x, cache, pos, mrope_pos):
        for j, kind in enumerate(unit):
            h = layers.rmsnorm(p[f"b{j}"]["ln_attn"], x)
            window = cfg.window if kind == "local" else None
            h, _ = attn_lib.decode_attention(
                p[f"b{j}"]["attn"], h, cache[f"b{j}"], pos,
                d_head=cfg.head_dim, window=window,
                rope_theta=cfg.rope_theta,
                mrope_sections=cfg.mrope_sections, mrope_positions=mrope_pos,
                softmax_scale_cap=cfg.attn_softcap)
            x = x + h
            h = layers.rmsnorm(p[f"b{j}"]["ln_mlp"], x)
            x = x + layers.mlp(p[f"b{j}"]["mlp"], h, act=cfg.act)
        return x

    def decode_step(params, state, tokens, pos):
        """tokens (B, 1) at position `pos`; the caches in `state` are
        written in place. Returns (logits (B, 1, V), state)."""
        x = base.embed_tokens(params, cfg, tokens)          # (B, 1, d)
        mrope_pos = None
        if cfg.mrope_sections:
            # every coordinate at the token's position, as in JAX
            mrope_pos = torch.full((x.shape[0], 3, 1), int(pos),
                                   dtype=torch.int32, device=x.device)
        blocks = base.units(params["blocks"], cfg, n_units)
        for i in range(n_units):
            cache = (unstack(state, i) if cfg.scan_layers
                     else state[f"u{i}"])
            x = _unit_decode(blocks[i], x, cache, pos, mrope_pos)
        return base.lm_logits(params, cfg, x), state

    def extra_inputs(batch_size: int, seq_len: int):
        """The VLM's batch entries beside the tokens, as name -> (shape,
        dtype): the patch embeddings and the M-RoPE positions of the
        patches and the text."""
        if not cfg.num_patches:
            return {}
        s_total = cfg.num_patches + seq_len
        return {"patch_embeds": ((batch_size, cfg.num_patches, cfg.d_model),
                                 cfg.dtype),
                "mrope_positions": ((batch_size, 3, s_total), torch.int32)}

    return Model(cfg=cfg, build_params=build_params, forward=forward,
                 prefill=prefill, loss_fn=base.lm_loss(forward),
                 init_decode_state=init_decode_state, decode_step=decode_step,
                 extra_inputs=extra_inputs, state_axes=state_axes)

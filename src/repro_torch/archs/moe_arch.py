"""MoE decoder family (counterpart of `repro/archs/moe_arch.py`):
arctic-480b (128 experts top-2 and a dense residual FFN beside them) and
kimi-k2-1t-a32b (384 experts top-8, the first layer dense, one shared
expert).

The `first_dense` dense blocks (`dense_{i}`, a wide gated FFN) come
first, then the MoE blocks (`blocks`, stacked or `u{i}`). Attention is
the dense family's, so a long prefill runs the `flash_attn` kernel; the
experts run `nn/moe.py`. Decode carries one KV cache a layer."""
from __future__ import annotations

import torch

from repro_torch.archs import base
from repro_torch.archs.base import Model, ModelConfig
from repro_torch.device import resolve_device
from repro_torch.nn import attention as attn_lib
from repro_torch.nn import layers
from repro_torch.nn import moe as moe_lib
from repro_torch.nn.module import ParamBuilder, stack_params, unstack


def _init_attn(b: ParamBuilder, cfg: ModelConfig):
    layers.rmsnorm_init(b, "ln_attn", cfg.d_model)
    attn_lib.attention_init(b, "attn", cfg.d_model, cfg.n_heads,
                            cfg.n_kv_heads, cfg.head_dim,
                            qkv_bias=cfg.qkv_bias, qk_norm=cfg.qk_norm)
    layers.rmsnorm_init(b, "ln_mlp", cfg.d_model)


def _init_moe_block(b: ParamBuilder, cfg: ModelConfig):
    _init_attn(b, cfg)
    moe_lib.moe_init(b, "moe", cfg.d_model, cfg.d_ff, cfg.n_experts)
    if cfg.dense_residual:
        layers.mlp_init(b, "dense_mlp", cfg.d_model, cfg.d_ff, gated=True)
    if cfg.n_shared_experts:
        layers.mlp_init(b, "shared_mlp", cfg.d_model,
                        cfg.d_ff * cfg.n_shared_experts, gated=True)


def _init_dense_block(b: ParamBuilder, cfg: ModelConfig):
    _init_attn(b, cfg)
    # first-dense layers use a wide dense FFN (kimi: 4 x d_model)
    layers.mlp_init(b, "dense_mlp", cfg.d_model,
                    max(cfg.d_ff, 4 * cfg.d_model), gated=True)


def _attn_apply(cfg: ModelConfig, p, x, positions):
    h = layers.rmsnorm(p["ln_attn"], x)
    h = attn_lib.attention(p["attn"], h, positions, d_head=cfg.head_dim,
                           causal=True, rope_theta=cfg.rope_theta,
                           chunk=cfg.attn_chunk, mode=cfg.kernels_mode)
    return x + h


def _ffn(cfg: ModelConfig, p, h):
    """The MoE block's FFN: the experts, plus the dense residual branch
    and the shared expert where the config has them. Returns (y, aux)."""
    y, aux = moe_lib.moe(p["moe"], h, top_k=cfg.top_k,
                         capacity_factor=cfg.capacity_factor, act=cfg.act)
    if cfg.dense_residual:
        y = y + layers.mlp(p["dense_mlp"], h, act=cfg.act)
    if cfg.n_shared_experts:
        y = y + layers.mlp(p["shared_mlp"], h, act=cfg.act)
    return y, aux


def build(cfg: ModelConfig) -> Model:
    n_moe = cfg.n_layers - cfg.first_dense

    def build_params(gen=None, device=None):
        b = base.builder(cfg, gen, device)
        base.make_embedding(b, cfg)
        for i in range(cfg.first_dense):
            _init_dense_block(b.sub(f"dense_{i}"), cfg)
        base.unit_params(b, "blocks", n_moe,
                         lambda ub: _init_moe_block(ub, cfg), cfg.scan_layers)
        return b.params, b.axes

    def _moe_block(p, carry, positions):
        x, aux = carry
        x = _attn_apply(cfg, p, x, positions)
        y, aux_i = _ffn(cfg, p, layers.rmsnorm(p["ln_mlp"], x))
        return x + y, aux + aux_i

    def _dense_block(p, x, positions):
        x = _attn_apply(cfg, p, x, positions)
        h = layers.rmsnorm(p["ln_mlp"], x)
        return x + layers.mlp(p["dense_mlp"], h, act=cfg.act)

    def trunk_with_aux(params, batch):
        """The last layer's output (B, S, d) and the MoE layers' mean aux
        loss."""
        x = base.embed_tokens(params, cfg, batch["tokens"])
        b_, s, _ = x.shape
        positions = torch.arange(s, device=x.device)[None].expand(b_, s)
        for i in range(cfg.first_dense):
            # outside remat, as in JAX
            x = _dense_block(params[f"dense_{i}"], x, positions)
        carry = (x, torch.zeros((), dtype=torch.float32, device=x.device))
        x, aux = base.run_blocks(
            lambda p, c: _moe_block(p, c, positions),
            base.units(params["blocks"], cfg, n_moe), carry,
            remat=cfg.remat)
        return x, aux / max(n_moe, 1)

    forward, prefill = base.heads(cfg, lambda p, bt: trunk_with_aux(p, bt)[0])

    def loss_fn(params, batch):
        x, aux = trunk_with_aux(params, batch)
        ce = base.cross_entropy(base.lm_logits(params, cfg, x),
                                batch["targets"])
        return ce + cfg.moe_aux_weight * aux, {"aux": aux}

    # ----------------------------------------------------------- decode ----
    def init_decode_state(batch_size: int, cache_len: int, device=None):
        dev = resolve_device(device)

        def mk():
            return attn_lib.init_cache(batch_size, cache_len, cfg.n_kv_heads,
                                       cfg.head_dim, cfg.dtype, dev)

        state = {f"dense_{i}": mk() for i in range(cfg.first_dense)}
        caches = [mk() for _ in range(n_moe)]
        state["blocks"] = (stack_params(caches) if cfg.scan_layers else
                           {f"u{i}": c for i, c in enumerate(caches)})
        return state

    def state_axes():
        per = dict(attn_lib.CACHE_AXES)
        st = {f"dense_{i}": per for i in range(cfg.first_dense)}
        st["blocks"] = base.stacked_state_axes(per, cfg.scan_layers, n_moe)
        return st

    def _attn_decode(p, x, cache, pos):
        h = layers.rmsnorm(p["ln_attn"], x)
        h, _ = attn_lib.decode_attention(p["attn"], h, cache, pos,
                                         d_head=cfg.head_dim,
                                         rope_theta=cfg.rope_theta)
        return x + h

    def check_decode_pos(state, pos):
        """decode_step's check of an int pos (every layer is global)."""
        caches = (state["dense_0"] if cfg.first_dense else
                  state["blocks"] if cfg.scan_layers else
                  state["blocks"]["u0"])
        attn_lib.check_pos(pos, caches["k"].shape[-3])

    def decode_step(params, state, tokens, pos):
        """tokens (B, 1) at position `pos`; the caches in `state` are
        written in place. Returns (logits (B, 1, V), state)."""
        x = base.embed_tokens(params, cfg, tokens)
        for i in range(cfg.first_dense):
            p = params[f"dense_{i}"]
            x = _attn_decode(p, x, state[f"dense_{i}"], pos)
            h = layers.rmsnorm(p["ln_mlp"], x)
            x = x + layers.mlp(p["dense_mlp"], h, act=cfg.act)
        for i, p in enumerate(base.units(params["blocks"], cfg, n_moe)):
            cache = (unstack(state["blocks"], i) if cfg.scan_layers
                     else state["blocks"][f"u{i}"])
            x = _attn_decode(p, x, cache, pos)
            y, _ = _ffn(cfg, p, layers.rmsnorm(p["ln_mlp"], x))
            x = x + y
        return base.lm_logits(params, cfg, x), state

    return Model(cfg=cfg, build_params=build_params, forward=forward,
                 prefill=prefill, loss_fn=loss_fn,
                 init_decode_state=init_decode_state, decode_step=decode_step,
                 state_axes=state_axes, check_decode_pos=check_decode_pos)

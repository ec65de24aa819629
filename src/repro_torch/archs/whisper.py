"""whisper-tiny: an encoder-decoder transformer backbone
(arXiv:2212.04356; counterpart of `repro/archs/whisper.py`).

The mel-spectrogram and conv frontend are a stub, as in JAX: the batch
carries precomputed frame embeddings `audio_feats` (B, enc_frames,
d_model). The encoder adds sinusoidal positions and runs non-causal dense
attention; the decoder adds learned positions (`dec_pos`, max_seq rows)
and runs causal self-attention, cross-attention to the encoder's output
and a GELU MLP, with layernorms and biased projections. No attention here
takes the blockwise branch, so whisper launches no kernel. Decode carries
one KV cache a decoder layer and the encoder's output."""
from __future__ import annotations

import torch

from repro_torch.archs import base
from repro_torch.archs.base import Model, ModelConfig
from repro_torch.device import resolve_device
from repro_torch.nn import attention as attn_lib
from repro_torch.nn import layers
from repro_torch.nn.module import ParamBuilder, stack_params, unstack


def _sinusoid(n: int, d: int, device=None):
    """(n, d) sinusoidal positions: sin then cos of pos * 10000^(-i /
    (d/2 - 1)), in float32 as JAX computes them."""
    pos = torch.arange(n, device=device)[:, None].float()
    dim = torch.arange(d // 2, device=device)[None, :].float()
    log_base = torch.log(torch.tensor(10000.0, device=device))
    inv = torch.exp(-dim * (log_base / max(d // 2 - 1, 1)))
    ang = pos * inv
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def build(cfg: ModelConfig) -> Model:
    def _init_enc_block(b: ParamBuilder):
        layers.layernorm_init(b, "ln_attn", cfg.d_model)
        attn_lib.attention_init(b, "attn", cfg.d_model, cfg.n_heads,
                                cfg.n_kv_heads, cfg.head_dim, qkv_bias=True,
                                out_bias=True)
        layers.layernorm_init(b, "ln_mlp", cfg.d_model)
        layers.mlp_init(b, "mlp", cfg.d_model, cfg.d_ff, gated=False,
                        bias=True)

    def _init_dec_block(b: ParamBuilder):
        _init_enc_block(b)
        layers.layernorm_init(b, "ln_cross", cfg.d_model)
        attn_lib.attention_init(b, "cross", cfg.d_model, cfg.n_heads,
                                cfg.n_kv_heads, cfg.head_dim, qkv_bias=True,
                                out_bias=True)

    def build_params(gen=None, device=None):
        b = base.builder(cfg, gen, device)
        base.make_embedding(b, cfg)
        b.add("dec_pos", (cfg.max_seq, cfg.d_model), (None, "embed"),
              init="normal", scale=0.02)
        layers.layernorm_init(b, "enc_final_norm", cfg.d_model)
        base.unit_params(b, "enc", cfg.enc_layers, _init_enc_block,
                         cfg.scan_layers)
        base.unit_params(b, "dec", cfg.n_layers, _init_dec_block,
                         cfg.scan_layers)
        return b.params, b.axes

    def _enc_block(p, x):
        h = layers.layernorm(p["ln_attn"], x)
        h = attn_lib.attention(p["attn"], h, None, d_head=cfg.head_dim,
                               causal=False, rope_theta=None)
        x = x + h
        h = layers.layernorm(p["ln_mlp"], x)
        return x + layers.mlp(p["mlp"], h, act="gelu")

    def _dec_block(p, x, enc_out):
        h = layers.layernorm(p["ln_attn"], x)
        h = attn_lib.attention(p["attn"], h, None, d_head=cfg.head_dim,
                               causal=True, rope_theta=None)
        x = x + h
        h = layers.layernorm(p["ln_cross"], x)
        x = x + attn_lib.cross_attention(p["cross"], h, enc_out,
                                         d_head=cfg.head_dim)
        h = layers.layernorm(p["ln_mlp"], x)
        return x + layers.mlp(p["mlp"], h, act="gelu")

    def encode(params, audio_feats):
        """audio_feats (B, F, d) -> the encoder's output (B, F, d)."""
        x = audio_feats.to(cfg.dtype)
        x = x + _sinusoid(x.shape[1], cfg.d_model, x.device).to(
            cfg.dtype)[None]
        x = base.run_blocks(_enc_block,
                            base.units(params["enc"], cfg, cfg.enc_layers),
                            x, remat=cfg.remat)
        return layers.layernorm(params["enc_final_norm"], x)

    def trunk(params, batch):
        enc_out = encode(params, batch["audio_feats"])
        s = batch["tokens"].shape[1]
        x = layers.embed(params["embed"], batch["tokens"], dtype=cfg.dtype)
        x = x + params["dec_pos"][:s].to(cfg.dtype)[None]
        return base.run_blocks(lambda p, h: _dec_block(p, h, enc_out),
                               base.units(params["dec"], cfg, cfg.n_layers),
                               x, remat=cfg.remat)

    forward, prefill = base.heads(cfg, trunk)

    # ----------------------------------------------------------- decode ----
    def init_decode_state(batch_size: int, cache_len: int, device=None):
        """{"enc_out": zeros (B, enc_frames, d) for the caller to fill
        with `encode`, "self": one KV cache a decoder layer (stacked on a
        leading layer dim with scan_layers)}."""
        dev = resolve_device(device)
        caches = [attn_lib.init_cache(batch_size, cache_len, cfg.n_kv_heads,
                                      cfg.head_dim, cfg.dtype, dev)
                  for _ in range(cfg.n_layers)]
        return {"enc_out": torch.zeros((batch_size, cfg.enc_frames,
                                        cfg.d_model), dtype=cfg.dtype,
                                       device=dev),
                "self": (stack_params(caches) if cfg.scan_layers else
                         {f"u{i}": c for i, c in enumerate(caches)})}

    def state_axes():
        return {"enc_out": ("batch", None, "embed"),
                "self": base.stacked_state_axes(dict(attn_lib.CACHE_AXES),
                                                cfg.scan_layers,
                                                cfg.n_layers)}

    def _check_table(pos):
        if not 0 <= pos < cfg.max_seq:
            raise ValueError(f"whisper decode: position {pos} is outside "
                             f"the position table (max_seq {cfg.max_seq})")

    def check_decode_pos(state, pos):
        """decode_step's checks of an int pos, in its order."""
        _check_table(pos)
        caches = state["self"] if cfg.scan_layers else state["self"]["u0"]
        attn_lib.check_pos(pos, caches["k"].shape[-3])

    def decode_step(params, state, tokens, pos):
        """tokens (B, 1) at position `pos`; the caches in `state` are
        written in place. Returns (logits (B, 1, V), state). An int pos
        past the position table raises ValueError (JAX's dynamic_slice
        clamps to its last row); a 0-d integer tensor pos is read on the
        device only, and the caller checks it (`check_decode_pos`)."""
        if isinstance(pos, torch.Tensor):
            row = params["dec_pos"].index_select(0, pos.reshape(1).long())
        else:
            pos = int(pos)
            _check_table(pos)
            row = params["dec_pos"][pos:pos + 1]
        x = layers.embed(params["embed"], tokens, dtype=cfg.dtype)
        x = x + row.to(cfg.dtype)[None]
        enc_out = state["enc_out"]
        for i, p in enumerate(base.units(params["dec"], cfg, cfg.n_layers)):
            cache = (unstack(state["self"], i) if cfg.scan_layers
                     else state["self"][f"u{i}"])
            h = layers.layernorm(p["ln_attn"], x)
            h, _ = attn_lib.decode_attention(p["attn"], h, cache, pos,
                                             d_head=cfg.head_dim,
                                             rope_theta=None)
            x = x + h
            h = layers.layernorm(p["ln_cross"], x)
            x = x + attn_lib.cross_attention(p["cross"], h, enc_out,
                                             d_head=cfg.head_dim)
            h = layers.layernorm(p["ln_mlp"], x)
            x = x + layers.mlp(p["mlp"], h, act="gelu")
        return base.lm_logits(params, cfg, x), state

    def extra_inputs(batch_size: int, seq_len: int):
        """The batch entry beside the tokens, as name -> (shape, dtype):
        the frame embeddings."""
        return {"audio_feats": ((batch_size, cfg.enc_frames, cfg.d_model),
                                cfg.dtype)}

    return Model(cfg=cfg, build_params=build_params, forward=forward,
                 prefill=prefill, loss_fn=base.lm_loss(forward),
                 init_decode_state=init_decode_state, decode_step=decode_step,
                 extra_inputs=extra_inputs, encode=encode,
                 state_axes=state_axes, check_decode_pos=check_decode_pos)

"""xlstm-350m: alternating mLSTM / sLSTM residual blocks (arXiv:2405.04517;
counterpart of `repro/archs/xlstm_arch.py`).

Pattern unit = (slstm_every - 1) mLSTM blocks + 1 sLSTM block. mLSTM runs
chunk-parallel (the `ssd_chunk` kernel), sLSTM a loop over time; decode
carries O(1) recurrent state."""
from __future__ import annotations

from repro_torch.archs import base
from repro_torch.archs.base import Model, ModelConfig
from repro_torch.device import resolve_device
from repro_torch.nn import layers, xlstm
from repro_torch.nn.module import stack_params, unstack


def build(cfg: ModelConfig) -> Model:
    every = cfg.slstm_every or (cfg.n_layers + 1)  # 0 -> all mLSTM
    unit = ["mlstm"] * (min(every, cfg.n_layers) - 1) + ["slstm"]
    if cfg.slstm_every == 0:
        unit = ["mlstm"]
    n_units = cfg.n_layers // len(unit)
    if n_units * len(unit) != cfg.n_layers:
        raise ValueError(f"{cfg.arch_id}: {cfg.n_layers} layers do not "
                         f"divide into units {unit}")

    def build_params(gen=None, device=None):
        b = base.builder(cfg, gen, device)
        base.make_embedding(b, cfg)

        def init_unit(ub):
            for j, kind in enumerate(unit):
                blk = ub.sub(f"b{j}")
                layers.rmsnorm_init(blk, "ln", cfg.d_model)
                if kind == "mlstm":
                    xlstm.mlstm_init(blk, "cell", cfg.d_model, cfg.n_heads)
                else:
                    xlstm.slstm_init(blk, "cell", cfg.d_model,
                                     cfg.n_kv_heads)

        base.unit_params(b, "blocks", n_units, init_unit, cfg.scan_layers)
        return b.params, b.axes

    def _unit_apply(p, x):
        for j, kind in enumerate(unit):
            blk = p[f"b{j}"]
            h = layers.rmsnorm(blk["ln"], x)
            if kind == "mlstm":
                h = xlstm.mlstm(blk["cell"], h, n_heads=cfg.n_heads,
                                mode=cfg.kernels_mode)
            else:
                h = xlstm.slstm(blk["cell"], h, n_heads=cfg.n_kv_heads)
            x = x + h
        return x

    def trunk(params, batch):
        x = base.embed_tokens(params, cfg, batch["tokens"])
        return base.run_blocks(_unit_apply,
                               base.units(params["blocks"], cfg, n_units), x,
                               remat=cfg.remat)

    forward, prefill = base.heads(cfg, trunk)

    def _unit_state(batch_size, dev):
        st = {}
        for j, kind in enumerate(unit):
            if kind == "mlstm":
                st[f"b{j}"] = xlstm.mlstm_decode_init(
                    batch_size, cfg.d_model, cfg.n_heads, dev)
            else:
                st[f"b{j}"] = xlstm.slstm_decode_init(batch_size,
                                                      cfg.d_model, dev)
        return st

    def init_decode_state(batch_size: int, cache_len: int, device=None):
        del cache_len  # O(1)-state decode
        dev = resolve_device(device)
        states = [_unit_state(batch_size, dev) for _ in range(n_units)]
        if cfg.scan_layers:
            return stack_params(states)
        return {f"u{i}": s for i, s in enumerate(states)}

    def state_axes():
        st = {f"b{j}": (xlstm.MLSTM_STATE_AXES if kind == "mlstm"
                        else xlstm.SLSTM_STATE_AXES)
              for j, kind in enumerate(unit)}
        if not cfg.scan_layers:
            return {f"u{i}": st for i in range(n_units)}
        # "layers" before each tensor's axes: the sLSTM triple's three
        return {k: tuple(("layers", *a) for a in ax)
                if kind == "slstm" else ("layers", *ax)
                for (k, ax), kind in zip(st.items(), unit)}

    def _unit_decode(p, x, st):
        new = {}
        for j, kind in enumerate(unit):
            blk = p[f"b{j}"]
            h = layers.rmsnorm(blk["ln"], x)
            if kind == "mlstm":
                h, new[f"b{j}"] = xlstm.mlstm_decode(
                    blk["cell"], h, st[f"b{j}"], n_heads=cfg.n_heads)
            else:
                h, new[f"b{j}"] = xlstm.slstm_decode(
                    blk["cell"], h, st[f"b{j}"], n_heads=cfg.n_kv_heads)
            x = x + h
        return x, new

    def decode_step(params, state, tokens, pos):
        """One token; returns (logits (B, 1, V), the new state)."""
        del pos
        x = base.embed_tokens(params, cfg, tokens)
        blocks = base.units(params["blocks"], cfg, n_units)
        news = []
        for i in range(n_units):
            st = unstack(state, i) if cfg.scan_layers else state[f"u{i}"]
            x, new = _unit_decode(blocks[i], x, st)
            news.append(new)
        new_state = (stack_params(news) if cfg.scan_layers
                     else {f"u{i}": s for i, s in enumerate(news)})
        return base.lm_logits(params, cfg, x), new_state

    return Model(cfg=cfg, build_params=build_params, forward=forward,
                 prefill=prefill, loss_fn=base.lm_loss(forward),
                 init_decode_state=init_decode_state, decode_step=decode_step,
                 state_axes=state_axes)

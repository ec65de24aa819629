"""Model zoo base: ModelConfig, shared assembly helpers, the Model bundle
(counterpart of `repro/archs/base.py`).

Every architecture exposes a `Model`:
    init(gen, device=None)       -> params (nested dict of tensors)
    param_axes()                 -> the parameters' logical-axis tree
    state_axes()                 -> the decode state's logical-axis tree
    forward(params, batch)       -> logits (B, S, V)   [training math]
    prefill(params, batch)       -> logits (B, V)      [the last position]
    loss_fn(params, batch)       -> (scalar loss, aux dict) [CE + aux]
    init_decode_state(batch_size, cache_len, device=None) -> state
    decode_step(params, state, tokens, pos) -> (logits, state)

Entry points run on CUDA unless given device="cpu". Serving callers run
them under `torch.no_grad()`; with grad mode on, every kernel call saves
its inputs for the backward through its plain version, and with
`cfg.remat` each layer unit is recomputed in the backward
(`torch.utils.checkpoint`, JAX's `jax.checkpoint`)."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.nn import layers
from repro_torch.nn.module import ParamBuilder, stack_axes
from repro_torch.train import annotate
from repro_torch.utils.tree import tree_map


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0  # 0 -> d_model // n_heads
    # attention options
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10000.0
    window: int | None = None           # sliding-window size for local layers
    global_every: int = 0               # every Nth layer is global (gemma 5:1 -> 6)
    logit_softcap: float | None = None
    attn_softcap: float | None = None
    # blockwise online-softmax attention (the flash_attn kernel) for long
    # sequences (None = dense). Engaged when S >= 2*attn_chunk and
    # S % attn_chunk == 0; the kernel's tiles do not depend on it.
    attn_chunk: int | None = 2048
    # MoE
    n_experts: int = 0
    top_k: int = 0
    dense_residual: bool = False        # arctic: dense FFN branch in parallel
    first_dense: int = 0                # kimi: first N layers are dense FFN
    n_shared_experts: int = 0           # kimi: always-on shared expert(s)
    capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01
    # SSM / xLSTM / hybrid
    ssm_state: int = 0
    ssm_head_dim: int = 64
    mamba_expand: int = 2
    slstm_every: int = 0                # xLSTM: every Nth layer is sLSTM
    attn_every: int = 0                 # zamba2: shared attn after every Nth block
    # audio (whisper) / vlm
    enc_layers: int = 0
    enc_frames: int = 1500
    num_patches: int = 0
    mrope_sections: tuple[int, ...] | None = None
    # runtime
    act: str = "silu"
    tie_embeddings: bool = True
    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32
    remat: bool = True
    scan_layers: bool = True
    max_seq: int = 8192                 # positional table size (whisper only)
    # the port's kernel route (ops.dispatch's mode): "auto" (the kernels on
    # CUDA tensors, the plain versions on CPU tensors) or "oracle" (the
    # plain versions everywhere, for comparison)
    kernels_mode: str = "auto"

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    def reduced(self, **kw) -> "ModelConfig":
        """Smoke-test variant: 2 layers, d_model<=256, <=4 experts."""
        d_model = min(self.d_model, 256)
        n_heads = min(self.n_heads, 4)
        n_kv = min(self.n_kv_heads, n_heads)
        upd = dict(
            n_layers=2,
            d_model=d_model,
            n_heads=n_heads,
            n_kv_heads=n_kv,
            d_head=d_model // n_heads,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab=min(self.vocab, 1024),
            n_experts=min(self.n_experts, 4),
            top_k=min(self.top_k, 2),
            first_dense=min(self.first_dense, 1),
            global_every=2 if self.global_every else 0,
            window=min(self.window, 64) if self.window else None,
            slstm_every=2 if self.slstm_every else 0,
            attn_every=2 if self.attn_every else 0,
            enc_layers=2 if self.enc_layers else 0,
            enc_frames=16 if self.enc_layers else self.enc_frames,
            num_patches=8 if self.num_patches else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=32 if self.ssm_state else self.ssm_head_dim,
            dtype=torch.float32,
            remat=False,
            scan_layers=False,
            max_seq=512,
        )
        if self.mrope_sections:
            hd = d_model // n_heads
            s0 = hd // 2 - 2 * (hd // 6)
            upd["mrope_sections"] = (s0, hd // 6, hd // 6)
        upd.update(kw)
        return dataclasses.replace(self, **upd)


@dataclasses.dataclass
class Model:
    cfg: ModelConfig
    # (gen, device) -> (params, axes): the parameters drawn from `gen` on
    # `device` (a new generator seeded 0 there when None), and their
    # logical axes; with device="meta" and no generator, meta leaves
    build_params: Callable
    forward: Callable
    prefill: Callable
    loss_fn: Callable
    init_decode_state: Callable | None = None
    decode_step: Callable | None = None
    extra_inputs: Callable | None = None  # shapes of aux inputs (vlm/audio)
    encode: Callable | None = None        # enc-dec only: the encoder
    state_axes: Callable | None = None    # () -> the decode state's axes

    def init(self, gen: torch.Generator | None = None, device=None):
        """The parameters (a nested dict of tensors), drawn from `gen`."""
        return self.build_params(gen, device)[0]

    def param_axes(self):
        """The parameters' logical-axis tree (one tuple a leaf), built on
        the meta device: nothing is drawn or allocated."""
        return self.build_params(None, "meta")[1]


# ---------------------------------------------------------------------------
# shared helpers
# ---------------------------------------------------------------------------


def padded_vocab(cfg: ModelConfig) -> int:
    """Vocab rounded up to 256, as the JAX package pads it."""
    return -(-cfg.vocab // 256) * 256


def builder(cfg: ModelConfig, gen: torch.Generator | None, device):
    """A ParamBuilder drawing from `gen` (seed 0 on the resolved device
    when None), which must live on the resolved device; on "meta" with
    no generator, one that draws nothing."""
    dev = resolve_device(device)
    if dev.type == "meta" and gen is None:
        return ParamBuilder(None, cfg.param_dtype, dev)
    if gen is None:
        gen = torch.Generator(dev).manual_seed(0)
    if gen.device.type != dev.type:
        raise ValueError(f"the generator is on {gen.device}, the parameters "
                         f"go to {dev}")
    return ParamBuilder(gen, cfg.param_dtype)


def unit_params(b: ParamBuilder, name: str, n_units: int, init_unit,
                stacked: bool) -> None:
    """b's `name` subtree: `n_units` unit trees drawn in turn from b's
    generator by `init_unit(ParamBuilder)`, as {"u{i}": tree}, or
    (`stacked`) stacked on a leading unit dim, each unit copied into the
    stack as it is drawn so that memory holds one unit beside the stack
    (gemma3-12b's 47 GB of float32 parameters would not fit twice on an
    80 GB card). A stack of one unit is a view of it (kimi-k2's one MoE
    unit holds 34 GB of bfloat16 experts). Its axes: each unit's, or the
    unit's with a leading "layers" entry (JAX's `stack_params`)."""
    out, axes, stack = {}, {}, None
    for i in range(n_units):
        ub = b.fresh()
        init_unit(ub)
        if not stacked:
            out[f"u{i}"], axes[f"u{i}"] = ub.params, ub.axes
            continue
        axes = stack_axes(ub.axes)
        if n_units == 1:
            stack = tree_map(lambda x: x[None], ub.params)
            break
        if stack is None:
            stack = tree_map(lambda x: x.new_empty((n_units,) + x.shape),
                             ub.params)
        tree_map(lambda st, x: st[i].copy_(x), stack, ub.params)
    b.params[name] = stack if stacked and n_units else out
    b.axes[name] = axes


def stacked_state_axes(unit_axes, stacked: bool, n_units: int):
    """A decode state's axes from one unit's: with a leading "layers"
    entry on every leaf where the units' states are stacked, else one
    copy a unit under "u{i}" (JAX's `state_axes`)."""
    if stacked:
        return stack_axes(unit_axes)
    return {f"u{i}": unit_axes for i in range(n_units)}


def make_embedding(b: ParamBuilder, cfg: ModelConfig):
    layers.embedding_init(b, "embed", padded_vocab(cfg), cfg.d_model)
    layers.rmsnorm_init(b, "final_norm", cfg.d_model)
    if not cfg.tie_embeddings:
        layers.linear_init(b, "lm_head", cfg.d_model, padded_vocab(cfg),
                           in_axis="embed", out_axis="vocab")


def embed_tokens(params, cfg: ModelConfig, tokens):
    x = layers.embed(params["embed"], tokens, dtype=cfg.dtype)
    return x * torch.tensor(cfg.d_model ** 0.5, dtype=cfg.dtype,
                            device=x.device)


def lm_logits(params, cfg: ModelConfig, x):
    x = layers.rmsnorm(params["final_norm"], x)
    if cfg.tie_embeddings:
        logits = layers.unembed(params["embed"], x)
    else:
        logits = layers.linear(params["lm_head"], x, dtype=torch.float32)
    if cfg.logit_softcap:
        logits = torch.tanh(logits / cfg.logit_softcap) * cfg.logit_softcap
    if padded_vocab(cfg) != cfg.vocab:
        logits = logits[..., : cfg.vocab]
    return logits


def cross_entropy(logits, targets, mask=None):
    """logits fp32 (B, S, V); targets int (B, S). The gold logit is
    picked with `gather`, the same value bit for bit as JAX's one-hot
    contraction (which only keeps a vocab-sharded tensor sharded; one
    card has no such tensor, and the one-hot would be a second (B, S, V)
    float32 tensor); on DTensor logits, that contraction."""
    logz = torch.logsumexp(logits, dim=-1)
    if annotate.is_dtensor(logits):
        # JAX's one-hot contraction: vocab-sharded logits stay sharded and
        # one (B, S) sum is reduced (DTensor's gather over a sharded dim
        # fails); a sum of one logit and zeros, the same value exactly
        vocab = torch.arange(logits.shape[-1], device=logits.device)
        onehot = (targets.long()[..., None] == vocab).to(logits.dtype)
        gold = torch.sum(logits * onehot, dim=-1)
    else:
        gold = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    nll = logz - gold
    if mask is None:
        return torch.mean(nll)
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)


def heads(cfg: ModelConfig, trunk):
    """(forward, prefill) over `trunk(params, batch) -> (B, S, d)`: the
    logits of every position, and of the last one only (JAX's
    `make_prefill_spec` takes `forward(...)[:, -1]`; rmsnorm is per row,
    so the two agree up to the unembedding's summation order)."""
    def forward(params, batch):
        return lm_logits(params, cfg, trunk(params, batch))

    def prefill(params, batch):
        return lm_logits(params, cfg, trunk(params, batch)[:, -1])

    return forward, prefill


def lm_loss(forward):
    """loss_fn(params, batch) -> (cross entropy of `forward`'s logits
    against batch["targets"], {}): the dense, xLSTM, zamba2 and whisper
    losses, which carry no auxiliary term."""
    def loss_fn(params, batch):
        return cross_entropy(forward(params, batch), batch["targets"]), {}

    return loss_fn


def run_blocks(block_fn, params_list, x, remat: bool = False):
    """block_fn(params_i, x) -> x over per-unit parameter trees (JAX's
    `run_blocks`, and `scan_blocks` over `units`' views of a stacked
    tree). With `remat` and grad mode on, each unit is recomputed in the
    backward (JAX's `jax.checkpoint`): its activations are not kept, and
    every kernel it calls launches again in the recompute. Under
    `no_grad` (serving) nothing changes. The blocks draw no random
    numbers, so the RNG state is not stashed."""
    fn = block_fn
    if remat and torch.is_grad_enabled():
        fn = lambda *args: checkpoint(block_fn, *args, use_reentrant=False,
                                      preserve_rng_state=False)
    for p in params_list:
        x = fn(p, x)
    return x


def units(params_blocks, cfg: ModelConfig, n_units: int):
    """Per-unit parameter trees: the `u{i}` subtrees, or views of unit i
    of the stacked tree (`scan_layers=True`, JAX's `scan_blocks` layout).
    The stacked leaves are split by one `unbind` each, so the backward
    stacks the units' gradients into the stacked leaf's once (a view per
    unit would add a full-size zero-padded gradient per unit)."""
    if cfg.scan_layers:
        split = tree_map(lambda x: x.unbind(0), params_blocks)
        # FSDP weight-gather hook on each unit's leaves (JAX's scan body)
        return [tree_map(lambda parts: annotate.weights(parts[i]), split)
                for i in range(n_units)]
    return [params_blocks[f"u{i}"] for i in range(n_units)]

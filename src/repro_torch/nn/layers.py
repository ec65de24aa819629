"""Core layers of the model zoo: rmsnorm, layernorm, linear, embedding,
(gated) MLP (counterpart of `repro/nn/layers.py`). Casts sit where the JAX package has
them: norms run in float32 and cast back, the tied unembedding is a
float32 product, every other product runs in the activations' dtype.
Every weight passes `annotate.weights` where JAX's does: the identity
unless a spec installs its FSDP weight-gather hook."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.nn.module import ParamBuilder
from repro_torch.train import annotate


def rmsnorm_init(b: ParamBuilder, name: str, dim: int, axis: str = "embed"):
    b.sub(name).add("scale", (dim,), (axis,), init="ones")


def rmsnorm(params, x, eps: float = 1e-6):
    dtype = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * annotate.weights(params["scale"]).float()).to(dtype)


def layernorm_init(b: ParamBuilder, name: str, dim: int,
                   axis: str = "embed"):
    sub = b.sub(name)
    sub.add("scale", (dim,), (axis,), init="ones")
    sub.add("bias", (dim,), (axis,), init="zeros")


def layernorm(params, x, eps: float = 1e-5):
    dtype = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * annotate.weights(params["scale"])
            + annotate.weights(params["bias"])).to(dtype)


def linear_init(b: ParamBuilder, name: str, in_dim: int, out_dim: int,
                in_axis: str = "embed", out_axis: str = "mlp",
                bias: bool = False, scale: float | None = None):
    sub = b.sub(name)
    sub.add("w", (in_dim, out_dim), (in_axis, out_axis), scale=scale)
    if bias:
        sub.add("b", (out_dim,), (out_axis,), init="zeros")


def linear(params, x, dtype=None):
    w = params["w"]
    if dtype is not None:
        w = w.to(dtype)
        x = x.to(dtype)
    y = x @ annotate.weights(w)
    if "b" in params:
        y = y + params["b"].to(y.dtype)
    return y


def embedding_init(b: ParamBuilder, name: str, vocab: int, dim: int,
                   scale=None):
    b.sub(name).add("table", (vocab, dim), ("vocab", "embed"), init="embed",
                    scale=scale if scale is not None else dim ** -0.5)


def embed(params, ids, dtype=None):
    # a DTensor table gathered whole before the lookup: DTensor's masked
    # gather over a vocab-sharded table fails on a table sharded on both
    # dims with batch-sharded ids (torch 2.13), and its partial sum loses
    # its mask on meta tensors (the card's 2.11)
    table = annotate.replicate(annotate.weights(params["table"]))
    if dtype is not None:
        table = table.to(dtype)
    return F.embedding(ids.long(), table)


def unembed(params, x):
    """Tied logits: x @ table^T in float32."""
    table = annotate.weights(params["table"])
    return torch.einsum("...d,vd->...v", x.float(), table.float())


ACTS = {
    "silu": F.silu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "relu": F.relu,
    "tanh": torch.tanh,
}


def mlp_init(b: ParamBuilder, name: str, d_model: int, d_ff: int,
             gated: bool = True, bias: bool = False):
    sub = b.sub(name)
    sub.add("wi", (d_model, d_ff), ("embed", "mlp"))
    if gated:
        sub.add("wg", (d_model, d_ff), ("embed", "mlp"))
    sub.add("wo", (d_ff, d_model), ("mlp", "embed"))
    if bias:
        sub.add("bi", (d_ff,), ("mlp",), init="zeros")
        sub.add("bo", (d_model,), ("embed",), init="zeros")


def mlp(params, x, act: str = "silu"):
    act_fn = ACTS[act]
    h = x @ annotate.weights(params["wi"].to(x.dtype))
    if "bi" in params:
        h = h + params["bi"].to(x.dtype)
    if "wg" in params:
        h = act_fn(x @ annotate.weights(params["wg"].to(x.dtype))) * h
    else:
        h = act_fn(h)
    y = h @ annotate.weights(params["wo"].to(x.dtype))
    if "bo" in params:
        y = y + params["bo"].to(x.dtype)
    return y

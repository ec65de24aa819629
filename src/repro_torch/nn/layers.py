"""Core layers of the model zoo: rmsnorm, layernorm, linear, embedding,
(gated) MLP (counterpart of `repro/nn/layers.py`). Casts sit where the JAX package has
them: norms run in float32 and cast back, the tied unembedding is a
float32 product, every other product runs in the activations' dtype."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.nn.module import ParamBuilder


def rmsnorm_init(b: ParamBuilder, name: str, dim: int):
    b.sub(name).add("scale", (dim,), init="ones")


def rmsnorm(params, x, eps: float = 1e-6):
    dtype = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * params["scale"].float()).to(dtype)


def layernorm_init(b: ParamBuilder, name: str, dim: int):
    sub = b.sub(name)
    sub.add("scale", (dim,), init="ones")
    sub.add("bias", (dim,), init="zeros")


def layernorm(params, x, eps: float = 1e-5):
    dtype = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * params["scale"] + params["bias"]).to(dtype)


def linear_init(b: ParamBuilder, name: str, in_dim: int, out_dim: int,
                bias: bool = False, scale: float | None = None):
    sub = b.sub(name)
    sub.add("w", (in_dim, out_dim), scale=scale)
    if bias:
        sub.add("b", (out_dim,), init="zeros")


def linear(params, x, dtype=None):
    w = params["w"]
    if dtype is not None:
        w = w.to(dtype)
        x = x.to(dtype)
    y = x @ w
    if "b" in params:
        y = y + params["b"].to(y.dtype)
    return y


def embedding_init(b: ParamBuilder, name: str, vocab: int, dim: int,
                   scale=None):
    b.sub(name).add("table", (vocab, dim), init="embed",
                    scale=scale if scale is not None else dim ** -0.5)


def embed(params, ids, dtype=None):
    table = params["table"]
    if dtype is not None:
        table = table.to(dtype)
    return F.embedding(ids.long(), table)


def unembed(params, x):
    """Tied logits: x @ table^T in float32."""
    return torch.einsum("...d,vd->...v", x.float(), params["table"].float())


ACTS = {
    "silu": F.silu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "relu": F.relu,
    "tanh": torch.tanh,
}


def mlp_init(b: ParamBuilder, name: str, d_model: int, d_ff: int,
             gated: bool = True, bias: bool = False):
    sub = b.sub(name)
    sub.add("wi", (d_model, d_ff))
    if gated:
        sub.add("wg", (d_model, d_ff))
    sub.add("wo", (d_ff, d_model))
    if bias:
        sub.add("bi", (d_ff,), init="zeros")
        sub.add("bo", (d_model,), init="zeros")


def mlp(params, x, act: str = "silu"):
    act_fn = ACTS[act]
    h = x @ params["wi"].to(x.dtype)
    if "bi" in params:
        h = h + params["bi"].to(x.dtype)
    if "wg" in params:
        h = act_fn(x @ params["wg"].to(x.dtype)) * h
    else:
        h = act_fn(h)
    y = h @ params["wo"].to(x.dtype)
    if "bo" in params:
        y = y + params["bo"].to(x.dtype)
    return y

"""The port's whisper-tiny (`archs/whisper.py`) and its layers
(`layernorm`, `cross_attention`) against the JAX package.

`layernorm` and `cross_attention` (with and without a source mask) on the
same numpy inputs; then the reduced whisper (2 encoder + 2 decoder
layers, 16 frames) in both parameter layouts: `encode`, `forward`, the
last-position prefill, `loss_fn` and 4 decode steps from the encoder's
output, against JAX's jitted functions with JAX's parameters carried over
by `bridge.zoo_params_from_numpy`, within 1e-5 * max(1, |ref|). Its
attention is dense everywhere, so no kernel is involved."""
from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.archs import api as japi
from repro.archs import whisper as jwhisper
from repro.configs import get_config as jget_config
from repro.nn import attention as jattn
from repro.nn import layers as jlayers
from repro.nn.module import ParamBuilder as JParamBuilder

from repro_torch import bridge
from repro_torch.archs import api, whisper
from repro_torch.configs import get_config
from repro_torch.nn import attention, layers

TOL = 1e-5


def _t(a):
    return torch.as_tensor(np.array(a))


def _close(got, want, name, tol=TOL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    lim = tol * max(1.0, float(np.abs(want).max(initial=0.0)))
    err = float(np.abs(got - want).max(initial=0.0))
    assert err <= lim, f"{name}: max |port - jax| = {err:.3g} > {lim:.3g}"


def _jtree(tree):
    return jax.tree.map(np.asarray, tree)


def test_layernorm_matches_jax():
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(3, 5, 48)) * 3 + 1).astype(np.float32)
    p = {"scale": rng.normal(size=48).astype(np.float32),
         "bias": rng.normal(size=48).astype(np.float32)}
    want = jax.jit(jlayers.layernorm)(p, x)
    _close(layers.layernorm(bridge.zoo_params_from_numpy(p, "cpu"), _t(x)),
           want, "layernorm")
    jb = JParamBuilder(jax.random.PRNGKey(0), jnp.float32)
    jlayers.layernorm_init(jb, "ln", 48)
    from repro_torch.nn.module import ParamBuilder
    b = ParamBuilder(torch.Generator().manual_seed(0))
    layers.layernorm_init(b, "ln", 48)
    for k in ("scale", "bias"):
        np.testing.assert_array_equal(b.params["ln"][k].numpy(),
                                      np.asarray(jb.params["ln"][k]))
    half = layers.layernorm(bridge.zoo_params_from_numpy(p, "cpu"),
                            _t(x).to(torch.bfloat16))
    assert half.dtype == torch.bfloat16


@pytest.mark.parametrize("masked", [False, True], ids=["dense", "src_mask"])
def test_cross_attention_matches_jax(masked):
    jb = JParamBuilder(jax.random.PRNGKey(1), jnp.float32)
    jattn.attention_init(jb, "cross", 64, 4, 4, 16, qkv_bias=True,
                         out_bias=True)
    jp = jb.params["cross"]
    jp = dict(jp, bq=jax.random.normal(jax.random.PRNGKey(2), (64,)),
              bo=jax.random.normal(jax.random.PRNGKey(3), (64,)))
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 7, 64)).astype(np.float32)
    src = rng.normal(size=(2, 11, 64)).astype(np.float32)
    mask = None
    if masked:
        mask = np.ones((2, 11), bool)
        mask[0, 6:] = False
        mask[1, :3] = False
    want = jax.jit(lambda p, a, b_, m: jattn.cross_attention(
        p, a, b_, d_head=16, src_mask=m))(jp, x, src, mask)
    got = attention.cross_attention(
        bridge.zoo_params_from_numpy(_jtree(jp), "cpu"), _t(x), _t(src),
        d_head=16, src_mask=None if mask is None else _t(mask))
    _close(got, want, "cross_attention")


def test_sinusoid_matches_jax():
    """The published 1,500 frames at d = 384. PyTorch's and XLA's float32
    exp differ by one ulp (<= 2^-23 below 1) on some of the inverse
    frequencies, and the angle pos * inv carries pos times that: the two
    agree within TOL + 1500 * 2^-23."""
    _close(whisper._sinusoid(1500, 384), jwhisper._sinusoid(1500, 384),
           "sinusoid", tol=TOL + 1500 * 2.0 ** -23)


S = 24
DECODE_STEPS = 4


@pytest.mark.parametrize("scan", [False, True], ids=["units", "stacked"])
def test_reduced_whisper_matches_jax(scan):
    jcfg = jget_config("whisper-tiny").reduced(scan_layers=scan)
    jmodel = japi.get_model(jcfg)
    jparams, _ = jmodel.init(jax.random.PRNGKey(0))
    keys = jax.random.split(jax.random.PRNGKey(1), 3)
    toks = np.asarray(jax.random.randint(keys[0], (2, S), 0, jcfg.vocab),
                      np.int32)
    tgts = np.asarray(jax.random.randint(keys[1], (2, S), 0, jcfg.vocab),
                      np.int32)
    feats = np.asarray(jax.random.normal(
        keys[2], (2, jcfg.enc_frames, jcfg.d_model)), np.float32)
    jbatch = {"tokens": jnp.asarray(toks), "targets": jnp.asarray(tgts),
              "audio_feats": jnp.asarray(feats)}
    jenc = jax.jit(jmodel.encode)(jparams, jbatch["audio_feats"])
    want = jax.jit(jmodel.forward)(jparams, jbatch)
    jloss, _ = jax.jit(jmodel.loss_fn)(jparams, jbatch)

    cfg = get_config("whisper-tiny").reduced(scan_layers=scan)
    model = api.get_model(cfg)
    assert {k: (tuple(s), str(d).removeprefix("torch."))
            for k, (s, d) in model.extra_inputs(2, S).items()} == \
        {k: (tuple(v.shape), np.dtype(v.dtype).name)
         for k, v in jmodel.extra_inputs(2, S).items()}
    params = bridge.zoo_params_from_numpy(_jtree(jparams), "cpu")
    batch = {"tokens": _t(toks), "targets": _t(tgts),
             "audio_feats": _t(feats)}
    with torch.no_grad():
        enc = model.encode(params, batch["audio_feats"])
        got = model.forward(params, batch)
        last = model.prefill(params, batch)
        loss, aux = model.loss_fn(params, batch)
    assert aux == {}
    _close(enc, jenc, "encode")
    _close(got, want, "forward")
    _close(last, np.asarray(want)[:, -1], "prefill")
    _close(loss, jloss, "loss")

    jstate = jmodel.init_decode_state(2, 16)
    jstate["enc_out"] = jenc
    jstep = jax.jit(jmodel.decode_step)
    with torch.no_grad():
        state = model.init_decode_state(2, 16, "cpu")
        assert tuple(state["enc_out"].shape) == tuple(jstate["enc_out"].shape)
        state["enc_out"] = enc
        for i in range(DECODE_STEPS):
            tok = toks[:, i:i + 1]
            jl, jstate = jstep(jparams, jstate, jnp.asarray(tok),
                               jnp.asarray(i, jnp.int32))
            lg, state = model.decode_step(params, state, _t(tok), i)
            _close(lg, jl, f"decode step {i}")
            err = float((lg[:, 0] - got[:, i]).abs().max())
            assert err < 1e-4, (i, err)
        with pytest.raises(ValueError, match="max_seq"):
            model.decode_step(params, state, _t(toks[:, :1]), cfg.max_seq)

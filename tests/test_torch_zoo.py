"""The port's model zoo slice against the JAX package: the `flash_attn`
and `ssd_chunk` kernels' plain versions, attention (RoPE and M-RoPE), the
chunked linear recurrence, mLSTM / sLSTM, and the reduced qwen3-0.6b,
xlstm-350m, gemma3-12b, qwen2-7b, command-r-plus-104b and qwen2-vl-2b
(forward, the last-position prefill and decode, both parameter layouts;
zamba2 is in `test_torch_zamba.py`; the MoE family, whisper and zoo
training in `test_torch_moe.py`, `test_torch_whisper.py` and
`test_torch_zoo_train.py`), plus the kernels' gradients, the registry and
`serve --zoo` for every arch.

On the CPU each kernel wrapper runs its plain PyTorch version; it is held
against the JAX Pallas kernel in interpret mode and the JAX oracle on the
same numpy inputs. fp32 outputs agree within 1e-5 * max(1, |ref|) (sums in
another order); a bf16 output within one bf16 ulp of the fp32 reference
plus that fp32 tolerance (it rounds a value that is itself within the
fp32 tolerance: near 0 that difference exceeds an ulp). Model outputs are
held against the JAX forward and decode jitted, as the JAX engine runs
them, with the JAX parameters carried over by
`bridge.zoo_params_from_numpy`. The CUDA
kernels are held against the plain versions on the card by
`chip_smoke.py`."""
from __future__ import annotations


import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.archs import api as japi
from repro.configs import get_config as jget_config
from repro.kernels import flash_attn as jfa
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.nn import attention as jattn
from repro.nn import ssm as jssm
from repro.nn import xlstm as jxlstm
from repro.nn.module import ParamBuilder as JParamBuilder

from repro_torch import bridge
from repro_torch.archs import api
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.kernels import ops
from repro_torch.nn import attention, ssm, xlstm

TOL = 1e-5


def _f(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _t(a):
    return torch.as_tensor(np.array(a))


def _close(got, want, name, tol=TOL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    lim = tol * max(1.0, float(np.abs(want).max(initial=0.0)))
    err = float(np.abs(got - want).max(initial=0.0))
    assert err <= lim, f"{name}: max |port - jax| = {err:.3g} > {lim:.3g}"


def _bf16_ulp_close(got, want32, name):
    """|got - want32| <= one bf16 ulp of want32 + TOL * max(1, |want32|),
    elementwise."""
    got = np.asarray(got, np.float64)
    want32 = np.asarray(want32, np.float64)
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want32), 1e-30))) - 7)
    slack = TOL * max(1.0, float(np.abs(want32).max()))
    bad = np.abs(got - want32) > ulp + slack
    assert not bad.any(), (f"{name}: {int(bad.sum())} elements beyond one "
                           f"bf16 ulp of the fp32 reference")


def _jtree(tree):
    return jax.tree.map(np.asarray, tree)


# ---------------------------------------------------------------------------
# flash_attn
# ---------------------------------------------------------------------------

# (name, G, Gkv, S, T, D, q_block, kv_block, causal, window)
FA_CASES = [
    ("causal", 2, 2, 256, 256, 64, 64, 64, True, None),
    ("window", 2, 2, 256, 256, 64, 64, 64, True, 64),
    ("full", 1, 1, 512, 512, 128, 128, 64, False, None),
    ("gqa4", 16, 4, 128, 128, 32, 64, 64, True, None),
    ("gqa2_window", 4, 2, 128, 128, 32, 64, 32, True, 40),
    ("ragged_s", 2, 1, 100, 100, 64, 128, 128, True, None),
    ("t_ne_s", 2, 2, 64, 96, 16, 64, 32, False, None),
    ("s1", 3, 3, 1, 1, 8, 128, 128, True, None),
]


def _fa_inputs(case, dtype=np.float32):
    _, g, gkv, s, t, d = case[:6]
    rng = np.random.default_rng(g * s + d)
    return (_f(rng, g, s, d, scale=0.3).astype(dtype),
            _f(rng, gkv, t, d, scale=0.3).astype(dtype),
            _f(rng, gkv, t, d, scale=0.3).astype(dtype))


@pytest.mark.parametrize("case", FA_CASES, ids=[c[0] for c in FA_CASES])
def test_flash_attn_matches_jax(case):
    qb, kb, causal, window = case[6:]
    q, k, v = _fa_inputs(case)
    got = ops.flash_attn(_t(q), _t(k), _t(v), causal=causal, window=window)
    want = jfa.flash_attn_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=causal, window=window)
    _close(got, want, "vs flash_attn_ref")
    pallas = jops.flash_attn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=causal, window=window, q_block=qb,
                             kv_block=kb, interpret=True)
    _close(got, pallas, "vs the Pallas kernel (interpret)")


@pytest.mark.parametrize("case", [FA_CASES[0], FA_CASES[4], FA_CASES[5]],
                         ids=["causal", "gqa2_window", "ragged_s"])
def test_flash_attn_bf16_io(case):
    import ml_dtypes
    qb, kb, causal, window = case[6:]
    q, k, v = _fa_inputs(case, ml_dtypes.bfloat16)
    got = ops.flash_attn(*(_t(x.astype(np.float32)).to(torch.bfloat16)
                           for x in (q, k, v)), causal=causal, window=window)
    assert got.dtype == torch.bfloat16
    want32 = jfa.flash_attn_ref(*(jnp.asarray(x, jnp.float32)
                                  for x in (q, k, v)),
                                causal=causal, window=window)
    _bf16_ulp_close(got.float(), want32, "port bf16")
    pallas = jops.flash_attn(*(jnp.asarray(x) for x in (q, k, v)),
                             causal=causal, window=window, q_block=qb,
                             kv_block=kb, interpret=True)
    _bf16_ulp_close(np.asarray(pallas, np.float32), want32, "Pallas bf16")


# ---------------------------------------------------------------------------
# ssd_chunk
# ---------------------------------------------------------------------------

SSD_CASES = [(1, 64, 32, 32), (4, 128, 64, 64), (2, 256, 128, 128),
             (2, 64, 64, 65)]


def _ssd_inputs(g, l, n, p, seed=None):
    rng = np.random.default_rng(g * l if seed is None else seed)
    return [_f(rng, g, l, n, scale=0.1), _f(rng, g, l, n, scale=0.1),
            _f(rng, g, l, p, scale=0.1),
            np.cumsum(-np.abs(_f(rng, g, l, scale=0.05)), -1).astype(
                np.float32),
            _f(rng, g, n, p, scale=0.1)]


@pytest.mark.parametrize("g,l,n,p", SSD_CASES,
                         ids=[f"g{c[0]}_l{c[1]}_n{c[2]}_p{c[3]}"
                              for c in SSD_CASES])
def test_ssd_chunk_matches_jax(g, l, n, p):
    args = _ssd_inputs(g, l, n, p)
    y, h1 = ops.ssd_chunk(*(_t(a) for a in args))
    y_k, h_k = jops.ssd_chunk(*(jnp.asarray(a) for a in args),
                              interpret=True)
    y_r, h_r = jax.vmap(jref.ssd_chunk_ref)(*(jnp.asarray(a) for a in args))
    _close(y, y_k, "y vs Pallas")
    _close(h1, h_k, "h1 vs Pallas")
    _close(y, y_r, "y vs ref")
    _close(h1, h_r, "h1 vs ref")


# ---------------------------------------------------------------------------
# gradients of the two wrappers against jitted jax.vjp of the JAX refs
# ---------------------------------------------------------------------------


def _jax_vjp(fn, args, cts):
    def vjp(a, c):
        return jax.vjp(fn, *a)[1](c)
    return jax.jit(vjp)([jnp.asarray(a) for a in args], cts)


def _port_vjp(fn, args, cts):
    leaves = [_t(a).requires_grad_(True) for a in args]
    outs = fn(*leaves)
    outs = outs if isinstance(outs, tuple) else (outs,)
    torch.autograd.backward(list(outs), [_t(c) for c in cts])
    return [x.grad for x in leaves]


@pytest.mark.parametrize("causal,window", [(True, None), (True, 24),
                                           (False, None)])
def test_flash_attn_grads_match_jax(causal, window):
    case = ("grad", 4, 2, 48, 48, 16, 0, 0, causal, window)
    args = _fa_inputs(case)
    ct = _f(np.random.default_rng(5), 4, 48, 16)

    def jfn(q, k, v):
        return jfa.flash_attn_ref(q, k, v, causal=causal, window=window)
    want = _jax_vjp(jfn, args, jnp.asarray(ct))
    got = _port_vjp(lambda q, k, v: ops.flash_attn(
        q, k, v, causal=causal, window=window), args, [ct])
    for name, a, b in zip("qkv", got, want):
        _close(a, b, f"d{name}")


def test_ssd_chunk_grads_match_jax():
    args = _ssd_inputs(2, 32, 16, 17, seed=3)
    rng = np.random.default_rng(6)
    cts = [_f(rng, 2, 32, 17), _f(rng, 2, 16, 17)]
    want = _jax_vjp(jax.vmap(jref.ssd_chunk_ref), args,
                    tuple(jnp.asarray(c) for c in cts))
    got = _port_vjp(ops.ssd_chunk, args, cts)
    for name, a, b in zip(("q", "k", "v", "lcum", "h0"), got, want):
        _close(a, b, f"d{name}")


def test_registry_and_cpu_route():
    assert ops.REGISTRY["flash_attn"].replaces == \
        "src/repro/kernels/flash_attn.py:73"
    assert ops.REGISTRY["ssd_chunk"].replaces == \
        "src/repro/kernels/ssd_chunk.py:49"
    q, k, v = (_t(a) for a in _fa_inputs(FA_CASES[3]))
    ops.reset_launch_counts()
    auto = ops.flash_attn(q, k, v)
    torch.testing.assert_close(ops.flash_attn(q, k, v, mode="oracle"), auto,
                               rtol=0, atol=0)
    with pytest.raises(ValueError, match="CUDA"):
        ops.flash_attn(q, k, v, mode="compiled")
    with pytest.raises(ValueError, match="CUDA"):
        ops.ssd_chunk(*(_t(a) for a in _ssd_inputs(1, 8, 4, 5)),
                      mode="compiled")
    assert ops.launch_counts()["flash_attn"] == 0       # the plain version
    assert ops.launch_counts()["ssd_chunk"] == 0


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def _qkv(rng, b, s, h, kv, d):
    return (_f(rng, b, s, h, d, scale=0.3), _f(rng, b, s, kv, d, scale=0.3),
            _f(rng, b, s, kv, d, scale=0.3))


@pytest.mark.parametrize("window", [None, 128])
@pytest.mark.parametrize("qc,kc", [(128, 64), (64, 128)])
def test_blockwise_attention_matches_jax(window, qc, kc):
    q, k, v = _qkv(np.random.default_rng(0), 2, 512, 8, 4, 32)
    got = attention.blockwise_attention(
        _t(q), _t(k), _t(v), causal=True, window=window,
        softmax_scale_cap=None)
    want = jattn.blockwise_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        window=window, softmax_scale_cap=None, q_chunk=qc, kv_chunk=kc)
    _close(got, want, "blockwise_attention")


@pytest.mark.parametrize("chunk", [None, 64])
def test_attention_matches_jax(chunk):
    """attention() through the dense branch (chunk None) and the
    blockwise branch (chunk 64 at S = 256), with qk-norm and GQA."""
    b = JParamBuilder(jax.random.PRNGKey(0), jnp.float32)
    jattn.attention_init(b, "attn", 64, 4, 2, 16, qk_norm=True)
    jp = b.params["attn"]
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (2, 256, 64)),
                   np.float32)
    pos = np.broadcast_to(np.arange(256)[None], (2, 256))
    want = jax.jit(lambda p, a, ps: jattn.attention(
        p, a, ps, d_head=16, chunk=chunk))(jp, jnp.asarray(x),
                                          jnp.asarray(pos))
    pt = bridge.zoo_params_from_numpy(_jtree(jp), "cpu")
    got = attention.attention(pt, _t(x), _t(pos), d_head=16, chunk=chunk)
    _close(got, want, f"attention(chunk={chunk})")


# ---------------------------------------------------------------------------
# chunked linear recurrence, mLSTM, sLSTM
# ---------------------------------------------------------------------------


def test_chunked_linear_rnn_matches_jax():
    """S = 300 in chunks of 128: three chunks, the last one padded, from a
    non-zero initial state."""
    rng = np.random.default_rng(4)
    b, s, h, n, p = 2, 300, 2, 16, 17
    q, k = _f(rng, b, s, h, n, scale=0.3), _f(rng, b, s, h, n, scale=0.3)
    v = _f(rng, b, s, h, p, scale=0.3)
    log_a = -np.abs(_f(rng, b, s, h, scale=0.1))
    h0 = _f(rng, b, h, n, p, scale=0.3)
    y, st = ssm.chunked_linear_rnn(_t(q), _t(k), _t(v), _t(log_a), chunk=128,
                                   init_state=_t(h0))
    jy, jst = jax.jit(lambda *a: jssm.chunked_linear_rnn(
        *a[:4], chunk=128, init_state=a[4]))(q, k, v, log_a, h0)
    _close(y, jy, "y")
    _close(st, jst, "final state")


def test_mlstm_slstm_match_jax():
    b = JParamBuilder(jax.random.PRNGKey(2), jnp.float32)
    jxlstm.mlstm_init(b, "m", 64, 4)
    jxlstm.slstm_init(b, "s", 64, 4)
    pt = bridge.zoo_params_from_numpy(_jtree(b.params), "cpu")
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(3), (2, 70, 64)),
                   np.float32)
    jm, jmst = jax.jit(lambda p, a: jxlstm.mlstm(
        p, a, n_heads=4, chunk=32, return_state=True))(b.params["m"], x)
    m, mst = xlstm.mlstm(pt["m"], _t(x), n_heads=4, chunk=32,
                         return_state=True)
    _close(m, jm, "mlstm")
    _close(mst, jmst, "mlstm state")
    js, jsst = jax.jit(lambda p, a: jxlstm.slstm(
        p, a, n_heads=4, return_state=True))(b.params["s"], x)
    s, sst = xlstm.slstm(pt["s"], _t(x), n_heads=4, return_state=True)
    _close(s, js, "slstm")
    for name, a, c in zip("hcn", sst, jsst):
        _close(a, c, f"slstm {name}")


# ---------------------------------------------------------------------------
# the reduced models, forward and decode
# ---------------------------------------------------------------------------

# attn_chunk=32, so the attention takes the blockwise branch (flash_attn)
# at S = 64 (qwen3, qwen2-7b, command-r), at S = 128 (gemma3: its window of
# 64 then cuts the local layer's keys) and at the VLM's 8 patches + 56
# text tokens; xlstm at S = 300: two chunks of 256, the second padded.
# "qwen2-vl-2b-text": the VLM without patches (text-only M-RoPE).
ZOO = [("qwen3-0.6b", dict(attn_chunk=32), 64),
       ("xlstm-350m", {}, 300),
       ("gemma3-12b", dict(attn_chunk=32), 128),
       ("qwen2-7b", dict(attn_chunk=32), 64),
       ("command-r-plus-104b", dict(attn_chunk=32), 64),
       ("qwen2-vl-2b", dict(attn_chunk=32), 56),
       ("qwen2-vl-2b-text", dict(attn_chunk=32, num_patches=0), 64)]
DECODE_STEPS = 4


def _vlm_inputs(rng, b, n_patches, s, d):
    """Patch embeddings and the M-RoPE positions laid out as Qwen2-VL
    Sec. 3.1 lays them out: the patches on a 2 x (n / 2) grid at t = 0,
    then the text from one past the largest patch coordinate, advancing
    in all three."""
    cols = n_patches // 2
    i = np.arange(n_patches)
    patch = np.stack([np.zeros_like(i), i // cols, i % cols])
    text = np.broadcast_to(cols + np.arange(s), (3, s))
    pos = np.concatenate([patch, text], axis=1).astype(np.int32)
    return {"patch_embeds": _f(rng, b, n_patches, d),
            "mrope_positions": np.ascontiguousarray(
                np.broadcast_to(pos, (b,) + pos.shape))}


@pytest.mark.parametrize("scan", [False, True], ids=["units", "stacked"])
@pytest.mark.parametrize("arch,kw,s", ZOO, ids=[z[0] for z in ZOO])
def test_reduced_model_matches_jax(arch, kw, s, scan):
    arch = arch.removesuffix("-text")
    jcfg = jget_config(arch).reduced(scan_layers=scan, **kw)
    jmodel = japi.get_model(jcfg)
    jparams, _ = jmodel.init(jax.random.PRNGKey(0))
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (2, s), 0,
                                         jcfg.vocab), np.int32)
    batch = {"tokens": toks}
    if jcfg.num_patches:
        batch.update(_vlm_inputs(np.random.default_rng(2), 2,
                                 jcfg.num_patches, s, jcfg.d_model))
    want = jax.jit(jmodel.forward)(jparams, {k: jnp.asarray(v)
                                             for k, v in batch.items()})

    cfg = get_config(arch).reduced(scan_layers=scan, **kw)
    model = api.get_model(cfg)
    params = bridge.zoo_params_from_numpy(_jtree(jparams), "cpu")
    tbatch = {k: _t(v) for k, v in batch.items()}
    with torch.no_grad():
        got = model.forward(params, tbatch)
        last = model.prefill(params, tbatch)
    _close(got, want, f"{arch} forward")
    _close(last, np.asarray(want)[:, -1], f"{arch} prefill vs JAX's "
           f"forward[:, -1]")
    _close(last, got[:, -1].numpy(), f"{arch} prefill vs forward[:, -1]")

    # decode: DECODE_STEPS tokens against JAX's decode, and (without
    # patches, whose rows shift the text's positions) against the port's
    # own forward at every position
    jstate = jmodel.init_decode_state(2, 16)
    jstep = jax.jit(jmodel.decode_step)
    with torch.no_grad():
        state = model.init_decode_state(2, 16, "cpu")
        for i in range(DECODE_STEPS):
            tok = toks[:, i:i + 1]
            jl, jstate = jstep(jparams, jstate, jnp.asarray(tok),
                               jnp.asarray(i, jnp.int32))
            lg, state = model.decode_step(params, state, _t(tok), i)
            _close(lg, jl, f"{arch} decode step {i}")
            if not cfg.num_patches:
                err = float((lg[:, 0] - got[:, i]).abs().max())
                assert err < 1e-4, (arch, i, err)
    assert bridge.zoo_params_to_numpy(params)["embed"]["table"].shape == \
        np.asarray(jparams["embed"]["table"]).shape


def test_apply_mrope_matches_jax():
    """M-RoPE at the reduced qwen2-vl's sections (12, 10, 10) of a 64-wide
    head and at the published (16, 24, 24) of a 128-wide one, positions
    below 500 drawn per coordinate. The jitted JAX frequencies and the
    port's are each within one float32 ulp of 1 / theta^(i/d), on
    different sides for some i, and the angle pos * freq carries that:
    the two agree within TOL + 500 * 2^-23 of max|x|."""
    rng = np.random.default_rng(7)
    for d, sections in [(64, (12, 10, 10)), (128, (16, 24, 24))]:
        x = _f(rng, 2, 9, 3, d)
        pos = rng.integers(0, 500, (2, 3, 9)).astype(np.int32)
        want = jax.jit(lambda a, p: jattn.apply_mrope(
            a, p, sections, 1_000_000.0))(x, pos)
        got = attention.apply_mrope(_t(x), _t(pos), sections, 1_000_000.0)
        _close(got, want, f"apply_mrope d={d}", tol=TOL + 500 * 2.0 ** -23)
    with pytest.raises(ValueError, match="sections"):
        attention.apply_mrope(_t(x), _t(pos), (16, 24, 23))


def test_vlm_extra_inputs_match_jax():
    jm = japi.get_model(jget_config("qwen2-vl-2b"))
    m = api.get_model(get_config("qwen2-vl-2b"))
    want = {k: (tuple(v.shape), np.dtype(v.dtype).name)
            for k, v in jm.extra_inputs(2, 7936).items()}
    got = {k: (shape, str(dt).removeprefix("torch."))
           for k, (shape, dt) in m.extra_inputs(2, 7936).items()}
    assert got == want
    assert api.get_model(get_config("qwen2-7b")).extra_inputs(2, 64) == {}


@pytest.mark.parametrize("arch", ["gemma3-12b", "zamba2-1.2b"])
def test_stacked_init_equals_units(arch):
    """The stacked layout, built a unit at a time (`base.unit_params`),
    holds unit i's draws where the `u{i}` layout does, from one seed."""
    from repro_torch.nn.module import unstack
    trees = {}
    for scan in (False, True):
        cfg = get_config(arch).reduced(scan_layers=scan, n_layers=4)
        trees[scan] = api.get_model(cfg).init(
            torch.Generator().manual_seed(0), "cpu")
    for i in range(2):
        for a, b in zip(jax.tree.leaves(jax.tree.map(
                lambda t: t.numpy(), trees[False]["blocks"][f"u{i}"])),
                jax.tree.leaves(jax.tree.map(
                    lambda t: t.numpy(), unstack(trees[True]["blocks"], i)))):
            np.testing.assert_array_equal(a, b)


def test_port_init_shapes_match_jax():
    """The port's own init builds JAX's tree: same keys and shapes, both
    layouts."""
    for arch in ARCH_IDS:
        for scan in (False, True):
            jcfg = jget_config(arch).reduced(scan_layers=scan)
            jp = jax.eval_shape(lambda k: japi.get_model(jcfg).init(k)[0],
                                jax.random.PRNGKey(0))
            pt = api.get_model(get_config(arch).reduced(
                scan_layers=scan)).init(torch.Generator().manual_seed(0),
                                        "cpu")
            want = {"/".join(str(k.key) for k in path): tuple(x.shape)
                    for path, x in jax.tree_util.tree_leaves_with_path(jp)}
            got = {}

            def walk(t, path=()):
                for k, v in t.items():
                    if isinstance(v, dict):
                        walk(v, path + (k,))
                    else:
                        got["/".join(path + (k,))] = tuple(v.shape)
            walk(pt)
            assert got == want, arch


# ---------------------------------------------------------------------------
# the serve CLI
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_serve_zoo_cli_on_cpu(arch, capsys):
    from repro_torch.launch import serve as tserve
    toks = tserve.main(["--zoo", arch, "--steps", "3", "--device", "cpu"])
    assert tuple(toks.shape) == (2, 3)
    assert "tok/s on CPU" in capsys.readouterr().out


def test_decode_past_the_cache_raises():
    """A global layer writes slot pos, so pos >= cache_len raises (JAX's
    dynamic_update_slice clamps the slot to the last one instead) and
    leaves the cache as it was; a windowed layer's ring buffer wraps."""
    from repro_torch.nn.module import ParamBuilder
    gen = torch.Generator().manual_seed(0)
    b = ParamBuilder(gen)
    attention.attention_init(b, "attn", 32, 4, 2, 8)
    p = b.params["attn"]
    x = torch.randn(2, 1, 32, generator=gen)
    cache = attention.init_cache(2, 4, 2, 8, torch.float32)
    for pos in range(4):
        y, _ = attention.decode_attention(p, x, cache, pos, d_head=8)
        assert tuple(y.shape) == (2, 1, 32)
    before = {name: t.clone() for name, t in cache.items()}
    with pytest.raises(ValueError, match=r"position 4 .*cache_len 4"):
        attention.decode_attention(p, x, cache, 4, d_head=8)
    for name, t in cache.items():
        assert torch.equal(t, before[name]), name
    ring = attention.init_cache(2, 4, 2, 8, torch.float32)
    for pos in range(7):
        y, _ = attention.decode_attention(p, x, ring, pos, d_head=8,
                                          window=4)
    assert bool(torch.isfinite(y).all())


def test_serve_zoo_past_the_cache_raises(monkeypatch):
    """`steps` beyond serve_zoo's 128-slot cache raise before any model is
    built or any step runs."""
    from repro_torch.archs import api as tapi
    from repro_torch.launch import serve as tserve

    def no_model(cfg):
        raise AssertionError("serve_zoo built a model before checking steps")

    monkeypatch.setattr(tapi, "get_model", no_model)
    with pytest.raises(ValueError, match="cache_len 128"):
        tserve.serve_zoo("qwen3-0.6b", 129, device="cpu")


def test_zoo_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the default device is valid")
    model = api.get_model(get_config("qwen3-0.6b").reduced())
    with pytest.raises(RuntimeError, match="CUDA"):
        model.init()
    with pytest.raises(RuntimeError, match="CUDA"):
        model.init_decode_state(2, 16)
    from repro_torch.launch import serve as tserve
    with pytest.raises(RuntimeError, match="CUDA"):
        tserve.main(["--zoo", "xlstm-350m", "--steps", "1"])

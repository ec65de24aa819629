"""Zoo training in the port against the JAX package: `loss_fn`,
`cross_entropy`, remat, the train step (`launch/specs.py`) and the
blockwise attention branches it differentiates through.

- The ten reduced arches (`attn_chunk=32`, S = 64: the dense family's,
  the MoE family's and zamba2's attention take the blockwise branch, the
  `flash_attn` autograd Function; xlstm and zamba2 run `ssd_chunk`'s):
  the loss and every leaf's gradient against jitted
  `jax.value_and_grad(model.loss_fn, has_aux=True)`, in both of the
  port's parameter layouts. JAX's is computed once per arch, in the
  `u{i}` layout: JAX draws the units first and stacks them for
  `scan_layers`, so the stacked case takes `_stack_units` of its
  parameters and gradients (the compile is most of a case's time). A
  gradient leaf is held within GRAD_TOL of its own largest |g| (an
  absolute tolerance would be loose for tiny leaves and tight for large
  ones). The port's and JAX's CPU sums take an order that depends on
  their thread counts: across torch's 1, 3 and 8 threads and XLA's
  multi- and single-threaded Eigen on an 8-core x86 host, the worst
  leaf of any case was at 0.27 of its limit (whisper's cross-attention
  key bias, whose gradient vanishes in exact arithmetic), zamba2's at
  0.14, arctic's at 0.017, and a thread count gave the same numbers in
  every run.
- One train step against JAX's `make_train_spec` body (its gradients
  from the case above, then `opt.update` and `apply_updates` jitted):
  AdamW on qwen3, Adafactor on arctic in both layouts (the stacked leaf
  factored and clipped as one): the optimizer states within GRAD_TOL of
  each leaf's scale, the parameters after the step within STEP_TOL * lr
  of JAX's where the gradient is not near AdamW's eps.
- Remat on gives the loss and gradients of remat off, and runs every
  kernel's forward twice a step (the recompute); its backward runs the
  plain version and launches nothing.
- `cross_entropy` against JAX's one-hot form; the soft-capped blockwise
  branch (plain PyTorch: no kernel takes a cap) against JAX's lax version,
  forward and gradients, and a capped config's loss and gradients."""
from __future__ import annotations

import dataclasses
import functools
import re

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (threads under xdist)

import jax
import jax.numpy as jnp

from repro.archs import api as japi
from repro.archs import base as jbase
from repro.configs import get_config as jget_config
from repro.nn import attention as jattn
from repro.optim import optimizers as jopt

from repro_torch import bridge
from repro_torch.archs import api, base
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.kernels import ops
from repro_torch.launch import specs
from repro_torch.nn import attention
from repro_torch.utils.tree import tree_leaves

TOL = 1e-5
GRAD_TOL = 1e-4
GRAD_FLOOR = 1e-3
STEP_TOL = 1e-3
S = 64
B = 2


def _t(a):
    return torch.as_tensor(np.array(a))


def _close(got, want, name, tol=TOL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    lim = tol * max(1.0, float(np.abs(want).max(initial=0.0)))
    err = float(np.abs(got - want).max(initial=0.0))
    assert err <= lim, f"{name}: max |port - jax| = {err:.3g} > {lim:.3g}"


def _leaf_close(got, want, name, tol=GRAD_TOL, floor=1e-30):
    """|got - want| <= tol * max(max|want| of this leaf, floor)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    scale = max(float(np.abs(want).max(initial=0.0)), floor)
    err = float(np.abs(got - want).max(initial=0.0))
    assert err <= tol * scale, (f"{name}: max |port - jax| = {err:.3g} > "
                                f"{tol} x {scale:.3g}")


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_paths(v, f"{prefix}/{k}" if prefix else str(k)))
        return out
    return {prefix: tree}


def _jtree(tree):
    return jax.tree.map(np.asarray, tree)


def _batch(jcfg, seed=1):
    """tokens and targets and the arch's extra inputs, as numpy: B x S
    tokens, or for the VLM S - num_patches text tokens after its patches
    (so that its S positions take the blockwise branch), with M-RoPE
    positions on a 2 x (n / 2) grid, then the text; whisper's frame
    embeddings."""
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(seed), 3)
    s = S - jcfg.num_patches
    batch = {"tokens": np.asarray(jax.random.randint(k1, (B, s), 0,
                                                     jcfg.vocab), np.int32),
             "targets": np.asarray(jax.random.randint(k2, (B, s), 0,
                                                      jcfg.vocab), np.int32)}
    if jcfg.num_patches:
        n = jcfg.num_patches
        cols = n // 2
        i = np.arange(n)
        patch = np.stack([np.zeros_like(i), i // cols, i % cols])
        text = np.broadcast_to(cols + np.arange(s), (3, s))
        pos = np.concatenate([patch, text], axis=1).astype(np.int32)
        batch["patch_embeds"] = np.asarray(jax.random.normal(
            k3, (B, n, jcfg.d_model)), np.float32)
        batch["mrope_positions"] = np.ascontiguousarray(
            np.broadcast_to(pos, (B,) + pos.shape))
    elif jcfg.enc_layers:
        batch["audio_feats"] = np.asarray(jax.random.normal(
            k3, (B, jcfg.enc_frames, jcfg.d_model)), np.float32)
    return batch


def _stack_units(tree):
    """JAX's stacked layout of a `u{i}` tree: each container of units
    u0 .. u{n-1} becomes their leaves stacked along a new first axis, as
    JAX's `stack_params` builds it for `scan_layers`."""
    if not isinstance(tree, dict):
        return tree
    if tree and all(re.fullmatch(r"u\d+", k) for k in tree):
        units = [_stack_units(tree[f"u{i}"]) for i in range(len(tree))]
        return jax.tree.map(lambda *xs: np.stack(xs), *units)
    return {k: _stack_units(v) for k, v in tree.items()}


@functools.lru_cache(maxsize=None)
def _jax_case(arch, **kw):
    """JAX's reduced model (attn_chunk=32, the `u{i}` layout), its
    parameters and a batch as numpy, and jitted
    `value_and_grad(loss_fn, has_aux=True)` there: (jmodel, jparams,
    batch, loss, aux, grads). Computed once per arch and shared by the
    tests, which must not write to the arrays."""
    jmodel = japi.get_model(jget_config(arch).reduced(
        scan_layers=False, attn_chunk=32, **kw))
    jparams = _jtree(jmodel.init(jax.random.PRNGKey(0))[0])
    batch = _batch(jmodel.cfg)
    (loss, aux), grads = jax.jit(jax.value_and_grad(
        jmodel.loss_fn, has_aux=True))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    return jmodel, jparams, batch, float(loss), _jtree(aux), _jtree(grads)


def _port(arch, scan, jparams, **kw):
    """The port's reduced model in its layout, with JAX's parameters
    (stacked for `scan`) carried over."""
    model = api.get_model(get_config(arch).reduced(
        scan_layers=scan, attn_chunk=32, **kw))
    tree = _stack_units(jparams) if scan else jparams
    return model, bridge.zoo_params_from_numpy(tree, "cpu")


def _port_batch(batch):
    return {k: _t(v) for k, v in batch.items()}


@pytest.mark.parametrize("scan", [False, True], ids=["units", "stacked"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_loss_and_grads_match_jax(arch, scan):
    jmodel, jparams, batch, jloss, jaux, jgrads = _jax_case(arch)
    if scan:
        # the stacked tree is JAX's own stacked layout, leaf for leaf
        jcfg = dataclasses.replace(jmodel.cfg, scan_layers=True)
        shapes = jax.eval_shape(
            lambda k: japi.get_model(jcfg).init(k)[0], jax.random.PRNGKey(0))
        want = {n: tuple(x.shape) for n, x in _paths(shapes).items()}
        got = {n: x.shape for n, x in _paths(_stack_units(jparams)).items()}
        assert got == want
        jgrads = _stack_units(jgrads)
    model, params = _port(arch, scan, jparams)
    loss, aux, grads = specs.loss_and_grads(model, params,
                                            _port_batch(batch))
    _close(loss, jloss, f"{arch} loss")
    assert sorted(aux) == sorted(jaux)
    for k in aux:
        _close(aux[k], jaux[k], f"{arch} aux {k}")
    _grads_close(grads, jgrads, arch)


def _grads_close(grads, jgrads, label):
    """Each leaf within GRAD_TOL of its largest |g|, or of GRAD_FLOOR x
    the largest |g| of any leaf where that is larger: a leaf whose
    gradient vanishes in exact arithmetic (whisper's key biases: the
    softmax ignores a shift common to all keys) holds rounding noise
    only."""
    want = _paths(_jtree(jgrads))
    got = _paths(bridge.zoo_params_to_numpy(grads))
    assert sorted(got) == sorted(want)
    top = max(float(np.abs(w).max(initial=0.0)) for w in want.values())
    for name in want:
        _leaf_close(got[name], want[name], f"{label} d/d {name}",
                    floor=GRAD_FLOOR * top)


def _jax_step(opt, jparams, jgrads):
    """The rest of `make_train_spec`'s train_step body after
    value_and_grad, jitted: `opt.update`, then `apply_updates`."""
    def update(params, opt_state, grads):
        updates, opt_state = opt.update(grads, opt_state, params)
        return jopt.apply_updates(params, updates), opt_state

    return jax.jit(update)(jparams, opt.init(jparams), jgrads)


@pytest.mark.parametrize("arch,scan,opt_name", [
    ("qwen3-0.6b", False, "adamw"), ("arctic-480b", False, "adafactor"),
    ("arctic-480b", True, "adafactor")],
    ids=["qwen3-adamw", "arctic-adafactor-units",
         "arctic-adafactor-stacked"])
def test_train_step_matches_jax(arch, scan, opt_name):
    assert specs.ARCH_OPTIMIZER.get(arch, "adamw") == opt_name
    lr = 1e-3
    _, jparams, batch, jloss, _, jgrads = _jax_case(arch)
    model, params = _port(arch, scan, jparams)
    if scan:
        jparams, jgrads = _stack_units(jparams), _stack_units(jgrads)
    jp1, jstate = _jax_step(jopt.OPTIMIZERS[opt_name](lr), jparams, jgrads)
    jgrads = _paths(jgrads)
    opt = specs.make_optimizer(arch, lr)
    step = specs.make_train_step(model, opt)
    state = opt.init(params)
    params, state, loss = step(params, state, _port_batch(batch))
    _close(loss, jloss, f"{arch} loss")
    got = _paths(bridge.zoo_params_to_numpy(params))
    want = _paths(_jtree(jp1))
    before = _paths(_jtree(jparams))
    for name in want:
        # AdamW's first step is lr * g / (|g| + 1e-8): where |g| is near
        # eps it turns rounding-level gradient differences into changes
        # of order lr (the moments are compared below instead). Entries
        # with |g| >= 1e-3 of the leaf's largest are held to STEP_TOL * lr,
        # and AdamW's first step moves no entry by more than lr
        g = np.abs(jgrads[name])
        big = g >= 1e-3 * g.max(initial=0.0)
        diff = np.abs(got[name] - want[name])
        err = float(diff[big].max(initial=0.0))
        assert err <= STEP_TOL * lr, (name, err)
        if opt_name == "adamw":
            moved = float(np.abs(got[name] - before[name]).max())
            assert moved <= lr * (1 + 1e-4), (name, moved)
    got_st = _paths(bridge.zoo_params_to_numpy(state))
    want_st = _paths(_jtree(jstate))
    assert sorted(got_st) == sorted(want_st)
    for name in want_st:
        if name == "step":
            assert int(got_st[name]) == int(want_st[name]) == 1
        else:
            _leaf_close(got_st[name], want_st[name], f"state {name}")
    if opt_name == "adafactor" and scan:
        # the stacked leaf keeps one row / column statistic over its last
        # two dims, per layer
        wi = params["blocks"]["moe"]["wi"]
        m = state["m"]["blocks"]["moe"]["wi"]
        assert tuple(m["vr"].shape) == tuple(wi.shape[:-1])
        assert tuple(m["vc"].shape) == tuple(wi.shape[:-2] + wi.shape[-1:])


@pytest.fixture
def forward_calls(monkeypatch):
    """Counts the zoo kernels' forward calls through their registry
    entries (on the CPU the launch counters stay 0: the plain versions
    run). The backward's plain version is not a registry call."""
    calls = {}
    for name in ("flash_attn", "ssd_chunk"):
        spec = ops.REGISTRY[name]
        calls[name] = 0

        def ref(*a, _fn=spec.ref, _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)
        monkeypatch.setitem(ops.REGISTRY, name,
                            dataclasses.replace(spec, ref=ref))
    return calls


# arch -> the zoo kernels' forward calls of one loss + gradient without
# remat and with it (each unit's again in the recompute). The reduced
# archs have 2 layers at S = 64: qwen3's and arctic's 2 attention layers;
# zamba2's one unit of 2 Mamba2 blocks (one chunk each) and the shared
# block; xlstm's one mLSTM layer (one chunk) and one sLSTM layer
REMAT_CASES = [
    ("qwen3-0.6b", {"flash_attn": 2}, {"flash_attn": 4}),
    ("zamba2-1.2b", {"ssd_chunk": 2, "flash_attn": 1},
     {"ssd_chunk": 4, "flash_attn": 2}),
    ("arctic-480b", {"flash_attn": 2}, {"flash_attn": 4}),
    ("xlstm-350m", {"ssd_chunk": 1}, {"ssd_chunk": 2}),
]


@pytest.mark.parametrize("arch,plain,remat", REMAT_CASES,
                         ids=[c[0] for c in REMAT_CASES])
def test_remat_equals_no_remat(arch, plain, remat, forward_calls):
    """The same loss and gradients with remat on and off (the stacked
    layout: each unit a view of the stacked leaves), the kernels' forward
    called once a layer and chunk without remat and twice with it; no
    call under no_grad is recomputed."""
    results = {}
    for on, want_calls in ((False, plain), (True, remat)):
        cfg = get_config(arch).reduced(scan_layers=True, attn_chunk=32,
                                       remat=on)
        model = api.get_model(cfg)
        params = model.init(torch.Generator().manual_seed(0), "cpu")
        gen = torch.Generator().manual_seed(1)
        batch = {"tokens": torch.randint(0, cfg.vocab, (B, S), generator=gen),
                 "targets": torch.randint(0, cfg.vocab, (B, S),
                                          generator=gen)}
        for k in forward_calls:
            forward_calls[k] = 0
        results[on] = specs.loss_and_grads(model, params, batch)
        got = {k: v for k, v in forward_calls.items() if v}
        assert got == want_calls, (arch, on, got)
        for k in forward_calls:
            forward_calls[k] = 0
        with torch.no_grad():
            model.prefill(params, batch)
        got = {k: v for k, v in forward_calls.items() if v}
        assert got == plain, (arch, on, "no_grad", got)
    (l0, _, g0), (l1, _, g1) = results[False], results[True]
    assert torch.equal(l0, l1)
    for a, b in zip(tree_leaves(g0), tree_leaves(g1)):
        _leaf_close(b.numpy(), a.numpy(), f"{arch} remat grad", tol=1e-6)


def test_cross_entropy_matches_jax():
    rng = np.random.default_rng(0)
    logits = (rng.normal(size=(2, 5, 37)) * 4).astype(np.float32)
    tgt = rng.integers(0, 37, (2, 5)).astype(np.int32)
    mask = (rng.random((2, 5)) > 0.3).astype(np.float32)
    for m in (None, mask):
        want = jax.jit(jbase.cross_entropy)(logits, tgt, m)
        got = base.cross_entropy(_t(logits), _t(tgt),
                                 None if m is None else _t(m))
        _close(got, want, "cross_entropy")
    # the gathered gold logit is the one-hot contraction's, bit for bit
    gold = torch.gather(_t(logits), -1, _t(tgt).long()[..., None])[..., 0]
    onehot = torch.nn.functional.one_hot(_t(tgt).long(), 37).float()
    assert torch.equal(gold, torch.sum(_t(logits) * onehot, -1))


@pytest.mark.parametrize("window", [None, 24])
def test_capped_blockwise_matches_jax(window):
    """The soft-capped blockwise branch (q chunks of 32, kv chunks of 16
    over S = T = 64, GQA 4:2) against JAX's lax version, the output and
    the gradients of q, k and v."""
    rng = np.random.default_rng(3)
    q = (rng.normal(size=(2, 64, 4, 16)) * 2).astype(np.float32)
    k = (rng.normal(size=(2, 64, 2, 16)) * 2).astype(np.float32)
    v = rng.normal(size=(2, 64, 2, 16)).astype(np.float32)
    ct = rng.normal(size=q.shape).astype(np.float32)
    kw = dict(causal=True, window=window, softmax_scale_cap=5.0,
              q_chunk=32, kv_chunk=16)
    fn = jax.jit(lambda a, b_, c: jattn.blockwise_attention(a, b_, c, **kw))
    want, vjp = jax.vjp(fn, q, k, v)
    jg = vjp(jnp.asarray(ct))
    args = [_t(x).requires_grad_(True) for x in (q, k, v)]
    got = attention.blockwise_attention(*args, **kw)
    _close(got.detach(), want, "capped blockwise")
    grads = torch.autograd.grad(got, args, _t(ct))
    for name, g, w in zip("qkv", grads, jg):
        _close(g, w, f"capped blockwise d{name}")


def test_capped_config_matches_jax(forward_calls):
    """qwen3 with attn_softcap 20 at attn_chunk=32, S = 64: the capped
    blockwise branch calls no kernel; loss and gradients against JAX's."""
    _, jparams, batch, jloss, _, jgrads = _jax_case("qwen3-0.6b",
                                                    attn_softcap=20.0)
    model, params = _port("qwen3-0.6b", False, jparams, attn_softcap=20.0)
    loss, _, grads = specs.loss_and_grads(model, params,
                                          _port_batch(batch))
    assert not any(forward_calls.values()), forward_calls
    _close(loss, jloss, "capped loss")
    _grads_close(grads, jgrads, "capped")

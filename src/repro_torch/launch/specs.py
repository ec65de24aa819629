"""The model zoo's train step, and its train / prefill / decode specs on a
DeviceMesh (counterpart of `repro/launch/specs.py`).

`ARCH_OPTIMIZER` picks each arch's optimizer as JAX does (Adafactor for
the >100B configs, whose Adam moments would not fit, AdamW otherwise),
and `make_train_step` is `make_train_spec`'s `train_step` body: value and
gradient of `model.loss_fn` (with its aux), `opt.update`, then
`apply_updates`, the parameters and the optimizer state updated in place.

The specs (`make_train_spec`, `make_prefill_spec`, `make_decode_spec`,
`make_spec`) give a `LoweredSpec` for one (arch, input shape, mesh):
meta-device arguments (nothing allocated: the parameters come from
`Model.build_params` on meta) and their DTensor placements, resolved from
the logical axes through the rule set `rules_for` picks.
`train/distributed.py::apply_spec` runs one on real tensors, and
`launch/dryrun.py` on meta ones. The FSDP archs that JAX gives an explicit
weight gather (`WEIGHT_GATHER_ARCHS`) get it here too: the train step
installs `_fsdp_weights_hook` for its body, and every `annotate.weights`
site (each stacked unit's leaves, the layers' weights) redistributes its
weight to its placements without the FSDP axis, an all-gather of the
weight where DTensor would otherwise reduce activations. Ops that DTensor
cannot shard run through `annotate.local` (ROADMAP Queue 3, P30)."""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.archs.api import get_model
from repro_torch.archs.base import Model, ModelConfig
from repro_torch.configs import InputShape
from repro_torch.nn import module as module_lib
from repro_torch.nn.module import axes_placements
from repro_torch.optim import optimizers as opt_lib
from repro_torch.train import annotate
from repro_torch.utils.tree import tree_leaves, tree_unflatten

ARCH_OPTIMIZER = {
    "arctic-480b": "adafactor",
    "kimi-k2-1t-a32b": "adafactor",
    "command-r-plus-104b": "adafactor",
}

# >=10B-parameter archs shard the 'embed' dim of their weights over the
# data axis (FSDP) besides tensor parallelism
FSDP_ARCHS = {"arctic-480b", "kimi-k2-1t-a32b", "command-r-plus-104b",
              "gemma3-12b"}

# the dense FSDP archs get the explicit weight gather (JAX's measured
# choice: its MoE archs' expert products bypass the layers' hook sites,
# and the partial gather cost them more than it saved)
WEIGHT_GATHER_ARCHS = {"gemma3-12b", "command-r-plus-104b"}


def rules_for(arch_id: str, shape: InputShape):
    """The rule set of (arch, shape): batch-1 decode (long_500k) shards
    the cache's sequence over every mesh axis; the FSDP archs take
    "fsdp"; the rest "default"."""
    if shape.kind == "decode" and shape.global_batch == 1:
        rules = dict(module_lib.RULE_SETS["long_ctx"])
        rules["batch"] = None
        rules["cache_seq"] = ("data", "model")
        return rules
    if arch_id in FSDP_ARCHS:
        return dict(module_lib.RULE_SETS["fsdp"])
    return dict(module_lib.RULE_SETS["default"])


@dataclasses.dataclass
class LoweredSpec:
    """A step and how its arguments and results lie on a DeviceMesh:
    `args` are meta-device stand-ins (shapes and dtypes, no data),
    `in_shardings` / `out_shardings` trees of DTensor placements (a tuple,
    one per mesh dim) in the arguments' and results' layout; a placements
    tuple where a subtree stands applies to all of its leaves.
    `donate_argnums` names the arguments whose storage the step updates in
    place (JAX donates them; the port's steps write them in place)."""
    fn: Any
    args: tuple
    in_shardings: tuple
    out_shardings: Any
    donate_argnums: tuple = ()


def make_optimizer(arch_id: str, lr=1e-4):
    """The arch's optimizer from ARCH_OPTIMIZER at `lr`."""
    return opt_lib.OPTIMIZERS[ARCH_OPTIMIZER.get(arch_id, "adamw")](lr)


def loss_and_grads(model: Model, params, batch):
    """(loss, aux, grads): the loss and its gradient with respect to
    every parameter leaf (zeros where it does not reach, as jax.grad
    gives), in `params`' tree. The parameter leaves are marked as
    requiring grad."""
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss, aux = model.loss_fn(params, batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return loss.detach(), {k: v.detach() for k, v in aux.items()}, \
        tree_unflatten(params, grads)


def make_train_step(model: Model, opt: opt_lib.Optimizer):
    """train_step(params, opt_state, batch) -> (params, opt_state, loss):
    batch holds "tokens" and "targets" (B, S) and the arch's
    `extra_inputs`. The parameters are updated in place (the JAX step
    donates them) and the returned loss is a detached device scalar, so
    a step needs no host sync."""
    def train_step(params, opt_state, batch):
        loss, _, grads = loss_and_grads(model, params, batch)
        updates, opt_state = opt.update(grads, opt_state, params)
        opt_lib.apply_updates(params, updates)
        return params, opt_state, loss

    return train_step


# ---------------------------------------------------------------------------
# The sharded specs
# ---------------------------------------------------------------------------


def abstract_init(model: Model):
    """(meta parameters, axes) without allocating."""
    return model.build_params(None, "meta")


def shardings_from_axes(axes_tree, rules, mesh):
    """DTensor placements (one per mesh dim) for every leaf of an axes
    tree."""
    return module_lib.tree_shardings(axes_tree, rules, mesh)


def batch_spec(mesh, rules):
    """The placements of a (batch, seq) input."""
    return axes_placements(("batch", "seq"), rules, mesh)


def _replicated(mesh):
    return axes_placements((), {}, mesh)


def _axis_size(mesh, mesh_axes) -> int:
    """The devices a rule entry spans on `mesh` (axes it lacks count 1)."""
    if mesh_axes is None:
        return 1
    if isinstance(mesh_axes, str):
        mesh_axes = (mesh_axes,)
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    n = 1
    for a in mesh_axes:
        n *= sizes.get(a, 1)
    return n


def vocab_rules(cfg: ModelConfig, rules, mesh):
    """Logits leave the model cut to the TRUE vocab (the padding sliced
    off), so their 'vocab' dim shards only where cfg.vocab divides over
    its mesh axes (whisper's 51,865 does not)."""
    if cfg.vocab % _axis_size(mesh, rules.get("vocab")) != 0:
        return dict(rules, vocab=None)
    return rules


def _replicating(fn):
    """fn with every plain tensor that meets a DTensor in its ops taken as
    replicated on the DTensor's mesh (positions, masks, RoPE tables made
    inside the step), as GSPMD replicates an unannotated constant."""
    def g(*args, **kw):
        from torch.distributed.tensor.experimental import implicit_replication
        with implicit_replication():
            return fn(*args, **kw)
    return g


def _one_sequence(rules, shape: InputShape):
    """`rules` with "batch" unsharded for a batch of one sequence (DTensor
    cannot flatten a size-1 dim it shards, and one sequence does not
    split), as `rules_for` sets it for batch-1 decode."""
    return dict(rules, batch=None) if shape.global_batch == 1 else rules


def _meta_inputs(model: Model, b: int, s: int, rules, mesh, targets: bool):
    """The meta batch of a (b, s) input and its placements: "tokens" (and
    "targets") int32 on ("batch", "seq"), the arch's extra inputs on
    "batch"."""
    meta = dict(dtype=torch.int32, device="meta")
    names = ("tokens", "targets") if targets else ("tokens",)
    batch = {k: torch.empty((b, s), **meta) for k in names}
    shardings = {k: batch_spec(mesh, rules) for k in names}
    if model.extra_inputs:
        for k, (shp, dt) in model.extra_inputs(b, s).items():
            batch[k] = torch.empty(shp, dtype=dt, device="meta")
            shardings[k] = axes_placements(
                ("batch",) + (None,) * (len(shp) - 1), rules, mesh)
    return batch, shardings


def make_train_spec(cfg: ModelConfig, shape: InputShape, mesh,
                    rules=None, optimizer: str | None = None) -> LoweredSpec:
    """One train step of `cfg` at `shape`: (params, opt_state, batch) ->
    (params, opt_state, loss); the parameters and the optimizer state are
    donated (updated in place)."""
    model = get_model(cfg)
    rules = _one_sequence(rules or rules_for(cfg.arch_id, shape), shape)
    opt = opt_lib.OPTIMIZERS[optimizer or ARCH_OPTIMIZER.get(cfg.arch_id,
                                                             "adamw")](1e-4)
    param_shapes, axes = abstract_init(model)
    opt_shapes = opt.init(param_shapes)
    p_shard = shardings_from_axes(axes, rules, mesh)
    o_shard = shardings_from_axes(opt.state_axes(axes), rules, mesh)
    batch, b_shard = _meta_inputs(model, shape.global_batch, shape.seq_len,
                                  rules, mesh, targets=True)
    train_step = _replicating(make_train_step(model, opt))
    weights_fn = (_fsdp_weights_hook(param_shapes, axes, rules, mesh)
                  if cfg.arch_id in WEIGHT_GATHER_ARCHS else None)
    if weights_fn is not None:
        inner = train_step

        def train_step(params, opt_state, batch):  # noqa: F811
            # every annotate.weights site gathers its weight's FSDP shards
            with annotate.install(weights_fn=weights_fn):
                return inner(params, opt_state, batch)

    return LoweredSpec(
        fn=train_step,
        args=(param_shapes, opt_shapes, batch),
        in_shardings=(p_shard, o_shard, b_shard),
        out_shardings=(p_shard, o_shard, _replicated(mesh)),
        donate_argnums=(0, 1),
    )


def _sorted_leaves(tree, axes):
    """(leaf, axes) pairs of a parameter tree in JAX's leaf order (dict
    keys sorted)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _sorted_leaves(tree[k], axes[k])
    else:
        yield tree, axes


def fsdp_gather_placements(param_shapes, axes, rules, mesh) -> dict:
    """The FSDP weight gather's targets: per-unit leaf shape (a stacked
    "blocks" leaf without its unit dim) -> the leaf's placements WITHOUT
    the FSDP axis (the first leaf of a shape in JAX's leaf order decides,
    as JAX keys its hook); empty where the rules map 'embed' to no mesh
    axis."""
    fsdp_axis = rules.get("embed")
    if fsdp_axis is None:
        return {}
    no_fsdp = {k: (None if v == fsdp_axis else v) for k, v in rules.items()}
    out = {}
    for key in sorted(param_shapes):
        strip = 1 if key == "blocks" else 0   # a unit's slice drops the dim
        for leaf, ax in _sorted_leaves(param_shapes[key], axes[key]):
            if leaf.dim():
                out.setdefault(tuple(leaf.shape[strip:]), axes_placements(
                    tuple(ax[strip:]), no_fsdp, mesh))
    return out


def _fsdp_weights_hook(param_shapes, axes, rules, mesh):
    """The weight-gather hook of an FSDP rule set, or None: a DTensor leaf
    redistributed to `fsdp_gather_placements`' entry for its shape (plain
    tensors and other shapes pass unchanged). DTensor then all-gathers
    the weights where it would otherwise reduce the activations whose
    contraction dim FSDP split."""
    targets = fsdp_gather_placements(param_shapes, axes, rules, mesh)
    if not targets:
        return None

    def weights_fn(x):
        pl = targets.get(tuple(x.shape))
        if pl is None or not annotate.is_dtensor(x):
            return x
        return x.redistribute(mesh, pl)

    return weights_fn


def make_prefill_spec(cfg: ModelConfig, shape: InputShape, mesh,
                      rules=None) -> LoweredSpec:
    """Inference prefill: (params, batch) -> the last position's logits
    (B, V) (`Model.prefill`; sampling happens downstream)."""
    model = get_model(cfg)
    rules = _one_sequence(rules or rules_for(cfg.arch_id, shape), shape)
    param_shapes, axes = abstract_init(model)
    batch, b_shard = _meta_inputs(model, shape.global_batch, shape.seq_len,
                                  rules, mesh, targets=False)
    return LoweredSpec(
        fn=_replicating(model.prefill),
        args=(param_shapes, batch),
        in_shardings=(shardings_from_axes(axes, rules, mesh), b_shard),
        out_shardings=axes_placements(("batch", "vocab"),
                                      vocab_rules(cfg, rules, mesh), mesh),
    )


def make_decode_spec(cfg: ModelConfig, shape: InputShape, mesh,
                     rules=None) -> LoweredSpec:
    """serve_step: (params, state, tokens (B, 1), pos) -> (logits (B, 1,
    V), state), ONE new token against a cache or state of seq_len; the
    state is donated (the caches are written in place at `pos`, a 0-d
    integer tensor or an int)."""
    model = get_model(cfg)
    rules = _one_sequence(rules or rules_for(cfg.arch_id, shape), shape)
    param_shapes, axes = abstract_init(model)
    b, s = shape.global_batch, shape.seq_len
    state_shapes = model.init_decode_state(b, s, device="meta")
    st_shard = shardings_from_axes(model.state_axes(), rules, mesh)
    tokens = torch.empty((b, 1), dtype=torch.int32, device="meta")
    pos = torch.empty((), dtype=torch.int32, device="meta")

    def serve_step(params, state, tokens, pos):
        if annotate.is_dtensor(pos):
            pos = pos.full_tensor()
        return model.decode_step(params, state, tokens, int(pos))

    return LoweredSpec(
        fn=_replicating(serve_step),
        args=(param_shapes, state_shapes, tokens, pos),
        in_shardings=(shardings_from_axes(axes, rules, mesh), st_shard,
                      axes_placements(("batch", None), rules, mesh),
                      _replicated(mesh)),
        out_shardings=(axes_placements(("batch", None, "vocab"),
                                       vocab_rules(cfg, rules, mesh), mesh),
                       st_shard),
        donate_argnums=(1,),
    )


def make_spec(cfg: ModelConfig, shape: InputShape, mesh, rules=None,
              optimizer: str | None = None) -> LoweredSpec:
    if shape.kind == "train":
        return make_train_spec(cfg, shape, mesh, rules, optimizer)
    if shape.kind == "prefill":
        return make_prefill_spec(cfg, shape, mesh, rules)
    return make_decode_spec(cfg, shape, mesh, rules)

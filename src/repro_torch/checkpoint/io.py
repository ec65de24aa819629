"""Tree checkpoints in the JAX package's file format (counterpart of
`repro/checkpoint/io.py`), so a file written by either package loads in
the other:

    8 bytes   little-endian length of the manifest
    manifest  a msgpack map {"treedef": str, "n_leaves": int}
    payload   an np.savez archive of leaf_0 .. leaf_{n-1}

Leaves are in jax.tree's flatten order, and "treedef" is the string
`str(jax.tree.structure(tree))` gives, for the trees these bundles hold:
nested dicts (keys sorted), leaves (`*`) and dataclass nodes, which JAX
registers with `register_dataclass` and renders as
`CustomNode(<Name>[()], [children in field order])` (the MDGNN state's
`MemoryState` and `PresState`). `bridge.mdgnn_bundle` builds the MDGNN
{"params", "state"} bundle in that layout.

The manifest is written and read here, byte for byte as msgpack packs it
(a fixmap of str keys, str values as fixstr / str8 / str16 / str32 and
non-negative ints in their shortest form), so the port needs no msgpack.
Restoring checks the leaf count, the treedef string and every leaf's
shape against a template before any tensor reaches the device."""
from __future__ import annotations

import dataclasses
import io
import pathlib
import struct

import numpy as np
import torch

from repro_torch.device import resolve_device


# ---------------------------------------------------------------------------
# trees
# ---------------------------------------------------------------------------


def _flatten(tree):
    """(leaves, treedef string) in jax.tree's order and rendering."""
    leaves = []

    def walk(node) -> str:
        if isinstance(node, dict):
            return "{" + ", ".join(f"{k!r}: {walk(node[k])}"
                                   for k in sorted(node)) + "}"
        if dataclasses.is_dataclass(node) and not isinstance(node, type):
            kids = [walk(getattr(node, f.name))
                    for f in dataclasses.fields(node)]
            return (f"CustomNode({type(node).__name__}[()], "
                    f"[{', '.join(kids)}])")
        leaves.append(node)
        return "*"

    return leaves, f"PyTreeDef({walk(tree)})"


def _unflatten(like, leaves):
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            out = {k: build(node[k]) for k in sorted(node)}
            return {k: out[k] for k in node}
        if dataclasses.is_dataclass(node) and not isinstance(node, type):
            return dataclasses.replace(node, **{
                f.name: build(getattr(node, f.name))
                for f in dataclasses.fields(node)})
        return next(it)

    return build(like)


def treedef_str(tree) -> str:
    """The string `str(jax.tree.structure(tree))` gives for `tree`."""
    return _flatten(tree)[1]


def _as_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _np_dtype(x):
    if isinstance(x, torch.Tensor):
        return torch.empty((), dtype=x.dtype).numpy().dtype
    return np.asarray(x).dtype


# ---------------------------------------------------------------------------
# the manifest (msgpack's encoding of a map of str keys to str or int)
# ---------------------------------------------------------------------------


def _pack_str(s: str) -> bytes:
    b = s.encode("utf-8")
    n = len(b)
    if n < 32:
        return bytes([0xA0 | n]) + b
    if n < 1 << 8:
        return b"\xd9" + struct.pack(">B", n) + b
    if n < 1 << 16:
        return b"\xda" + struct.pack(">H", n) + b
    return b"\xdb" + struct.pack(">I", n) + b


def _pack_uint(v: int) -> bytes:
    if v < 0:
        raise ValueError(f"the manifest holds non-negative ints, got {v}")
    if v < 0x80:
        return bytes([v])
    for code, fmt, top in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                           (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
        if v < top:
            return bytes([code]) + struct.pack(fmt, v)
    raise ValueError(f"int {v} does not fit msgpack's uint64")


def pack_manifest(manifest: dict) -> bytes:
    """msgpack.packb of a map of at most 15 str keys to str or int
    values, in the map's order."""
    if len(manifest) > 15:
        raise ValueError("the manifest is a fixmap of at most 15 keys")
    out = [bytes([0x80 | len(manifest)])]
    for k, v in manifest.items():
        out.append(_pack_str(k))
        out.append(_pack_str(v) if isinstance(v, str) else _pack_uint(v))
    return b"".join(out)


def unpack_manifest(buf: bytes) -> dict:
    """msgpack.unpackb of what `pack_manifest` writes (any str form,
    any int form); anything else raises ValueError."""
    pos = 0

    def take(n):
        nonlocal pos
        if pos + n > len(buf):
            raise ValueError("checkpoint manifest is truncated")
        chunk = buf[pos:pos + n]
        pos += n
        return chunk

    def value():
        c = take(1)[0]
        if c < 0x80:
            return c
        if 0xA0 <= c <= 0xBF:
            return take(c & 0x1F).decode("utf-8")
        if c in (0xD9, 0xDA, 0xDB):
            fmt = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}[c]
            n = struct.unpack(fmt, take(struct.calcsize(fmt)))[0]
            return take(n).decode("utf-8")
        ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if c in ints:
            return struct.unpack(ints[c], take(struct.calcsize(ints[c])))[0]
        if c >= 0xE0:
            return c - 0x100
        raise ValueError(f"checkpoint manifest holds msgpack type 0x{c:02x},"
                         f" not a str or an int")

    head = take(1)[0]
    if not 0x80 <= head <= 0x8F:
        raise ValueError("checkpoint manifest is not a msgpack fixmap")
    out = {}
    for _ in range(head & 0x0F):
        k = value()
        if not isinstance(k, str):
            raise ValueError("checkpoint manifest keys must be str")
        out[k] = value()
    if pos != len(buf):
        raise ValueError("checkpoint manifest has trailing bytes")
    return out


# ---------------------------------------------------------------------------
# save / load
# ---------------------------------------------------------------------------


def save_checkpoint(path: str, tree) -> None:
    """Write `tree` (nested dicts and dataclass nodes whose leaves are
    tensors or numpy arrays) to `path`, parent directories made."""
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    leaves, treedef = _flatten(tree)
    buf = io.BytesIO()
    np.savez(buf, **{f"leaf_{i}": _as_numpy(x)
                     for i, x in enumerate(leaves)})
    manifest = pack_manifest({"treedef": treedef, "n_leaves": len(leaves)})
    with open(path, "wb") as f:
        f.write(len(manifest).to_bytes(8, "little"))
        f.write(manifest)
        f.write(buf.getvalue())


def read_checkpoint(path: str, like_tree):
    """The tree of `like_tree`'s structure with numpy leaves, each cast to
    the template leaf's dtype. The leaf count, the tree structure and every
    leaf's shape are checked against the template first, and a mismatch
    (a checkpoint written under another model config) raises ValueError
    with the JAX module's messages."""
    with open(path, "rb") as f:
        mlen = int.from_bytes(f.read(8), "little")
        manifest = unpack_manifest(f.read(mlen))
        data = np.load(io.BytesIO(f.read()))
    leaves, treedef = _flatten(like_tree)
    if manifest["n_leaves"] != len(leaves):
        raise ValueError(
            f"checkpoint {path} holds {manifest['n_leaves']} leaves but the "
            f"restore template has {len(leaves)} — was it written under a "
            f"different model config/variant?")
    saved_td = manifest.get("treedef")
    if saved_td is not None and saved_td != treedef:
        raise ValueError(
            f"checkpoint {path} tree structure does not match the restore "
            f"template (same leaf count, different nesting) — was it "
            f"written under a different model config/variant?")
    out = []
    for i, ref in enumerate(leaves):
        arr = data[f"leaf_{i}"]
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(
                f"checkpoint {path} leaf {i} has shape {tuple(arr.shape)} "
                f"but the restore template expects {tuple(ref.shape)} — "
                f"config mismatch (e.g. d_mem / n_nodes / n_layers)")
        out.append(arr.astype(_np_dtype(ref)))
    return _unflatten(like_tree, out)


def load_checkpoint(path: str, like_tree, device=None):
    """`read_checkpoint`, then every leaf as a tensor on `device` (cuda
    unless "cpu" is given): nothing reaches the device before the checks
    pass."""
    dev = resolve_device(device)
    tree = read_checkpoint(path, like_tree)
    leaves, _ = _flatten(tree)
    return _unflatten(tree, [torch.from_numpy(a).to(dev) for a in leaves])

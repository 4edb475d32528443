"""Pytree <-> slab bridge: the canonical flat representation of a model.

PyTorch counterpart of ``repro.core.slab``. A *slab* is one contiguous
1-D f32 buffer holding every parameter: leaves flattened in leaf order,
concatenated, zero-padded to a multiple of ``LANE``. The two kernels of
the round (``repro_torch.kernels.ota_channel`` and
``repro_torch.kernels.adaptive_update``) work on slabs.

Leaf order is ``jax.tree.flatten``'s on nested dicts, lists and tuples:
dict keys sorted, recursing into nested containers. So the same
parameters give bitwise-equal slabs in both packages, and slabs,
optimizer state and checkpoints carry over between them.

``LANE == 128`` is kept from the JAX package. It fixes the slab padding
and the quantizer's per-128-block scales, which are facts of the wire
format, not of any chip's tiling. ``shards=P`` rounds the padded length
up to a multiple of ``LANE * P`` (the shard-aligned padding rule).

Zero padding is load-bearing: it keeps L2 norms exact and is a fixed
point of every update mode.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, List, Tuple

import numpy as np
import torch

PyTree = Any

LANE = 128

# A treedef is a nested tuple: ("leaf",), ("dict", keys, children),
# ("list", children), ("tuple", children) or ("namedtuple", cls,
# children).
TreeDef = tuple


def _is_namedtuple(tree) -> bool:
    return isinstance(tree, tuple) and hasattr(type(tree), "_fields")


def tree_flatten(tree: PyTree) -> Tuple[List[Any], TreeDef]:
    """Leaves in ``jax.tree.flatten`` order, plus the structure. A
    NamedTuple is a node of its own type, as in ``jax.tree``."""
    if isinstance(tree, dict):
        keys = tuple(sorted(tree))
        leaves, defs = [], []
        for k in keys:
            sub, d = tree_flatten(tree[k])
            leaves += sub
            defs.append(d)
        return leaves, ("dict", keys, tuple(defs))
    if isinstance(tree, (list, tuple)):
        leaves, defs = [], []
        for item in tree:
            sub, d = tree_flatten(item)
            leaves += sub
            defs.append(d)
        if _is_namedtuple(tree):
            return leaves, ("namedtuple", type(tree), tuple(defs))
        kind = "list" if isinstance(tree, list) else "tuple"
        return leaves, (kind, tuple(defs))
    return [tree], ("leaf",)


def tree_unflatten(treedef: TreeDef, leaves: List[Any]) -> PyTree:
    """Inverse of ``tree_flatten``."""
    it = iter(leaves)

    def build(d):
        if d[0] == "leaf":
            return next(it)
        if d[0] == "dict":
            return {k: build(c) for k, c in zip(d[1], d[2])}
        if d[0] == "namedtuple":
            return d[1](*[build(c) for c in d[2]])
        items = [build(c) for c in d[1]]
        return items if d[0] == "list" else tuple(items)

    out = build(treedef)
    if next(it, None) is not None:
        raise ValueError("more leaves than the treedef holds")
    return out


def treedef_str(treedef: TreeDef) -> str:
    """The structure as ``str(jax.tree.structure(tree))`` prints it, e.g.
    ``PyTreeDef({'b': *, 'w': *})``: the slab layout's fingerprint
    (``slab_state.spec_meta``) must read the same in both packages."""

    def render(d):
        if d[0] == "leaf":
            return "*"
        if d[0] == "dict":
            return "{" + ", ".join(f"{k!r}: {render(c)}"
                                   for k, c in zip(d[1], d[2])) + "}"
        if d[0] == "namedtuple":
            return (f"CustomNode(namedtuple[{d[1].__name__}], ["
                    + ", ".join(render(c) for c in d[2]) + "])")
        items = [render(c) for c in d[1]]
        if d[0] == "list":
            return "[" + ", ".join(items) + "]"
        return "(" + ", ".join(items) + (",)" if len(items) == 1 else ")")

    return f"PyTreeDef({render(treedef)})"


def tree_map(fn, tree: PyTree, *rest: PyTree) -> PyTree:
    leaves, treedef = tree_flatten(tree)
    others = [tree_flatten(r)[0] for r in rest]
    return tree_unflatten(treedef, [fn(*xs) for xs in zip(leaves, *others)])


def _torch_dtype(dt) -> torch.dtype:
    if isinstance(dt, torch.dtype):
        return dt
    if np.dtype(dt).name == "bfloat16":
        return torch.bfloat16
    return torch.from_numpy(np.zeros(0, np.dtype(dt))).dtype


@dataclasses.dataclass(frozen=True)
class SlabSpec:
    """Static layout of a pytree inside a 1-D slab.

    ``offsets[i]:offsets[i]+sizes[i]`` is leaf i (in ``treedef`` order);
    ``total`` is the exact element count and ``padded`` the lane-rounded
    slab length actually materialised.
    """

    treedef: TreeDef
    shapes: Tuple[Tuple[int, ...], ...]
    dtypes: Tuple[torch.dtype, ...]
    offsets: Tuple[int, ...]
    sizes: Tuple[int, ...]
    total: int
    padded: int
    shards: int = 1

    @property
    def n_leaves(self) -> int:
        return len(self.shapes)

    @property
    def shard_len(self) -> int:
        """Length of one per-device slab slice (``padded / shards``)."""
        return self.padded // self.shards


def make_slab_spec(tree: PyTree, lane: int = LANE, shards: int = 1) -> SlabSpec:
    """Build the static slab layout of ``tree`` (anything with ``shape``
    and ``dtype``: tensors or numpy arrays).

    ``shards`` > 1 applies the shard-aligned padding rule: the padded
    length becomes the smallest multiple of ``lane * shards`` holding all
    leaves, so the slab splits into ``shards`` equal lane-aligned slices.
    """
    leaves, treedef = tree_flatten(tree)
    if not leaves:
        raise ValueError("cannot build a slab spec from an empty pytree")
    if shards < 1:
        raise ValueError(f"shards must be >= 1, got {shards}")
    shapes = tuple(tuple(int(s) for s in l.shape) for l in leaves)
    dtypes = tuple(_torch_dtype(l.dtype) for l in leaves)
    sizes = tuple(math.prod(s) for s in shapes)
    offsets, off = [], 0
    for s in sizes:
        offsets.append(off)
        off += s
    quantum = lane * shards
    padded = -(-off // quantum) * quantum
    return SlabSpec(treedef=treedef, shapes=shapes, dtypes=dtypes,
                    offsets=tuple(offsets), sizes=tuple(sizes), total=off,
                    padded=padded, shards=shards)


def _leaves_of(spec: SlabSpec, tree: PyTree) -> List[torch.Tensor]:
    leaves, treedef = tree_flatten(tree)
    if treedef != spec.treedef:
        raise ValueError("tree structure does not match the slab spec")
    return leaves


def tree_to_slab(spec: SlabSpec, tree: PyTree,
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Flatten ``tree`` into one (padded,) slab of ``dtype`` (zero tail)."""
    leaves = _leaves_of(spec, tree)
    flat = torch.cat([l.reshape(-1).to(dtype) for l in leaves])
    return torch.nn.functional.pad(flat, (0, spec.padded - spec.total))


def slab_to_tree(spec: SlabSpec, slab: torch.Tensor, cast: bool = True) -> PyTree:
    """Invert ``tree_to_slab``: restore shapes and (if ``cast``) dtypes.

    Leaves are views of ``slab`` where no cast is needed. ``cast=False``
    keeps the slab dtype on every leaf (the f32 optimizer state).
    """
    leaves = []
    for shape, dt, off, size in zip(spec.shapes, spec.dtypes, spec.offsets,
                                    spec.sizes):
        leaf = slab[off:off + size].view(shape)
        leaves.append(leaf.to(dt) if cast else leaf)
    return tree_unflatten(spec.treedef, leaves)


def stack_to_slab(spec: SlabSpec, tree: PyTree,
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Flatten a client-stacked tree (leaves ``(N, *shape)``) to (N, padded)."""
    leaves = _leaves_of(spec, tree)
    n = leaves[0].shape[0]
    flat = torch.cat([l.reshape(n, -1).to(dtype) for l in leaves], dim=1)
    return torch.nn.functional.pad(flat, (0, spec.padded - spec.total))


def zeros_slab(spec: SlabSpec, dtype: torch.dtype = torch.float32,
               device=None) -> torch.Tensor:
    return torch.zeros((spec.padded,), dtype=dtype, device=device)

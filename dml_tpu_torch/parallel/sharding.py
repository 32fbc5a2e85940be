"""Parameter partitioning for tensor parallelism: PyTorch counterpart of
dml_tpu/parallel/sharding.py, with the cut and the reassembly that
GSPMD does implicitly.

The rule is the JAX package's: a leaf's output-channel axis is sharded
over `tp` when it divides evenly and holds at least two channels a rank
(`size % tp == 0 and size >= 2 * tp`), else the leaf is replicated;
expert weights (`w_up`, `w_down`) follow `moe.moe_partition_spec`
(their leading E axis over `ep` when ep > 1 divides it, else
replicated; the layout [E, d, d_ff] is Flax's, so those pieces are the
JAX device shards as they are). Elsewhere the layouts differ: JAX
shards the last axis of a Flax leaf (HWIO convs, [in, out] dense
kernels), where the port holds
OIHW and [out, in] (`models.params_io`). So the port's output-channel
axis is dim 0 of every conv and linear weight and channel vector, and
the test is on that dim: rank t of the tp axis holds the same
contiguous channel block as JAX's device at tp index t.
`partition_lm_params` is the LM serving forms' rule: the last axis of
the LM tree's Flax-layout leaves, as JAX cuts them.

A spec is a `PartitionSpec`: one axis name or None per dim, `P()` for a
replicated leaf, as JAX spells it. A spec of this rule names at most one
axis; `shard`, `gather` and `gather_tree` cut and reassemble over it.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import torch

from .mesh import Mesh, all_gather
from .moe import moe_partition_spec


class PartitionSpec(tuple):
    """Per-dim mesh axis (or None); empty: replicated."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


P = PartitionSpec


def replicated(mesh=None) -> PartitionSpec:
    return P()


def _tp(mesh) -> int:
    return int((getattr(mesh, "shape", mesh) or {}).get("tp", 1))


def _spec_for(path: tuple, leaf: Any, tp: int, mesh=None) -> PartitionSpec:
    if mesh is not None:
        moe_spec = moe_partition_spec(path, leaf, mesh)
        if moe_spec is not None:
            return P(*moe_spec)
    if tp <= 1:
        return P()
    shape = tuple(getattr(leaf, "shape", ()))
    if not shape:
        return P()
    out = shape[0]
    if out % tp != 0 or out < 2 * tp:
        return P()
    # the output-channel axis (dim 0) over tp: conv OIHW -> ('tp', None,
    # None, None), linear [out, in] -> ('tp', None), vectors -> ('tp',)
    return P("tp", *([None] * (len(shape) - 1)))


def partition_params(tree: Any, mesh) -> Any:
    """A tree of PartitionSpecs matching `tree` (a state_dict, optimizer
    moments, or nested dicts of them: anything whose leaves are shaped
    like parameters). Keys are split on '.' into the leaf's path. `mesh`
    is a Mesh or a mapping of axis sizes."""
    tp = _tp(mesh)

    def walk(node, path):
        if isinstance(node, Mapping):
            return {k: walk(v, path + tuple(str(k).split("."))) for k, v in node.items()}
        return _spec_for(path, node, tp, mesh)

    return walk(tree, ())


def partition_lm_params(tree: Any, mesh) -> Any:
    """The LM serving forms' rule (`inference.lm_sharded`): a tree of
    PartitionSpecs matching the LM params tree `tree` (nested dicts of
    tensors in Flax's layout). Expert weights follow `moe_partition_spec`;
    every other leaf has its LAST axis over tp under JAX's size test, as
    JAX's `partition_params` cuts the same leaves (the embedding [V, d]
    on d, the [in, out] kernels on out, the norm scales [d]), so rank t's
    piece is JAX's device shard at tp index t. (`partition_params` cuts
    dim 0, the output axis of the port's image layouts and the input axis
    of an LM kernel.)"""
    tp = _tp(mesh)

    def spec(path, leaf):
        moe_spec = moe_partition_spec(path, leaf, mesh) if mesh is not None else None
        if moe_spec is not None:
            return P(*moe_spec)
        shape = tuple(leaf.shape)
        if tp <= 1 or not shape or shape[-1] % tp != 0 or shape[-1] < 2 * tp:
            return P()
        return P(*([None] * (len(shape) - 1)), "tp")

    def walk(node, path):
        if isinstance(node, Mapping):
            return {k: walk(v, path + (str(k),)) for k, v in node.items()}
        return spec(path, node)

    return walk(tree, ())


def shard_dim(spec: PartitionSpec, axis: str = "tp") -> Optional[int]:
    """The dim sharded over `axis`, or None when no dim is."""
    return spec.index(axis) if axis in spec else None


def _axis_of(spec: PartitionSpec) -> Optional[str]:
    return next((a for a in spec if a is not None), None)


def shard(t: torch.Tensor, spec: PartitionSpec, mesh: Mesh) -> torch.Tensor:
    """This rank's piece of the full tensor `t` over the axis `spec`
    names (a contiguous copy; `t` itself when the leaf is replicated)."""
    axis = _axis_of(spec)
    if axis is None:
        return t
    dim, n, i = spec.index(axis), mesh.shape[axis], mesh.coords[axis]
    k = t.shape[dim] // n
    return t.narrow(dim, i * k, k).clone(memory_format=torch.contiguous_format)


def gather(t: torch.Tensor, spec: PartitionSpec, mesh: Mesh) -> torch.Tensor:
    """The full tensor from the pieces of a sharded leaf (a collective
    over the group of the axis `spec` names); `t` itself when it is
    replicated."""
    axis = _axis_of(spec)
    return t if axis is None else all_gather(t, mesh, axis, spec.index(axis))


def gather_tree(pieces: Mapping[str, torch.Tensor], specs: Mapping[str, PartitionSpec],
                mesh: Mesh, axis: str = "tp") -> Dict[str, torch.Tensor]:
    """Full tensors from this rank's pieces (`shard` of each) of the
    leaves sharded over `axis`: those of each dtype in one all-gather,
    flattened into one buffer; the other leaves as they are."""
    out = dict(pieces)
    by_dtype: Dict[torch.dtype, list] = {}
    for n, t in pieces.items():
        if shard_dim(specs[n], axis) is not None:
            by_dtype.setdefault(t.dtype, []).append(n)
    size = mesh.shape[axis]
    for names in by_dtype.values():
        flat = torch.cat([pieces[n].reshape(-1) for n in names])
        full = all_gather(flat, mesh, axis).view(size, -1)
        off = 0
        for n in names:
            p, k = pieces[n], pieces[n].numel()
            out[n] = torch.cat([full[r, off:off + k].view(p.shape) for r in range(size)],
                               shard_dim(specs[n], axis))
            off += k
    return out

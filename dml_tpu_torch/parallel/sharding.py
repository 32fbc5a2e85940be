"""Parameter partitioning for tensor parallelism: PyTorch counterpart of
dml_tpu/parallel/sharding.py, with the cut and the reassembly that
GSPMD does implicitly.

The rule is the JAX package's: a leaf's output-channel axis is sharded
over `tp` when it divides evenly and holds at least two channels a rank
(`size % tp == 0 and size >= 2 * tp`), else the leaf is replicated;
expert weights (`w_up`, `w_down`) follow `moe.moe_partition_spec`
(replicated at ep = 1). The layouts differ: JAX shards the last axis of
a Flax leaf (HWIO convs, [in, out] dense kernels), where the port holds
OIHW and [out, in] (`models.params_io`). So the port's output-channel
axis is dim 0 of every conv and linear weight and channel vector, and
the test is on that dim: rank t of the tp axis holds the same
contiguous channel block as JAX's device at tp index t.

A spec is a `PartitionSpec`: one axis name or None per dim, `P()` for a
replicated leaf, as JAX spells it.
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


def shard_dim(spec: PartitionSpec) -> Optional[int]:
    """The dim sharded over tp, or None for a replicated leaf."""
    return spec.index("tp") if "tp" in spec else None


def shard(t: torch.Tensor, spec: PartitionSpec, mesh: Mesh) -> torch.Tensor:
    """This rank's tp piece of the full tensor `t` (a contiguous copy;
    `t` itself when the leaf is replicated)."""
    dim = shard_dim(spec)
    if dim is None:
        return t
    tp, i = mesh.shape["tp"], mesh.coords["tp"]
    k = t.shape[dim] // tp
    return t.narrow(dim, i * k, k).clone(memory_format=torch.contiguous_format)


def gather(t: torch.Tensor, spec: PartitionSpec, mesh: Mesh) -> torch.Tensor:
    """The full tensor from the tp pieces of a sharded leaf (a
    collective over the tp group); `t` itself when it is replicated."""
    dim = shard_dim(spec)
    return t if dim is None else all_gather(t, mesh, "tp", dim)


def gather_tree(pieces: Mapping[str, torch.Tensor], specs: Mapping[str, PartitionSpec],
                mesh: Mesh) -> Dict[str, torch.Tensor]:
    """Full tensors from this rank's pieces (`shard` of each): the
    sharded leaves of each dtype in one all-gather over tp, flattened
    into one buffer; replicated leaves as they are."""
    out = dict(pieces)
    by_dtype: Dict[torch.dtype, list] = {}
    for n, t in pieces.items():
        if shard_dim(specs[n]) is not None:
            by_dtype.setdefault(t.dtype, []).append(n)
    tp = mesh.shape["tp"]
    for names in by_dtype.values():
        flat = torch.cat([pieces[n].reshape(-1) for n in names])
        full = all_gather(flat, mesh, "tp").view(tp, -1)
        off = 0
        for n in names:
            p, k = pieces[n], pieces[n].numel()
            out[n] = torch.cat([full[r, off:off + k].view(p.shape) for r in range(tp)],
                               shard_dim(specs[n]))
            off += k
    return out

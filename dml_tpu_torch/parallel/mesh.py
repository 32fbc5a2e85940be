"""Device meshes over torch.distributed, and the collectives the port's
dp and tp forms call: PyTorch counterpart of dml_tpu/parallel/mesh.py.

The JAX package runs one process over N devices, and GSPMD places the
collectives from sharding annotations. The port runs one process per
rank (one GPU each), every rank given the same host arguments (SPMD),
and calls the collectives itself, through the functions below.

A `Mesh` lays its ranks out as `np.asarray(ranks).reshape(shape)` over
the axes `AXES`, `dp` outermost, as the JAX package lays its devices
out: rank r's coordinates are those of device r in JAX's mesh over the
same count. It holds one process group per axis: for `dp` and `tp`
always (a group of one where the axis has size 1, so that a one-rank
world still runs its collectives), for `sp`, `pp` and `ep` where the
axis has more than one rank, and always one for the dp x sp plane
(`("dp", "sp")`: the ranks that hold different rows or sequence chunks
of a batch, over which the LM sums its gradients in one collective; the
dp or sp group itself where the other axis has size 1).
`make_mesh` is collective: every rank of the world calls it, in
the same order, as `torch.distributed.new_group` requires, whether or
not the rank is in the mesh (`ranks=`).

Without torch.distributed a mesh of one rank is a plain one-device mesh
(`resolve_mesh` gives None for it, and the forms run their one-device
code); a mesh of more ranks than the world has raises, and so does a
mesh of more than one rank that has no process group. Nothing runs on
one rank in place of several.

Collectives (`all_reduce`, `all_gather`, `all_to_all`, `ring_shift`,
`barrier`) take a tensor on the rank's device. Under gloo a CUDA tensor
is copied to the host, exchanged there and copied back: the group's
backend decides that, never a caught error. Each runs inside a
`torch.profiler.record_function` range named `mesh.<collective>.<axis>`,
which a profile reads for the collectives' share of a step.
`all_to_all` and `ring_shift` are the sequence-parallel forms'
collectives (JAX's `lax.all_to_all(tiled=True)` and the ring's
`ppermute`); both are differentiable: the gradient of an all-to-all is
the inverse all-to-all, and that of a shift the shift the other way.

`record_collectives()` is the port's counterpart of reading the
collectives out of an optimized HLO module (the JAX package's
tools/ring_vs_ulysses.py): while it is active, each `all_reduce`,
`all_gather`, all-to-all and shift of this thread appends `(op, axis,
result bytes)` to the list it yields, under HLO's op names
(`all-reduce`, `all-gather`, `all-to-all`, `collective-permute`). When
it is inactive they record nothing.
"""

from __future__ import annotations

import contextlib
import contextvars
from collections import OrderedDict
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..config import MeshSpec
from . import mesh_size

AXES = ("dp", "tp", "sp", "pp", "ep")
#: axes that always get a process group (the forms of this package)
_ALWAYS_GROUPED = ("dp", "tp")
#: groups over more than one axis, always made
PLANES = (("dp", "sp"),)


def _world() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


class Mesh:
    """Ranks laid out over `AXES`. `shape` maps every axis to its size
    (an ordered mapping, as `jax.sharding.Mesh.shape`); `ranks` is the
    grid of global ranks; `rank` this process's global rank, or None when
    it is not in the mesh; `coords` its index along each axis."""

    def __init__(self, shape: Dict[str, int], ranks: np.ndarray, rank: Optional[int],
                 groups: Dict[str, object], group_all, backend: Optional[str]):
        self.shape = OrderedDict((a, int(shape[a])) for a in AXES)
        self.ranks = ranks
        self.rank = rank
        self.backend = backend
        self._groups = groups
        self._group_all = group_all
        self.coords: Optional[Dict[str, int]] = None
        if rank is not None:
            at = np.argwhere(ranks == rank)[0]
            self.coords = {a: int(i) for a, i in zip(AXES, at)}

    @property
    def distributed(self) -> bool:
        """Whether the mesh runs over torch.distributed (it has groups)."""
        return self.backend is not None

    @property
    def index(self) -> int:
        """This rank's place in the mesh's row-major order (0 writes)."""
        return int(np.flatnonzero(self.ranks.reshape(-1) == self.rank)[0])

    def group(self, axis):
        """The process group of this rank's line along `axis` (a name, or
        a tuple of `PLANES`)."""
        if axis not in self._groups:
            raise ValueError(f"mesh has no process group for axis {axis!r} on this rank")
        return self._groups[axis]

    def __repr__(self) -> str:
        return f"Mesh({dict(self.shape)}, rank={self.rank}, backend={self.backend})"


def make_mesh(spec: Optional[MeshSpec] = None, ranks: Optional[Sequence[int]] = None) -> Mesh:
    """A Mesh over `ranks` (default: every rank of the world) with the
    axis sizes of `spec` (-1 fills). `ranks=range(k)` is the counterpart
    of JAX's `devices=jax.devices()[:k]`: the other ranks take no part,
    and each of them gets a Mesh whose `rank` is None."""
    spec = spec or MeshSpec()
    world = _world()
    ranks = list(range(world)) if ranks is None else [int(r) for r in ranks]
    sizes = spec.resolve(len(ranks))
    if len(ranks) > world:
        raise ValueError(f"mesh asks for {len(ranks)} ranks but the world has {world}"
                         + ("" if world > 1 else " (torch.distributed is not initialized)"))
    if len(set(ranks)) != len(ranks) or not all(0 <= r < world for r in ranks):
        raise ValueError(f"mesh ranks {ranks} are not distinct ranks of a world of {world}")
    grid = np.asarray(ranks).reshape([sizes[a] for a in AXES])
    if world == 1 and not (dist.is_available() and dist.is_initialized()):
        return Mesh(sizes, grid, 0, {}, None, None)
    me = dist.get_rank()
    groups = {}
    grouped = [(a, (a,)) for a in AXES if sizes[a] > 1 or a in _ALWAYS_GROUPED]
    # a plane with at most one axis longer than 1 is that axis's line (or
    # its first axis's, which is always grouped): it shares that group
    shared = {p: next((a for a in p if sizes[a] > 1), p[0]) for p in PLANES
              if sum(sizes[a] > 1 for a in p) <= 1}
    for key, axes in grouped + [(p, p) for p in PLANES if p not in shared]:
        at = [AXES.index(a) for a in axes]
        n = int(np.prod([sizes[a] for a in axes]))
        for line in np.moveaxis(grid, at, range(-len(at), 0)).reshape(-1, n):
            members = [int(r) for r in line]
            group = dist.new_group(members)
            if me in members:
                groups[key] = group
    for plane, axis in shared.items():
        if axis in groups:
            groups[plane] = groups[axis]
    group_all = dist.group.WORLD if len(ranks) == world else dist.new_group(ranks)
    rank = me if me in ranks else None
    return Mesh(sizes, grid, rank, groups if rank is not None else {}, group_all,
                dist.get_backend())


def local_mesh(dp: int = -1, tp: int = 1, sp: int = 1, pp: int = 1, ep: int = 1) -> Mesh:
    """A mesh over every rank of the world."""
    return make_mesh(MeshSpec(dp=dp, tp=tp, sp=sp, pp=pp, ep=ep))


def resolve_mesh(mesh) -> Optional[Mesh]:
    """The Mesh a form runs over, or None to run on one device: `mesh` is
    None, a mapping of axis sizes or an object with such a `.shape` (a
    JAX mesh), or a Mesh. One device when it asks for one rank and runs
    no collectives; ValueError when it asks for more ranks than the world
    has, when it has no process group, or when this rank is not in it."""
    if isinstance(mesh, Mesh):
        if not mesh.distributed:
            return None
        if mesh.rank is None:
            raise ValueError(f"rank {dist.get_rank()} is not in {mesh}")
        return mesh
    n, world = mesh_size(mesh), _world()
    if n == 1:
        return None
    if n > world:
        raise ValueError(f"mesh asks for {n} ranks but the world has {world}"
                         + ("" if world > 1 else " (torch.distributed is not initialized)"))
    raise ValueError(f"mesh {dict(getattr(mesh, 'shape', mesh))} has no process group: "
                     f"build it with parallel.mesh.make_mesh")


# ---- collectives ----

#: the list `record_collectives` yields, while one is active in this context
_RECORDS: contextvars.ContextVar[Optional[List[Tuple[str, str, int]]]] = contextvars.ContextVar(
    "mesh_collective_records", default=None)


@contextlib.contextmanager
def record_collectives() -> Iterator[List[Tuple[str, str, int]]]:
    """Record every collective this thread calls inside the block:
    yields a list that each call appends `(op, axis, result bytes)` to
    (one entry a call, its result's bytes on this rank)."""
    records: List[Tuple[str, str, int]] = []
    token = _RECORDS.set(records)
    try:
        yield records
    finally:
        _RECORDS.reset(token)


def _record(op: str, axis, result: torch.Tensor) -> None:
    records = _RECORDS.get()
    if records is not None:
        name = axis if isinstance(axis, str) else "+".join(axis)
        records.append((op, name, result.numel() * result.element_size()))


def _staged(t: torch.Tensor, mesh: Mesh) -> bool:
    """gloo reduces host tensors: a CUDA tensor goes through the host."""
    return t.is_cuda and mesh.backend == "gloo"


def all_reduce(t: torch.Tensor, mesh: Mesh, axis) -> torch.Tensor:
    """Sum `t` over the ranks of this rank's `axis` group (an axis name or
    a plane of `PLANES`), in place; returns `t`."""
    name = axis if isinstance(axis, str) else "+".join(axis)
    with torch.profiler.record_function(f"mesh.all_reduce.{name}"):
        if _staged(t, mesh):
            host = t.cpu()
            dist.all_reduce(host, group=mesh.group(axis))
            t.copy_(host)
        else:
            dist.all_reduce(t, group=mesh.group(axis))
    _record("all-reduce", axis, t)
    return t


def all_gather(t: torch.Tensor, mesh: Mesh, axis: str, dim: int = 0) -> torch.Tensor:
    """The ranks' `t` along `axis`, concatenated along `dim` in the
    axis's order (a new tensor on `t`'s device)."""
    n = mesh.shape[axis]
    with torch.profiler.record_function(f"mesh.all_gather.{axis}"):
        src = (t.cpu() if _staged(t, mesh) else t).contiguous()
        parts: List[torch.Tensor] = [torch.empty_like(src) for _ in range(n)]
        dist.all_gather(parts, src, group=mesh.group(axis))
        out = torch.cat(parts, dim)
    _record("all-gather", axis, out)
    return out.to(t.device) if out.device != t.device else out


def barrier(mesh: Mesh) -> None:
    """Wait for every rank of the mesh."""
    with torch.profiler.record_function("mesh.barrier"):
        dist.barrier(group=mesh._group_all)


def _group_rank(mesh: Mesh, axis: str, i: int) -> int:
    """The global rank of the axis group's i-th member (a peer of a
    point-to-point op is named by its global rank)."""
    return dist.get_global_rank(mesh.group(axis), i)


def _all_to_all(t: torch.Tensor, mesh: Mesh, axis: str, split_dim: int,
                concat_dim: int) -> torch.Tensor:
    n = mesh.shape[axis]
    if t.shape[split_dim] % n:
        raise ValueError(f"all_to_all: dim {split_dim} of {tuple(t.shape)} is not divisible "
                         f"by {axis}={n}")
    with torch.profiler.record_function(f"mesh.all_to_all.{axis}"):
        x = t.movedim(split_dim, 0)
        # piece j (rows j*S/n..) goes to the axis's rank j
        x = x.reshape(n, x.shape[0] // n, *x.shape[1:])
        x = (x.cpu() if _staged(t, mesh) else x).contiguous()
        got = torch.empty_like(x)
        dist.all_to_all_single(got, x, group=mesh.group(axis))
        got = got.to(t.device) if got.device != t.device else got
        _record("all-to-all", axis, got)
        # got[i] came from rank i: concatenated along concat_dim in rank order
        return torch.cat([p.movedim(0, split_dim) for p in got.unbind(0)], concat_dim)


def _shift(t: torch.Tensor, mesh: Mesh, axis: str, reverse: bool) -> torch.Tensor:
    n, i = mesh.shape[axis], mesh.coords[axis]
    to, frm = ((i - 1) % n, (i + 1) % n) if reverse else ((i + 1) % n, (i - 1) % n)
    with torch.profiler.record_function(f"mesh.ring_shift.{axis}"):
        src = (t.cpu() if _staged(t, mesh) else t).contiguous()
        got = torch.empty_like(src)
        group = mesh.group(axis)
        reqs = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, src, _group_rank(mesh, axis, to), group),
            dist.P2POp(dist.irecv, got, _group_rank(mesh, axis, frm), group)])
        for r in reqs:  # complete before the next exchange: each is matched in order
            r.wait()
    _record("collective-permute", axis, got)
    return got.to(t.device) if got.device != t.device else got


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axis, split_dim, concat_dim):
        ctx.args = (mesh, axis, split_dim, concat_dim)
        return _all_to_all(t, mesh, axis, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, split_dim, concat_dim = ctx.args
        return _all_to_all(g, mesh, axis, concat_dim, split_dim), None, None, None, None


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axis):
        ctx.args = (mesh, axis)
        return _shift(t, mesh, axis, reverse=False)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, *ctx.args, reverse=True), None, None


def all_to_all(t: torch.Tensor, mesh: Mesh, axis: str, split_dim: int,
               concat_dim: int) -> torch.Tensor:
    """`jax.lax.all_to_all(t, axis, split_dim, concat_dim, tiled=True)`:
    `t`'s `split_dim` is cut into as many pieces as the axis has ranks,
    piece j goes to the axis's rank j, and the pieces received are
    concatenated along `concat_dim` in rank order (a new tensor on `t`'s
    device). Differentiable: the backward is the inverse all-to-all."""
    if torch.is_grad_enabled() and t.requires_grad:
        return _AllToAll.apply(t, mesh, axis, split_dim, concat_dim)
    return _all_to_all(t, mesh, axis, split_dim, concat_dim)


def ring_shift(t: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """`ppermute` with perm [(j, (j + 1) % n)]: send `t` to the next rank
    of the axis and return what the previous rank sent. Every rank of the
    axis calls it, with tensors of one shape and dtype. Differentiable:
    the backward is the shift the other way."""
    if torch.is_grad_enabled() and t.requires_grad:
        return _RingShift.apply(t, mesh, axis)
    return _shift(t, mesh, axis, reverse=False)

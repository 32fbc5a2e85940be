"""GPipe-style pipeline parallelism over a `pp` mesh axis: PyTorch
counterpart of dml_tpu/parallel/pipeline.py.

One process per rank (`parallel.mesh`), every rank given the same
arguments. Stage parameters are stacked along a leading axis of size S
(`stack_stage_params`); `stage_sharding` gives each leaf's spec,
P("pp", None, ...), and `stage_slice` each pp rank's slice of the stack,
which is all a rank has to hold. `pipeline_apply` takes either.

The schedule is JAX's: S + M - 1 ticks; at tick t stage 0 injects
microbatch t, every stage applies its stage to its activation and hands
the result to the next pp rank (`mesh.ring_shift`, one hop a tick), and
the last stage's output at tick t is microbatch t - (S - 1). The
emissions are collected on the last stage and summed over pp (JAX's
psum), so every rank returns the whole [B, ...] output. A stage skips
the compute of a tick outside its microbatch window (JAX computes it
and masks it out), never the tick's shift. When the microbatch's example
dim divides by dp, each dp row pipelines its slice of every microbatch
and the rows are all-gathered over dp (JAX's P(None, "dp")); otherwise
the dp rows run the same work.

Gradients: the schedule is one autograd Function, whose backward runs
the ticks in reverse, each stage's input cotangent travelling one hop
back a tick (the reverse shift), so that every rank makes the same
collective calls in the same order. The parameter gradients are summed
over dp when the batch was split (JAX's transpose of parameters
replicated over dp), and the input's gradient comes back whole on every
rank. `remat=True` runs each tick's stage under
`torch.utils.checkpoint` (its activations are recomputed in the
backward instead of kept); the values are the same.

JAX's `shard_map_nocheck` and `pcast_varying` are shims over versions of
JAX's own API (the replication checker's keyword, the varying cast): the
port has no shard_map, so they have no counterpart.
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

import torch
from torch.utils import _pytree as pytree
from torch.utils.checkpoint import checkpoint

from .mesh import _shift, all_gather, all_reduce, resolve_mesh
from .sharding import P, shard

# stage_fn(stage_params, x_microbatch) -> y_microbatch (same shape and dtype)
StageFn = Callable[[Any, torch.Tensor], torch.Tensor]


def stack_stage_params(per_stage: Sequence[Any]) -> Any:
    """Stack S per-stage param trees along a new leading axis."""
    return pytree.tree_map(lambda *leaves: torch.stack(leaves, 0), per_stage[0], *per_stage[1:])


def stage_sharding(mesh, stacked: Any) -> Any:
    """The spec of each leaf of a stacked tree: its stage axis over pp."""
    return pytree.tree_map(lambda leaf: P("pp", *([None] * (leaf.ndim - 1))), stacked)


def stage_slice(stacked: Any, mesh) -> Any:
    """This pp rank's slice of a stacked tree (leading dim 1)."""
    specs = stage_sharding(mesh, stacked)
    return pytree.tree_map(lambda leaf, spec: shard(leaf, spec, mesh), stacked, specs)


def _stage_of(stacked: Any, s: int, stage: int) -> Any:
    def pick(leaf):
        if leaf.shape[0] == s:
            return leaf[stage]
        if leaf.shape[0] == 1:
            return leaf[0]
        raise ValueError(f"a stage leaf's leading dim {leaf.shape[0]} is neither pp={s} nor 1")

    return pytree.tree_map(pick, stacked)


class _Plan:
    """One rank's place in the schedule."""

    def __init__(self, fn, mesh, axis, m, mb, remat):
        self.fn, self.mesh, self.axis, self.m, self.remat = fn, mesh, axis, m, remat
        self.s = mesh.shape[axis] if mesh is not None else 1
        self.stage = mesh.coords[axis] if mesh is not None else 0
        dp = mesh.shape["dp"] if mesh is not None else 1
        self.split = dp > 1 and mb % dp == 0
        self.mbl = mb // dp if self.split else mb
        self.dpi = mesh.coords["dp"] if self.split else 0

    def rows(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's dp slice of [M, mb, ...]."""
        return t[:, self.dpi * self.mbl:(self.dpi + 1) * self.mbl] if self.split else t

    def shift(self, t: torch.Tensor, reverse: bool = False) -> torch.Tensor:
        return _shift(t, self.mesh, self.axis, reverse) if self.s > 1 else torch.zeros_like(t)

    def valid(self, t: int) -> bool:
        return 0 <= t - self.stage < self.m

    def forward(self, params, xm, keep_graph: bool):
        """The ticks on this rank: the whole output [M, mb, ...] on every
        rank, and, when keep_graph, each computed tick's (input, output)
        with its graph."""
        s, stage, m = self.s, self.stage, self.m
        xl = self.rows(xm)
        state = torch.zeros_like(xl[0])
        emits, recs = [None] * m, {}
        for t in range(s + m - 1):
            if self.valid(t):
                cur = xl[t] if stage == 0 else state
                if keep_graph:
                    cur = cur.detach().requires_grad_(True)
                    with torch.enable_grad():
                        out = (checkpoint(self.fn, params, cur, use_reentrant=False)
                               if self.remat else self.fn(params, cur))
                    recs[t] = (cur, out)
                    out = out.detach()
                else:
                    out = self.fn(params, cur)
            else:
                out = torch.zeros_like(state)
            # the last stage's hand-off reaches stage 0, which injects instead
            state = self.shift(out)
            if stage == s - 1 and t >= s - 1:
                emits[t - (s - 1)] = out
        y = torch.stack(emits) if stage == s - 1 else torch.zeros_like(xl)
        if s > 1:
            all_reduce(y, self.mesh, self.axis)
        if self.split:
            y = all_gather(y, self.mesh, "dp", 1)
        return y, recs

    def backward(self, gy, xm, recs, leaves):
        """The ticks in reverse: (the input's gradient [M, mb, ...], each
        leaf's gradient or None)."""
        s, stage, m = self.s, self.stage, self.m
        gy = self.rows(gy)
        gx = torch.zeros_like(self.rows(xm))
        grads = [None] * len(leaves)
        wrt = [i for i, leaf in enumerate(leaves) if leaf.requires_grad]
        send = torch.zeros_like(gx[0])  # d(this stage's input at t + 1)
        for t in reversed(range(s + m - 1)):
            g_out = self.shift(send, reverse=True)  # d(this stage's output at t)
            if stage == s - 1 and t >= s - 1:
                g_out = g_out + gy[t - (s - 1)]
            dcur = torch.zeros_like(g_out)
            if t in recs:
                cur, out = recs.pop(t)
                got = torch.autograd.grad(out, [cur] + [leaves[i] for i in wrt], g_out,
                                          allow_unused=True)
                dcur = got[0] if got[0] is not None else dcur
                for i, g in zip(wrt, got[1:]):
                    if g is not None:
                        grads[i] = g if grads[i] is None else grads[i] + g
            if stage == 0:
                if self.valid(t):
                    gx[t] += dcur
                send = torch.zeros_like(dcur)
            else:
                send = dcur
        if self.mesh is not None:
            if s > 1:
                all_reduce(gx, self.mesh, self.axis)
            if self.split:
                gx = all_gather(gx, self.mesh, "dp", 1)
                for i in wrt:
                    g = grads[i] if grads[i] is not None else torch.zeros_like(leaves[i])
                    grads[i] = all_reduce(g.contiguous(), self.mesh, "dp")
        return gx, grads


class _Pipeline(torch.autograd.Function):
    @staticmethod
    def forward(ctx, plan, spec, xm, *leaves):
        local = [leaf.detach().requires_grad_(leaf.requires_grad) for leaf in leaves]
        y, recs = plan.forward(pytree.tree_unflatten(local, spec), xm, keep_graph=True)
        ctx.plan, ctx.recs, ctx.local = plan, recs, local
        ctx.save_for_backward(xm)
        return y

    @staticmethod
    def backward(ctx, gy):
        (xm,) = ctx.saved_tensors
        gx, grads = ctx.plan.backward(gy, xm, ctx.recs, ctx.local)
        return (None, None, gx, *grads)


def pipeline_apply(
    stage_fn: StageFn,
    stacked_params: Any,
    x: torch.Tensor,
    *,
    mesh,
    num_microbatches: int,
    axis: str = "pp",
    remat: bool = False,
) -> torch.Tensor:
    """Run `x` [B, ...] through S pipelined stages; returns [B, ...], the
    last stage's output, on every rank. `stacked_params` leaves have
    leading dim S = mesh.shape[axis] (the whole stack) or 1 (this rank's
    `stage_slice`); B must divide into `num_microbatches` equal
    microbatches. `mesh` is a `parallel.mesh.Mesh` that this rank is in,
    or None / a one-device mesh (S = 1)."""
    m = num_microbatches
    b = x.shape[0]
    if b % m != 0:
        raise ValueError(f"batch {b} not divisible by microbatches {m}")
    mesh = resolve_mesh(mesh)
    plan = _Plan(stage_fn, mesh, axis, m, b // m, remat)
    params = _stage_of(stacked_params, plan.s, plan.stage)
    xm = x.reshape(m, b // m, *x.shape[1:])
    leaves, spec = pytree.tree_flatten(params)
    if torch.is_grad_enabled() and (x.requires_grad or any(
            isinstance(leaf, torch.Tensor) and leaf.requires_grad for leaf in leaves)):
        y = _Pipeline.apply(plan, spec, xm, *leaves)
    else:
        y, _ = plan.forward(params, xm, keep_graph=False)
    return y.reshape(b, *x.shape[1:])

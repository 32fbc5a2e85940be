"""Mixture-of-experts FFN: PyTorch counterpart of dml_tpu/parallel/moe.py,
on one device and with the experts sharded over an `ep` mesh axis.

GShard top-2 routing with a fixed per-expert capacity: `top2_dispatch`
turns the softmaxed router gates of a group of g tokens into dense
one-hot dispatch and combine tensors [g, E, C], and `MoEMLP` runs the
layer as four einsums (dispatch, expert up, expert down, combine), every
shape static. Routing runs in float32 (softmax, argmax, cumsum); the
expert products run in the model dtype (cuBLAS on the card). Tokens over
an expert's capacity pass through on the residual path. The layer holds
no Pallas kernel in the JAX package, so it holds no hand-written kernel
here either.

Parameters keep the Flax names and layouts: `router.kernel` [d, E],
`w_up` [E, d, d_ff], `w_down` [E, d_ff, d], float32, cast to the model
dtype at use. The load-balance loss is returned with the output, never
kept on the module (a value left there goes stale under `no_grad`, remat
or a second forward); `models.transformer.TransformerLM(...,
return_aux=True)` collects one per MoE block for the trainer.

Over a mesh (`MoEMLP(mesh=)`, a `parallel.mesh.Mesh` with ep > 1 and E
divisible by ep), rank e of the `ep` axis holds experts [e E/ep, (e+1)
E/ep) of `w_up` and `w_down` (`moe_partition_spec`: the JAX package's
P("ep", None, None), whose device shards these are). The tokens are the
same on every rank of the `ep` axis (the JAX package never splits them
over ep: its tokens are P("dp", "sp"), and GSPMD places one all-reduce
over ep, no all-to-all). Every rank routes all of them over all E
experts, runs its own experts on its slice of the dispatch tensor,
all-gathers the expert outputs over ep and combines on the full E, as
one device does. The gradients match one device's on every rank: the
router's and the aux term's come from the full combine, identical on
each rank; the input's share through the local experts is summed over ep
in the backward (the all-gather's backward keeps the rank's own slice).
When E is not divisible by ep, every rank holds and runs every expert,
with no collective (the JAX package drops the annotation then).

A rank's x is its own tokens (its dp rows and sp slice of the LM's
batch), and routing groups are taken within them: over sp that is the
per-shard sequence, the JAX package's rule (`dml_tpu/parallel/moe.py:
86-103`); a caller whose tokens do not split over dp or sp passes them
whole, and the groups are taken over the whole sequence, as JAX takes
them then.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..models.transformer import Dense, silu
from .mesh import Mesh, all_gather, all_reduce, resolve_mesh


def expert_shards(num_experts: int, mesh) -> int:
    """Over how many ranks the experts are split: ep when the mesh's ep
    axis has more than one rank and divides E, else 1 (replicated)."""
    ep = int((getattr(mesh, "shape", mesh) or {}).get("ep", 1))
    return ep if ep > 1 and num_experts % ep == 0 else 1


class _SumGradOverEp(torch.autograd.Function):
    """Identity forward; the gradient summed over ep (each rank's share
    flows through its own experts only)."""

    @staticmethod
    def forward(ctx, x, mesh: Mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous(), ctx.mesh, "ep"), None


class _GatherOverEp(torch.autograd.Function):
    """The ranks' expert outputs [..., E/ep, ...] gathered into [..., E,
    ...] along `dim`; the backward keeps this rank's slice (every rank
    computes the same loss from the gathered tensor, so the slice is the
    whole gradient)."""

    @staticmethod
    def forward(ctx, x, mesh: Mesh, dim: int):
        ctx.mesh, ctx.dim, ctx.k = mesh, dim, x.shape[dim]
        return all_gather(x, mesh, "ep", dim)

    @staticmethod
    def backward(ctx, g):
        start = ctx.mesh.coords["ep"] * ctx.k
        return g.narrow(ctx.dim, start, ctx.k).contiguous(), None, None


def top2_dispatch(gates: torch.Tensor, capacity: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """GShard top-2 gating. gates: [..., n, E] float32 (softmaxed), each
    leading index one routing group of n tokens.

    Returns (dispatch [..., n, E, C] 0/1 in gates' dtype, combine [..., n,
    E, C], aux [...]: the load-balance loss of each group). A token's
    first choice queues before every second choice (the cumsum minus the
    token's own mask gives its place); a choice past `capacity` drops.
    Gradients reach the gates through combine and aux only."""
    e = gates.shape[-1]
    mask1 = F.one_hot(gates.argmax(-1), e).to(gates.dtype)
    mask2 = F.one_hot((gates * (1.0 - mask1)).argmax(-1), e).to(gates.dtype)

    # GShard eq. 4: E * <share routed to e> . <mean gate of e>
    aux = (mask1.mean(-2) * gates.mean(-2)).sum(-1) * e

    pos1 = mask1.cumsum(-2) - mask1
    mask1 = mask1 * (pos1 < capacity)
    pos2 = mask2.cumsum(-2) - mask2 + mask1.sum(-2, keepdim=True)
    mask2 = mask2 * (pos2 < capacity)

    g1 = (gates * mask1).sum(-1)
    g2 = (gates * mask2).sum(-1)
    denom = g1 + g2
    denom = torch.where(denom > 0, denom, torch.ones_like(denom))
    g1, g2 = g1 / denom, g2 / denom

    # a dropped choice has position 0 here and a zero mask below
    p1 = F.one_hot((pos1 * mask1).sum(-1).long(), capacity).to(gates.dtype)
    p2 = F.one_hot((pos2 * mask2).sum(-1).long(), capacity).to(gates.dtype)
    combine = (g1[..., None, None] * mask1[..., None] * p1[..., None, :]
               + g2[..., None, None] * mask2[..., None] * p2[..., None, :])
    dispatch = (combine > 0).to(gates.dtype)
    return dispatch, combine, aux


def group_size_for(t: int, group_size: int) -> int:
    """The routing group: the largest divisor of the sequence length `t`
    that is at most `group_size` (groups never mix batch rows)."""
    g = min(group_size, t)
    while t % g:
        g -= 1
    return g


class MoEMLP(nn.Module):
    """Drop-in transformer FFN: x [B, T, d] -> (y [B, T, d], aux), where
    aux is the load-balance loss averaged over the [B, T/g] groups.

    Routing groups are the [B, T/g, g] grid with g = `group_size_for(T,
    group_size)`; capacity is max(1, ceil(g / E * capacity_factor)) per
    expert and group. With `mesh` (ep > 1 dividing E), `w_up` and
    `w_down` hold this rank's E/ep experts (`expert_shards`)."""

    def __init__(self, d_model: int, num_experts: int, d_ff: int,
                 capacity_factor: float = 1.25, group_size: int = 1024, mesh=None,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.mesh = resolve_mesh(mesh)
        self.num_experts, self.d_ff = num_experts, d_ff
        self.capacity_factor, self.group_size, self.dtype = capacity_factor, group_size, dtype
        self.shards = expert_shards(num_experts, self.mesh)
        local = num_experts // self.shards
        self.router = Dense(d_model, num_experts, torch.float32)
        self.w_up = nn.Parameter(torch.zeros(local, d_model, d_ff))
        self.w_down = nn.Parameter(torch.zeros(local, d_ff, d_model))

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        b, t, d = x.shape
        e, dt = self.num_experts, self.dtype
        g = group_size_for(t, self.group_size)
        capacity = max(1, math.ceil(g / e * self.capacity_factor))
        tokens = x.reshape(b, t // g, g, d)

        gates = torch.softmax(self.router(tokens), dim=-1)  # float32 [B, Gt, g, E]
        dispatch, combine, aux = top2_dispatch(gates, capacity)

        if self.shards > 1:  # this rank's experts on their slice of the dispatch
            local = e // self.shards
            dispatch = dispatch.narrow(3, self.mesh.coords["ep"] * local, local)
            tokens = _SumGradOverEp.apply(tokens, self.mesh)
        expert_in = torch.einsum("bgnec,bgnd->bgecd", dispatch.to(dt), tokens.to(dt))
        h = silu(torch.einsum("bgecd,edf->bgecf", expert_in, self.w_up.to(dt)))
        out_e = torch.einsum("bgecf,efd->bgecd", h, self.w_down.to(dt))
        if self.shards > 1:
            out_e = _GatherOverEp.apply(out_e, self.mesh, 2)
        out = torch.einsum("bgnec,bgecd->bgnd", combine.to(dt), out_e)
        return out.reshape(b, t, d), aux.mean()


def moe_partition_spec(path: tuple, leaf, mesh) -> Optional[tuple]:
    """The JAX package's sharding rule for expert weights: None for a
    leaf that is not `w_up` or `w_down`; else ("ep", None, None) (the
    leading E axis over ep) when the mesh's ep axis has more than one
    rank and divides the leaf's E, () (replicated) otherwise. The layout
    [E, d, d_ff] is Flax's, so the pieces are the JAX device shards."""
    keys = [getattr(k, "key", str(k)) for k in path]
    if not any(k in ("w_up", "w_down") for k in keys):
        return None
    shape = tuple(getattr(leaf, "shape", ()))
    if shape and expert_shards(shape[0], mesh) > 1:
        return ("ep",) + (None,) * (len(shape) - 1)
    return ()

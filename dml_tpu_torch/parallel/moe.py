"""Mixture-of-experts FFN: PyTorch counterpart of dml_tpu/parallel/moe.py
on one device.

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

Differences from the JAX package, by design: one device. A mesh of more
than one device (expert parallelism over `ep`) raises
NotImplementedError, as does `moe_partition_spec` for ep > 1; those are
ROADMAP A5(b). At ep = 1 the expert weights are replicated over any
mesh, as in the JAX package (`sharding.partition_params`).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..models.transformer import Dense, silu
from . import mesh_size


def _one_device(mesh) -> None:
    if mesh_size(mesh) > 1:
        raise NotImplementedError(
            "expert parallelism over a mesh of more than one device is not ported yet: "
            "ROADMAP A5(b) (all-to-all and ring forms)"
        )


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
    expert and group."""

    def __init__(self, d_model: int, num_experts: int, d_ff: int,
                 capacity_factor: float = 1.25, group_size: int = 1024, mesh=None,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        _one_device(mesh)
        self.num_experts, self.d_ff = num_experts, d_ff
        self.capacity_factor, self.group_size, self.dtype = capacity_factor, group_size, dtype
        self.router = Dense(d_model, num_experts, torch.float32)
        self.w_up = nn.Parameter(torch.zeros(num_experts, d_model, d_ff))
        self.w_down = nn.Parameter(torch.zeros(num_experts, d_ff, d_model))

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        b, t, d = x.shape
        e, dt = self.num_experts, self.dtype
        g = group_size_for(t, self.group_size)
        capacity = max(1, math.ceil(g / e * self.capacity_factor))
        tokens = x.reshape(b, t // g, g, d)

        gates = torch.softmax(self.router(tokens), dim=-1)  # float32 [B, Gt, g, E]
        dispatch, combine, aux = top2_dispatch(gates, capacity)

        expert_in = torch.einsum("bgnec,bgnd->bgecd", dispatch.to(dt), tokens.to(dt))
        h = silu(torch.einsum("bgecd,edf->bgecf", expert_in, self.w_up.to(dt)))
        out_e = torch.einsum("bgecf,efd->bgecd", h, self.w_down.to(dt))
        out = torch.einsum("bgnec,bgecd->bgnd", combine.to(dt), out_e)
        return out.reshape(b, t, d), aux.mean()


def moe_partition_spec(path: tuple, leaf, mesh) -> Optional[tuple]:
    """The JAX package's sharding rule for expert weights at ep = 1:
    None for a leaf that is not `w_up` or `w_down`, else () (replicated).
    A mesh with ep > 1 (the E axis over `ep`) raises."""
    if int((getattr(mesh, "shape", mesh) or {}).get("ep", 1)) > 1:
        raise NotImplementedError(
            "expert weights sharded over an ep axis of more than one rank are not ported "
            "yet: ROADMAP A5(b)")
    keys = [getattr(k, "key", str(k)) for k in path]
    return () if any(k in ("w_up", "w_down") for k in keys) else None

"""Ring attention: exact attention over a sequence sharded across the
`sp` axis of a mesh. PyTorch counterpart of
dml_tpu/parallel/ring_attention.py.

Each rank of the axis holds one chunk of the sequence. Key/value blocks
rotate around the ring (`mesh.ring_shift`, JAX's `ppermute`), and each
rank merges its queries' attention over every block it is handed with
the online-softmax recurrence, so the whole T x T score matrix never
exists and the sequence grows with the axis.

The port's convention: a rank passes **its own shard**, q/k/v [B/dp,
T/sp, H, D] (the body JAX runs inside `shard_map`), and gets its shard
of the output; query positions follow from `mesh.coords["sp"]`. Every
rank of the axis calls with shards of one shape.

Two bodies, as in the JAX package:
- the flash body: each block through K2 (`ops.flash_attention.
  flash_attention_lse`, out and lse); the diagonal block causal,
  strictly-past blocks full, strictly-future blocks launch nothing;
  blocks merge as `m = max(lse, lse_blk)`, `w = e_blk / (e + e_blk)` in
  float32, cast to q's dtype at the end. It is one autograd Function
  over the whole ring: its backward runs the ring again, rotating k, v
  and their gradient accumulators together, and calls K3 on each block
  that ran with the merged out and lse (`flash_block_backward`: the
  delta kernel once a call). Causal, sp-rank r launches r + 1 K2
  forward and r + 1 K3 (dq + dkv) backward, and one delta kernel; full
  attention sp of each and one delta. The ring makes sp - 1 rotations
  (JAX's last `ppermute` only brings the blocks home), plus one that
  brings each block's gradient home. At sp = 1 it is one K2 launch and
  no collective.
- the dense body: the JAX package's `_ring_attention_local` (running
  max, running denominator, float32 accumulators) through autograd and
  the differentiable `ring_shift`: the plain version, for CPU tensors.

`use_flash=None` picks the flash body for a CUDA tensor and the dense
body for a CPU tensor (the JAX package picks the flash body on a TPU).
A CUDA tensor launches the kernels or raises; the dense body refuses
one. `reference_attention` is `ops.flash_attention`'s (the oracle).
k and v may carry fewer heads than q (a divisor): the flash body rotates
them at that count, the dense body repeats them.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops.flash_attention import (
    NEG_INF, flash_attention, flash_attention_lse, flash_block_backward, reference_attention,
)
from .mesh import Mesh, resolve_mesh, ring_shift

__all__ = ["ring_attention", "reference_attention"]


def _merge(out, lse, o_blk, lse_blk):
    """Fold one block's (out, lse) into the running float32 pair: the
    JAX package's two-estimate recurrence (a first block has lse = NEG_INF
    before it, so its weight is 1)."""
    m = torch.maximum(lse, lse_blk)
    a = torch.exp(lse - m)
    b = torch.exp(lse_blk - m)
    w = (b / (a + b)).transpose(1, 2)[..., None]  # [B, H, T] -> [B, T, H, 1]
    return out * (1.0 - w) + o_blk.to(torch.float32) * w, m + torch.log(a + b)


class _RingFlash(torch.autograd.Function):
    """The flash body over the whole ring, forward and backward: one
    Function, so that every rank runs every rotation of the backward (a
    rank whose last blocks were all in its future still forwards the
    others' gradients) and runs them in one order."""

    @staticmethod
    def forward(ctx, q, k, v, mesh: Mesh, axis: str, causal: bool, scale: float):
        n, me = mesh.shape[axis], mesh.coords[axis]
        b, t, h, d = q.shape
        out = torch.zeros((b, t, h, d), dtype=torch.float32, device=q.device)
        lse = torch.full((b, h, t), NEG_INF, dtype=torch.float32, device=q.device)
        kv = torch.stack([k, v])  # one message a rotation
        for i in range(n):
            if i:
                kv = ring_shift(kv, mesh, axis)
            src = (me - i) % n  # the rank the block came from
            if causal and src > me:
                continue  # strictly in the future: nothing to launch
            o_blk, lse_blk = flash_attention_lse(q, kv[0], kv[1], causal=causal and src == me,
                                                 scale=scale)
            out, lse = _merge(out, lse, o_blk, lse_blk)
        out = out.to(q.dtype)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (mesh, axis, causal, scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        mesh, axis, causal, scale = ctx.args
        n, me = mesh.shape[axis], mesh.coords[axis]
        block = flash_block_backward(q, out, lse, dout.to(q.dtype), scale=scale)
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        kv = torch.stack([k, v])
        dkv = torch.zeros((2, *k.shape), dtype=torch.float32, device=q.device)
        for i in range(n):
            if i:  # the block's gradient travels with it
                kv = ring_shift(kv, mesh, axis)
                dkv = ring_shift(dkv, mesh, axis)
            src = (me - i) % n
            if causal and src > me:
                continue
            dq_b, dk_b, dv_b = block(kv[0], kv[1], causal and src == me)
            dq += dq_b
            dkv[0] += dk_b
            dkv[1] += dv_b
        if n > 1:  # the block held last is the next rank's: send its gradient home
            dkv = ring_shift(dkv, mesh, axis)
        return dq.to(q.dtype), dkv[0].to(k.dtype), dkv[1].to(v.dtype), None, None, None, None


def _block_attn(q, k, scale, mask):
    """One block's masked scores: (m_blk [B, H, Tq], p = exp(s - m_blk)
    [B, H, Tq, Tk]); a row with no visible key gets p = 0 and m_blk =
    NEG_INF. q, k float32 [B, T, H, D], mask [Tq, Tk] bool (True keeps)."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if mask is not None:
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m_blk = s.amax(dim=-1)
    p = torch.exp(s - m_blk[..., None])
    if mask is not None:
        any_valid = mask.any(dim=-1)  # [Tq]
        p = p * any_valid[:, None].to(p.dtype)
        m_blk = torch.where(any_valid, m_blk, torch.full_like(m_blk, NEG_INF))
    return m_blk, p


def _ring_dense(q, k, v, mesh: Optional[Mesh], axis: str, causal: bool, scale: float):
    """The JAX package's dense body, differentiable through autograd."""
    n, me = (1, 0) if mesh is None else (mesh.shape[axis], mesh.coords[axis])
    b, t, h, d = q.shape
    qf = q.to(torch.float32)
    q_pos = me * t + torch.arange(t, device=q.device)
    o = torch.zeros((b, h, t, d), dtype=torch.float32, device=q.device)
    m = torch.full((b, h, t), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, t), dtype=torch.float32, device=q.device)
    kv = torch.stack([k, v])
    for i in range(n):
        if i:
            kv = ring_shift(kv, mesh, axis)
        src = (me - i) % n
        mask = None
        if causal:
            k_pos = src * t + torch.arange(t, device=q.device)
            mask = q_pos[:, None] >= k_pos[None, :]
        k_blk, v_blk = (x.repeat_interleave(h // x.shape[2], dim=2).to(torch.float32)
                        for x in kv.unbind(0))
        m_blk, p = _block_attn(qf, k_blk, scale, mask)
        m_new = torch.maximum(m, m_blk)
        alpha = torch.exp(m - m_new)
        beta = torch.exp(m_blk - m_new)
        o = o * alpha[..., None] + torch.einsum("bhqk,bkhd->bhqd", p * beta[..., None], v_blk)
        l = l * alpha + p.sum(dim=-1) * beta
        m = m_new
    out = o / l.clamp_min(1e-30)[..., None]
    return out.permute(0, 2, 1, 3).to(q.dtype)


def ring_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh, *,
    causal: bool = True, axis_name: str = "sp", scale: Optional[float] = None,
    use_flash: Optional[bool] = None,
) -> torch.Tensor:
    """Exact attention with the sequence sharded over `axis_name`: q
    [B, T/sp, H, D] and k/v [B, T/sp, KV, D] are this rank's shards (KV
    dividing H), the result is its shard of the output [B, T/sp, H, D]
    in q's dtype. `mesh` is a `parallel.mesh.Mesh` (or None: one device,
    sp = 1). `use_flash=None`: the flash body on a CUDA tensor, the dense
    body on a CPU tensor."""
    if q.ndim != 4 or k.shape != v.shape or k.shape[1] != q.shape[1]:
        raise ValueError(f"ring attention needs q [B,T,H,D] and k/v of q's length, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    mesh = resolve_mesh(mesh)
    n = 1 if mesh is None else mesh.shape[axis_name]
    if use_flash is None:
        use_flash = q.device.type != "cpu"
    if not use_flash:
        if q.device.type != "cpu":
            raise RuntimeError(f"the dense ring body is the plain version, for CPU tensors: "
                               f"a {q.device.type} tensor takes the flash body")
        return _ring_dense(q, k, v, mesh, axis_name, causal, scale)
    if n == 1:  # one block, no collective
        return flash_attention(q, k, v, causal=causal, scale=scale)
    return _RingFlash.apply(q, k, v, mesh, axis_name, causal, scale)

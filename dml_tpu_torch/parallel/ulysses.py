"""Ulysses sequence parallelism: all-to-all head<->sequence resharding
in place of the ring's key/value rotation. PyTorch counterpart of
dml_tpu/parallel/ulysses.py.

Both strategies compute exact attention over a sequence sharded on the
`sp` axis. Ulysses reshards [B, T/sp, H, D] to [B, T, H/sp, D] with one
`mesh.all_to_all`, runs the whole sequence through one attention call
for its slice of heads, and reshards back with the inverse all-to-all.
It needs the head count divisible by sp; the ring runs at any head
count. (The trade-off, and the JAX package's measurements of it on a
TPU, are in the JAX module's docstring.)

As `ring_attention`, a rank passes its own shards [B/dp, T/sp, H, D]
and gets its shard of the output; every rank of the axis calls with
shards of one shape, so T is divisible by sp by construction (the LM
checks its sequence length, `LongContextLM`).

GQA follows the JAX package's rule: k/v with fewer heads than q are
repeated to q's heads before the collective when sp == 1 or when their
head count does not divide over sp; otherwise they ride the all-to-all
at their own head count and are repeated after it. Where q, k and v
have equal head counts they go as one all-to-all.

`use_flash=None` runs the flash kernel on a CUDA tensor (K2 forward,
and through its autograd Function K3 backward: one K2 and one K3 a call,
and one delta kernel) and the float32 `reference_attention` on a CPU
tensor, as the JAX package runs its reference off the TPU;
`use_flash=True` on a CPU tensor runs the kernels' plain versions. A
CUDA tensor launches the kernels or raises. At sp == 1 there is nothing
to reshard: one local call. The backward is the attention's plus the
all-to-all's inverse.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops.flash_attention import flash_attention, reference_attention
from .mesh import all_to_all, resolve_mesh


def _attend(q, k, v, causal, scale, use_flash):
    if use_flash:
        return flash_attention(q, k, v, causal=causal, scale=scale)
    if q.device.type != "cpu":
        raise RuntimeError(f"reference_attention is the plain version, for CPU tensors: "
                           f"a {q.device.type} tensor takes the flash kernel")
    return reference_attention(q, k, v, causal=causal, scale=scale)


def ulysses_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh, *,
    causal: bool = True, axis_name: str = "sp", scale: Optional[float] = None,
    use_flash: Optional[bool] = None,
) -> torch.Tensor:
    """Exact attention with the sequence sharded over `axis_name`, two
    all-to-all reshards around one attention call: q [B, T/sp, H, D] and
    k/v [B, T/sp, KV, D] (KV dividing H) are this rank's shards, the
    result its shard of the output [B, T/sp, H, D]. ValueError when the
    heads do not divide over the axis. `mesh` is a `parallel.mesh.Mesh`
    (or None: one device, sp = 1)."""
    mesh = resolve_mesh(mesh)
    sp = 1 if mesh is None else mesh.shape[axis_name]
    h, kv_h = q.shape[2], k.shape[2]
    if h % sp:
        raise ValueError(f"ulysses needs n_heads ({h}) divisible by {axis_name} axis size "
                         f"({sp}); use ring_attention for head-poor models")
    if kv_h != h:
        if h % kv_h:
            raise ValueError(f"q heads {h} not a multiple of kv heads {kv_h}")
        if sp == 1 or kv_h % sp:
            # no reshard at all, or kv heads that do not split over sp:
            # full heads before the collective
            k = k.repeat_interleave(h // kv_h, dim=2)
            v = v.repeat_interleave(h // kv_h, dim=2)
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    if use_flash is None:
        use_flash = q.device.type != "cpu"
    if sp == 1:  # nothing to reshard: one local call
        return _attend(q, k, v, causal, scale, use_flash)

    def to_heads(x):  # [.., B, T/sp, H, D] -> [.., B, T, H/sp, D]
        return all_to_all(x, mesh, axis_name, split_dim=x.ndim - 2, concat_dim=x.ndim - 3)

    if k.shape[2] == h:
        qh, kh, vh = to_heads(torch.stack([q, k, v])).unbind(0)
    else:  # native kv heads ride the collective, repeated after it
        qh = to_heads(q)
        kh, vh = to_heads(torch.stack([k, v])).unbind(0)
        kh = kh.repeat_interleave(h // kv_h, dim=2)
        vh = vh.repeat_interleave(h // kv_h, dim=2)
    oh = _attend(qh, kh, vh, causal, scale, use_flash)
    # the inverse reshard: [B, T, H/sp, D] -> [B, T/sp, H, D]
    return all_to_all(oh, mesh, axis_name, split_dim=1, concat_dim=2)

"""Flash attention, forward: PyTorch counterpart of
dml_tpu/ops/flash_attention.py.

The TPU kernel it replaces is `dml_tpu/ops/flash_attention.py::
_fwd_kernel`; on Hopper it is the CUDA C++ kernel in
`dml_tpu_torch/csrc/flash_attention.cu` (one block per (q-tile, head,
batch) looping over k-tiles; bf16 on `mma.sync` tensor-core tiles with
f32 accumulation, f32 on plain FMAs), built with nvcc for sm_90a at
first use and called through ctypes. The source file says what bounds
it and how it is laid out. The kernel picks its own tile, so the TPU
knobs `block_q`, `block_k` and `interpret` are not part of this
signature.

`flash_attention` and `flash_attention_lse` are the kernel's wrappers.
On a CUDA tensor they launch the kernel (and count the launch in
`flash_launches`) or raise; on a CPU tensor they run the plain version,
`attention_with_lse`: full-matrix attention in float32 that rounds the
probabilities to V's dtype before P V, as the kernel does.
`reference_attention` is this module's copy of `dml_tpu/parallel/
ring_attention.py::reference_attention` (float32 throughout), the
oracle and `TransformerLM`'s default attention. The backward kernels
(K3) are not ported yet: a CUDA input that requires grad raises rather
than being silently detached.

One extension over the JAX signature: k and v may carry fewer heads
than q (KV dividing H, grouped-query attention). Query head h then reads
kv head h // (H // KV), which is what `jnp.repeat(k, H // KV, axis=2)`
gives the JAX kernel, without the copy.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

import torch

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128)
_DTYPES = (torch.bfloat16, torch.float32)

#: kernel launches since the last reset (plain int; a test or
#: chip_smoke.py zeroes it, drives a path, and reads it back)
flash_launches = 0
_count_lock = threading.Lock()


def _library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library."""
    from ._build import load_library

    lib = load_library("dml_flash_attention", ["flash_attention.cu"])
    fn = lib.dml_flash_fwd
    fn.argtypes = (
        [ctypes.c_void_p] * 5
        + [ctypes.c_int] * 7
        + [ctypes.c_longlong] * 9
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return lib


def _expand_kv(x: torch.Tensor, heads: int) -> torch.Tensor:
    """[B, T, KV, D] -> [B, T, H, D], kv head j repeated H // KV times
    (jnp.repeat's order)."""
    kv = x.shape[2]
    return x if kv == heads else x.repeat_interleave(heads // kv, dim=2)


def _attention(q, k, v, causal, scale, round_p):
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    h = q.shape[2]
    k, v = _expand_kv(k, h), _expand_kv(v, h)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        tq, tk = s.shape[-2], s.shape[-1]
        mask = torch.arange(tq, device=q.device)[:, None] >= torch.arange(tk, device=q.device)[None, :]
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    if not round_p:
        p = torch.softmax(s, dim=-1)
        return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype), None
    # the kernel's order: unnormalised p = exp(s - m) in V's dtype for
    # P V, divided by the f32 row sum l at the end
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    acc = torch.einsum("bhqk,bkhd->bhqd", p.to(v.dtype).float(), v.float())
    out = (acc / l).permute(0, 2, 1, 3)
    return out.to(q.dtype), (m + torch.log(l))[..., 0]


def attention_with_lse(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool, scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version: full-matrix attention in float32 in the
    kernel's order (and the TPU kernel's): unnormalised probabilities
    exp(s - rowmax) rounded to V's dtype for P V, then divided by their
    float32 row sum. q [B, Tq, H, D], k/v [B, Tk, KV, D] ->
    (out [B, Tq, H, D] in q's dtype, lse [B, H, Tq] f32)."""
    return _attention(q, k, v, causal, scale, round_p=True)


def reference_attention(q, k, v, *, causal: bool = True, scale=None) -> torch.Tensor:
    """Plain full-matrix attention, float32 throughout (the correctness
    oracle, and TransformerLM's default): q, k, v [B, T, H, D] ->
    [B, Tq, H, D]."""
    return _attention(q, k, v, causal, scale, round_p=False)[0]


def _check(q, k, v, causal):
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(f"expected [B,T,H,D], got {tuple(q.shape)}")
    if k.shape != v.shape or k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3]:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not fit q {tuple(q.shape)}")
    if q.shape[2] % k.shape[2]:
        raise ValueError(f"kv heads {k.shape[2]} must divide q heads {q.shape[2]}")
    if causal and q.shape[1] != k.shape[1]:
        raise ValueError("causal attention needs equal q/k lengths")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise TypeError(f"q/k/v must share bfloat16 or float32, got {q.dtype}/{k.dtype}/{v.dtype}")


def _kernel_view(x: torch.Tensor) -> torch.Tensor:
    """x itself if the kernel can read it through strides (unit last
    stride, 16-byte aligned rows), else a contiguous copy."""
    vec = 16 // x.element_size()
    ok = (x.stride(3) == 1 and x.data_ptr() % 16 == 0
          and all(s % vec == 0 for s in x.stride()[:3]))
    return x if ok else x.contiguous()


def _flash_cuda(q, k, v, causal, scale):
    global flash_launches
    if any(t.requires_grad for t in (q, k, v)) and torch.is_grad_enabled():
        raise NotImplementedError(
            "flash attention backward (K3) is not ported yet (ROADMAP B, K3): "
            "call under torch.no_grad() or on tensors that do not require grad"
        )
    b, tq, h, d = q.shape
    tk, kv = k.shape[1], k.shape[2]
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} not supported by the kernel (one of {HEAD_DIMS})")
    if not (k.device == v.device == q.device):
        raise ValueError("q, k and v must be on one device")
    q, k, v = _kernel_view(q), _kernel_view(k), _kernel_view(v)
    out = torch.empty((b, tq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.dml_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
            int(q.dtype == torch.bfloat16), b, h, h // kv, tq, tk, d,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            float(scale), int(causal), stream,
        )
    if err != 0:
        raise RuntimeError(f"flash attention kernel launch failed: cudaError {err}")
    with _count_lock:
        flash_launches += 1
    return out, lse


def flash_attention_lse(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool = False, scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flash attention that also returns the per-row log-sum-exp.
    q [B, Tq, H, D], k/v [B, Tk, KV, D] -> (out [B, Tq, H, D] in q's
    dtype, lse [B, H, Tq] f32). The kernel on a CUDA tensor, the plain
    version on a CPU tensor."""
    _check(q, k, v, causal)
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    if q.device.type == "cpu":
        return attention_with_lse(q, k, v, causal=causal, scale=scale)
    if q.device.type != "cuda":
        raise RuntimeError(f"no flash attention kernel for device {q.device}")
    return _flash_cuda(q, k, v, causal, scale)


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool = True, scale: Optional[float] = None,
) -> torch.Tensor:
    """Blockwise (flash) attention. q [B, Tq, H, D], k/v [B, Tk, KV, D]
    (Tk may differ from Tq when not causal); returns [B, Tq, H, D] in
    q's dtype."""
    return flash_attention_lse(q, k, v, causal=causal, scale=scale)[0]

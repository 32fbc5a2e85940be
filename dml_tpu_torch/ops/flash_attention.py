"""Flash attention, forward and backward: PyTorch counterpart of
dml_tpu/ops/flash_attention.py.

The TPU kernels it replaces are `dml_tpu/ops/flash_attention.py::
_fwd_kernel` (K2) and the backward pair `_bwd_dq_kernel` and
`_bwd_dkv_kernel` (K3). On Hopper they are the CUDA C++ kernels in
`dml_tpu_torch/csrc/flash_attention.cu` and `csrc/flash_attention_bwd.cu`,
built with nvcc for sm_90a at first use and called through ctypes.

The forward's route follows from the dtype and the head dim alone
(`kernel_route`): bf16 at D 64 and 128, every main-path shape, runs the
warp-specialized kernel (a TMA producer streaming K and V tiles through a
shared-memory ring, two or three consumer warpgroups on `wgmma`, P kept
in registers); bf16 at D 16 and 32 runs the `mma.sync` kernel; float32
runs plain FMAs. The backward (the TPU's two-kernel split: dq over k-tiles,
dk and dv over q-tiles, no atomics) is bf16 `mma.sync` and f32 FMAs. The
source files say what bounds each kernel and how it is laid out. The
kernels pick their own tiles, so the TPU knobs `block_q`, `block_k` and
`interpret` are not part of these signatures.

`flash_attention` and `flash_attention_lse` are the forward kernel's
wrappers. On a CUDA tensor they launch the kernel (and count the launch
in `flash_launches`) or raise; on a CPU tensor they run the plain
version, `attention_with_lse`: full-matrix attention in float32 that
rounds the probabilities to V's dtype before P V, as the kernel does.
When grad is enabled and an input requires it, both go through one
`torch.autograd.Function` (the custom VJPs `_flash` and `_flash_lse`),
whose backward is `flash_attention_backward`: K3 on a CUDA tensor
(counted in `flash_bwd_launches`, one per backward), the plain
`attention_backward` on a CPU tensor. An lse output that gets no
gradient passes nothing to the backward, as the JAX code leaves its
g_lse stream out of the kernels. `reference_attention` is this module's
copy of `dml_tpu/parallel/ring_attention.py::reference_attention`
(float32 throughout), the oracle and `TransformerLM`'s default
attention.

One extension over the JAX signature: k and v may carry fewer heads
than q (KV dividing H, grouped-query attention). Query head h then reads
kv head h // (H // KV), which is what `jnp.repeat(k, H // KV, axis=2)`
gives the JAX kernel, without the copy; the backward sums each group's
dk and dv, which is the repeat's gradient.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

import torch

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128)
_DTYPES = (torch.bfloat16, torch.float32)

#: kernel launches since the last reset (plain ints; a test or
#: chip_smoke.py zeroes them, drives a path, and reads them back):
#: forward launches, and backward launches (the dq and dkv kernels of
#: one backward count once)
flash_launches = 0
flash_bwd_launches = 0
_count_lock = threading.Lock()


def _library() -> ctypes.CDLL:
    """Build (at first use) and load the forward kernel's library."""
    from ._build import load_library

    lib = load_library("dml_flash_attention", ["flash_attention.cu"])
    for fn in (lib.dml_flash_fwd, lib.dml_flash_fwd_mma):
        fn.argtypes = (
            [ctypes.c_void_p] * 5
            + [ctypes.c_int] * 7
            + [ctypes.c_longlong] * 9
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
    return lib


def kernel_route(dtype: torch.dtype, head_dim: int) -> str:
    """The forward kernel that `dml_flash_fwd` launches for (dtype, D),
    as the C entry point picks it: "wgmma+tma" for bf16 at D 64 and 128,
    "mma.sync" for bf16 at D 16 and 32, "fma" for float32."""
    if dtype not in _DTYPES or head_dim not in HEAD_DIMS:
        raise ValueError(f"no flash attention kernel for {dtype} at head_dim {head_dim}")
    if dtype == torch.float32:
        return "fma"
    return "wgmma+tma" if head_dim in (64, 128) else "mma.sync"


def _bwd_library() -> ctypes.CDLL:
    """Build (at first use) and load the backward kernels' library."""
    from ._build import load_library

    lib = load_library("dml_flash_attention_bwd", ["flash_attention_bwd.cu"])
    fn = lib.dml_flash_bwd
    fn.argtypes = (
        [ctypes.c_void_p] * 10
        + [ctypes.c_int] * 7
        + [ctypes.c_longlong] * 12
        + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return lib


def _expand_kv(x: torch.Tensor, heads: int) -> torch.Tensor:
    """[B, T, KV, D] -> [B, T, H, D], kv head j repeated H // KV times
    (jnp.repeat's order)."""
    kv = x.shape[2]
    return x if kv == heads else x.repeat_interleave(heads // kv, dim=2)


def _scores(q, k, causal, scale):
    """s = q k^T * scale in float32 [B, H, Tq, Tk] over kv heads
    expanded to q's, causal positions masked with NEG_INF."""
    k = _expand_kv(k, q.shape[2])
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        tq, tk = s.shape[-2], s.shape[-1]
        mask = torch.arange(tq, device=q.device)[:, None] >= torch.arange(tk, device=q.device)[None, :]
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    return s


def _attention(q, k, v, causal, scale, round_p):
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    s = _scores(q, k, causal, scale)
    v = _expand_kv(v, q.shape[2])
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


def _delta(out: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO * O) in float32, [B, Tq, H, D] -> [B, H, Tq]
    (the JAX package computes it outside its kernels too)."""
    return (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


def attention_backward(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
    lse: torch.Tensor, dout: torch.Tensor, dlse: Optional[torch.Tensor] = None, *,
    causal: bool, scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward's plain version: recomputation from the saved lse in
    float32, rounded where the TPU kernels round. p = exp(s - lse),
    dp = dO V^T, ds = p (dp - delta [+ dlse]) scale; dv = p^T dO with p
    in dO's dtype, dk = ds^T Q with ds in Q's dtype, dq = ds K with ds in
    K's dtype. q/out/dout [B, Tq, H, D], k/v [B, Tk, KV, D], lse/dlse
    [B, H, Tq] f32 -> (dq, dk, dv) in q's, k's and v's dtypes; a grouped
    k/v gets its group's sum."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    b, tk, kv, d = k.shape
    p = torch.exp(_scores(q, k, causal, scale) - lse[..., None])
    dof = dout.float()
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, _expand_kv(v, q.shape[2]).float())
    row = dp - _delta(out, dout)[..., None]
    if dlse is not None:
        row = row + dlse.float()[..., None]
    ds = p * row * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(dout.dtype).float(), dof)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(q.dtype).float(), q.float())
    dq = torch.einsum("bhqk,bkhd->bqhd", ds.to(k.dtype).float(), _expand_kv(k, q.shape[2]).float())
    if kv != q.shape[2]:
        dk = dk.reshape(b, tk, kv, -1, d).sum(3)
        dv = dv.reshape(b, tk, kv, -1, d).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


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
    """x itself if the kernels can read it through strides (unit last
    stride, a 16-byte aligned base, 16-byte multiples for the other
    strides, none of them 0 where the dim is longer than 1: what a TMA
    tensor map takes), else a contiguous copy in a new allocation (for a
    contiguous x at a misaligned offset, `x.contiguous()` would be x)."""
    vec = 16 // x.element_size()
    ok = (x.stride(3) == 1 and x.data_ptr() % 16 == 0
          and all(s % vec == 0 and (s > 0 or n == 1) for s, n in zip(x.stride()[:3], x.shape[:3])))
    return x if ok else x.clone(memory_format=torch.contiguous_format)


def _check_cuda(q, k, v):
    if q.shape[3] not in HEAD_DIMS:
        raise ValueError(f"head_dim {q.shape[3]} not supported by the kernel (one of {HEAD_DIMS})")
    if not (k.device == v.device == q.device):
        raise ValueError("q, k and v must be on one device")


def _flash_cuda(q, k, v, causal, scale, mma_sync=False):
    """Launch K2 on the current stream; returns (out, lse). `mma_sync`
    runs the mma.sync kernel whatever D is (to time it beside the
    wgmma route); the wrappers never pass it. Counts one launch."""
    global flash_launches
    _check_cuda(q, k, v)
    b, tq, h, d = q.shape
    tk, kv = k.shape[1], k.shape[2]
    q, k, v = _kernel_view(q), _kernel_view(k), _kernel_view(v)
    out = torch.empty((b, tq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        fn = lib.dml_flash_fwd_mma if mma_sync else lib.dml_flash_fwd
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
            int(q.dtype == torch.bfloat16), b, h, h // kv, tq, tk, d,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            float(scale), int(causal), stream,
        )
    if err != 0:
        raise RuntimeError(f"flash attention kernel launch failed: error {err} "
                           "(a cudaError, or 10000 + the CUresult of a tensor map)")
    with _count_lock:
        flash_launches += 1
    return out, lse


def _flash_bwd_cuda(q, k, v, dout, lse, delta, dlse, causal, scale, parts=3):
    """Launch K3: the dq kernel (parts & 1) and the dkv kernel (parts &
    2) on the current stream; returns (dq, dk, dv), a part not launched
    left unwritten. Counts one backward launch."""
    global flash_bwd_launches
    _check_cuda(q, k, v)
    b, tq, h, d = q.shape
    tk, kv = k.shape[1], k.shape[2]
    if dout.shape != q.shape or dout.dtype != q.dtype or dout.device != q.device:
        raise ValueError(f"dout {dout.dtype} {tuple(dout.shape)} does not fit q {q.dtype} {tuple(q.shape)}")
    rows = [lse, delta] + ([] if dlse is None else [dlse])
    if any(r.shape != (b, h, tq) or r.dtype != torch.float32 or r.device != q.device for r in rows):
        raise ValueError(f"lse/delta/dlse must be float32 [B, H, Tq] = {(b, h, tq)} on {q.device}")
    q, k, v, dout = (_kernel_view(x) for x in (q, k, v, dout))
    lse, delta = lse.contiguous(), delta.contiguous()
    dlse = None if dlse is None else dlse.contiguous()
    dq = torch.empty((b, tq, h, d), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, tk, kv, d), dtype=k.dtype, device=q.device)
    dv = torch.empty((b, tk, kv, d), dtype=v.dtype, device=q.device)
    lib = _bwd_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.dml_flash_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), None if dlse is None else dlse.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            int(q.dtype == torch.bfloat16), b, h, kv, tq, tk, d,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            dout.stride(0), dout.stride(1), dout.stride(2),
            float(scale), int(causal), int(parts), stream,
        )
    if err != 0:
        raise RuntimeError(f"flash attention backward kernel launch failed: cudaError {err}")
    with _count_lock:
        flash_bwd_launches += 1
    return dq, dk, dv


def flash_attention_backward(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
    lse: torch.Tensor, dout: torch.Tensor, dlse: Optional[torch.Tensor] = None, *,
    causal: bool, scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernels' wrapper: (dq, dk, dv) of attention given
    the forward's (out, lse), the out cotangent `dout` and, for the lse
    variant, the lse cotangent `dlse` (None when lse gets no gradient).
    K3 on a CUDA tensor (delta = rowsum(dO * O) as a torch expression,
    then the dq and dkv kernels), the plain version on a CPU tensor."""
    _check(q, k, v, causal)
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    if q.device.type == "cpu":
        return attention_backward(q, k, v, out, lse, dout, dlse, causal=causal, scale=scale)
    if q.device.type != "cuda":
        raise RuntimeError(f"no flash attention kernel for device {q.device}")
    return _flash_bwd_cuda(q, k, v, dout, lse, _delta(out, dout), dlse, causal, scale)


def _forward(q, k, v, causal, scale):
    if q.device.type == "cpu":
        return attention_with_lse(q, k, v, causal=causal, scale=scale)
    if q.device.type != "cuda":
        raise RuntimeError(f"no flash attention kernel for device {q.device}")
    return _flash_cuda(q, k, v, causal, scale)


class _FlashAttention(torch.autograd.Function):
    """Flash attention with its backward: the counterpart of the JAX
    package's custom VJPs `_flash` and `_flash_lse` (one Function serves
    both: `flash_attention` keeps only `out`, and an output that gets no
    gradient reaches the backward as None)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        ctx.set_materialize_grads(False)
        out, lse = _forward(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out, lse

    @staticmethod
    def backward(ctx, dout, dlse):
        q, k, v, out, lse = ctx.saved_tensors
        if dout is None:  # only lse reached the loss
            dout = torch.zeros_like(out)
        dq, dk, dv = flash_attention_backward(q, k, v, out, lse, dout, dlse,
                                              causal=ctx.causal, scale=ctx.scale)
        return dq, dk, dv, None, None


def flash_attention_lse(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool = False, scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flash attention that also returns the per-row log-sum-exp.
    q [B, Tq, H, D], k/v [B, Tk, KV, D] -> (out [B, Tq, H, D] in q's
    dtype, lse [B, H, Tq] f32). The kernel on a CUDA tensor, the plain
    version on a CPU tensor; differentiable in both outputs."""
    _check(q, k, v, causal)
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, causal, scale)
    return _forward(q, k, v, causal, scale)


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool = True, scale: Optional[float] = None,
) -> torch.Tensor:
    """Blockwise (flash) attention. q [B, Tq, H, D], k/v [B, Tk, KV, D]
    (Tk may differ from Tq when not causal); returns [B, Tq, H, D] in
    q's dtype."""
    return flash_attention_lse(q, k, v, causal=causal, scale=scale)[0]

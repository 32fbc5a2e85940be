"""Decode-step attention over the KV cache: PyTorch counterpart of
dml_tpu/ops/decode_attention.py.

The TPU kernel it replaces is `dml_tpu/ops/decode_attention.py::
_decode_kernel`; on Hopper it is the CUDA C++ pair in
`dml_tpu_torch/csrc/decode_attention.cu` (a split-T partial kernel and a
small merge kernel), built with nvcc for sm_90a at first use and called
through ctypes. The source file says what bounds it and how it is laid
out.

`decode_attention` is the wrapper. On a CUDA tensor it launches the
kernels (and counts one launch of the pair in `decode_launches`) or
raises; on a CPU tensor it runs the plain version, `decode_attention_
plain`: the float32 einsum of `dml_tpu/inference/generate.py::
batched_decode_step` (`:369-376`), which is also what the JAX package
runs off the TPU. Every cache form goes to the kernel on CUDA (bf16,
f32, int8; MHA, GQA, MQA): there is no switch.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import torch

NEG_INF = -1e30
MAX_GROUP = 16    # query heads per kv head the kernel takes
MAX_CHUNK = 128   # cache rows per block at most (the kernel's shared-memory tile)
HEAD_DIMS = (16, 32, 64, 128)
_CACHE_KINDS = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}

#: kernel launches since the last reset (plain int; a test or
#: chip_smoke.py zeroes it, drives a path, and reads it back)
decode_launches = 0
_count_lock = threading.Lock()
_sm_count = {}


def _library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library."""
    from ._build import load_library

    lib = load_library("dml_decode_attention", ["decode_attention.cu"])
    fn = lib.dml_decode_attention
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def decode_attention_plain(q, k, v, pos, *, k_scale=None, v_scale=None, scale=None):
    """The plain version: f32 einsum over the (dequantized) cache.
    Same arguments and result as `decode_attention`."""
    b, _, h, d = q.shape
    kv, t = k.shape[1], k.shape[2]
    grp = h // kv
    scale = d ** -0.5 if scale is None else scale
    ck, cv = k.float(), v.float()
    if k_scale is not None:  # [B, KV, 1, T] -> per-row [B, KV, T, 1]
        ck = ck * k_scale.transpose(2, 3)
        cv = cv * v_scale.transpose(2, 3)
    valid = torch.arange(t, device=q.device)[None, :] <= pos.to(q.device)[:, None]  # [B, T]
    qg = q.float().reshape(b, 1, kv, grp, d)
    s = torch.einsum("bqkgd,bktd->bkgqt", qg, ck) * scale
    s = torch.where(valid[:, None, None, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqt,bktd->bqkgd", p, cv)
    return out.reshape(b, 1, h, d)


def _split(batch: int, kv: int, t: int, device) -> tuple:
    """(rows per block, blocks along T): at least four blocks per SM over
    the whole grid, at most MAX_CHUNK and at least 16 rows per block."""
    if device not in _sm_count:
        _sm_count[device] = torch.cuda.get_device_properties(device).multi_processor_count
    want = -(-4 * _sm_count[device] // (batch * kv))
    n_split = min(max(-(-t // MAX_CHUNK), want), -(-t // 16))
    chunk = -(-t // n_split)
    return chunk, -(-t // chunk)


def _decode_cuda(q, k, v, pos, k_scale, v_scale, scale):
    global decode_launches
    b, _, h, d = q.shape
    kv, t = k.shape[1], k.shape[2]
    g = h // kv
    if g > MAX_GROUP:
        raise ValueError(f"{g} query heads per kv head; the kernel takes at most {MAX_GROUP}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} not supported by the kernel (one of {HEAD_DIMS})")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    tensors = [q, k, v, pos] + ([k_scale, v_scale] if k_scale is not None else [])
    if any(x.device != q.device for x in tensors):
        raise ValueError("q, the cache, its scales and pos must be on one device")
    if not all(x.is_contiguous() for x in (k, v) + ((k_scale, v_scale) if k_scale is not None else ())):
        raise ValueError("decode_attention needs a contiguous cache (init_cache's layout)")
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("decode_attention needs a 16-byte aligned cache")
    quantized = k_scale is not None
    if quantized and (k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32):
        raise TypeError("int8 cache scales must be float32")
    q = q.contiguous()
    pos = pos.to(torch.int32).contiguous()
    chunk, n_split = _split(b, kv, t, q.device)
    o_part = torch.empty((b, kv, n_split, g, d), dtype=torch.float32, device=q.device)
    m_part = torch.empty((b, kv, n_split, g), dtype=torch.float32, device=q.device)
    l_part = torch.empty_like(m_part)
    out = torch.empty((b, 1, h, d), dtype=torch.float32, device=q.device)
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.dml_decode_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            k_scale.data_ptr() if quantized else None,
            v_scale.data_ptr() if quantized else None,
            pos.data_ptr(), o_part.data_ptr(), m_part.data_ptr(), l_part.data_ptr(),
            out.data_ptr(), _CACHE_KINDS[k.dtype], int(q.dtype == torch.bfloat16),
            b, kv, g, t, d, chunk, n_split, float(scale), stream,
        )
    if err != 0:
        raise RuntimeError(f"decode attention kernel launch failed: cudaError {err}")
    with _count_lock:
        decode_launches += 1
    return out


def decode_attention(
    q: torch.Tensor,  # [B, 1, H, D]
    k: torch.Tensor,  # [B, KV, T, D] cache (bf16/f32, or int8 with scales)
    v: torch.Tensor,
    pos: torch.Tensor,  # [B] int: slot b attends cache rows <= pos[b]
    *,
    k_scale: Optional[torch.Tensor] = None,  # [B, KV, 1, T] f32 (int8 cache)
    v_scale: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """One decode step of cache attention; returns f32 [B, 1, H, D].

    The cache is head-major ([B, KV, T, D], `init_cache`'s layout), H =
    KV * G with kv-major head order (head h = kv * G + g). Pass
    `k_scale`/`v_scale` to read an int8 cache. The kernel on a CUDA
    tensor, the plain version on a CPU tensor."""
    if q.ndim != 4 or q.shape[1] != 1:
        raise ValueError(f"decode q must be [B,1,H,D], got {tuple(q.shape)}")
    b, _, h, d = q.shape
    if k.ndim != 4 or k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"cache {tuple(k.shape)} / {tuple(v.shape)} does not fit q {tuple(q.shape)}")
    if h % k.shape[1]:
        raise ValueError(f"H {h} not divisible by KV {k.shape[1]}")
    if (k_scale is None) != (v_scale is None):
        raise ValueError("pass both k_scale and v_scale or neither")
    if (k_scale is not None) != (k.dtype == torch.int8):
        raise TypeError("an int8 cache needs k_scale/v_scale, and only an int8 cache takes them")
    if k.dtype not in _CACHE_KINDS or v.dtype != k.dtype:
        raise TypeError(f"cache dtype must be one of {list(_CACHE_KINDS)}, got {k.dtype}/{v.dtype}")
    if k_scale is not None and tuple(k_scale.shape) != (b, k.shape[1], 1, k.shape[2]):
        raise ValueError(f"scales must be [B, KV, 1, T], got {tuple(k_scale.shape)}")
    if tuple(pos.shape) != (b,):
        raise ValueError(f"pos must be [B], got {tuple(pos.shape)}")
    scale = d ** -0.5 if scale is None else scale
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, pos, k_scale=k_scale, v_scale=v_scale, scale=scale)
    if q.device.type != "cuda":
        raise RuntimeError(f"no decode attention kernel for device {q.device}")
    return _decode_cuda(q, k, v, pos, k_scale, v_scale, scale)

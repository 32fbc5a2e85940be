"""Decode-step attention over the KV cache: PyTorch counterpart of
dml_tpu/ops/decode_attention.py.

The TPU kernel it replaces is `dml_tpu/ops/decode_attention.py::
_decode_kernel`; on Hopper it is `decode_kernel` in
`dml_tpu_torch/csrc/decode_attention.cu`, one launch per call: bulk
asynchronous loads of each block's contiguous span of the cache, the
scores, softmax and P V per warp in registers, and the merge of the
splits folded into the last block of each (b, kv) plane. The source file
says what bounds it and how it is laid out. It is built with nvcc for
sm_90a at first use and called through ctypes.

`decode_attention` is the wrapper. On a CUDA tensor it launches the
kernel (and counts one launch in `decode_launches`) or raises; on a CPU
tensor it runs the plain version, `decode_attention_plain`: the float32
einsum of `dml_tpu/inference/generate.py::batched_decode_step`
(`:369-376`), which is also what the JAX package runs off the TPU. Every
cache form goes to the kernel on CUDA (bf16, f32, int8; MHA, GQA, MQA):
there is no switch. `split_plan` sizes the grid; it is a pure function
of the shapes and the SM count, so the CPU tests hold it to its rules.

`_decode_cuda(..., split_pair=True)` runs the first Hopper version
instead (a split kernel and a merge kernel, two launches), and
`_decode_cuda(..., ahead=...)` sets how many K and V sub-tiles a block of
the new kernel keeps in flight (AHEAD; ISSUE_ALL issues its whole chunk
at block start); only chip_smoke.py passes either, to time the
alternatives in turns on one card.
"""

from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple, Optional

import torch

NEG_INF = -1e30
MAX_GROUP = 16    # query heads per kv head the kernel takes
HEAD_DIMS = (16, 32, 64, 128)
_CACHE_KINDS = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}

# the one-launch kernel's plan (mirrors csrc/decode_attention.cu)
SUB_ROWS = 32            # rows per bulk sub-tile; chunks are multiples of it
MAX_CHUNK = 1024         # rows per block at most
CHUNK_BYTES = 64 << 10   # K + V bytes per block at most
MAX_SPLIT = 64           # splits a plane is cut into for parallelism alone
MERGE_BYTES = 64 << 10   # partials of one plane, read by its last block
SMEM_PER_SM = 228 << 10  # H100: shared memory of an SM, 1 KB of it reserved per block
MAX_BLOCKS_PER_SM = 4    # a residency the registers allow (128 threads, <= 128 registers)
AHEAD = 2                # K and V sub-tiles a block keeps in flight
ISSUE_ALL = MAX_CHUNK // SUB_ROWS  # an `ahead` that issues a block's whole chunk at once
THREADS, WARPS = 128, 4
# the first version's tile (csrc/decode_attention.cu::split_pair)
SPLIT_PAIR_ROWS = 128

#: kernel launches since the last reset (plain int; a test or
#: chip_smoke.py zeroes it, drives a path, and reads it back)
decode_launches = 0
_count_lock = threading.Lock()
_sm_count = {}
_workspace = {}  # (device index, stream) -> int32 counters, zero between calls
_workspace_lock = threading.Lock()


def _library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library."""
    from ._build import load_library

    lib = load_library("dml_decode_attention", ["decode_attention.cu"])
    fn = lib.dml_decode_attention
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 10 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn = lib.dml_decode_attention_split
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


class Plan(NamedTuple):
    chunk: int          # rows per block (a multiple of SUB_ROWS)
    n_split: int        # blocks along T per (b, kv) plane
    smem_bytes: int     # dynamic shared memory per block
    blocks_per_sm: int  # blocks an SM holds at once at that size


def smem_bytes(chunk: int, d: int, itemsize: int, quantized: bool) -> int:
    """Dynamic shared memory of one block: csrc/decode_attention.cu::layout."""
    gt = 8 if itemsize == 4 else 4  # query heads per warp
    return (2 * chunk * d * itemsize + (2 * (chunk + 4) * 4 if quantized else 0)
            + WARPS * gt * d * 4 + 2 * WARPS * gt * 4 + THREADS * 8 + THREADS * 16 + 16
            + (chunk // SUB_ROWS + 1) * 16)


def split_plan(b: int, kv: int, t: int, d: int, g: int, itemsize: int, quantized: bool,
               n_sm: int) -> Plan:
    """The one-launch kernel's grid: block (split, kv, b) owns rows
    [split * chunk, (split + 1) * chunk) of its plane, cut short at
    pos[b] by the kernel. The chunk is sized by bytes (at most
    CHUNK_BYTES of K + V, at most MAX_CHUNK rows, a multiple of
    SUB_ROWS); within that, the plane is cut into as many splits as keep
    the whole grid resident in one wave (at most MAX_SPLIT, at least one
    sub-tile each), so every SM holds a similar share of the bytes, and
    no more than keep a plane's partials (G * D floats a split) within
    MERGE_BYTES, which the plane's last block reads alone. When
    even the fewest splits the byte budget allows overflow one wave
    (long contexts at large B * KV), the plan takes those fewest."""
    row = 2 * d * itemsize + (8 if quantized else 0)
    max_rows = min(MAX_CHUNK, CHUNK_BYTES // row // SUB_ROWS * SUB_ROWS)
    min_split = -(-t // max_rows)

    def per_sm(chunk):
        return min(MAX_BLOCKS_PER_SM, SMEM_PER_SM // (smem_bytes(chunk, d, itemsize, quantized) + 1024))

    slots = n_sm * per_sm(max_rows)  # at the largest block: conservative
    want = max(min_split, min(slots // (b * kv), -(-t // SUB_ROWS), MAX_SPLIT,
                              max(1, MERGE_BYTES // (g * d * 4))))
    chunk = -(-(-(-t // want)) // SUB_ROWS) * SUB_ROWS
    n_split = -(-t // chunk)
    return Plan(chunk, n_split, smem_bytes(chunk, d, itemsize, quantized), per_sm(chunk))


def _sms(device) -> int:
    if device not in _sm_count:
        _sm_count[device] = torch.cuda.get_device_properties(device).multi_processor_count
    return _sm_count[device]


def _counters(device, stream: int, n: int) -> torch.Tensor:
    """The ticket counters of (device, stream): zeroed once, left zero by
    every call, grown (zeroed again) when B * KV outgrows them."""
    key = (device.index, stream)
    with _workspace_lock:
        ws = _workspace.get(key)
        if ws is None or ws.numel() < n:
            ws = torch.zeros(max(n, 2 * ws.numel() if ws is not None else 64), dtype=torch.int32,
                             device=device)
            _workspace[key] = ws
        return ws


def _split_pair_plan(batch: int, kv: int, t: int, device) -> tuple:
    """The first version's (rows per block, blocks along T): at least
    four blocks per SM over the whole grid, at most SPLIT_PAIR_ROWS and
    at least 16 rows per block."""
    want = -(-4 * _sms(device) // (batch * kv))
    n_split = min(max(-(-t // SPLIT_PAIR_ROWS), want), -(-t // 16))
    chunk = -(-t // n_split)
    return chunk, -(-t // chunk)


def _decode_cuda(q, k, v, pos, k_scale, v_scale, scale, split_pair=False, ahead=AHEAD):
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
    if quantized and (k_scale.data_ptr() % 16 or v_scale.data_ptr() % 16):
        raise ValueError("decode_attention needs 16-byte aligned cache scales")
    # the kernel reads a contiguous q in 8- or 16-byte vectors
    if not q.is_contiguous() or q.data_ptr() % 16:
        q = q.clone(memory_format=torch.contiguous_format)
    pos = pos.to(torch.int32).contiguous()
    out = torch.empty((b, 1, h, d), dtype=torch.float32, device=q.device)
    if split_pair:
        chunk, n_split = _split_pair_plan(b, kv, t, q.device)
    else:
        plan = split_plan(b, kv, t, d, g, k.element_size(), quantized, _sms(q.device))
        chunk, n_split = plan.chunk, plan.n_split
    o_part = torch.empty((b, kv, n_split, g, d), dtype=torch.float32, device=q.device)
    m_part = torch.empty((b, kv, n_split, g), dtype=torch.float32, device=q.device)
    l_part = torch.empty_like(m_part)
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                k_scale.data_ptr() if quantized else None,
                v_scale.data_ptr() if quantized else None,
                pos.data_ptr(), o_part.data_ptr(), m_part.data_ptr(), l_part.data_ptr())
        kind, q_bf16 = _CACHE_KINDS[k.dtype], int(q.dtype == torch.bfloat16)
        if split_pair:
            err = lib.dml_decode_attention_split(
                *ptrs, out.data_ptr(), kind, q_bf16, b, kv, g, t, d, chunk, n_split,
                float(scale), stream)
        else:
            counters = _counters(q.device, stream, b * kv)
            err = lib.dml_decode_attention(
                *ptrs, counters.data_ptr(), out.data_ptr(), kind, q_bf16, b, kv, g, t, d, chunk,
                n_split, ahead, float(scale), stream)
            if err != 0:
                counters.zero_()  # a launch that failed may have left tickets behind
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

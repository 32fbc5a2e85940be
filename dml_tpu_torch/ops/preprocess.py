"""Fused image normalize: uint8 ingest -> model dtype, one pass.

PyTorch counterpart of dml_tpu/ops/preprocess.py. The TPU kernel it
replaces is `dml_tpu/ops/preprocess.py::_normalize_kernel`; on Hopper it
is the CUDA C++ kernel in `dml_tpu_torch/csrc/normalize.cu`, built with
nvcc for sm_90a at first use and called through ctypes. The source file
says what bounds it (device-memory bytes) and how it is laid out.

`fused_normalize` is the kernel's wrapper, reached by `normalize` (the
engine's forward) and `normalize_sharded` (the Trainer's step and
evaluate). On a CUDA tensor it launches
the kernel (and counts the launch in `normalize_launches`) or raises; on
a CPU tensor it runs the plain PyTorch version,
`models.preprocess.normalize_on_device`, as the JAX package pairs its
kernel with the same function. `launch_plan` is the grid the kernel
runs on, and `_aligned_input` the 16-byte alignment its vector loads
need; both are plain Python.
"""

from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple

import torch

from ..models.preprocess import normalize_on_device

_MODES = {"caffe": 0, "tf": 1, "unit": 2}
_OUT_DTYPES = (torch.bfloat16, torch.float32)

#: kernel launches since the last reset (plain int; a test or
#: chip_smoke.py zeroes it, drives a path, and reads it back)
normalize_launches = 0
_count_lock = threading.Lock()


#: a block's threads (4 warps) and a vector group's pixels
#: (csrc/normalize.cu kThreads, kGroup)
THREADS = 128
GROUP = 16


class LaunchPlan(NamedTuple):
    """The kernel's grid for `n_pixels` pixels, as the C entry
    `dml_normalize_u8` computes it: lane l of warp w < tile_warps converts
    group 32 w + l below `groups` (16 pixels each); lane l < tail of warp
    tile_warps converts pixel 16 * groups + l."""

    groups: int
    tail: int
    tile_warps: int
    blocks: int


def launch_plan(n_pixels: int) -> LaunchPlan:
    groups, tail = divmod(n_pixels, GROUP)
    tile_warps = -(-groups // 32)
    warps = tile_warps + (tail > 0)
    return LaunchPlan(groups, tail, tile_warps, -(-warps // (THREADS // 32)))


def _aligned_input(x: torch.Tensor) -> torch.Tensor:
    """x itself if its base is 16-byte aligned (a fresh allocation always
    is), else a copy in a new allocation: a contiguous view such as x[1:]
    of a [N,299,299,3] batch starts 268,203 bytes in, where the kernel's
    16-byte loads cannot read."""
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library."""
    from ._build import load_library

    lib = load_library("dml_normalize", ["normalize.cu"])
    lib.dml_normalize_u8.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.dml_normalize_u8.restype = ctypes.c_int
    return lib


def normalize(
    x: torch.Tensor, mode: str, dtype: torch.dtype = torch.bfloat16
) -> torch.Tensor:
    """Product entry point (the engine's forward calls it): the Hopper
    kernel on a CUDA tensor, plain PyTorch on a CPU tensor."""
    return fused_normalize(x, mode, dtype)


def normalize_sharded(
    x: torch.Tensor, mode: str, dtype: torch.dtype = torch.bfloat16, mesh=None
) -> torch.Tensor:
    """`normalize` for the mesh paths (the Trainer's step and evaluate),
    per rank: each rank normalizes its own batch shard, as the JAX
    package wraps its kernel in `shard_map` over the dp axis. On one
    device (`mesh` None or of size 1) that is `fused_normalize` on the
    local batch: K1 on a CUDA tensor, the plain version on a CPU tensor.
    A mesh of more than one device raises NotImplementedError."""
    from ..parallel import mesh_size

    if mesh_size(mesh) > 1:
        raise NotImplementedError(
            "normalize_sharded over a mesh of more than one device (one batch shard "
            "per rank) is not ported yet: ROADMAP A5 (multi-GPU forms)"
        )
    return fused_normalize(x, mode, dtype)


def fused_normalize(
    x: torch.Tensor, mode: str, dtype: torch.dtype = torch.bfloat16
) -> torch.Tensor:
    """uint8 [N, H, W, 3] -> normalized `dtype` [N, H, W, 3] (same modes
    as `normalize_on_device`: "caffe", "tf", "unit", "raw"). The output
    is contiguous NHWC, so `out.permute(0, 3, 1, 2)` is a channels-last
    NCHW tensor with no copy."""
    if mode == "raw":
        return x.to(dtype)
    if mode not in _MODES:
        raise ValueError(f"unknown preprocess mode {mode!r}")
    if x.ndim != 4 or x.shape[-1] != 3:
        raise ValueError(f"expected [N,H,W,3], got {tuple(x.shape)}")
    if x.dtype != torch.uint8:
        raise TypeError(f"expected uint8 input, got {x.dtype}")
    if dtype not in _OUT_DTYPES:
        raise TypeError(f"output dtype must be bfloat16 or float32, got {dtype}")
    if x.device.type == "cpu":
        return normalize_on_device(x, mode, dtype)
    if x.device.type != "cuda":
        raise RuntimeError(f"no normalize kernel for device {x.device}")
    if not x.is_contiguous():
        raise ValueError("fused_normalize needs a contiguous input")
    return _normalize_cuda(x, mode, dtype)


def _normalize_cuda(x, mode, dtype):
    """Launch K1 on the current stream and count the launch."""
    global normalize_launches
    lib = _library()
    x = _aligned_input(x)
    out = torch.empty(x.shape, dtype=dtype, device=x.device)
    n_pixels = x.numel() // 3
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.dml_normalize_u8(x.data_ptr(), out.data_ptr(), n_pixels, _MODES[mode],
                                   int(dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"normalize kernel launch failed: cudaError {err}")
    with _count_lock:
        normalize_launches += 1
    return out

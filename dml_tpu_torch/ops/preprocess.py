"""Fused image normalize: uint8 ingest -> model dtype, one pass.

PyTorch counterpart of dml_tpu/ops/preprocess.py. The TPU kernel it
replaces is `dml_tpu/ops/preprocess.py::_normalize_kernel`; on Hopper it
is the CUDA C++ kernel in `dml_tpu_torch/csrc/normalize.cu`, built with
nvcc for sm_90a at first use and called through ctypes. The source file
says what bounds it (device-memory bytes) and how it is laid out.

`fused_normalize` is the kernel's wrapper. On a CUDA tensor it launches
the kernel (and counts the launch in `normalize_launches`) or raises; on
a CPU tensor it runs the plain PyTorch version,
`models.preprocess.normalize_on_device`, as the JAX package pairs its
kernel with the same function.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from ..models.preprocess import normalize_on_device

_MODES = {"caffe": 0, "tf": 1, "unit": 2}
_OUT_DTYPES = (torch.bfloat16, torch.float32)

#: kernel launches since the last reset (plain int; a test or
#: chip_smoke.py zeroes it, drives a path, and reads it back)
normalize_launches = 0
_count_lock = threading.Lock()


def _library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library."""
    from ._build import load_library

    lib = load_library("dml_normalize", ["normalize.cu"])
    fn = lib.dml_normalize_u8
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return lib


def normalize(
    x: torch.Tensor, mode: str, dtype: torch.dtype = torch.bfloat16
) -> torch.Tensor:
    """Product entry point (the engine's forward calls it): the Hopper
    kernel on a CUDA tensor, plain PyTorch on a CPU tensor."""
    return fused_normalize(x, mode, dtype)


def fused_normalize(
    x: torch.Tensor, mode: str, dtype: torch.dtype = torch.bfloat16
) -> torch.Tensor:
    """uint8 [N, H, W, 3] -> normalized `dtype` [N, H, W, 3] (same modes
    as `normalize_on_device`: "caffe", "tf", "unit", "raw"). The output
    is contiguous NHWC, so `out.permute(0, 3, 1, 2)` is a channels-last
    NCHW tensor with no copy."""
    global normalize_launches
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
    lib = _library()
    out = torch.empty(x.shape, dtype=dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.dml_normalize_u8(
            x.data_ptr(), out.data_ptr(), x.numel() // 3,
            _MODES[mode], int(dtype == torch.bfloat16), stream,
        )
    if err != 0:
        raise RuntimeError(f"normalize kernel launch failed: cudaError {err}")
    with _count_lock:
        normalize_launches += 1
    return out

"""Image preprocessing: host-side decode, device-side normalize.

PyTorch counterpart of dml_tpu/models/preprocess.py, with the same split:

- host: decode + resize to the model's static input size, output
  **uint8** (PIL/numpy), so the host->device copy moves a quarter of
  the bytes float32 would
- device: normalization runs inside the forward
  (`ops.preprocess.normalize`: the hand-written kernel on a CUDA tensor,
  `normalize_on_device` below on a CPU tensor)

Normalization modes match Keras so converted imagenet weights see the
distribution they were trained on:
- "caffe" (ResNet50): RGB->BGR, subtract imagenet BGR means, no scale
- "tf" (InceptionV3): scale to [-1, 1]
- "unit": scale to [0, 1]
- "raw": a plain cast (the model normalizes internally)

Decoding: an all-JPEG batch goes through the port's native loader
(`native/loader.py`: libjpeg DCT-scaled decode, C++ bilinear resize, a
thread pool), the JAX package's fast path; PIL decodes everything else,
and everything when the loader cannot be built or `DML_NATIVE_LOADER=0`.
"""

from __future__ import annotations

import io
import threading
from typing import Iterable, List, Tuple

import numpy as np
import torch

_CAFFE_MEAN_BGR = (103.939, 116.779, 123.68)

#: batches `load_images` decoded by each path since the last reset (a
#: caller zeroes it, loads, and reads which decoder served the batch)
decoded_batches = {"native": 0, "pil": 0}
_count_lock = threading.Lock()


def decode_image(data: bytes, size: Tuple[int, int]) -> np.ndarray:
    """JPEG/PNG bytes -> uint8 RGB array of shape (H, W, 3)."""
    from PIL import Image

    img = Image.open(io.BytesIO(data))
    img = img.convert("RGB").resize((size[1], size[0]), Image.BILINEAR)
    return np.asarray(img, dtype=np.uint8)


def _is_jpeg_file(path: str) -> bool:
    """Content sniff (the SOI marker), not the extension: fetched inputs
    carry store/version suffixes that an extension check misses."""
    try:
        with open(path, "rb") as f:
            return f.read(2) == b"\xff\xd8"
    except OSError:
        return False


def load_images(paths: Iterable[str], size: Tuple[int, int]) -> np.ndarray:
    """Decode a batch of image files -> uint8 (N, H, W, 3).

    An all-JPEG batch (sniffed by content) goes through the native
    loader; PIL decodes otherwise, when the loader is unavailable, and
    when the native decode raises on a file (a truncated JPEG, say).
    The same structure as dml_tpu/models/preprocess.py::load_images."""
    paths = [str(p) for p in paths]
    if paths:
        from ..native.loader import get_loader

        # loader first (cached), sniff second: without the library the
        # per-file open and read would be pure overhead
        loader = get_loader()
        if loader is not None and all(_is_jpeg_file(p) for p in paths):
            try:
                out = loader.decode_batch(paths, size)
                with _count_lock:
                    decoded_batches["native"] += 1
                return out
            except RuntimeError as e:
                import logging

                logging.getLogger(__name__).debug("native decode fell back to PIL: %s", e)
    arrs: List[np.ndarray] = []
    for p in paths:
        with open(p, "rb") as f:
            arrs.append(decode_image(f.read(), size))
    if arrs:
        with _count_lock:
            decoded_batches["pil"] += 1
    return np.stack(arrs) if arrs else np.zeros((0, *size, 3), np.uint8)


def normalize_on_device(
    x: torch.Tensor, mode: str, dtype: torch.dtype = torch.float32
) -> torch.Tensor:
    """uint8 (N,H,W,3) tensor -> normalized `dtype`, in plain PyTorch ops
    on whatever device `x` lies. This is the plain version of the
    normalize kernel (ops/preprocess.py): float32 math written as the JAX
    reference writes it, then one rounding to `dtype`.

    The divisors are 0-dim tensors on x's device, not Python floats: on
    a CUDA tensor PyTorch turns division by a host scalar into a multiply
    by its reciprocal, which is off by one float32 ulp for many of the
    256 input values."""
    x = x.to(torch.float32)

    def const(v):
        return torch.tensor(v, dtype=torch.float32, device=x.device)

    if mode == "caffe":
        x = x.flip(-1) - const(_CAFFE_MEAN_BGR)
    elif mode == "tf":
        x = x / const(127.5) - 1.0
    elif mode == "unit":
        x = x / const(255.0)
    elif mode == "raw":
        pass  # model normalizes internally
    else:
        raise ValueError(f"unknown preprocess mode {mode!r}")
    return x.to(dtype)

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

Decoding is PIL only; the JAX package's native libjpeg loader has no
counterpart in this package yet.
"""

from __future__ import annotations

import io
from typing import Iterable, List, Tuple

import numpy as np
import torch

_CAFFE_MEAN_BGR = (103.939, 116.779, 123.68)


def decode_image(data: bytes, size: Tuple[int, int]) -> np.ndarray:
    """JPEG/PNG bytes -> uint8 RGB array of shape (H, W, 3)."""
    from PIL import Image

    img = Image.open(io.BytesIO(data))
    img = img.convert("RGB").resize((size[1], size[0]), Image.BILINEAR)
    return np.asarray(img, dtype=np.uint8)


def load_images(paths: Iterable[str], size: Tuple[int, int]) -> np.ndarray:
    """Decode a batch of image files -> uint8 (N, H, W, 3)."""
    arrs: List[np.ndarray] = []
    for p in paths:
        with open(p, "rb") as f:
            arrs.append(decode_image(f.read(), size))
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

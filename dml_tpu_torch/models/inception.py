"""InceptionV3 (Keras-graph-compatible) in PyTorch.

Counterpart of dml_tpu/models/inception.py. Conv/BN pairs are named by
creation order (`conv2d_{i}`, `batch_normalization_{i}`, i = 0..93) as
Flax names them, so the state_dict keys are the Flax tree's layer names.
`__init__` creates the pairs and `forward` consumes them in the same
order, which is the order the JAX graph calls them in.

What must match the Flax graph:
- convs have no bias; BN has no scale (its weight is a buffer of ones,
  not a parameter), eps 1e-3, momentum 0.99
- stride-1 convs are SAME, which for the odd 1x7/7x1/1x3/3x1/3x3/5x5
  kernels is a symmetric pad of (k-1)/2; stride-2 convs, and the stem's
  marked ones, are VALID
- the branch pool is a SAME 3x3/1 average that divides by the valid
  cells only (`count_include_pad=False`)
- branches concatenate in the JAX order: 1x1, 5x5 (or 7x7), double
  3x3 (or double 7x7), pool
- head: global average pool, cast to float32, dense, softmax, all f32

NHWC at the public input, channels-last NCHW inside, conv weights in
`param_dtype` cast to the compute dtype at each call, BN and head in
float32 (see models/resnet.py).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .layers import BatchNorm, Conv2d

BN_EPS = 1e-3


class InceptionV3(nn.Module):
    def __init__(self, num_classes: int = 1000, dtype: torch.dtype = torch.float32,
                 param_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.param_dtype = dtype if param_dtype is None else param_dtype
        self._n = 0
        add = self._add
        # ---- stem ----
        add(3, 32, 3, 3, stride=2, valid=True)
        add(32, 32, 3, 3, valid=True)
        add(32, 64, 3, 3)
        add(64, 80, 1, 1, valid=True)
        add(80, 192, 3, 3, valid=True)
        cin = 192
        # ---- mixed 0, 1, 2 (35x35) ----
        for pool_filters in (32, 64, 64):
            add(cin, 64, 1, 1)
            add(cin, 48, 1, 1)
            add(48, 64, 5, 5)
            add(cin, 64, 1, 1)
            add(64, 96, 3, 3)
            add(96, 96, 3, 3)
            add(cin, pool_filters, 1, 1)
            cin = 64 + 64 + 96 + pool_filters
        # ---- mixed 3 (reduce to 17x17) ----
        add(cin, 384, 3, 3, stride=2, valid=True)
        add(cin, 64, 1, 1)
        add(64, 96, 3, 3)
        add(96, 96, 3, 3, stride=2, valid=True)
        cin = 384 + 96 + cin
        # ---- mixed 4..7 (17x17, factorized 7x7) ----
        for c7 in (128, 160, 160, 192):
            add(cin, 192, 1, 1)
            add(cin, c7, 1, 1)
            add(c7, c7, 1, 7)
            add(c7, 192, 7, 1)
            add(cin, c7, 1, 1)
            add(c7, c7, 7, 1)
            add(c7, c7, 1, 7)
            add(c7, c7, 7, 1)
            add(c7, 192, 1, 7)
            add(cin, 192, 1, 1)
            cin = 4 * 192
        # ---- mixed 8 (reduce to 8x8) ----
        add(cin, 192, 1, 1)
        add(192, 320, 3, 3, stride=2, valid=True)
        add(cin, 192, 1, 1)
        add(192, 192, 1, 7)
        add(192, 192, 7, 1)
        add(192, 192, 3, 3, stride=2, valid=True)
        cin = 320 + 192 + cin
        # ---- mixed 9, 10 (8x8, expanded filter banks) ----
        for _ in range(2):
            add(cin, 320, 1, 1)
            add(cin, 384, 1, 1)
            add(384, 384, 1, 3)
            add(384, 384, 3, 1)
            add(cin, 448, 1, 1)
            add(448, 384, 3, 3)
            add(384, 384, 1, 3)
            add(384, 384, 3, 1)
            add(cin, 192, 1, 1)
            cin = 320 + 2 * 384 + 2 * 384 + 192
        self.num_conv = self._n
        self.predictions = nn.Linear(cin, num_classes)  # float32 head

    def _add(self, cin, cout, kh, kw, stride=1, valid=False):
        i = self._n
        self._n += 1
        pad = (0, 0) if valid else ((kh - 1) // 2, (kw - 1) // 2)
        self.add_module(
            f"conv2d_{i}",
            Conv2d(cin, cout, (kh, kw), stride=stride, padding=pad, bias=False,
                   dtype=self.param_dtype, compute_dtype=self.dtype),
        )
        self.add_module(f"batch_normalization_{i}",
                        BatchNorm(cout, BN_EPS, momentum=0.99, scale=False))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC image in any float dtype -> float32 class probabilities."""
        layers = iter(range(self.num_conv))

        def cbn(y):
            i = next(layers)
            y = getattr(self, f"conv2d_{i}")(y)
            return F.relu(getattr(self, f"batch_normalization_{i}")(y))

        def maxpool(y):
            return F.max_pool2d(y, 3, stride=2)

        def avgpool3(y):
            return F.avg_pool2d(y, 3, stride=1, padding=1, count_include_pad=False)

        def cat(*ys):
            return torch.cat(ys, dim=1)

        x = x.to(self.dtype).permute(0, 3, 1, 2)
        # ---- stem ----
        x = cbn(cbn(cbn(x)))
        x = maxpool(x)
        x = cbn(cbn(x))
        x = maxpool(x)
        # ---- mixed 0, 1, 2 ----
        for _ in range(3):
            b1 = cbn(x)
            b5 = cbn(cbn(x))
            b3d = cbn(cbn(cbn(x)))
            bp = cbn(avgpool3(x))
            x = cat(b1, b5, b3d, bp)
        # ---- mixed 3 ----
        b3 = cbn(x)
        b3d = cbn(cbn(cbn(x)))
        x = cat(b3, b3d, maxpool(x))
        # ---- mixed 4..7 ----
        for _ in range(4):
            b1 = cbn(x)
            b7 = cbn(cbn(cbn(x)))
            b7d = cbn(cbn(cbn(cbn(cbn(x)))))
            bp = cbn(avgpool3(x))
            x = cat(b1, b7, b7d, bp)
        # ---- mixed 8 ----
        b3 = cbn(cbn(x))
        b7x3 = cbn(cbn(cbn(cbn(x))))
        x = cat(b3, b7x3, maxpool(x))
        # ---- mixed 9, 10 ----
        for _ in range(2):
            b1 = cbn(x)
            b3 = cbn(x)
            b3 = cat(cbn(b3), cbn(b3))
            b3d = cbn(cbn(x))
            b3d = cat(cbn(b3d), cbn(b3d))
            bp = cbn(avgpool3(x))
            x = cat(b1, b3, b3d, bp)
        x = x.mean(dim=(2, 3)).float()  # global average pool, f32 head
        return torch.softmax(self.predictions(x), dim=-1)

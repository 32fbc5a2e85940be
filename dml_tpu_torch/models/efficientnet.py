"""EfficientNet family (Keras-graph-compatible B0..B7) in PyTorch.

Counterpart of dml_tpu/models/efficientnet.py, layer for layer and name
for name: the submodules are attributes of the top module with the
Keras names (`stem_conv`, `block2a_expand_conv`, `block2a_dwconv`,
`block2a_se_reduce`, `top_conv`, `predictions`, ...), so the state_dict
keys are the Flax tree's layer names.

What must match the Flax graph:
- preprocessing is in the graph, as Keras bakes it in (the registry's
  mode is "raw": the engine only casts the uint8 batch): x / 255, then
  (x - mean) / std with torch-style mean and std, all in the compute
  dtype, the constants rounded to it
- the stem and every stride-2 depthwise conv: an explicit Keras
  `correct_pad` zero pad, then a VALID conv; stride-1 convs are SAME
  (a symmetric pad of k // 2 for the odd kernels); depthwise convs are
  `Conv2d(groups=C)`
- MBConv blocks: 1x1 expand (when expand != 1), depthwise, squeeze and
  excite on the pooled map with `max(1, int(filters_in * se_ratio))`
  filters (the block's input width, not the expanded one) and 1x1 convs
  WITH bias, 1x1 project, and the residual when stride 1 and the widths
  agree; drop-connect is the identity, in training too, as in the Flax
  graph
- swish activations; BN eps 1e-3, momentum 0.99
- head: global average pool, cast to float32, dense, softmax, all f32

`s2d_stem=True` runs the stem's 3x3/2 conv as space-to-depth and a
stride-1 2x2 conv over 12 channels, folded at each call from the SAME
`stem_conv.weight` (`_S2DStemConv`), with one extra zero row/col where
the padded extent is odd: the same function on the same parameter.

NHWC at the public input, channels-last NCHW inside, conv weights in
`param_dtype` cast to the compute dtype at each call, BN and head in
float32 (see models/resnet.py).
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .layers import BatchNorm, Conv2d, correct_pad as _correct_pad, zero_pad

BN_EPS = 1e-3
# torch-style normalization baked into the keras graph
_MEAN = (0.485, 0.456, 0.406)
_STD = (0.229, 0.224, 0.225)

# B0 base config: (kernel, repeats, filters_in, filters_out, expand, stride, se)
_BASE_BLOCKS = (
    (3, 1, 32, 16, 1, 1, 0.25),
    (3, 2, 16, 24, 6, 2, 0.25),
    (5, 2, 24, 40, 6, 2, 0.25),
    (3, 3, 40, 80, 6, 2, 0.25),
    (5, 3, 80, 112, 6, 1, 0.25),
    (5, 4, 112, 192, 6, 2, 0.25),
    (3, 1, 192, 320, 6, 1, 0.25),
)
# name -> (width_mult, depth_mult, input_size)
VARIANTS = {
    "b0": (1.0, 1.0, 224),
    "b1": (1.0, 1.1, 240),
    "b2": (1.1, 1.2, 260),
    "b3": (1.2, 1.4, 300),
    "b4": (1.4, 1.8, 380),
    "b5": (1.6, 2.2, 456),
    "b6": (1.8, 2.6, 528),
    "b7": (2.0, 3.1, 600),
}


def _round_filters(filters: float, width: float, divisor: int = 8) -> int:
    """Keras round_filters: scale then round to the divisor."""
    filters *= width
    new = max(divisor, int(filters + divisor / 2) // divisor * divisor)
    if new < 0.9 * filters:
        new += divisor
    return int(new)


def _round_repeats(repeats: int, depth: float) -> int:
    return int(math.ceil(depth * repeats))


class _S2DStemConv(Conv2d):
    """The stem's 3x3/2 conv as space-to-depth and a stride-1 2x2 conv
    over 4C input channels. The parameter is the stock conv's
    `(F, C, 3, 3)` weight; the fold happens at each call: the kernel
    zero-padded to 4x4, k2[f, (dy*2+dx)*C + c, dy', dx'] = k4[f, c,
    2dy'+dy, 2dx'+dx], so conv(s2d(x), k2, stride 1) == conv(x, k4,
    stride 2) == conv(x, k, stride 2) (the padded 4th row/col is zero).
    The input's padded extents must be even."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        f = self.weight.shape[0]
        k4 = F.pad(self.weight.to(self.compute_dtype), (0, 1, 0, 1))  # [F, C, 4, 4]
        k2 = (k4.reshape(f, c, 2, 2, 2, 2)        # f, c, dy', dy, dx', dx
              .permute(0, 3, 5, 1, 2, 4)           # f, dy, dx, c, dy', dx'
              .reshape(f, 4 * c, 2, 2))
        xs = (x.permute(0, 2, 3, 1)                # NHWC
              .reshape(b, h // 2, 2, w // 2, 2, c)
              .permute(0, 1, 3, 2, 4, 5)
              .reshape(b, h // 2, w // 2, 4 * c)
              .permute(0, 3, 1, 2))
        return F.conv2d(xs, k2)


class EfficientNet(nn.Module):
    """EfficientNet-B{n}; flat Keras-named layers for weight import."""

    def __init__(
        self,
        width: float = 1.0,
        depth: float = 1.0,
        num_classes: int = 1000,
        dtype: torch.dtype = torch.float32,
        param_dtype: Optional[torch.dtype] = None,
        s2d_stem: bool = False,
    ):
        super().__init__()
        self.dtype = dtype
        self.param_dtype = dtype if param_dtype is None else param_dtype
        self.s2d_stem = s2d_stem
        self.register_buffer("mean", torch.tensor(_MEAN), persistent=False)
        self.register_buffer("std", torch.tensor(_STD), persistent=False)
        stem = _round_filters(32, width)
        conv = _S2DStemConv if s2d_stem else Conv2d
        self.stem_conv = conv(3, stem, 3, stride=2, bias=False, dtype=self.param_dtype,
                              compute_dtype=dtype)
        self.stem_bn = BatchNorm(stem, BN_EPS, momentum=0.99)
        # (name, kernel, filters_in, filters_out, expand, stride, se_ratio) in forward order
        self.blocks: List[Tuple[str, int, int, int, int, int, float]] = []
        for i, (k, repeats, fin, fout, expand, stride, se) in enumerate(_BASE_BLOCKS):
            fin, fout = _round_filters(fin, width), _round_filters(fout, width)
            for j in range(_round_repeats(repeats, depth)):
                block = (f"block{i + 1}{chr(ord('a') + j)}", k, fin if j == 0 else fout, fout,
                         expand, stride if j == 0 else 1, se)
                self._mbconv_layers(*block)
                self.blocks.append(block)
        top = _round_filters(1280, width)
        self._conv_bn("top_conv", "top_bn", fout, top, 1)
        self.predictions = nn.Linear(top, num_classes)  # float32 head

    def _conv(self, name, cin, cout, k, stride=1, groups=1, bias=False, padding=0):
        self.add_module(name, Conv2d(cin, cout, k, stride=stride, padding=padding, groups=groups,
                                     bias=bias, dtype=self.param_dtype, compute_dtype=self.dtype))

    def _conv_bn(self, conv, bn, cin, cout, k):
        self._conv(conv, cin, cout, k)
        self.add_module(bn, BatchNorm(cout, BN_EPS, momentum=0.99))

    def _mbconv_layers(self, name, kernel, filters_in, filters_out, expand, stride, se_ratio):
        filters = filters_in * expand
        if expand != 1:
            self._conv_bn(f"{name}_expand_conv", f"{name}_expand_bn", filters_in, filters, 1)
        # stride 2: an explicit correct_pad in forward, then VALID; stride 1: SAME
        self._conv(f"{name}_dwconv", filters, filters, kernel, stride=stride, groups=filters,
                   padding=0 if stride == 2 else kernel // 2)
        self.add_module(f"{name}_bn", BatchNorm(filters, BN_EPS, momentum=0.99))
        if 0 < se_ratio <= 1:
            se_filters = max(1, int(filters_in * se_ratio))
            self._conv(f"{name}_se_reduce", filters, se_filters, 1, bias=True)
            self._conv(f"{name}_se_expand", se_filters, filters, 1, bias=True)
        self._conv_bn(f"{name}_project_conv", f"{name}_project_bn", filters, filters_out, 1)

    def _mbconv(self, x, name, kernel, filters_in, filters_out, expand, stride, se_ratio):
        def layer(suffix):
            return getattr(self, f"{name}_{suffix}")

        inputs = x
        if expand != 1:
            x = F.silu(layer("expand_bn")(layer("expand_conv")(x)))
        if stride == 2:
            x = zero_pad(x, _correct_pad(kernel, x.shape[2:4]))
        x = F.silu(layer("bn")(layer("dwconv")(x)))
        if 0 < se_ratio <= 1:
            se = x.mean(dim=(2, 3), keepdim=True)
            se = F.silu(layer("se_reduce")(se))
            x = x * torch.sigmoid(layer("se_expand")(se))
        x = layer("project_bn")(layer("project_conv")(x))
        if stride == 1 and filters_in == filters_out:
            x = x + inputs
        return x

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC image (uint8 or float, 0..255) -> float32 class
        probabilities."""
        # the keras rescaling and normalization layers, in the compute dtype
        x = x.to(self.dtype) / 255.0
        x = (x - self.mean.to(self.dtype)) / self.std.to(self.dtype)
        (pt, pb), (pl, pr) = _correct_pad(3, x.shape[1:3])
        if self.s2d_stem:
            # one extra zero row/col where the padded extent is odd: the
            # fold needs even extents, and the kernel row that reads it is zero
            pb += (x.shape[1] + pt + pb) % 2
            pr += (x.shape[2] + pl + pr) % 2
        x = zero_pad(x.permute(0, 3, 1, 2), ((pt, pb), (pl, pr)))
        x = F.silu(self.stem_bn(self.stem_conv(x)))
        for block in self.blocks:
            x = self._mbconv(x, *block)
        x = F.silu(self.top_bn(self.top_conv(x)))
        x = x.mean(dim=(2, 3)).float()  # avg_pool, f32 head
        return torch.softmax(self.predictions(x), dim=-1)


def build_variant(
    variant: str, num_classes: int = 1000, dtype: torch.dtype = torch.float32,
    param_dtype: Optional[torch.dtype] = None, s2d_stem: bool = False,
) -> EfficientNet:
    width, depth, _ = VARIANTS[variant]
    return EfficientNet(width=width, depth=depth, num_classes=num_classes, dtype=dtype,
                        param_dtype=param_dtype, s2d_stem=s2d_stem)

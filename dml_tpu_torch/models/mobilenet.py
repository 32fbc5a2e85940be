"""MobileNetV2 (Keras-graph-compatible) in PyTorch.

Counterpart of dml_tpu/models/mobilenet.py, layer for layer and name
for name: `Conv1`/`bn_Conv1` stem, inverted-residual blocks named
`expanded_conv_*` (block 0, which has no expand conv) and `block_N_*`,
`Conv_1`/`Conv_1_bn` and `predictions` at the head, so the state_dict
keys are the Flax tree's layer names.

What must match the Flax graph:
- the stem and every stride-2 depthwise conv: an explicit Keras
  `correct_pad` zero pad (the one rule, `efficientnet._correct_pad`),
  then a VALID 3x3/2 conv; stride-1 depthwise convs are SAME (a pad of
  1); depthwise convs are `Conv2d(groups=C)`; no conv has a bias
- ReLU6 activations (none after the project conv); BN eps 1e-3,
  momentum 0.999
- the residual only where the block keeps its width at stride 1
- head: global average pool, cast to float32, dense, softmax, all f32

The input arrives normalized to [-1, 1] (the registry's "tf" mode).
NHWC at the public input, channels-last NCHW inside, conv weights in
`param_dtype` cast to the compute dtype at each call, BN and head in
float32 (see models/resnet.py).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch import nn

from .efficientnet import _correct_pad
from .layers import BatchNorm, Conv2d, relu6, zero_pad

BN_EPS = 1e-3
BN_MOMENTUM = 0.999

# (expansion, out_channels, repeats, first_stride) per stage: the
# MobileNetV2 paper's table 2 (alpha=1.0 channels, all multiples of 8)
STAGES = (
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
)


def _pad_for_stride2(x: torch.Tensor) -> torch.Tensor:
    return zero_pad(x, _correct_pad(3, x.shape[2:4]))


class MobileNetV2(nn.Module):
    def __init__(self, num_classes: int = 1000, dtype: torch.dtype = torch.float32,
                 param_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.param_dtype = dtype if param_dtype is None else param_dtype
        self._conv_bn("Conv1", "bn_Conv1", 3, 32, 3, stride=2)
        # (prefix, expansion, in_c, filters, stride) per block, in forward order
        self.blocks: List[Tuple[str, int, int, int, int]] = []
        self._block(1, 32, 16, 1, 0)
        cin, block_id = 16, 1
        for expansion, filters, repeats, first_stride in STAGES:
            for r in range(repeats):
                self._block(expansion, cin, filters, first_stride if r == 0 else 1, block_id)
                cin, block_id = filters, block_id + 1
        self._conv_bn("Conv_1", "Conv_1_bn", cin, 1280, 1)
        self.predictions = nn.Linear(1280, num_classes)  # float32 head

    def _conv_bn(self, conv, bn, cin, cout, k, stride=1, groups=1):
        # stride 2: an explicit correct_pad in forward, then VALID; stride 1: SAME
        self.add_module(conv, Conv2d(cin, cout, k, stride=stride, groups=groups,
                                     padding=0 if stride == 2 else k // 2, bias=False,
                                     dtype=self.param_dtype, compute_dtype=self.dtype))
        self.add_module(bn, BatchNorm(cout, BN_EPS, momentum=BN_MOMENTUM))

    def _block(self, expansion, in_c, filters, stride, block_id):
        """One inverted-residual block's layers, with Keras's names."""
        prefix = "expanded_conv" if block_id == 0 else f"block_{block_id}"
        ch = in_c
        if block_id:
            ch = in_c * expansion
            self._conv_bn(f"{prefix}_expand", f"{prefix}_expand_BN", in_c, ch, 1)
        self._conv_bn(f"{prefix}_depthwise", f"{prefix}_depthwise_BN", ch, ch, 3, stride=stride,
                      groups=ch)
        self._conv_bn(f"{prefix}_project", f"{prefix}_project_BN", ch, filters, 1)
        self.blocks.append((prefix, block_id, in_c, filters, stride))

    def _cbn(self, x, conv, bn):
        return getattr(self, bn)(getattr(self, conv)(x))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC image in any float dtype -> float32 class probabilities."""
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        x = relu6(self._cbn(_pad_for_stride2(x), "Conv1", "bn_Conv1"))
        for prefix, block_id, in_c, filters, stride in self.blocks:
            inputs = x
            if block_id:
                x = relu6(self._cbn(x, f"{prefix}_expand", f"{prefix}_expand_BN"))
            if stride == 2:
                x = _pad_for_stride2(x)
            x = relu6(self._cbn(x, f"{prefix}_depthwise", f"{prefix}_depthwise_BN"))
            x = self._cbn(x, f"{prefix}_project", f"{prefix}_project_BN")
            if in_c == filters and stride == 1:
                x = inputs + x
        x = relu6(self._cbn(x, "Conv_1", "Conv_1_bn"))
        x = x.mean(dim=(2, 3)).float()  # global average pool, f32 head
        return torch.softmax(self.predictions(x), dim=-1)

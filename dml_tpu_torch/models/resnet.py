"""ResNet-v1 family (Keras-graph-compatible ResNet50/101/152) in PyTorch.

Counterpart of dml_tpu/models/resnet.py, layer for layer and name for
name: the submodules are attributes of the top module with the Keras
names (`conv1_conv`, `conv2_block1_0_bn`, ...), so the state_dict keys
are the Flax tree's layer names and `params_io.from_flax_variables` maps
them one to one.

What must match the Flax graph:
- stem: an explicit 3-pixel zero pad then a VALID 7x7/2 conv, which is
  `Conv2d(padding=3)`; max pool: a -inf pad then a VALID 3x3/2 pool,
  which is `max_pool2d(3, 2, padding=1)`
- bottleneck blocks with the stride on the first 1x1 conv (Caffe
  variant); BN epsilon 1.001e-5
- head: global average pool, cast to float32, dense, softmax, all f32

The public input is NHWC, as in the JAX package. Inside, the model runs
NCHW in `torch.channels_last` memory: `x.permute(0, 3, 1, 2)` of an NHWC
tensor is already that, so no copy. Conv weights are held in
`param_dtype` and cast to the compute `dtype` at each call, as Flax
casts its float32 kernels (`layers.Conv2d`). The inference engine holds
them in the compute dtype (cast once: the same values); the trainer in
float32, so its gradients and AdamW updates are float32. BN statistics
and parameters and the dense head stay float32. BN momentum 0.99, as in
the Flax graph (it moves the running statistics in training).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .layers import BatchNorm, Conv2d

BN_EPS = 1.001e-5


class ResNet(nn.Module):
    """ResNet-v1 with bottleneck blocks (50/101/152 by `depths`)."""

    def __init__(
        self,
        depths: Sequence[int] = (3, 4, 6, 3),
        num_classes: int = 1000,
        dtype: torch.dtype = torch.float32,
        param_dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        self.dtype = dtype
        self.param_dtype = dtype if param_dtype is None else param_dtype
        self._conv_bn("conv1", 3, 64, 7, 2)
        # (prefix, has conv shortcut) per block, in forward order
        self.blocks: List[Tuple[str, bool]] = []
        cin, filters = 64, 64
        for stage, blocks in enumerate(depths, start=2):
            for b in range(1, blocks + 1):
                stride = 1 if (stage == 2 or b > 1) else 2
                p = f"conv{stage}_block{b}"
                if b == 1:
                    self._conv_bn(f"{p}_0", cin, 4 * filters, 1, stride)
                self._conv_bn(f"{p}_1", cin, filters, 1, stride)
                self._conv_bn(f"{p}_2", filters, filters, 3, 1)
                self._conv_bn(f"{p}_3", filters, 4 * filters, 1, 1)
                self.blocks.append((p, b == 1))
                cin = 4 * filters
            filters *= 2
        self.predictions = nn.Linear(cin, num_classes)  # float32 head

    def _conv_bn(self, name, cin, cout, k, stride):
        self.add_module(
            f"{name}_conv",
            Conv2d(cin, cout, k, stride=stride, padding=k // 2, dtype=self.param_dtype,
                   compute_dtype=self.dtype),
        )
        self.add_module(f"{name}_bn", BatchNorm(cout, BN_EPS, momentum=0.99))

    def _cbn(self, x, name):
        return getattr(self, f"{name}_bn")(getattr(self, f"{name}_conv")(x))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC image in any float dtype -> float32 class probabilities."""
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        x = F.relu(self._cbn(x, "conv1"))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        for p, shortcut in self.blocks:
            sc = self._cbn(x, f"{p}_0") if shortcut else x
            y = F.relu(self._cbn(x, f"{p}_1"))
            y = F.relu(self._cbn(y, f"{p}_2"))
            y = self._cbn(y, f"{p}_3")
            x = F.relu(sc + y)
        x = x.mean(dim=(2, 3)).float()  # global average pool, f32 head
        return torch.softmax(self.predictions(x), dim=-1)


def ResNet50(num_classes: int = 1000, dtype: torch.dtype = torch.float32,
             param_dtype: Optional[torch.dtype] = None) -> ResNet:
    return ResNet(depths=(3, 4, 6, 3), num_classes=num_classes, dtype=dtype,
                  param_dtype=param_dtype)


def ResNet101(num_classes: int = 1000, dtype: torch.dtype = torch.float32,
             param_dtype: Optional[torch.dtype] = None) -> ResNet:
    return ResNet(depths=(3, 4, 23, 3), num_classes=num_classes, dtype=dtype,
                  param_dtype=param_dtype)


def ResNet152(num_classes: int = 1000, dtype: torch.dtype = torch.float32,
             param_dtype: Optional[torch.dtype] = None) -> ResNet:
    return ResNet(depths=(3, 8, 36, 3), num_classes=num_classes, dtype=dtype,
                  param_dtype=param_dtype)

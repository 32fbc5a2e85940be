"""Layers shared by the CNN families."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class BatchNorm(nn.Module):
    """Inference BatchNorm over channel dim 1 with float32 statistics.

    Flax's `nn.BatchNorm(dtype=bf16)` promotes a bf16 input against its
    float32 mean/var/scale/bias, computes (x - mean) * rsqrt(var + eps)
    * scale + bias in float32 and rounds to bf16 once at the end.
    `F.batch_norm` with a bf16 input and float32 parameters does the
    same: float32 math, one rounding to the input dtype. So the
    parameters here stay float32 whatever the model dtype.

    The state_dict keys are weight/bias/running_mean/running_var (no
    num_batches_tracked: nothing here trains). A layer that Keras built
    without a scale (InceptionV3) carries weight = ones.
    """

    def __init__(self, num_features: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.batch_norm(
            x, self.running_mean, self.running_var, self.weight, self.bias,
            training=False, momentum=0.0, eps=self.eps,
        )

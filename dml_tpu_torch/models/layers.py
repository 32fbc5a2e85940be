"""Layers shared by the CNN families."""

from __future__ import annotations

from contextlib import contextmanager
from typing import Iterator

import torch
import torch.nn.functional as F
from torch import nn


class Conv2d(nn.Conv2d):
    """`nn.Conv2d` whose weights may be held in another dtype than the
    one it computes in: Flax's `param_dtype` beside `dtype`. The weights
    (and bias) are cast to `compute_dtype` at each call, as Flax casts
    its float32 kernels, so a trainer keeps float32 master weights and
    float32 gradients while the convolution runs in bf16. With the two
    dtypes equal (the inference engine) the cast is a no-op."""

    def __init__(self, *args, compute_dtype: torch.dtype, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = self.bias
        return self._conv_forward(
            x, self.weight.to(self.compute_dtype),
            None if b is None else b.to(self.compute_dtype),
        )


class BatchNorm(nn.Module):
    """BatchNorm over channel dim 1 with Flax's semantics and float32
    statistics and parameters.

    Inference (`.eval()`): Flax's `nn.BatchNorm(dtype=bf16)` promotes a
    bf16 input against its float32 mean/var/scale/bias, computes (x -
    mean) * rsqrt(var + eps) * scale + bias in float32 and rounds to bf16
    once at the end. `F.batch_norm` with a bf16 input and float32
    parameters does the same.

    Training (`.train()`, Flax's `use_running_average=False`): the input
    is normalized by its batch statistics, computed in float32, with the
    biased variance (`F.batch_norm(training=True)`), and the running
    statistics move as Flax moves them: ra = momentum * ra + (1 -
    momentum) * batch, in float32, with that same biased variance.
    PyTorch's own update writes the unbiased variance into the running
    one; the forward rescales its new part (C-vector operations). The
    batch variance is PyTorch's (a Welford/two-pass sum) where Flax's is
    the fast max(0, E[x^2] - E[x]^2): the two agree to rounding.
    `update_stats = False` (see `frozen_batch_stats`) normalizes the same
    way and leaves the running statistics alone, for a forward run again
    under activation checkpointing.

    The state_dict keys are weight/bias/running_mean/running_var. A
    layer built without a scale (Keras's InceptionV3, `scale=False`)
    holds weight = ones as a buffer, not a parameter: nothing trains it,
    as Flax has no such parameter.
    """

    def __init__(self, num_features: int, eps: float, momentum: float = 0.99,
                 scale: bool = True):
        super().__init__()
        self.eps, self.momentum = eps, momentum
        self.update_stats = True
        ones = torch.ones(num_features)
        if scale:
            self.weight = nn.Parameter(ones)
        else:
            self.register_buffer("weight", ones)
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(
                x, self.running_mean, self.running_var, self.weight, self.bias,
                training=False, momentum=0.0, eps=self.eps,
            )
        # PyTorch moves running buffers by ra = m ra + (1 - m) batch with
        # m = 1 - momentum, Flax's rule, but with the unbiased variance
        # v n/(n-1). It updates copies (autograd keeps the tensors it was
        # given, and a remat recompute must save the same ones); rescaling
        # the variance's new part by (n-1)/n leaves Flax's m ra + (1 - m) v.
        m = self.momentum
        mean, var = self.running_mean.clone(), self.running_var.clone()
        y = F.batch_norm(x, mean, var, self.weight, self.bias, training=True,
                         momentum=1.0 - m, eps=self.eps)
        if self.update_stats:
            n = x.numel() // x.shape[1]
            with torch.no_grad():
                self.running_mean.copy_(mean)
                new_part = torch.add(var, self.running_var, alpha=-m)
                self.running_var.mul_(m).add_(new_part, alpha=(n - 1) / n)
        return y


@contextmanager
def frozen_batch_stats(module: nn.Module) -> Iterator[None]:
    """Within the block, every BatchNorm of `module` leaves its running
    statistics as they are (it still normalizes by the batch's)."""
    bns = [m for m in module.modules() if isinstance(m, BatchNorm)]
    before = [m.update_stats for m in bns]
    for m in bns:
        m.update_stats = False
    try:
        yield
    finally:
        for m, b in zip(bns, before):
            m.update_stats = b

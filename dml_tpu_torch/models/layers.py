"""Layers shared by the model families, with Flax's semantics."""

from __future__ import annotations

from contextlib import contextmanager
from typing import Callable, Iterator, Optional, Tuple

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


class Linear(nn.Linear):
    """`nn.Linear` held in one dtype and computed in another: Flax's
    `nn.Dense(dtype=compute_dtype)` over `param_dtype` parameters. The
    input, weight and bias are cast to `compute_dtype` at each call (as
    `Conv2d` casts its weights), so a trainer keeps float32 masters."""

    def __init__(self, *args, compute_dtype: torch.dtype, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = self.bias
        cd = self.compute_dtype
        return F.linear(x.to(cd), self.weight.to(cd), None if b is None else b.to(cd))


class LayerNorm(nn.Module):
    """Flax's `nn.LayerNorm(dtype=compute_dtype)` over the last dim:
    epsilon 1e-6 (PyTorch's default is 1e-5), statistics in float32,
    float32 scale and bias, and the output rounded once to
    `compute_dtype`: the input is promoted to float32, as Flax promotes
    it against its float32 statistics (CUDA's `layer_norm` refuses a
    bf16 input with float32 parameters)."""

    def __init__(self, num_features: int, compute_dtype: torch.dtype, eps: float = 1e-6):
        super().__init__()
        self.eps, self.compute_dtype = eps, compute_dtype
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), self.weight.shape, self.weight, self.bias, self.eps)
        return y.to(self.compute_dtype)


def relu6(x: torch.Tensor) -> torch.Tensor:
    """min(max(x, 0), 6), Keras's ReLU6."""
    return x.clamp(0.0, 6.0)


def correct_pad(kernel: int, size_hw: Tuple[int, int]) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """Keras `imagenet_utils.correct_pad` for the stride-2 VALID convs:
    ((top, bottom), (left, right)), with `adjust = 1 - size % 2` per dim
    (an even size drops one pixel of leading pad, (0, 1) for k = 3; an
    odd one keeps the symmetric pad). Getting this wrong on odd feature
    maps (EfficientNet-B4's 95-pixel block input) shifts every activation
    after it off the Keras graph."""
    correct = kernel // 2
    adj_h = 1 - size_hw[0] % 2
    adj_w = 1 - size_hw[1] % 2
    return ((correct - adj_h, correct), (correct - adj_w, correct))


def zero_pad(x: torch.Tensor, pads: Tuple[Tuple[int, int], Tuple[int, int]]) -> torch.Tensor:
    """Zero-pad an NCHW tensor by ((top, bottom), (left, right))."""
    (top, bottom), (left, right) = pads
    return F.pad(x, (left, right, top, bottom))


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

    Across data-parallel ranks (`sum_batch_stats`, set by the trainer
    over a mesh), training normalizes by the global batch's statistics,
    as GSPMD computes them (`_GlobalBatchNorm`): each rank's per-channel
    sums of x and x^2 over its shard, in float32, with its element
    count, summed over the ranks by `stats_sum`; the variance is Flax's
    max(0, E[x^2] - E[x]^2), which the running variance takes as it is.
    With `stats_sum` None (one device) the layer is the form above.

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
        #: sums a float32 tensor over the data-parallel ranks (in place,
        #: returning it), or None
        self.stats_sum: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
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
        if self.stats_sum is not None:
            return self._global_batch_forward(x)
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

    def _global_batch_forward(self, x: torch.Tensor) -> torch.Tensor:
        y, mean, var = _GlobalBatchNorm.apply(x, self.weight, self.bias, self.eps, self.stats_sum)
        if self.update_stats:
            m = self.momentum
            with torch.no_grad():
                self.running_mean.mul_(m).add_(mean, alpha=1.0 - m)
                self.running_var.mul_(m).add_(var, alpha=1.0 - m)
        return y


class _GlobalBatchNorm(torch.autograd.Function):
    """BatchNorm in training by statistics summed over the ranks:
    (x, weight, bias, eps, stats_sum) -> (y, mean, var), mean and var
    float32 and not differentiated.

    Forward: each rank's per-channel mean and biased variance in float32
    (`var_mean`), as sums (n mean, n (var + mean^2), n) summed over the
    ranks; the global mean and Flax's variance; y by PyTorch's batch_norm
    kernel with them. Backward: the loss of each rank is its own, and the
    global statistics tie every rank's input to every rank's output, so
    the per-channel sums of dy and dy * x_hat that the input gradient
    needs are summed over the ranks (a second collective, in the same
    order on every rank): dx = w invstd (dy - S(dy) / N - x_hat
    S(dy x_hat) / N), with the local sums of this rank as its weight and
    bias gradients (the trainer sums those over the ranks)."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, stats_sum):
        c = x.shape[1]
        n = x.numel() // c
        dims = [0, *range(2, x.ndim)]
        var_l, mean_l = torch.var_mean(x.float(), dims, correction=0)
        sums = stats_sum(torch.cat([mean_l * n, (var_l + mean_l * mean_l) * n,
                                    mean_l.new_full((1,), float(n))]))
        count = sums[-1]
        mean = sums[:c] / count
        var = (sums[c:2 * c] / count - mean * mean).clamp_min(0.0)
        y = F.batch_norm(x, mean, var, weight, bias, training=False, momentum=0.0, eps=eps)
        ctx.save_for_backward(x, weight, mean, var, count)
        ctx.eps, ctx.stats_sum = eps, stats_sum
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _mean, _var):
        x, weight, mean, var, count = ctx.saved_tensors
        c = x.shape[1]
        invstd = torch.rsqrt(var + ctx.eps)
        # eval mode: dx = dy w invstd, and the local sums of dy x_hat and dy
        # (the CUDA kernel wants the saved statistics too: the same ones)
        dx, gw, gb = torch.ops.aten.native_batch_norm_backward(
            dy, x, weight, mean, var, mean, invstd, False, ctx.eps, [True, True, True])
        sums = ctx.stats_sum(torch.cat([gb, gw])) / count
        k1 = -weight * invstd * invstd * sums[c:]  # the x_hat term, per unit of x
        k0 = -weight * invstd * sums[:c] - k1 * mean
        shape = (1, c) + (1,) * (x.ndim - 2)
        dx = torch.addcmul(k0.view(shape), x, k1.view(shape)).add_(dx).to(x.dtype)
        return (dx, gw if ctx.needs_input_grad[1] else None,
                gb if ctx.needs_input_grad[2] else None, None, None)


def sum_batch_stats(module: nn.Module,
                    stats_sum: Optional[Callable[[torch.Tensor], torch.Tensor]]) -> None:
    """Every BatchNorm of `module` normalizes in training by the global
    batch, its statistics summed over the ranks by `stats_sum` (None: by
    its own batch)."""
    for m in module.modules():
        if isinstance(m, BatchNorm):
            m.stats_sum = stats_sum


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

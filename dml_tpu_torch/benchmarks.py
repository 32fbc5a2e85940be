"""Slope timing on the device for the port's measurements: PyTorch
counterpart of dml_tpu/benchmarks.py.

The JAX package's protocol answers a remoted TPU, where a host timer
measures dispatch and a single dispatch carries a fixed round trip. It
times the SLOPE between two chain lengths, (T(c2) - T(c1)) / (c2 - c1),
which cancels every fixed cost of a call. The port keeps the same
statistics (the slope, `reps` interleaved short/long pairs, the median,
min and max over them, a non-positive rep counted and never clamped
into the range) and times each chain where its tensors live:

- on a CUDA tensor, `fn(n, *args)` enqueues n iterations on the current
  stream between two `torch.cuda.Event(enable_timing=True)`; the timer
  then synchronizes and reads `elapsed_time`. Nothing else times a
  CUDA tensor: there is no host-clock fallback;
- on CPU tensors (and on arguments holding no tensor, as the scripted
  cases of the tests pass), the host's monotonic clock around the call.

What the slope includes: PyTorch runs eagerly, so the host enqueues each
iteration's kernels one by one. Where the host enqueues more slowly than
the card runs them, the card waits between kernels and the slope is the
host's time an iteration, not the card's; where the card is slower, it
is the card's. The image forward at batch 32 is host-bound on the H100
(PERF.md §5), so its slope there reads the host. No CUDA graph is used
here: capturing the chain is an optimisation of the port, not of its
timer.

Each iteration feeds a loop-carried scalar back into its input (`poke`:
one element written in place), so no iteration can be skipped or reused,
and reduces the full output into the carry, as the JAX loop does.

`compiled_flops` keeps the JAX name for the MFU numerator; the count is
not XLA's (see its docstring). `peak_flops` is the MFU denominator, the
published dense bf16 peak of the card by its name; an unknown card
raises (no TPU figure is a fallback for a GPU).
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Callable, Iterator, Optional, Sequence, Tuple

import torch


def poke(x: torch.Tensor, acc: torch.Tensor) -> torch.Tensor:
    """Write `acc % 2`, cast to x's dtype, into x's first element in place
    and return x: a loop-carried value in the input, so no iteration can
    be hoisted or reused. `acc` is a scalar tensor on x's device, so
    nothing synchronizes."""
    x[(0,) * x.ndim].copy_((acc % 2).to(x.dtype))
    return x


def _tensors(obj: Any) -> Iterator[torch.Tensor]:
    """Every tensor in `obj` (nested tuples, lists and mappings)."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _tensors(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _tensors(v)


def _device_of(args: Sequence[Any]) -> torch.device:
    """Where a chain over `args` runs: cuda when any tensor in them is
    on a CUDA device, else the CPU."""
    for t in _tensors(args):
        if t.is_cuda:
            return t.device
    return torch.device("cpu")


def _timed(fn: Callable, args: Tuple, device: torch.device) -> float:
    """Seconds of one `fn(*args)`: between two CUDA events on the current
    stream for a CUDA device, on the host's monotonic clock otherwise."""
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3
    t0 = time.monotonic()
    fn(*args)
    return time.monotonic() - t0


def _paired_slopes(
    c1fn: Callable, c2fn: Callable, args: Tuple,
    n1: int, n2: int, reps: int,
) -> dict:
    """`reps` INDEPENDENT slope measurements, interleaved short/long so
    drift of the card or the host (clocks, heat, neighbours) hits both
    chain lengths alike. Returns median + min/max: a single slope hides
    run-to-run dispersion."""
    device = _device_of(args)
    _timed(c1fn, args, device)  # settle: first-call set-up outside the reps
    _timed(c2fn, args, device)
    slopes = []
    for _ in range(reps):
        t1 = _timed(c1fn, args, device)
        t2 = _timed(c2fn, args, device)
        slopes.append((t2 - t1) / (n2 - n1))
    # a non-positive slope is a FAILED rep (noise swallowed the delta),
    # not a fast one: clamping it into min would publish an absurd range
    # bound. Report stats over the valid reps and count the failures so
    # a mostly-degenerate point is visible.
    valid = sorted(s for s in slopes if s > 0)
    if not valid:
        return {
            "median": 1e-9, "min": 1e-9, "max": 1e-9,
            "reps": reps, "degenerate_reps": reps,
        }
    stats = {
        "median": valid[len(valid) // 2],
        "min": valid[0],
        "max": valid[-1],
        "reps": reps,
    }
    if len(valid) < reps:
        stats["degenerate_reps"] = reps - len(valid)
    return stats


def device_seconds_per_iter_stats(
    step: Callable[..., torch.Tensor],
    *args: Any,
    chains: Tuple[int, int] = (10, 50),
    reps: int = 5,
) -> dict:
    """Per-iteration seconds of `step` with dispersion: dict of
    median/min/max over `reps` independent paired slopes.

    `step(i, acc, *args)` must return a float32 scalar tensor that
    depends on the FULL computation under test (reduce its output, e.g.
    `out.float().amax()`), and should feed `poke(input, acc)` into the
    op so iterations can't be reused. Each slope uses two chain lengths
    to cancel fixed launch and readback costs."""

    def chained(n, *a):
        acc = torch.zeros((), dtype=torch.float32, device=_device_of(a))
        for i in range(n):
            acc = step(i, acc, *a) * 1e-12 + acc
        return acc

    return dynamic_slope_stats(chained, args, chains, reps)


def device_seconds_per_iter(
    step: Callable[..., torch.Tensor],
    *args: Any,
    chains: Tuple[int, int] = (10, 50),
    reps: int = 5,
) -> float:
    """Median seconds per on-device execution of `step` (see
    `device_seconds_per_iter_stats` for the dispersion-reporting
    form)."""
    return device_seconds_per_iter_stats(
        step, *args, chains=chains, reps=reps
    )["median"]


def dynamic_slope_stats(
    fn: Callable,
    args: Tuple,
    lengths: Tuple[int, int] = (16, 64),
    reps: int = 5,
) -> dict:
    """Slope stats for a body whose chain length is an argument:
    `fn(n, *args)` runs the sequential body n times (e.g. a decode loop
    carrying the KV cache, or a train loop carrying its state). The same
    callable serves both lengths, so the two chains differ only in n."""
    n1, n2 = lengths
    return _paired_slopes(
        lambda *a: fn(n1, *a), lambda *a: fn(n2, *a), args, n1, n2, reps
    )


def forward_rate_stats(
    forward: Callable,
    variables: Any,
    batch_u8: torch.Tensor,
    *,
    chains: Tuple[int, int] = (10, 50),
    reps: int = 5,
) -> dict:
    """Steady-state seconds per forward(variables, batch) on the batch's
    device, with dispersion (median/min/max over `reps` paired slopes)."""

    def step(i, acc, vs, b):
        return forward(vs, poke(b, acc)).float().amax()

    with torch.inference_mode():
        return device_seconds_per_iter_stats(
            step, variables, batch_u8, chains=chains, reps=reps
        )


def forward_rate(
    forward: Callable,
    variables: Any,
    batch_u8: torch.Tensor,
    *,
    chains: Tuple[int, int] = (10, 50),
    reps: int = 5,
) -> float:
    """Median form of `forward_rate_stats`."""
    return forward_rate_stats(
        forward, variables, batch_u8, chains=chains, reps=reps
    )["median"]


def attention_flops(b: int, tq: int, tk: int, h: int, d: int) -> float:
    """FLOPs of one attention forward, q [b, tq, h, d] against tk keys:
    2 per multiply-add of q·k^T and p·v over every (query, key) pair,
    4·b·h·tq·tk·d, causal or not (torch.utils.flop_counter's count for
    scaled_dot_product_attention)."""
    return 4.0 * b * h * tq * tk * d


@contextlib.contextmanager
def _kernel_flops(counter) -> Iterator[list]:
    """While active, each flash attention forward (K2, a ctypes launch no
    aten op sees) is counted by `attention_flops`, in place of whatever
    the counter saw inside it (the plain version's matrix products on a
    CPU tensor): the yielded list collects the corrections."""
    from .ops import flash_attention as fa

    extra = [0.0]
    orig = fa._forward

    def counted(q, k, v, causal, scale):
        before = counter.get_total_flops()
        out = orig(q, k, v, causal, scale)
        seen = counter.get_total_flops() - before
        b, tq, h, d = q.shape
        extra[0] += attention_flops(b, tq, k.shape[1], h, d) - seen
        return out

    fa._forward = counted
    try:
        yield extra
    finally:
        fa._forward = orig


def compiled_flops(forward: Callable, variables: Any, batch: torch.Tensor) -> float:
    """FLOPs of one forward(variables, batch), the MFU numerator: the
    convolutions and matrix products at 2 per multiply-add, every output
    position times its full window (`torch.utils.flop_counter`), and the
    port's flash attention kernel by `attention_flops`. The count is the
    same whichever implements the work, the card's kernels or the plain
    versions on the CPU.

    The name is the JAX package's; the count is not XLA's. XLA's
    `cost_analysis` counts less for the same forward: on the CPU, 0.884x
    this count for ResNet50 at batch 2, 64x64, and 0.808x for InceptionV3
    at batch 2, 75x75 (tests/test_torch_benchmarks.py pins both ratios),
    so an MFU from this count is not comparable with the JAX package's
    without that factor."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with torch.inference_mode(), counter, _kernel_flops(counter) as extra:
        forward(variables, batch)
    return float(counter.get_total_flops() + extra[0])


def dispatch_latency(
    forward: Callable, variables: Any, batch_u8: torch.Tensor, reps: int = 20
) -> Tuple[float, float]:
    """(p50, p99) seconds from submit to the full batch result on the
    host (`.cpu()`): the end-to-end latency a client of one batch sees,
    unlike the slope, which is the pipelined throughput."""
    with torch.inference_mode():
        forward(variables, batch_u8).cpu()  # settle
        lat = []
        for _ in range(reps):
            t0 = time.monotonic()
            forward(variables, batch_u8).cpu()
            lat.append(time.monotonic() - t0)
    lat.sort()
    return lat[len(lat) // 2], lat[min(len(lat) - 1, int(len(lat) * 0.99))]


# published dense bf16 FLOP/s per card, by a substring of its CUDA name
# (lower case): NVIDIA's H100 SXM data sheet, at the 700 W power limit
PEAK_FLOPS = {
    "h100 80gb hbm3": 989e12,  # H100 SXM
}


def peak_flops(device: Optional[Any] = None) -> float:
    """The card's published dense bf16 peak (`PEAK_FLOPS`), by
    `torch.cuda.get_device_name(device)`. Raises for a card the table
    lacks: an MFU against another card's peak is not an MFU."""
    name = torch.cuda.get_device_name(device)
    kind = name.lower()
    for sub, peak in PEAK_FLOPS.items():
        if sub in kind:
            return peak
    raise ValueError(f"no published peak for {name!r}: add it to PEAK_FLOPS")

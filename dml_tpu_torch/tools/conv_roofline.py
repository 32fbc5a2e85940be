"""Analytical conv roofline on an NVIDIA H100: where each CNN's MFU
ceiling sits. PyTorch counterpart of dml_tpu/tools/conv_roofline.py.

For every convolution of a model's eval forward, viewed as a matrix
product (M = N·Ho·Wo output rows, K = kh·kw·Cin_g, Nc = Cout):

- **tensor-core term**: a bf16 `wgmma` instruction is m64nNk16 (the
  PTX ISA's warpgroup MMA shapes: N a multiple of 8 up to 256, K 16 for
  16-bit inputs), so K pads to a multiple of 16 and Cout to a multiple
  of 8; tile utilization = (K/K_pad)·(Nc/Nc_pad), and the term is
  FLOPs / (PEAK · utilization). A depthwise conv (groups > 1) never
  reaches the tensor cores: it keeps only the stream term, as JAX's VPU
  branch does.
- **HBM term**: bytes (input + weights + output at bf16) / stream
  bandwidth, at the published `HBM_BW`, or at the measured per-class
  bandwidth (`eff_bw`).

Per conv, time = max(tensor-core, HBM) (no overlap within a conv);
summing gives a **pessimistic** serial roofline, while max(sum
tensor-core, sum HBM) gives an **optimistic** perfectly-pipelined one.
A measured MFU below the pessimistic bound points at a layout or
algorithm problem, not at the architecture.

The inventory is taken from the port's model without running a
convolution: the model is built on the `meta` device and its eval
forward runs under a `TorchDispatchMode` that records each
`aten.convolution` and `aten.cat` (the port's `layers.Conv2d` is an
`nn.Conv2d`; Inception joins its branches with `torch.cat`). Shapes are
reported in the JAX package's NHWC/HWIO terms (lhs, rhs, out), so the
two packages' fields compare directly. A conv's lhs is its input as the
convolution reads it: where the port pads inside the conv (ResNet's
stem, `Conv2d(padding=3)`) and JAX pads before it, the padded extent is
the same and the lhs is not.

`microbench` and `concat_microbench` time each unique shape in
isolation through `benchmarks.device_seconds_per_iter` with
`F.conv2d` / `torch.cat` (cuDNN and PyTorch's copy, library calls as
`lax.conv` is in JAX: no kernel of the port is replaced) and compare
with the fused forward, the port's model on the card.

Run: ``python -m dml_tpu_torch.tools.conv_roofline [model ...]``
(CPU-safe: runs nothing on a device), ``--concat [model batch]``, or on
the card ``--microbench [model batch]`` / ``--concat-microbench [model
batch]``.
"""

from __future__ import annotations

import collections
import json
import math
import sys
from typing import Any, Dict, List, Tuple

# NVIDIA's H100 SXM data sheet, at the 700 W power limit
HBM_BW = 3.35e12  # HBM3 bytes/s
PEAK = 989e12  # dense bf16 FLOP/s

# the bf16 wgmma granule: K (reduction) and N (output columns)
K_GRANULE = 16
N_GRANULE = 8


def eff_bw(feature_group_count: int, spatial: int) -> float:
    """Per-class effective HBM bandwidth of an isolated bf16 conv,
    measured on the card by `microbench("EfficientNetB4", 128)` at 380x380
    (chip_smoke.py phase 22, NVIDIA H100 80GB HBM3, 700.00 W): each
    class's bytes over its slope time, summed over B4's unique shapes by
    occurrence. Two buckets per class by the input's spatial size, as
    the JAX module keeps: depthwise 1.88 TB/s at 48^2 and up (95^2-191^2
    at 1.43-2.49), 1.18 at 12^2-27^2 (0.89-1.89); dense 1.93 at 95^2 and
    up (2.46-2.79 for the 1x1s, 0.51 for the 3-channel stem), 0.93 below
    (0.35-1.58: at 12^2-24^2 each conv takes the ~120-140 us a chain
    iteration costs the host, so these read the launch floor, not
    HBM). The squeeze-excite convs on 1x1 maps are left out of the
    buckets: their ~125 us are that floor, for a few KB."""
    if feature_group_count > 1:  # depthwise: a window stream, no tensor cores
        return 1.88e12 if spatial >= 48 else 1.18e12
    return 1.93e12 if spatial >= 95 else 0.93e12


def _nhwc(shape) -> Tuple[int, ...]:
    n, c, h, w = shape
    return (n, h, w, c)


class _Inventory:
    """A dispatch mode recording every convolution and concatenation of
    a forward, in NHWC/HWIO terms."""

    def __init__(self):
        self.convs: List[Dict[str, Any]] = []
        self.concats: List[Tuple[Tuple[Tuple[int, ...], ...], Tuple[int, ...], int]] = []

    def mode(self):
        import torch
        from torch.utils._python_dispatch import TorchDispatchMode

        conv, cat = torch.ops.aten.convolution.default, torch.ops.aten.cat.default
        inv = self

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                if func is conv:
                    inv._conv(args, out)
                elif func is cat:
                    inv._cat(args, kwargs or {}, out)
                return out

        return Mode()

    def _conv(self, args, out):
        x, w, _b, stride, padding, dilation, transposed, _op, groups = args
        if transposed or any(d != 1 for d in dilation) or x.ndim != 4:
            raise ValueError(f"conv_roofline: unsupported convolution {tuple(w.shape)} "
                             f"(transposed={transposed}, dilation={tuple(dilation)})")
        o, cin_g, kh, kw = w.shape
        self.convs.append({
            "lhs": _nhwc(x.shape),
            "rhs": (kh, kw, cin_g, o),
            "out": _nhwc(out.shape),
            "groups": int(groups),
            "strides": tuple(int(s) for s in stride),
            "padding": tuple((int(p), int(p)) for p in padding),
        })

    def _cat(self, args, kwargs, out):
        tensors = args[0]
        dim = int(args[1] if len(args) > 1 else kwargs.get("dim", 0))
        if out.ndim == 4:  # NCHW -> NHWC
            ins = tuple(_nhwc(t.shape) for t in tensors)
            self.concats.append((ins, _nhwc(out.shape), (0, 3, 1, 2)[dim % 4]))
        else:
            ins = tuple(tuple(t.shape) for t in tensors)
            self.concats.append((ins, tuple(out.shape), dim % out.ndim))


def inventory(name: str, batch: int) -> _Inventory:
    """Every convolution and concatenation of `name`'s eval forward at
    `batch` x its input size, bf16, taken on the `meta` device (nothing
    is computed or allocated)."""
    import torch

    from ..models.registry import get_model

    spec = get_model(name)
    with torch.device("meta"):
        model = spec.build(dtype=torch.bfloat16).eval()
        x = torch.zeros((batch, *spec.input_size, 3), dtype=torch.bfloat16)
    inv = _Inventory()
    # no_grad, not inference_mode: under inference_mode the mode would see
    # aten.conv2d, before its decomposition into aten.convolution
    with torch.no_grad(), inv.mode():
        model(x)
    return inv


def _conv_flops(c: Dict[str, Any]) -> float:
    kh, kw, cin_g, cout = c["rhs"]
    n, ho, wo, _ = c["out"]
    return 2.0 * n * ho * wo * kh * kw * cin_g * cout


def _conv_bytes(c: Dict[str, Any]) -> float:
    return 2.0 * (math.prod(c["lhs"]) + math.prod(c["rhs"]) + math.prod(c["out"]))


def tile_util(k_dim: int, n_dim: int) -> float:
    """The share of a padded wgmma tile doing useful work: K padded to
    `K_GRANULE`, Cout to `N_GRANULE`."""
    return ((k_dim / (math.ceil(k_dim / K_GRANULE) * K_GRANULE))
            * (n_dim / (math.ceil(n_dim / N_GRANULE) * N_GRANULE)))


def _roofline(convs: List[Dict[str, Any]], name: str, batch: int) -> Dict[str, Any]:
    tot_flops = tc_flops = w_util = 0.0
    t_serial = t_tc_sum = t_mem_sum = t_serial_meas = 0.0
    for c in convs:
        kh, kw, cin_g, cout = c["rhs"]
        flops = _conv_flops(c)
        tot_flops += flops
        bytes_ = _conv_bytes(c)
        t_mem = bytes_ / HBM_BW
        t_mem_meas = bytes_ / eff_bw(c["groups"], c["lhs"][1])
        t_mem_sum += t_mem
        if c["groups"] > 1:  # depthwise: a stream, no tensor-core work
            t_serial += t_mem
            t_serial_meas += t_mem_meas
            continue
        util = tile_util(kh * kw * cin_g, cout)
        t_tc = flops / (PEAK * util)
        tc_flops += flops
        w_util += flops * util
        t_tc_sum += t_tc
        t_serial += max(t_tc, t_mem)
        t_serial_meas += max(t_tc, t_mem_meas)
    t_pipelined = max(t_tc_sum, t_mem_sum)
    return {
        "model": name,
        "batch": batch,
        "conv_gflops": round(tot_flops / 1e9, 1),
        "mxu_flop_share": round(tc_flops / tot_flops, 3),
        "tile_util_flop_weighted": round(w_util / max(tc_flops, 1), 3),
        "mfu_bound_serial": round(tot_flops / PEAK / t_serial, 3),
        "mfu_bound_serial_measured_bw": round(tot_flops / PEAK / t_serial_meas, 3),
        "mfu_bound_pipelined": round(tot_flops / PEAK / t_pipelined, 3),
        "roofline_ms_serial": round(t_serial * 1e3, 2),
        "roofline_ms_serial_measured_bw": round(t_serial_meas * 1e3, 2),
        "roofline_ms_pipelined": round(t_pipelined * 1e3, 2),
    }


def analyze(name: str, batch: int) -> Dict[str, Any]:
    """The roofline of `name` at `batch` (the JAX module's fields;
    `mxu_flop_share` is the tensor cores' share of the conv FLOPs)."""
    return _roofline(inventory(name, batch).convs, name, batch)


def _device(device):
    from ..models.lm_params import resolve_device

    return resolve_device(device)


def _conv_step(stride, padding, groups):
    import torch.nn.functional as F

    from ..benchmarks import poke

    def step(i, acc, x, w):
        y = F.conv2d(poke(x, acc), w, None, stride, padding, 1, groups)
        return y[0, 0, 0, 0].float()  # the next iteration's poke waits on this one

    return step


def _zeros_nchw(nhwc, dev, dtype):
    """A zero tensor of NHWC extents `nhwc`, as PyTorch's NCHW logical
    shape in channels-last memory (the engine's layout)."""
    import torch

    n, h, w, c = nhwc
    return torch.zeros((n, c, h, w), dtype=dtype, device=dev).to(
        memory_format=torch.channels_last)


def microbench(name: str = "EfficientNetB4", batch: int = 128, device=None) -> Dict[str, Any]:
    """Slope-time every UNIQUE conv shape of the model in isolation on the
    card, sum (weighted by occurrence count), and compare against the
    fused full forward (the port's model with its seeded weights).
    `shapes` gives each unique shape's class (depthwise or dense), input
    spatial size and measured bandwidth: the figures `eff_bw` holds."""
    import torch

    from ..benchmarks import device_seconds_per_iter, forward_rate
    from ..models.params_io import init_variables
    from ..models.registry import get_model

    dev = _device(device)
    inv = inventory(name, batch)
    shapes: collections.Counter = collections.Counter()
    for c in inv.convs:
        shapes[(c["lhs"], c["rhs"], c["groups"], c["strides"], c["padding"], c["out"])] += 1
    tot_flops = sum(_conv_flops(c) for c in inv.convs)
    t_parts = 0.0
    rows = []
    for (ls, rs, fg, st, pad, out), cnt in shapes.items():
        kh, kw, cin_g, cout = rs
        x = _zeros_nchw(ls, dev, torch.bfloat16)
        w = torch.zeros((cout, cin_g, kh, kw), dtype=torch.bfloat16, device=dev).to(
            memory_format=torch.channels_last)
        step = _conv_step(st, tuple(p[0] for p in pad), fg)
        # reps>=3: with 2 samples the "median" is the max
        with torch.inference_mode():
            t = device_seconds_per_iter(step, x, w, chains=(6, 24), reps=3)
        t_parts += t * cnt
        b = _conv_bytes({"lhs": ls, "rhs": rs, "out": out})
        rows.append({"kind": "depthwise" if fg > 1 else "dense", "spatial": ls[1],
                     "lhs": list(ls), "rhs": list(rs), "count": cnt,
                     "us": round(t * 1e6, 2), "gb_per_s": round(b / t / 1e9, 1)})
        del x, w
    spec = get_model(name)
    model = spec.build(dtype=torch.bfloat16)
    model.load_state_dict(init_variables(spec, seed=0))
    model = model.to(dev, memory_format=torch.channels_last).eval()
    x0 = torch.zeros((batch, *spec.input_size, 3), dtype=torch.bfloat16, device=dev)
    t_fused = forward_rate(lambda m, x: m(x), model, x0, chains=(3, 10), reps=3)
    return {
        "model": name,
        "batch": batch,
        "unique_conv_shapes": len(shapes),
        "conv_gflops": round(tot_flops / 1e9, 1),
        "isolated_sum_ms": round(t_parts * 1e3, 1),
        "isolated_sum_mfu": round(tot_flops / PEAK / t_parts, 3),
        "fused_forward_ms": round(t_fused * 1e3, 1),
        "fused_conv_mfu": round(tot_flops / PEAK / t_fused, 3),
        "fusion_overlap_factor": round(t_parts / t_fused, 2),
        "shapes": rows,
    }


def _concat_shapes(name: str, batch: int):
    """(concat inventory, conv tot_flops): every concatenation in the
    model's forward as (input_shapes, output_shape, dim) with occurrence
    counts, plus the conv FLOP total the bounds normalize by. CPU-safe
    (the meta device)."""
    inv = inventory(name, batch)
    return collections.Counter(inv.concats), sum(_conv_flops(c) for c in inv.convs)


def concat_analysis(name: str = "InceptionV3", batch: int = 128) -> Dict[str, Any]:
    """CPU-safe concat accounting: the conv roofline treats each
    branch's output as free to materialize, but a branch CONCAT is a
    pure HBM copy (every input read, the joined tensor written, zero
    FLOPs). Folding those bytes, at the stream bandwidth the conv HBM
    terms use, into the serial roofline gives
    `mfu_bound_serial_with_concat`. `concat_microbench` replaces the
    constant with isolated slope-timed concats at the model's shapes."""
    concats, tot_flops = _concat_shapes(name, batch)
    base = analyze(name, batch)
    concat_bytes = 0.0
    n_concats = 0
    for (ins, out_shape, _dim), cnt in concats.items():
        per = 2.0 * (sum(math.prod(s) for s in ins) + math.prod(out_shape))
        concat_bytes += per * cnt
        n_concats += cnt
    t_concat = concat_bytes / HBM_BW
    t_serial = base["roofline_ms_serial"] / 1e3
    # zero concat traffic degenerates EXACTLY to the plain bound (the
    # reconstruction from the rounded ms field would drift a ulp)
    with_concat = (
        base["mfu_bound_serial"] if concat_bytes == 0
        else round(tot_flops / PEAK / (t_serial + t_concat), 3)
    )
    return {
        "model": name,
        "batch": batch,
        "concat_sites": n_concats,
        "concat_unique_shapes": len(concats),
        "concat_gbytes": round(concat_bytes / 1e9, 2),
        "concat_ms_at_stream_bw": round(t_concat * 1e3, 2),
        "mfu_bound_serial": base["mfu_bound_serial"],
        "mfu_bound_serial_with_concat": with_concat,
    }


def concat_microbench(name: str = "InceptionV3", batch: int = 128, device=None) -> Dict[str, Any]:
    """On-card concat evidence: slope-time an isolated `torch.cat` at
    every unique concat shape of the model's forward (channels-last
    inputs, the engine's layout), sum by occurrence, and fold the
    MEASURED copy time into the serial conv roofline."""
    import torch

    from ..benchmarks import device_seconds_per_iter, poke

    dev = _device(device)
    concats, tot_flops = _concat_shapes(name, batch)
    base = analyze(name, batch)
    t_parts = 0.0
    concat_bytes = 0.0
    for (ins, out_shape, dim), cnt in concats.items():
        if len(out_shape) == 4:
            args = [_zeros_nchw(s, dev, torch.bfloat16) for s in ins]
            tdim = (0, 2, 3, 1)[dim]  # NHWC dim -> NCHW dim
        else:
            args = [torch.zeros(s, dtype=torch.bfloat16, device=dev) for s in ins]
            tdim = dim
        concat_bytes += cnt * 2.0 * (sum(math.prod(s) for s in ins) + math.prod(out_shape))

        def step(i, acc, *ops, dim=tdim):
            y = torch.cat((poke(ops[0], acc),) + ops[1:], dim)
            return y.reshape(-1)[0].float()

        with torch.inference_mode():
            t_parts += device_seconds_per_iter(step, *args, chains=(6, 24), reps=3) * cnt
        del args
    t_serial = base["roofline_ms_serial"] / 1e3
    t_concat_const = concat_bytes / HBM_BW
    eff_bw_meas = concat_bytes / t_parts if t_parts > 0 else None
    return {
        "model": name,
        "batch": batch,
        "concat_sites": sum(concats.values()),
        "concat_unique_shapes": len(concats),
        "concat_gbytes": round(concat_bytes / 1e9, 2),
        "concat_ms_measured": round(t_parts * 1e3, 2),
        "concat_bw_gb_per_s": (
            round(eff_bw_meas / 1e9, 1) if eff_bw_meas else None
        ),
        "mfu_bound_serial": base["mfu_bound_serial"],
        "mfu_bound_serial_with_concat": round(
            tot_flops / PEAK / (t_serial + t_parts), 3
        ),
        "concat_ms_at_stream_bw": round(t_concat_const * 1e3, 2),
        "mfu_bound_serial_with_concat_stream_bw": round(
            tot_flops / PEAK / (t_serial + t_concat_const), 3
        ),
        "note": "isolated copies are pessimistic (in the fused forward a concat "
                "can overlap other work), so the corrected bound brackets the "
                "truth from below while the concat-blind roofline brackets it "
                "from above",
    }


def main() -> None:
    args = [
        a for a in sys.argv[1:]
        if a not in ("--microbench", "--concat", "--concat-microbench")
    ]

    def model_batch(default_model, default_batch=128):
        """(model, batch) from the positional operands."""
        model = args[0] if args else default_model
        batch = int(args[1]) if len(args) > 1 else default_batch
        return model, batch

    if "--microbench" in sys.argv[1:]:
        print(json.dumps(microbench(*model_batch("EfficientNetB4"))))
        return
    if "--concat-microbench" in sys.argv[1:]:
        print(json.dumps(concat_microbench(*model_batch("InceptionV3"))))
        return
    if "--concat" in sys.argv[1:]:
        print(json.dumps(
            concat_analysis(*model_batch("InceptionV3")), indent=1
        ))
        return
    targets = args or ["ResNet50", "InceptionV3", "EfficientNetB4"]
    out = [analyze(t, b) for t in targets for b in (32, 128)]
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()

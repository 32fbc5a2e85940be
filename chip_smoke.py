#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (dml_tpu_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero:

1. device: the card's name, capability (must be 9.x, Hopper) and power
   limit;
2. build: nvcc builds the normalize kernel from dml_tpu_torch/csrc/;
3. kernel: the kernel against its plain PyTorch version on the card, in
   every mode (caffe, tf, unit), output dtype (bf16, f32) and shape
   ([32,224,224,3], [32,299,299,3], ragged [3,7,5,3]); float32 must
   agree within 1e-6, bf16 within one bf16 ulp (and the count of
   elements that are not bit-identical is printed). Kernel and plain
   times by CUDA events, L2 flushed before every launch, beside the
   device-memory byte bound;
4. ResNet50 and 5. InceptionV3, bf16 at batch 32, served through the
   port's InferenceEngine on cuda with seeded weights: infer_arrays on
   40 images (2 padded chunks), infer_arrays_nowait on the same,
   infer_files on 8 PNGs. The kernel's launch count over that run must
   equal the number of forward chunks. Probabilities must be finite and
   sum to 1; top-1 must match the same module fed by the plain
   normalize, and, on 4 images, the port's float32 CPU engine (both the
   bf16 engine and a float32 CUDA engine with TF32 off). Per-batch
   latency p50/p90/p99 over 1000 batches and images/s at batch 32, the
   device time of one forward, and a torch.profiler breakdown of where
   a batch's time goes.

Then the card's name and power limit as nvidia-smi prints them, the
kernels' summary line, and last `{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published
BATCH = 32
N_IMAGES = 40  # 2 chunks at batch 32: one full, one padded
N_FILES = 8
MODELS = (("ResNet50", "caffe"), ("InceptionV3", "tf"))


def check(ok, msg):
    """A check that stays under `python -O` (unlike assert)."""
    if not ok:
        raise AssertionError(msg)


def emit(**kw):
    print(json.dumps(kw), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def bf16_ulp(ref):
    import torch

    a = ref.float().abs().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


class Timer:
    """Per-launch device time by CUDA events. A 256 MB write before each
    launch evicts the 50 MB L2 (the serving path meets its input cold)
    and keeps the card busy while the host enqueues the timed launch,
    so host overhead stays out of the measurement."""

    def __init__(self):
        import torch

        self.flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")

    def ms(self, fn, iters=30, warmup=3):
        import torch

        for _ in range(warmup):
            fn()
        pairs = []
        for _ in range(iters):
            self.flush.zero_()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            pairs.append((s, e))
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in pairs)


def phase_kernel(timer):
    import torch
    from dml_tpu_torch.ops import preprocess as ops
    from dml_tpu_torch.models.preprocess import normalize_on_device

    g = torch.Generator(device="cuda").manual_seed(0)
    timings = {}
    for shape in ((32, 224, 224, 3), (32, 299, 299, 3), (3, 7, 5, 3)):
        x = torch.randint(0, 256, shape, dtype=torch.uint8, device="cuda", generator=g)
        for mode in ("caffe", "tf", "unit"):
            for dtype in (torch.bfloat16, torch.float32):
                got = ops.fused_normalize(x, mode, dtype)
                want = normalize_on_device(x, mode, dtype)
                torch.cuda.synchronize()
                check(got.dtype == dtype and got.shape == x.shape and got.is_contiguous(),
                      f"kernel output {got.dtype} {tuple(got.shape)}")
                err = (got.float() - want.float()).abs()
                max_err = float(err.max())
                n_diff = int((got != want).sum())
                if dtype == torch.float32:
                    ok = max_err <= 1e-6
                else:
                    ok = bool((err <= bf16_ulp(want)).all())
                case = dict(phase="kernel_check", shape=list(shape), mode=mode,
                            dtype=str(dtype).split(".")[-1], max_abs_err=max_err,
                            n_not_identical=n_diff, ok=ok)
                emit(**case)
                if not ok:
                    raise AssertionError(f"normalize kernel disagrees: {case}")
                if shape[0] == 32:
                    k_ms = timer.ms(lambda: ops.fused_normalize(x, mode, dtype))
                    p_ms = timer.ms(lambda: normalize_on_device(x, mode, dtype))
                    nbytes = x.numel() * (1 + got.element_size())
                    bound = nbytes / HBM_BYTES_PER_S * 1e3
                    timings[(shape, mode, dtype)] = dict(
                        ms=k_ms, plain_ms=p_ms, bound_ms=bound, max_abs_err=max_err)
                    emit(phase="kernel_time", shape=list(shape), mode=mode,
                         dtype=str(dtype).split(".")[-1], ms=k_ms, plain_ms=p_ms,
                         bound_ms=bound, bytes=nbytes,
                         achieved_gb_s=nbytes / (k_ms * 1e-3) / 1e9)
    return timings


def seeded_weights(spec, seed):
    """The engine's seeded init, with BN statistics, scales and shifts
    drawn from the same seed: with Flax's init alone (mean 0, var 1)
    every image of a random ResNet saturates to one class, which makes
    top-1 agreement a weak check."""
    import torch
    from dml_tpu_torch.models.params_io import init_variables

    sd = init_variables(spec, seed=seed)
    g = torch.Generator().manual_seed(seed + 1)
    for k, v in sd.items():
        if k.endswith("running_mean"):
            v.normal_(0.0, 0.2, generator=g)
        elif k.endswith("running_var"):
            v.uniform_(0.5, 2.0, generator=g)
        elif k.endswith(".weight") and v.ndim == 1 and "batch_normalization" not in k:
            v.uniform_(0.5, 1.0, generator=g)  # BN scale (InceptionV3 has none)
        elif k.endswith(".bias") and v.ndim == 1 and k != "predictions.bias":
            if k.replace(".bias", ".running_mean") in sd:
                v.normal_(0.0, 0.2, generator=g)  # BN shift
    return sd


def write_pngs(dirname, imgs):
    from PIL import Image

    files = []
    for i, im in enumerate(imgs):
        p = os.path.join(dirname, f"img{i}.png")
        Image.fromarray(im).save(p)
        files.append(p)
    return files


def phase_model(name, mode, timer):
    import torch
    from dml_tpu_torch.inference import InferenceEngine
    from dml_tpu_torch.models.preprocess import normalize_on_device
    from dml_tpu_torch.models.registry import get_model
    from dml_tpu_torch.ops import preprocess as ops

    spec = get_model(name)
    h, w = spec.input_size
    sd = seeded_weights(spec, seed=0)
    rng = np.random.RandomState(1)
    imgs = rng.randint(0, 256, (N_IMAGES, h, w, 3)).astype(np.uint8)
    # per-image brightness so the images differ in more than noise
    imgs = np.clip(imgs // 2 + rng.randint(0, 128, (N_IMAGES, 1, 1, 3)), 0, 255).astype(np.uint8)

    eng = InferenceEngine(dtype=torch.bfloat16)  # device None -> cuda
    check(eng.device.type == "cuda", f"engine on {eng.device}")
    t0 = time.monotonic()
    lm = eng.load_model(name, variables=sd, batch_size=BATCH)
    load_s = time.monotonic() - t0

    with tempfile.TemporaryDirectory() as tmp:
        files = write_pngs(tmp, imgs[:N_FILES])
        # ---- the main path, counted ----
        ops.normalize_launches = 0
        probs = eng.infer_arrays(name, imgs)
        probs_nw = eng.infer_arrays_nowait(name, imgs)()
        res = eng.infer_files(name, files)
        torch.cuda.synchronize()
        launches = ops.normalize_launches
    chunks = 2 * -(-N_IMAGES // BATCH) + -(-N_FILES // BATCH)
    check(launches == chunks, f"{name}: {launches} kernel launches for {chunks} chunks")
    check(probs.shape == (N_IMAGES, 1000) and probs.dtype == np.float32,
          f"{name}: probs {probs.dtype} {probs.shape}")
    check(np.isfinite(probs).all(), f"{name}: non-finite probabilities")
    row_err = float(np.abs(probs.sum(-1) - 1.0).max())
    check(row_err <= 1e-2, f"{name}: rows sum to 1 +- {row_err}")
    nw_err = float(np.abs(probs_nw - probs).max())
    check(nw_err <= 1e-6, f"{name}: nowait differs from sync by {nw_err}")
    check(len(res.top5) == N_FILES and all(len(t) == 5 for t in res.top5),
          f"{name}: infer_files top-5 malformed")
    top1 = probs.argmax(-1)

    # same module fed by the plain normalize
    with torch.inference_mode():
        plain = []
        for s in range(0, N_IMAGES, BATCH):
            chunk = imgs[s:s + BATCH]
            pad = np.zeros((BATCH - len(chunk), h, w, 3), np.uint8)
            x = torch.from_numpy(np.concatenate([chunk, pad])).cuda()
            y = lm.module(normalize_on_device(x, mode, torch.bfloat16))
            plain.append(y[:len(chunk)].float().cpu().numpy())
    plain = np.concatenate(plain)
    plain_err = float(np.abs(plain - probs).max())
    check((plain.argmax(-1) == top1).all(), f"{name}: top-1 differs from the plain-normalize run")

    # float32 on the CPU vs the card (bf16, and f32 with TF32 off)
    few = imgs[:4]
    cpu = InferenceEngine(dtype=torch.float32, device="cpu")
    cpu.load_model(name, variables=sd, batch_size=4, warmup=False)
    p_cpu = cpu.infer_arrays(name, few)
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        g32 = InferenceEngine(dtype=torch.float32)
        g32.load_model(name, variables=sd, batch_size=4, warmup=False)
        p_g32 = g32.infer_arrays(name, few)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    del g32
    cpu_top1 = p_cpu.argmax(-1)
    srt = np.sort(p_cpu, -1)
    margins = (srt[:, -1] - srt[:, -2]).tolist()
    check((p_g32.argmax(-1) == cpu_top1).all(), f"{name}: f32 cuda top-1 != cpu")
    check((top1[:4] == cpu_top1).all(), f"{name}: bf16 cuda top-1 != f32 cpu")

    # latency at batch 32 through infer_arrays (copy in, forward, readback)
    batch = imgs[:BATCH]
    for _ in range(3):
        eng.infer_arrays(name, batch)
    lat = []  # 1000 samples: p99 has 10 beyond it
    for _ in range(1000):
        t0 = time.monotonic()
        eng.infer_arrays(name, batch)
        lat.append((time.monotonic() - t0) * 1e3)
    p50 = statistics.median(lat)
    p90, p99 = (float(v) for v in np.percentile(lat, [90, 99]))
    # device time of one forward alone (normalize + model), L2 flushed
    xb = torch.from_numpy(batch).cuda()
    fwd_ms = timer.ms(lambda: eng._forward(lm, xb), iters=10, warmup=2)
    emit(phase="model", model=name, dtype="bfloat16", batch=BATCH,
         load_s=load_s, first_query_s=lm.first_query, launches=launches,
         chunks=chunks, row_sum_err=row_err, nowait_vs_sync=nw_err,
         plain_normalize_max_abs_diff=plain_err,
         top1=top1.tolist(), top1_cpu_f32=cpu_top1.tolist(),
         cpu_f32_top_margin=margins,
         cuda_f32_vs_cpu_f32_max_abs=float(np.abs(p_g32 - p_cpu).max()),
         cuda_bf16_vs_cpu_f32_max_abs=float(np.abs(probs[:4] - p_cpu).max()),
         latency_samples=len(lat), latency_ms_p50=p50, latency_ms_p90=p90,
         latency_ms_p99=p99,
         images_per_s=BATCH / (statistics.mean(lat) / 1e3),
         forward_device_ms=fwd_ms,
         max_memory_allocated_mb=torch.cuda.max_memory_allocated() / 1e6)
    emit(phase="profile", model=name, **profile_serving(eng, name, batch))
    eng.unload_model(name)
    return launches


def profile_serving(eng, name, batch, iters=5):
    """Where a batch's time goes: torch.profiler over `iters` calls of
    infer_arrays at batch 32. Device time by kernel (top 8 and by kind),
    device operations per batch, and the device's idle share of the wall
    time (the profiler's own host overhead lengthens the wall time, so
    this share is an upper bound for the unprofiled run)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.monotonic()
        for _ in range(iters):
            eng.infer_arrays(name, batch)
        wall_us = (time.monotonic() - t0) * 1e6
    # (substring of the kernel name, kind), first match wins
    kinds = (("normalize_kernel", "normalize"), ("Memcpy HtoD", "copy_h2d"),
             ("Memcpy DtoH", "copy_d2h"), ("fprop", "conv"), ("implicit_gemm", "conv"),
             ("conv", "conv"), ("batch_norm", "batch_norm"), ("pool", "pool"),
             ("CatArray", "concat"), ("gemm", "dense"), ("softmax", "softmax"),
             ("clamp", "relu"), ("CUDAFunctor_add", "add"), ("reduce", "mean"))
    by_kind, per_kernel, n_kernels = {}, [], 0
    for e in prof.key_averages():
        us = e.self_device_time_total
        if e.device_type != torch.autograd.DeviceType.CUDA or us <= 0:
            continue
        per_kernel.append((us, e.key))
        n_kernels += e.count
        kind = next((v for k, v in kinds if k in e.key), "other")
        by_kind[kind] = by_kind.get(kind, 0.0) + us
    busy = sum(by_kind.values())
    per_kernel.sort(reverse=True)
    return dict(
        iters=iters, wall_ms_per_batch=wall_us / iters / 1e3,
        device_busy_ms_per_batch=busy / iters / 1e3 if busy else None,
        device_idle_share=1 - busy / wall_us if busy else None,
        device_ops_per_batch=n_kernels / iters,
        by_kind_ms_per_batch={k: v / iters / 1e3 for k, v in sorted(by_kind.items())},
        top_kernels=[(k[:120], us / iters / 1e3) for us, k in per_kernel[:8]],
    )


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    import dml_tpu_torch  # noqa: F401  (fails outside a checkout)

    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    smi = nvidia_smi()
    emit(phase="device", name=name, capability=list(cap), count=torch.cuda.device_count(),
         nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda)
    check(cap[0] == 9, f"expected a Hopper card (9.x), got {cap}")

    from dml_tpu_torch.ops import preprocess as ops

    t0 = time.monotonic()
    ops._library()
    emit(phase="build", kernel="normalize", seconds=time.monotonic() - t0)

    timer = Timer()
    timings = phase_kernel(timer)
    launches = {m: phase_model(m, mode, timer) for m, mode in MODELS}

    kernels = []
    for model, mode in MODELS:
        shape = (32, 224, 224, 3) if model == "ResNet50" else (32, 299, 299, 3)
        t = timings[(shape, mode, torch.bfloat16)]
        kernels.append(dict(
            name=f"normalize_u8[{model} b32 {mode} bf16]", route="cuda",
            source="dml_tpu_torch/csrc/normalize.cu",
            replaces="dml_tpu/ops/preprocess.py:30",
            launches=launches[model], max_abs_err=t["max_abs_err"],
            ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
            bound_by="bytes", library_ms=None,
        ))
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (dml_tpu_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero:

1. device: the card's name, capability (must be 9.x, Hopper) and power
   limit;
2. build: nvcc builds the four kernel libraries (normalize, flash
   attention forward and backward, decode attention) from
   dml_tpu_torch/csrc/, all started together, with seconds for each;
   beside them ptxas reports the flash forward's and backward's kernels
   (registers, spills; one `ptxas` line per source, with the wgmma
   kernels' setmaxnreg counts); a spill in a wgmma kernel fails;
3. kernel: the normalize kernel against its plain PyTorch version on the
   card, in every mode (caffe, tf, unit), output dtype (bf16, f32) and
   shape ([32,224,224,3], [32,299,299,3], ragged [3,7,5,3]); float32
   must agree within 1e-6, bf16 within one bf16 ulp (and the count of
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
   a batch's time goes;
6. flash_check: the flash attention forward against its plain version
   (out and lse), each case naming its route (`kernel_route`): the LM's
   prefill shape (q [8,2048,16,64], GQA-4 k/v [8,2048,4,64], bf16,
   causal, v a strided view of the qkv output) and B=1, the training
   forward ([1,2048,16,64], k/v repeated from 4 heads), D=128 (MHA, and
   GQA-4 at B=2 T=2048), ragged T=100 and T=1000, a poisoned tail (k/v
   [:, :1000] views of longer buffers holding +-1e4 past row 1000: the
   output must equal the clean copies'), non-causal cross attention
   (Tq=64, Tk=192; Tq=200, Tk=1000 GQA-4), bf16 D=32 (the mma.sync
   route) and float32 cases; tolerances float32 2e-5 (out and lse),
   bf16 out 2e-2 and lse 1e-4. At prefill_b8, prefill_b1 and mha_b1 the
   wgmma kernel, the mma.sync kernel (checked too), SDPA and the plain
   version are timed in turns (new, mma.sync, SDPA, plain, SDPA,
   mma.sync, new) beside the tensor-core operation bound, with TFLOP/s
   and share of the bound;
7. decode_check: the decode attention kernel against its plain version
   within 2e-5 for bf16, f32 and int8 caches; GQA-4, MQA and MHA; B=1
   and B=8 at T=4096 with mixed per-slot positions, and the LM's own
   decode shape; rows past each slot's position poisoned with +-1e4
   must not change the output. Kernel, plain and SDPA (bf16) times
   beside the byte bound of the valid cache rows;
8. lm: the 198M-parameter GQA-4 LM (bench.py's _bench_lm config, 12
   layers, d_model 1024, seeded weights) served by the port's generate
   on cuda in bf16: B=8 prompts of 2048 tokens, 64 new tokens. The
   flash kernel must launch 12 times (one per layer) and the decode
   kernel 12 x 63 times; tokens in range and equal to prefill plus 63
   batched_decode_step calls. Then the int8 form (int8 KV cache and
   int8 weights) for 16 new tokens with its launch counts, and float32
   parity: the CUDA run (TF32 off) and the port's CPU run give the same
   greedy tokens on 2 prompts of 32 tokens. Prefill ms, time to first
   token and decode ms per step (and tokens/s) at B=1 and B=8, peak
   device memory, and a torch.profiler breakdown of one prefill and one
   decode step;
9. flash_bwd_check: the flash backward (the delta kernel, then the dq
   and dkv kernels) against the plain `attention_backward` on the card,
   each case naming its route (`bwd_kernel_route`) and run with and
   without an lse cotangent: the training shape (q/k/v [1,2048,16,64]
   bf16, causal, k/v repeated to 16 heads as the LM's blocks send them),
   GQA k/v [1,2048,4,64], D=128 (MHA, and GQA-4 at T=2048), ragged
   T=100, 129, 193 and 1000, a poisoned tail (q, k, v and dO [:, :1000]
   views of longer buffers holding NaN past row 1000: the gradients must
   equal the clean copies'), strided views (q, k, v cut from a qkv
   projection's output, dO transposed), non-causal cross attention
   (Tq=64, Tk=192; Tq=200, Tk=1000 GQA-4), bf16 D=32 (the mma.sync
   route) and float32 at T=1000, cross and D=16; float32 within atol
   5e-5 + rtol 5e-4, bf16 within 1e-2 of the largest reference
   magnitude. The delta kernel's row arrays against `bwd_rows_plain`
   (lse and the pad rows exact, delta within 1e-4). Two backwards on the
   same inputs give bit-equal dq, dk and dv (train, gqa4). At the
   training shape the new pair, the mma.sync pair (checked too), the
   delta kernel, SDPA's backward and the plain version are timed in
   turns, whole and per kernel, beside the operation bounds (the
   backward's 5 products, the two-kernel split's 7, dq's 3 and dkv's 4)
   and the delta kernel's byte bound;
10. train: the port's LongContextLM on cuda at the same LM config, bf16,
   B=1, T=2048, seed 0: 1 warm-up and 20 steps on one seeded batch.
   Every loss finite, the last below the first; each step 12 flash, 12
   flash-backward and 12 delta-kernel launches and no other kernel; a checkpoint save
   and restore repeats the next two losses within 1e-5 relative; then
   16 greedy tokens from the trained weights (12 flash, 12 x 15 decode
   launches); float32 parity: a 2-layer d_model-128 config trained 3
   steps on cuda (TF32 off) and on the CPU gives losses within 1e-4
   relative. Step ms median and p90, tokens/s, peak device memory, and
   a torch.profiler breakdown of one step.

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
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # H100 SXM dense, published
BATCH = 32
N_IMAGES = 40  # 2 chunks at batch 32: one full, one padded
N_FILES = 8
MODELS = (("ResNet50", "caffe"), ("InceptionV3", "tf"))
# the LM that bench.py's _bench_lm measures (bench.py:3077-3085, GQA-4 at
# :3229-3232): about 198M parameters
LM_CFG = dict(vocab_size=32000, d_model=1024, n_heads=16, n_layers=12, d_ff=4096, n_kv_heads=4)
LM_BATCH, PROMPT_LEN, NEW_TOKENS = 8, 2048, 64
DECODE_CTX = 4096
# training: bench.py's lm_198m_t2048 entry (bench.py:2867-2903), batch 1
TRAIN_T, TRAIN_STEPS, TRAIN_NEW_TOKENS = 2048, 20, 16


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


def reset_launch_counts():
    """Every kernel's launch count to 0, just before a main path runs."""
    from dml_tpu_torch.ops import decode_attention, flash_attention, preprocess

    preprocess.normalize_launches = 0
    flash_attention.flash_launches = 0
    flash_attention.flash_bwd_launches = 0
    flash_attention.flash_bwd_delta_launches = 0
    decode_attention.decode_launches = 0


def launch_counts():
    from dml_tpu_torch.ops import decode_attention, flash_attention, preprocess

    return {"normalize": preprocess.normalize_launches,
            "flash_attention": flash_attention.flash_launches,
            "flash_bwd": flash_attention.flash_bwd_launches,
            "flash_bwd_delta": flash_attention.flash_bwd_delta_launches,
            "decode_attention": decode_attention.decode_launches}


def bf16_ulp(ref):
    import torch

    a = ref.float().abs().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


class Timer:
    """Per-launch device time by CUDA events. A 256 MB write before each
    launch evicts the 50 MB L2 (the serving path meets its input cold).
    Then the card spins for about a millisecond, longer than the host
    takes to enqueue the timed call: without that, a wrapper whose host
    side outlasts the flush (the decode wrapper, ~0.1-0.2 ms of Python on
    a loaded host) leaves the card idle between the start event and its
    kernel, and the measurement doubles with the host's load."""

    HOLD_CYCLES = 2_000_000  # ~1 ms at the H100's 1.98 GHz boost clock

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
            torch.cuda._sleep(self.HOLD_CYCLES)
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
        reset_launch_counts()
        probs = eng.infer_arrays(name, imgs)
        probs_nw = eng.infer_arrays_nowait(name, imgs)()
        res = eng.infer_files(name, files)
        torch.cuda.synchronize()
        counts = launch_counts()
    launches = counts["normalize"]
    chunks = 2 * -(-N_IMAGES // BATCH) + -(-N_FILES // BATCH)
    check(counts == {"normalize": chunks, "flash_attention": 0, "flash_bwd": 0,
                     "flash_bwd_delta": 0, "decode_attention": 0},
          f"{name}: launches {counts} for {chunks} chunks")
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
    emit(phase="profile", model=name,
         **profile_calls(lambda: eng.infer_arrays(name, batch), 5, IMAGE_KINDS))
    eng.unload_model(name)
    return launches


IMAGE_KINDS = (
    ("normalize_kernel", "normalize"), ("Memcpy HtoD", "copy_h2d"),
    ("Memcpy DtoH", "copy_d2h"), ("fprop", "conv"), ("implicit_gemm", "conv"),
    ("conv", "conv"), ("batch_norm", "batch_norm"), ("pool", "pool"),
    ("CatArray", "concat"), ("gemm", "dense"), ("softmax", "softmax"),
    ("clamp", "relu"), ("CUDAFunctor_add", "add"), ("reduce", "mean"))
LM_KINDS = (
    ("flash_fwd_", "flash_attention"), ("decode_partial_kernel", "decode_attention"),
    ("decode_merge_kernel", "decode_attention"), ("index_put", "cache_write"),
    ("gemm", "matmul"), ("gemv", "matmul"), ("nvjet", "matmul"), ("xmma", "matmul"),
    ("cutlass", "matmul"), ("Memcpy", "copy"), ("Memset", "copy"), ("reduce", "reduce"),
    ("index", "gather"), ("CatArray", "concat"), ("elementwise", "elementwise"))


def profile_calls(fn, iters, kinds):
    """Where a call's time goes: torch.profiler over `iters` calls of
    `fn`. Device time by kernel (top 8 and by kind, first substring
    match in `kinds` wins), device operations per call, and the device's
    idle share of the wall time (the profiler's own host overhead
    lengthens the wall time, so this share is an upper bound for the
    unprofiled run)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.monotonic()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.monotonic() - t0) * 1e6
    by_kind, per_kernel, n_kernels = {}, [], 0
    for e in prof.key_averages():
        us = e.self_device_time_total
        # a user annotation (Optimizer.step's record_function) spans its
        # kernels on the device timeline: counting it would count them twice
        if (e.device_type != torch.autograd.DeviceType.CUDA or us <= 0
                or getattr(e, "is_user_annotation", False)):
            continue
        per_kernel.append((us, e.key))
        n_kernels += e.count
        kind = next((v for k, v in kinds if k in e.key), "other")
        by_kind[kind] = by_kind.get(kind, 0.0) + us
    busy = sum(by_kind.values())
    per_kernel.sort(reverse=True)
    return dict(
        iters=iters, wall_ms_per_call=wall_us / iters / 1e3,
        device_busy_ms_per_call=busy / iters / 1e3 if busy else None,
        device_idle_share=1 - busy / wall_us if busy else None,
        device_ops_per_call=n_kernels / iters,
        by_kind_ms_per_call={k: v / iters / 1e3 for k, v in sorted(by_kind.items())},
        top_kernels=[(k[:120], us / iters / 1e3) for us, k in per_kernel[:8]],
    )


def build_all():
    """nvcc for every kernel library at once, one thread (and one nvcc)
    each; seconds per library."""
    from concurrent.futures import ThreadPoolExecutor

    from dml_tpu_torch.ops import _build, decode_attention, flash_attention, preprocess

    libs = {"normalize": preprocess._library, "flash_attention": flash_attention._library,
            "flash_attention_bwd": flash_attention._bwd_library,
            "decode_attention": decode_attention._library}

    def timed(fn):
        t0 = time.monotonic()
        fn()
        return time.monotonic() - t0

    sources = ("flash_attention.cu", "flash_attention_bwd.cu")
    t0 = time.monotonic()
    with ThreadPoolExecutor(len(libs) + len(sources)) as ex:
        reports = {src: ex.submit(_build.ptxas_report, [src]) for src in sources}
        futures = {k: ex.submit(timed, fn) for k, fn in libs.items()}
        seconds = {k: f.result() for k, f in futures.items()}
        ptxas = {src: ptxas_usage(r.result()) for src, r in reports.items()}
    emit(phase="build", seconds=seconds, wall_seconds=time.monotonic() - t0)
    for src in sources:
        emit(phase="ptxas", source=f"dml_tpu_torch/csrc/{src}", kernels=ptxas[src],
             setmaxnreg=setmaxnreg_counts(src))
        spills = {k: u for k, u in ptxas[src].items()
                  if "wgmma" in k and (u.get("spill_stores") or u.get("spill_loads"))}
        check(not spills, f"wgmma kernels spill registers: {spills}")


def ptxas_usage(report):
    """{kernel<template args>: {registers, spill_stores, spill_loads}}
    from ptxas -v."""
    import re

    usage, name = {}, None
    for line in report.splitlines():
        m = re.search(r"Function properties for \S*?(flash_(?:fwd|bwd)_\w+?_kernel)I((?:Li\d+E)+)E", line)
        if m:
            name = f"{m.group(1)}<{','.join(re.findall(r'Li(\d+)E', m.group(2)))}>"
            usage[name] = {}
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            usage[name].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            usage[name]["registers"] = int(m.group(1))
            name = None
    return usage


def setmaxnreg_counts(source):
    """The wgmma kernels' registers per thread after setmaxnreg, by role
    (and, in the forward, by consumer count), from their source: ptxas
    reports the count at entry."""
    import re

    from dml_tpu_torch.ops import _build

    with open(os.path.join(_build.CSRC_DIR, source)) as f:
        src = f.read()
    regs = {}
    for role in ("PRODUCER", "CONSUMER"):
        m = re.search(role + r"_REGS = NC == 3 \? (\d+) : (\d+);", src)
        if m:
            regs[role.lower()] = {"3 consumers": int(m.group(1)), "2 consumers": int(m.group(2))}
        else:
            regs[role.lower()] = int(re.search(role + r"_REGS = (\d+);", src).group(1))
    return regs


def dtype_name(dtype):
    return str(dtype).split(".")[-1]


def phase_flash(timer):
    """The flash kernel against its plain version; the wgmma route beside
    the mma.sync route, the plain version and SDPA at the LM's shapes."""
    import torch
    import torch.nn.functional as F
    from dml_tpu_torch.ops import flash_attention as fa

    bf16, f32 = torch.bfloat16, torch.float32
    g = torch.Generator(device="cuda").manual_seed(1)
    cases = (  # name, b, tq, tk, h, kv, d, causal, dtype
        ("prefill_b8", 8, PROMPT_LEN, PROMPT_LEN, 16, 4, 64, True, bf16),
        ("prefill_b1", 1, PROMPT_LEN, PROMPT_LEN, 16, 4, 64, True, bf16),
        ("mha_b1", 1, TRAIN_T, TRAIN_T, 16, 16, 64, True, bf16),
        ("d128", 2, 1024, 1024, 8, 8, 128, True, bf16),
        ("d128_gqa", 2, 2048, 2048, 16, 4, 128, True, bf16),
        ("ragged_t100", 2, 100, 100, 16, 4, 64, True, bf16),
        ("ragged_t1000", 2, 1000, 1000, 16, 4, 64, True, bf16),
        ("poisoned_tail", 2, 1000, 1000, 16, 4, 64, True, bf16),
        ("cross", 2, 64, 192, 16, 16, 64, False, bf16),
        ("cross_ragged", 2, 200, 1000, 16, 4, 64, False, bf16),
        ("d32", 2, 300, 300, 4, 2, 32, True, bf16),
        ("f32_t1000", 2, 1000, 1000, 8, 2, 64, True, f32),
        ("f32_cross", 2, 64, 192, 4, 4, 32, False, f32),
        ("f32_d16", 1, 130, 130, 2, 1, 16, True, f32),
    )
    timed = ("prefill_b8", "prefill_b1", "mha_b1")
    timings = {}
    for name, b, tq, tk, h, kv, d, causal, dtype in cases:
        q = torch.randn((b, tq, h, d), generator=g, device="cuda").to(dtype)
        clean = None
        if name.startswith("prefill"):
            # the LM's layout: k contiguous after rope, v a strided view of the qkv output
            qkv = torch.randn((b, tk, (h + 2 * kv) * d), generator=g, device="cuda").to(dtype)
            k = qkv[..., h * d:(h + kv) * d].reshape(b, tk, kv, d).contiguous()
            v = qkv[..., (h + kv) * d:].reshape(b, tk, kv, d)
        elif name == "mha_b1":
            # the training forward: Block repeats 4 kv heads to 16
            k, v = (torch.randn((b, tk, 4, d), generator=g, device="cuda").to(dtype)
                    .repeat_interleave(h // 4, dim=2) for _ in range(2))
        elif name == "poisoned_tail":
            # k and v are [:, :Tk] views of longer buffers whose rows at Tk
            # and beyond hold +-1e4: the kernel must never read them
            kb, vb = (torch.randn((b, tk + 152, kv, d), generator=g, device="cuda").to(dtype)
                      for _ in range(2))
            kb[:, tk:], vb[:, tk:] = 1e4, -1e4
            k, v = kb[:, :tk], vb[:, :tk]
            clean = fa.flash_attention_lse(q, k.contiguous(), v.contiguous(), causal=causal)
        else:
            k = torch.randn((b, tk, kv, d), generator=g, device="cuda").to(dtype)
            v = torch.randn((b, tk, kv, d), generator=g, device="cuda").to(dtype)
        out, lse = fa.flash_attention_lse(q, k, v, causal=causal)
        p_out, p_lse = fa.attention_with_lse(q, k, v, causal=causal)
        torch.cuda.synchronize()
        err_out = float((out.float() - p_out.float()).abs().max())
        err_lse = float((lse - p_lse).abs().max())
        # bf16 lse: the scores are the same bf16 products summed in f32
        # on both sides, only in another order
        tol_out, tol_lse = (2e-5, 2e-5) if dtype == f32 else (2e-2, 1e-4)
        ok = (out.dtype == dtype and tuple(out.shape) == (b, tq, h, d)
              and tuple(lse.shape) == (b, h, tq) and err_out <= tol_out and err_lse <= tol_lse)
        extra = {}
        if clean is not None:
            extra["equal_to_clean_run"] = bool(torch.equal(clean[0], out) and torch.equal(clean[1], lse))
            ok &= extra["equal_to_clean_run"]
        case = dict(phase="flash_check", case=name, q=[b, tq, h, d], kv=[b, tk, kv, d],
                    causal=causal, dtype=dtype_name(dtype), route=fa.kernel_route(dtype, d),
                    max_abs_err_out=err_out, max_abs_err_lse=err_lse, tol_out=tol_out,
                    tol_lse=tol_lse, ok=ok, **extra)
        emit(**case)
        check(ok, f"flash kernel disagrees: {case}")
        if name in timed:
            scale = d ** -0.5
            m_out, m_lse = fa._flash_cuda(q, k, v, causal, scale, mma_sync=True)
            torch.cuda.synchronize()
            m_err = float((m_out.float() - p_out.float()).abs().max())
            m_err_lse = float((m_lse - p_lse).abs().max())
            check(m_err <= tol_out and m_err_lse <= tol_lse,
                  f"{name}: mma.sync route disagrees ({m_err}, {m_err_lse})")
            qh, kh, vh = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)

            def library():
                return F.scaled_dot_product_attention(qh, kh, vh, is_causal=causal,
                                                      enable_gqa=kv != h)

            lib_diff = float((library().transpose(1, 2).float() - p_out.float()).abs().max())
            runs = {"wgmma": lambda: fa.flash_attention_lse(q, k, v, causal=causal),
                    "mma_sync": lambda: fa._flash_cuda(q, k, v, causal, scale, mma_sync=True),
                    "sdpa": library}
            # in turns on one card: new, mma.sync, SDPA, plain, SDPA, mma.sync, new
            turns = {key: [] for key in runs}
            for key in ("wgmma", "mma_sync", "sdpa"):
                turns[key].append(timer.ms(runs[key], iters=20))
            p_ms = timer.ms(lambda: fa.attention_with_lse(q, k, v, causal=causal), iters=5,
                            warmup=1)
            for key in ("sdpa", "mma_sync", "wgmma"):
                turns[key].append(timer.ms(runs[key], iters=20))
            k_ms, m_ms, l_ms = (statistics.mean(turns[key]) for key in ("wgmma", "mma_sync", "sdpa"))
            ops = 4 * b * h * tq * tk * d / (2 if causal else 1)
            nbytes = (q.numel() + k.numel() + v.numel() + out.numel()) * q.element_size() \
                + lse.numel() * 4
            t_ops = ops / PEAK_FLOPS[dtype_name(dtype)] * 1e3
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            bound = max(t_ops, t_bytes)
            timings[name] = dict(ms=k_ms, plain_ms=p_ms, library_ms=l_ms, bound_ms=bound,
                                 bound_by="operations" if t_ops >= t_bytes else "bytes",
                                 max_abs_err=err_out, mma_sync_ms=m_ms)
            emit(phase="flash_time", case=name, route=fa.kernel_route(dtype, d), ms=k_ms,
                 mma_sync_ms=m_ms, plain_ms=p_ms, sdpa_ms=l_ms, turns_ms=turns,
                 speedup_vs_mma_sync=m_ms / k_ms, vs_sdpa=k_ms / l_ms,
                 mma_sync_max_abs_err_out=m_err, sdpa_vs_plain_max_abs=lib_diff, ops=ops,
                 bytes=nbytes, ops_bound_ms=t_ops, bytes_bound_ms=t_bytes,
                 achieved_tflop_s=ops / (k_ms * 1e-3) / 1e12,
                 mma_sync_tflop_s=ops / (m_ms * 1e-3) / 1e12,
                 sdpa_tflop_s=ops / (l_ms * 1e-3) / 1e12,
                 share_of_bound=bound / k_ms, mma_sync_share_of_bound=bound / m_ms)
        del q, k, v, out, lse, p_out, p_lse, clean
    torch.cuda.empty_cache()
    return timings


def phase_decode(timer):
    """The decode kernel against its plain version, every cache form;
    times at the LM's decode shape and at 4k context."""
    import torch
    import torch.nn.functional as F
    from dml_tpu_torch.ops import decode_attention as da

    g = torch.Generator(device="cuda").manual_seed(2)
    lm_t = PROMPT_LEN + NEW_TOKENS
    cases = (  # name, b, kv, h, t, cache dtype, positions
        ("lm_b8", 8, 4, 16, lm_t, torch.bfloat16, [PROMPT_LEN + NEW_TOKENS // 2] * 8),
        ("gqa4_b8", 8, 4, 16, DECODE_CTX, torch.bfloat16, None),
        ("gqa4_b1", 1, 4, 16, DECODE_CTX, torch.bfloat16, [3000]),
        ("mqa_b8", 8, 1, 16, DECODE_CTX, torch.bfloat16, None),
        ("mha_b8", 8, 16, 16, DECODE_CTX, torch.bfloat16, None),
        ("mha_b1", 1, 16, 16, DECODE_CTX, torch.bfloat16, [DECODE_CTX - 1]),
        ("f32_gqa4_b8", 8, 4, 16, DECODE_CTX, torch.float32, None),
        ("f32_mqa_b1", 1, 1, 16, DECODE_CTX, torch.float32, [1234]),
        ("int8_gqa4_b8", 8, 4, 16, DECODE_CTX, torch.int8, None),
        ("int8_mha_b1", 1, 16, 16, DECODE_CTX, torch.int8, [2047]),
    )
    d = 64
    timings = {}
    for name, b, kv, h, t, cdt, pos in cases:
        if pos is None:  # mixed per-slot positions, one slot at the end
            pos = torch.randint(0, t, (b,), generator=g, device="cuda").tolist()
            pos[0] = t - 1
        pos_t = torch.tensor(pos, dtype=torch.int32, device="cuda")
        if cdt == torch.int8:
            k = torch.randint(-127, 128, (b, kv, t, d), generator=g, device="cuda").to(cdt)
            v = torch.randint(-127, 128, (b, kv, t, d), generator=g, device="cuda").to(cdt)
            ks = torch.rand((b, kv, 1, t), generator=g, device="cuda") * 0.02
            vs = torch.rand((b, kv, 1, t), generator=g, device="cuda") * 0.02
            q = torch.randn((b, 1, h, d), generator=g, device="cuda")
        else:
            k = torch.randn((b, kv, t, d), generator=g, device="cuda").to(cdt)
            v = torch.randn((b, kv, t, d), generator=g, device="cuda").to(cdt)
            ks = vs = None
            q = torch.randn((b, 1, h, d), generator=g, device="cuda").to(cdt)
        out = da.decode_attention(q, k, v, pos_t, k_scale=ks, v_scale=vs)
        plain = da.decode_attention_plain(q, k, v, pos_t, k_scale=ks, v_scale=vs)
        # rows past each slot's position are invisible: poison them
        kp, vp = k.clone(), v.clone()
        ksp, vsp = (ks.clone(), vs.clone()) if ks is not None else (None, None)
        for i, p in enumerate(pos):
            big = 127 if cdt == torch.int8 else 1e4
            kp[i, :, p + 1:] = big if i % 2 else -big
            vp[i, :, p + 1:] = -big if i % 2 else big
            if ksp is not None:
                ksp[i, :, :, p + 1:] = 1e4
                vsp[i, :, :, p + 1:] = 1e4
        poisoned = da.decode_attention(q, kp, vp, pos_t, k_scale=ksp, v_scale=vsp)
        torch.cuda.synchronize()
        err = float((out - plain).abs().max())
        ok = (out.dtype == torch.float32 and tuple(out.shape) == (b, 1, h, d) and err <= 2e-5
              and torch.equal(poisoned, out))
        case = dict(phase="decode_check", case=name, b=b, kv=kv, h=h, t=t, cache=dtype_name(cdt),
                    pos=pos, max_abs_err=err, poisoned_rows_change_output=not torch.equal(
                        poisoned, out), ok=ok)
        emit(**case)
        check(ok, f"decode kernel disagrees: {case}")
        del kp, vp, ksp, vsp, poisoned
        if name in ("lm_b8", "gqa4_b8", "gqa4_b1", "mqa_b8", "mha_b1", "int8_gqa4_b8"):
            k_ms = timer.ms(lambda: da.decode_attention(q, k, v, pos_t, k_scale=ks, v_scale=vs),
                            iters=50)
            p_ms = timer.ms(lambda: da.decode_attention_plain(q, k, v, pos_t, k_scale=ks,
                                                             v_scale=vs), iters=20)
            l_ms = None
            if cdt == torch.bfloat16:
                mask = (torch.arange(t, device="cuda")[None, :] <= pos_t[:, None])[:, None, None, :]
                qh = q.transpose(1, 2)

                def library():
                    return F.scaled_dot_product_attention(qh, k, v, attn_mask=mask,
                                                          enable_gqa=kv != h)

                l_ms = timer.ms(library, iters=50)
            rows = sum(p + 1 for p in pos)
            nbytes = 2 * rows * kv * d * k.element_size() + (8 * rows * kv if ks is not None else 0) \
                + q.numel() * q.element_size() + out.numel() * 4 + b * 4
            ops = 4 * rows * h * d
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = ops / PEAK_FLOPS["float32"] * 1e3
            timings[name] = dict(ms=k_ms, plain_ms=p_ms, library_ms=l_ms,
                                 bound_ms=max(t_bytes, t_ops),
                                 bound_by="bytes" if t_bytes >= t_ops else "operations",
                                 max_abs_err=err)
            emit(phase="decode_time", case=name, ms=k_ms, plain_ms=p_ms, sdpa_ms=l_ms,
                 bytes=nbytes, bytes_bound_ms=t_bytes, ops_bound_ms=t_ops,
                 achieved_gb_s=nbytes / (k_ms * 1e-3) / 1e9, share_of_bound=t_bytes / k_ms)
    torch.cuda.empty_cache()
    return timings


def wall_ms(fn, reps=5, warmup=1):
    """Median host time of `fn` ending in a device sync (what a caller waits)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        t0 = time.monotonic()
        fn()
        torch.cuda.synchronize()
        out.append((time.monotonic() - t0) * 1e3)
    return statistics.median(out)


def greedy_with_margins(gen, params, cfg, prompt, n):
    """Greedy tokens through prefill and batched_decode_step, with the
    top-1 minus top-2 logit margin of every step."""
    import torch

    b, tp = prompt.shape
    logits, cache = gen.prefill(params, cfg, prompt, tp + n)
    toks, margins = [], []
    for i in range(n):
        top2 = logits.topk(2, dim=-1).values
        margins.append((top2[:, 0] - top2[:, 1]).tolist())
        toks.append(logits.argmax(-1).to(torch.int32))
        if i < n - 1:
            pos = torch.full((b,), tp + i, dtype=torch.int32, device=prompt.device)
            logits, cache = gen.batched_decode_step(params, cfg, cache, toks[-1], pos)
    return torch.stack(toks, 1), margins


def phase_lm():
    """The LM serving path at full width: generate on cuda, counted."""
    import dataclasses

    import torch
    from dml_tpu_torch.inference import generate as gen
    from dml_tpu_torch.inference.quantize import quantize_lm_params, quantized_bytes
    from dml_tpu_torch.models.lm_params import init_lm_params

    cfg = gen.LMConfig(**LM_CFG, dtype=torch.bfloat16)
    t0 = time.monotonic()
    p32 = init_lm_params(cfg, seed=0)  # device None -> cuda
    params = gen.serving_params(p32, cfg)
    torch.cuda.synchronize()
    load_s = time.monotonic() - t0
    n_params = quantized_bytes(p32)[1] // 4
    rng = np.random.RandomState(3)
    prompts = torch.from_numpy(
        rng.randint(0, cfg.vocab_size, (LM_BATCH, PROMPT_LEN)).astype(np.int32)).cuda()
    gen.generate(params, cfg, prompts[:, :64], 2)  # warm-up: cuBLAS handles, kernel loads
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # ---- the main path, counted ----
    reset_launch_counts()
    t0 = time.monotonic()
    toks = gen.generate(params, cfg, prompts, NEW_TOKENS)
    torch.cuda.synchronize()
    generate_s = time.monotonic() - t0
    launches = launch_counts()
    peak_mb = torch.cuda.max_memory_allocated() / 1e6
    want = {"normalize": 0, "flash_attention": cfg.n_layers, "flash_bwd": 0,
            "flash_bwd_delta": 0, "decode_attention": cfg.n_layers * (NEW_TOKENS - 1)}
    check(launches == want, f"generate launched {launches}, want {want}")
    check(toks.dtype == torch.int32 and tuple(toks.shape) == (LM_BATCH, NEW_TOKENS),
          f"tokens {toks.dtype} {tuple(toks.shape)}")
    check(0 <= int(toks.min()) and int(toks.max()) < cfg.vocab_size, "token out of range")
    manual, _ = greedy_with_margins(gen, params, cfg, prompts, NEW_TOKENS)
    check(torch.equal(manual, toks), "prefill + batched_decode_step tokens != generate's")

    # int8 KV cache and int8 weights
    qcfg = dataclasses.replace(cfg, kv_quant=True)
    qparams = quantize_lm_params(p32)
    reset_launch_counts()
    qtoks = gen.generate(qparams, qcfg, prompts, 16)
    torch.cuda.synchronize()
    q_launches = launch_counts()
    q_want = {"normalize": 0, "flash_attention": cfg.n_layers, "flash_bwd": 0,
              "flash_bwd_delta": 0, "decode_attention": cfg.n_layers * 15}
    check(q_launches == q_want, f"int8 generate launched {q_launches}, want {q_want}")
    check(0 <= int(qtoks.min()) and int(qtoks.max()) < cfg.vocab_size, "int8 token out of range")
    int8_agree = float((qtoks == toks[:, :16]).float().mean())

    # float32: the card (TF32 off) against the port's CPU path
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    small = prompts[:2, :32]
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        g32 = gen.generate(p32, cfg32, small, 8).cpu()
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    cpu_params = init_lm_params(cfg32, seed=0, device="cpu")
    c32, margins = greedy_with_margins(gen, cpu_params, cfg32, small.cpu(), 8)
    check(torch.equal(g32, c32), f"f32 cuda tokens {g32.tolist()} != cpu {c32.tolist()}")
    check(torch.equal(gen.generate(cpu_params, cfg32, small.cpu(), 8), c32),
          "cpu generate != cpu prefill + decode steps")
    bf16_first_vs_f32 = toks[:2, :8].cpu().tolist()
    del cpu_params, qparams

    # latency: prefill and time to first token at B=1 and B=8 (Tp=2048),
    # decode ms per step at 4k context
    timing = {}
    for b in (1, LM_BATCH):
        pb = prompts[:b]
        timing[f"prefill_ms_b{b}"] = wall_ms(lambda: gen.prefill(params, cfg, pb, PROMPT_LEN + 1))
        timing[f"ttft_ms_b{b}"] = wall_ms(
            lambda: gen.generate(params, cfg, pb, 1))
        ctx = torch.from_numpy(
            rng.randint(0, cfg.vocab_size, (b, DECODE_CTX)).astype(np.int32)).cuda()
        logits, cache = gen.prefill(params, cfg, ctx, DECODE_CTX + 48)
        cur = logits.argmax(-1).to(torch.int32)
        for i in range(3):  # warm-up
            logits, cache = gen.decode_step(params, cfg, cache, cur, DECODE_CTX + i)
        steps = 40
        torch.cuda.synchronize()
        t0 = time.monotonic()
        for i in range(steps):  # back to back, as generate runs them
            logits, cache = gen.decode_step(params, cfg, cache, cur, DECODE_CTX + 3 + i)
            cur = logits.argmax(-1).to(torch.int32)
        torch.cuda.synchronize()
        step_ms = (time.monotonic() - t0) * 1e3 / steps
        timing[f"decode_ms_per_step_b{b}_ctx{DECODE_CTX}"] = step_ms
        timing[f"decode_tokens_per_s_b{b}_ctx{DECODE_CTX}"] = b * 1e3 / step_ms
        if b == LM_BATCH:
            pos = torch.full((b,), DECODE_CTX + 44, dtype=torch.int32, device="cuda")
            prof_decode = profile_calls(
                lambda: gen.batched_decode_step(params, cfg, cache, cur, pos), 5, LM_KINDS)
            prof_decode["device_ops_per_token"] = prof_decode["device_ops_per_call"] / b
        del cache, logits
    prof_prefill = profile_calls(
        lambda: gen.prefill(params, cfg, prompts, PROMPT_LEN + 1), 2, LM_KINDS)
    prof_prefill["device_ops_per_token"] = prof_prefill["device_ops_per_call"] / (
        LM_BATCH * PROMPT_LEN)
    emit(phase="lm", config=dict(LM_CFG, dtype="bfloat16"), params_millions=n_params / 1e6,
         load_s=load_s, batch=LM_BATCH, prompt_len=PROMPT_LEN, new_tokens=NEW_TOKENS,
         generate_s=generate_s, launches=launches, int8_launches=q_launches,
         tokens_in_range=True, prefill_plus_steps_equal_generate=True,
         int8_vs_bf16_token_agreement=int8_agree,
         weight_bytes={"bf16_serving": quantized_bytes(params)[0],
                       "int8": quantized_bytes(quantize_lm_params(p32))[0],
                       "f32": quantized_bytes(p32)[0]},
         f32_cuda_tokens=g32.tolist(), f32_cpu_tokens=c32.tolist(),
         f32_cpu_top1_margins=margins, bf16_cuda_tokens_first8=bf16_first_vs_f32,
         max_memory_allocated_mb_generate_b8=peak_mb, **timing)
    emit(phase="profile", path="lm_prefill_b8_t2048", **prof_prefill)
    emit(phase="profile", path=f"lm_decode_step_b8_ctx{DECODE_CTX}", **prof_decode)
    return launches

def _bwd_inputs(name, b, tq, tk, h, kv, d, dtype, g):
    """q, k, v, dO for a flash_bwd_check case, and for the poisoned tail
    their clean contiguous copies."""
    import torch

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)

    if name == "poisoned_tail":
        # [:, :T] views of longer buffers whose rows at T and beyond hold
        # NaN: no kernel may read them
        bufs = [randn(b, t + 152, n, d) for t, n in ((tq, h), (tk, kv), (tk, kv), (tq, h))]
        for x, t in zip(bufs, (tq, tk, tk, tq)):
            x[:, t:] = float("nan")
        views = [x[:, :t] for x, t in zip(bufs, (tq, tk, tk, tq))]
        return views, [x.contiguous() for x in views]
    if name == "strided":
        # q, k, v cut from a qkv projection's output; dO made head-major
        qkv = randn(b, tq, (h + 2 * kv) * d)
        q = qkv[..., :h * d].view(b, tq, h, d)
        k = qkv[..., h * d:(h + kv) * d].view(b, tk, kv, d)
        v = qkv[..., (h + kv) * d:].view(b, tk, kv, d)
        return [q, k, v, randn(b, h, tq, d).transpose(1, 2)], None
    return [randn(b, tq, h, d), randn(b, tk, kv, d), randn(b, tk, kv, d), randn(b, tq, h, d)], None


def _bwd_bounds(b, tq, tk, h, d, causal, el):
    """(operations, bytes) and the bound of the whole backward at its
    minimum (5 products; q, k, v, out, dO, lse in; dq, dk, dv out), the
    split's 7, each kernel's own (dq: S, dP, dQ; dkv: S, dP, dV, dK; both
    read q, k, v, dO and the two row arrays), and the delta kernel's
    (out, dO, lse in; the two padded row arrays out)."""
    from dml_tpu_torch.ops.flash_attention import _rows_len

    product = 2 * b * h * tq * tk * d / (2 if causal else 1)
    qkvo = b * tq * h * d * el  # one [B, T, H, D] tensor (k/v have H heads here)
    rows = b * h * tq * 4
    prows = b * h * _rows_len(tq) * 4
    bound = {}
    for key, ops, nbytes, peak in (
            ("min", 5 * product, 8 * qkvo + rows, "bfloat16"),
            ("split", 7 * product, 8 * qkvo + rows, "bfloat16"),
            ("dq", 3 * product, 5 * qkvo + 2 * prows, "bfloat16"),
            ("dkv", 4 * product, 6 * qkvo + 2 * prows, "bfloat16"),
            ("delta", 2 * b * tq * h * d, 2 * qkvo + rows + 2 * prows, "float32")):
        t_ops = ops / PEAK_FLOPS[peak] * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        bound[key] = dict(ops=ops, bytes=nbytes, ops_bound_ms=t_ops, bytes_bound_ms=t_bytes,
                          bound_ms=max(t_ops, t_bytes),
                          bound_by="operations" if t_ops >= t_bytes else "bytes")
    return bound


def phase_flash_bwd(timer):
    """The flash backward kernels against their plain versions; the
    wgmma pair beside the mma.sync pair, SDPA's backward and the plain
    version at the training shape."""
    import torch
    from dml_tpu_torch.ops import flash_attention as fa

    bf16, f32 = torch.bfloat16, torch.float32
    g = torch.Generator(device="cuda").manual_seed(4)
    cases = (  # name, b, tq, tk, h, kv, d, causal, dtype
        ("train", 1, TRAIN_T, TRAIN_T, 16, 16, 64, True, bf16),
        ("gqa4", 1, TRAIN_T, TRAIN_T, 16, 4, 64, True, bf16),
        ("d128", 1, 1024, 1024, 8, 8, 128, True, bf16),
        ("d128_gqa", 1, TRAIN_T, TRAIN_T, 16, 4, 128, True, bf16),
        ("ragged_t100", 2, 100, 100, 16, 4, 64, True, bf16),
        ("ragged_t129", 2, 129, 129, 16, 4, 64, True, bf16),
        ("ragged_t193", 2, 193, 193, 8, 8, 128, True, bf16),
        ("ragged_t1000", 2, 1000, 1000, 16, 4, 64, True, bf16),
        ("poisoned_tail", 2, 1000, 1000, 16, 4, 64, True, bf16),
        ("strided", 2, 1000, 1000, 16, 4, 64, True, bf16),
        ("cross", 2, 64, 192, 16, 16, 64, False, bf16),
        ("cross_ragged", 2, 200, 1000, 16, 4, 64, False, bf16),
        ("d32", 2, 300, 300, 4, 2, 32, True, bf16),
        ("f32_t1000", 2, 1000, 1000, 8, 2, 64, True, f32),
        ("f32_cross", 2, 64, 192, 4, 4, 32, False, f32),
        ("f32_d16", 1, 130, 130, 2, 1, 16, True, f32),
    )
    deterministic = ("train", "gqa4")
    names = ("dq", "dk", "dv")

    def held(got, want, dtype):
        errs, ok = {}, True
        for n, a, r in zip(names, got, want):
            ok &= a.dtype == r.dtype and a.shape == r.shape
            diff = (a.float() - r.float()).abs()
            errs[n] = float(diff.max())
            if dtype == f32:
                ok &= bool((diff <= 5e-5 + 5e-4 * r.float().abs()).all())
            else:
                ok &= errs[n] <= 1e-2 * float(r.float().abs().max())
        return errs, ok

    timings = {}
    for name, b, tq, tk, h, kv, d, causal, dtype in cases:
        (q, k, v, dout), clean = _bwd_inputs(name, b, tq, tk, h, kv, d, dtype, g)
        out, lse = fa.flash_attention_lse(q, k, v, causal=causal)
        for with_lse in (False, True):
            dlse = torch.randn((b, h, tq), generator=g, device="cuda") if with_lse else None
            got = fa.flash_attention_backward(q, k, v, out, lse, dout, dlse, causal=causal)
            want = fa.attention_backward(q, k, v, out, lse, dout, dlse, causal=causal)
            rows = fa._bwd_rows_cuda(out, dout, lse, dlse)
            p_rows = fa.bwd_rows_plain(out, dout, lse, dlse)
            torch.cuda.synchronize()
            errs, ok = held(got, want, dtype)
            delta_err = float((rows[1] - p_rows[1]).abs().max())
            rows_ok = torch.equal(rows[0], p_rows[0]) and delta_err <= 1e-4 and torch.equal(
                rows[1][..., tq:], p_rows[1][..., tq:])
            ok &= rows_ok
            extra = {}
            if clean is not None:
                c_out, c_lse = fa.flash_attention_lse(*clean[:3], causal=causal)
                c_got = fa.flash_attention_backward(*clean[:3], c_out, c_lse, clean[3], dlse,
                                                    causal=causal)
                extra["equal_to_clean_run"] = all(torch.equal(a, c) for a, c in zip(got, c_got))
                ok &= extra["equal_to_clean_run"]
            if name in deterministic:
                again = fa.flash_attention_backward(q, k, v, out, lse, dout, dlse, causal=causal)
                extra["bit_equal_rerun"] = all(torch.equal(a, c) for a, c in zip(got, again))
                ok &= extra["bit_equal_rerun"]
            case = dict(phase="flash_bwd_check", case=name, q=[b, tq, h, d], kv=[b, tk, kv, d],
                        causal=causal, dtype=dtype_name(dtype), route=fa.bwd_kernel_route(dtype, d),
                        lse_cotangent=with_lse, max_abs_err=errs,
                        max_abs_ref={n: float(r.float().abs().max()) for n, r in zip(names, want)},
                        bar="atol 5e-5 + rtol 5e-4" if dtype == f32 else "1e-2 of max |ref|",
                        delta_max_abs_err=delta_err, rows_ok=rows_ok, ok=ok, **extra)
            emit(**case)
            check(ok, f"flash backward kernels disagree: {case}")
            del got, want, rows, p_rows
        if name == "train":
            timings[name] = time_flash_bwd(timer, q, k, v, out, lse, dout, causal, errs)
        del q, k, v, dout, out, lse, clean
    torch.cuda.empty_cache()
    return timings


def time_flash_bwd(timer, q, k, v, out, lse, dout, causal, errs):
    """K3 at one shape: the new pair and the mma.sync pair (checked
    against the plain version first), whole and per kernel, the delta
    kernel, SDPA's backward and the plain version, in turns."""
    import torch
    import torch.nn.functional as F
    from dml_tpu_torch.ops import flash_attention as fa

    b, tq, h, d = q.shape
    tk = k.shape[1]
    scale = d ** -0.5
    lse_r, delta_r = fa._bwd_rows_cuda(out, dout, lse, None)
    delta_err = float((delta_r - fa.bwd_rows_plain(out, dout, lse)[1]).abs().max())
    m_got = fa._flash_bwd_cuda(q, k, v, dout, lse_r, delta_r, causal, scale, mma_sync=True)
    want = fa.attention_backward(q, k, v, out, lse, dout, causal=causal)
    torch.cuda.synchronize()
    m_err = max(float((a.float() - r.float()).abs().max()) for a, r in zip(m_got, want))
    m_bar = max(1e-2 * float(r.float().abs().max()) for r in want)
    check(m_err <= m_bar, f"mma.sync backward disagrees ({m_err} > {m_bar})")
    del m_got, want

    def part(n, mma_sync=False):
        return lambda: fa._flash_bwd_cuda(q, k, v, dout, lse_r, delta_r, causal, scale, parts=n,
                                          mma_sync=mma_sync)

    def k3_mma():
        rows = fa._bwd_rows_cuda(out, dout, lse, None)
        return fa._flash_bwd_cuda(q, k, v, dout, *rows, causal, scale, mma_sync=True)

    qh, kh, vh = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
    oh = F.scaled_dot_product_attention(qh, kh, vh, is_causal=causal)
    doh = dout.transpose(1, 2)
    runs = {
        "k3": lambda: fa.flash_attention_backward(q, k, v, out, lse, dout, causal=causal),
        "dq": part(1), "dkv": part(2),
        "delta": lambda: fa._bwd_rows_cuda(out, dout, lse, None),
        "k3_mma_sync": k3_mma, "dq_mma_sync": part(1, True), "dkv_mma_sync": part(2, True),
        "sdpa": lambda: torch.autograd.grad(oh, (qh, kh, vh), doh, retain_graph=True),
    }
    # in turns on one card: new, mma.sync, SDPA, plain, SDPA, mma.sync, new
    order = ("k3", "dq", "dkv", "delta", "k3_mma_sync", "dq_mma_sync", "dkv_mma_sync", "sdpa")
    turns = {key: [] for key in runs}
    for key in order:
        turns[key].append(timer.ms(runs[key], iters=20))
    p_ms = timer.ms(lambda: fa.attention_backward(q, k, v, out, lse, dout, causal=causal), iters=5,
                    warmup=1)
    p_delta_ms = timer.ms(lambda: fa.bwd_rows_plain(out, dout, lse), iters=20)
    for key in reversed(order):
        turns[key].append(timer.ms(runs[key], iters=20))
    ms = {key: statistics.mean(v) for key, v in turns.items()}
    bound = _bwd_bounds(b, tq, tk, h, d, causal, q.element_size())
    emit(phase="flash_bwd_time", case="train", route=fa.bwd_kernel_route(q.dtype, d),
         ms=ms, turns_ms=turns, plain_ms=p_ms, delta_plain_ms=p_delta_ms, bound=bound,
         mma_sync_max_abs_err=m_err, delta_max_abs_err=delta_err,
         speedup_vs_mma_sync={key: ms[f"{key}_mma_sync"] / ms[key] for key in ("k3", "dq", "dkv")},
         vs_sdpa=ms["k3"] / ms["sdpa"],
         share_of_bound={"k3_min": bound["min"]["bound_ms"] / ms["k3"],
                         "k3_split": bound["split"]["bound_ms"] / ms["k3"],
                         "dq": bound["dq"]["bound_ms"] / ms["dq"],
                         "dkv": bound["dkv"]["bound_ms"] / ms["dkv"],
                         "delta": bound["delta"]["bound_ms"] / ms["delta"],
                         "k3_split_mma_sync": bound["split"]["bound_ms"] / ms["k3_mma_sync"],
                         "dq_mma_sync": bound["dq"]["bound_ms"] / ms["dq_mma_sync"],
                         "dkv_mma_sync": bound["dkv"]["bound_ms"] / ms["dkv_mma_sync"]},
         achieved_tflop_s_split=bound["split"]["ops"] / (ms["k3"] * 1e-3) / 1e12)
    del qh, kh, vh, oh, doh
    return dict(ms=ms, plain_ms=p_ms, delta_plain_ms=p_delta_ms, library_ms=ms["sdpa"],
                bound=bound, max_abs_err=max(errs.values()), delta_max_abs_err=delta_err)


TRAIN_KINDS = (
    ("flash_bwd_", "flash_attention_bwd"), ("flash_fwd_", "flash_attention_fwd"),
    ("Adam", "optimizer"), ("multi_tensor_apply", "optimizer"),
    ("gemm", "matmul"), ("gemv", "matmul"), ("nvjet", "matmul"), ("xmma", "matmul"),
    ("cutlass", "matmul"), ("Memcpy", "copy"), ("Memset", "copy"), ("softmax", "softmax"),
    ("index", "gather_scatter"), ("reduce", "reduce"), ("CatArray", "concat"),
    ("elementwise", "elementwise"))


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-30)


def phase_train():
    """The LM training path at full width: LongContextLM.train_step on
    cuda, counted."""
    import torch
    from dml_tpu_torch.parallel.long_context import LongContextLM

    n_layers = LM_CFG["n_layers"]
    t0 = time.monotonic()
    lm = LongContextLM(seq_len=TRAIN_T, dtype=torch.bfloat16, seed=0, **LM_CFG)  # device None -> cuda
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    check(lm.device.type == "cuda", f"LongContextLM on {lm.device}")
    rng = np.random.RandomState(5)
    toks = torch.from_numpy(
        rng.randint(0, LM_CFG["vocab_size"], (1, TRAIN_T)).astype(np.int32)).cuda()
    warm = lm.train_step(toks)  # warm-up: cuBLAS handles, kernel loads
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # ---- the main path, counted ----
    reset_launch_counts()
    losses, step_ms = [], []
    per_step = {"normalize": 0, "flash_attention": n_layers, "flash_bwd": n_layers,
                "flash_bwd_delta": n_layers, "decode_attention": 0}
    for _ in range(TRAIN_STEPS):
        before = launch_counts()
        t0 = time.monotonic()
        losses.append(lm.train_step(toks))  # float(loss) waits for the whole step
        step_ms.append((time.monotonic() - t0) * 1e3)
        after = launch_counts()
        moved = {k: after[k] - before[k] for k in after}
        check(moved == per_step, f"a train step launched {moved}, want {per_step}")
    launches = launch_counts()
    peak_mb = torch.cuda.max_memory_allocated() / 1e6
    check(all(np.isfinite(losses)), f"non-finite loss: {losses}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses[0]} -> {losses[-1]}")

    # checkpoint round trip on the card: the next two losses repeat
    with tempfile.TemporaryDirectory() as ck:
        t0 = time.monotonic()
        lm.save_checkpoint(ck)
        save_s = time.monotonic() - t0
        ahead = [lm.train_step(toks) for _ in range(2)]
        t0 = time.monotonic()
        check(lm.restore_checkpoint(ck) == 1 + TRAIN_STEPS, "restored the wrong step")
        restore_s = time.monotonic() - t0
        again = [lm.train_step(toks) for _ in range(2)]
    ck_rel = max(_rel(a, b) for a, b in zip(again, ahead))
    check(ck_rel <= 1e-5, f"losses after restore {again} != {ahead}")

    # serve from the trained weights
    reset_launch_counts()
    gen_toks = lm.generate(toks[:, :128].cpu().numpy(), TRAIN_NEW_TOKENS)
    torch.cuda.synchronize()
    gen_launches = launch_counts()
    gen_want = {"normalize": 0, "flash_attention": n_layers, "flash_bwd": 0,
                "flash_bwd_delta": 0, "decode_attention": n_layers * (TRAIN_NEW_TOKENS - 1)}
    check(gen_launches == gen_want, f"generate launched {gen_launches}, want {gen_want}")
    check(gen_toks.shape == (1, TRAIN_NEW_TOKENS) and 0 <= gen_toks.min()
          and gen_toks.max() < LM_CFG["vocab_size"], f"generated tokens {gen_toks}")

    prof = profile_calls(lambda: lm.train_step(toks), 3, TRAIN_KINDS)
    del lm
    torch.cuda.empty_cache()

    # float32: the card (TF32 off) against the port's CPU path
    small = dict(vocab_size=512, d_model=128, n_heads=4, n_kv_heads=2, n_layers=2, d_ff=256)
    stoks = np.random.RandomState(6).randint(0, 512, (2, 128)).astype(np.int32)
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        g32 = LongContextLM(seq_len=128, dtype=torch.float32, seed=1, **small)
        cuda_losses = [g32.train_step(stoks) for _ in range(3)]
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    c32 = LongContextLM(seq_len=128, dtype=torch.float32, seed=1, device="cpu", **small)
    cpu_losses = [c32.train_step(stoks) for _ in range(3)]
    f32_rel = max(_rel(a, b) for a, b in zip(cuda_losses, cpu_losses))
    check(f32_rel <= 1e-4, f"f32 cuda losses {cuda_losses} != cpu {cpu_losses}")
    del g32, c32

    med = statistics.median(step_ms)
    emit(phase="train", config=dict(LM_CFG, dtype="bfloat16", seq_len=TRAIN_T, batch=1,
                                    optimizer="AdamW lr 3e-4 wd 1e-4"),
         init_s=init_s, warmup_loss=warm, steps=TRAIN_STEPS, losses=losses, launches=launches,
         launches_per_step=per_step, step_ms=step_ms, step_ms_median=med,
         step_ms_p90=float(np.percentile(step_ms, 90)), tokens_per_s=TRAIN_T / (med / 1e3),
         max_memory_allocated_mb=peak_mb, checkpoint_save_s=save_s,
         checkpoint_restore_s=restore_s, losses_ahead=ahead, losses_after_restore=again,
         restore_max_rel_diff=ck_rel, generate_launches=gen_launches,
         generated=gen_toks.tolist(), f32_cuda_losses=cuda_losses, f32_cpu_losses=cpu_losses,
         f32_max_rel_diff=f32_rel)
    emit(phase="profile", path=f"train_step_b1_t{TRAIN_T}", **prof)
    return launches


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

    build_all()
    timer = Timer()
    timings = phase_kernel(timer)
    launches = {m: phase_model(m, mode, timer) for m, mode in MODELS}
    flash = phase_flash(timer)
    decode = phase_decode(timer)
    lm_launches = phase_lm()
    bwd = phase_flash_bwd(timer)
    train_launches = phase_train()

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
    for case, shape, path_launches in (
            ("prefill_b8", f"prefill b{LM_BATCH} T{PROMPT_LEN} H16 KV4 D64 bf16 causal",
             lm_launches["flash_attention"]),
            ("mha_b1", f"train forward b1 T{TRAIN_T} H16 D64 bf16 causal, k/v repeated",
             train_launches["flash_attention"])):
        t = dict(flash[case])
        kernels.append(dict(
            name=f"flash_fwd[{shape}; wgmma+TMA]", route="cuda", variant="wgmma+tma",
            source="dml_tpu_torch/csrc/flash_attention.cu",
            replaces="dml_tpu/ops/flash_attention.py:65", launches=path_launches, **t))
    t = decode["lm_b8"]
    kernels.append(dict(
        name=f"decode_attention[b{LM_BATCH} cache {PROMPT_LEN + NEW_TOKENS} KV4 G4 D64 bf16]",
        route="cuda", source="dml_tpu_torch/csrc/decode_attention.cu",
        replaces="dml_tpu/ops/decode_attention.py:53",
        launches=lm_launches["decode_attention"], **t))
    t = bwd["train"]
    shape = f"train b1 T{TRAIN_T} H16 D64 bf16 causal"
    for part, line in (("dq", 113), ("dkv", 166)):
        kernels.append(dict(
            name=f"flash_bwd_{part}[{shape}; wgmma+TMA; plain and library times are the whole "
                 f"backward's]",
            route="cuda", variant="wgmma+tma", source="dml_tpu_torch/csrc/flash_attention_bwd.cu",
            replaces=f"dml_tpu/ops/flash_attention.py:{line}",
            launches=train_launches["flash_bwd"], max_abs_err=t["max_abs_err"],
            ms=t["ms"][part], mma_sync_ms=t["ms"][f"{part}_mma_sync"], plain_ms=t["plain_ms"],
            bound_ms=t["bound"][part]["bound_ms"], bound_by=t["bound"][part]["bound_by"],
            library_ms=t["library_ms"]))
    kernels.append(dict(
        name=f"flash_bwd_delta[{shape}; rowsum(dO*O) and padded lse rows]", route="cuda",
        source="dml_tpu_torch/csrc/flash_attention_bwd.cu",
        replaces="dml_tpu/ops/flash_attention.py:311 (a jnp expression beside the Pallas kernels)",
        launches=train_launches["flash_bwd_delta"], max_abs_err=t["delta_max_abs_err"],
        ms=t["ms"]["delta"], plain_ms=t["delta_plain_ms"], bound_ms=t["bound"]["delta"]["bound_ms"],
        bound_by=t["bound"]["delta"]["bound_by"], library_ms=None))
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

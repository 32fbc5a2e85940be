#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (dml_tpu_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py
    python3 chip_smoke.py --kernel-only   # phases 1-3 for the normalize kernel alone
    python3 chip_smoke.py --lm-server     # phases 1-2 and 12 (the LM server) alone
    python3 chip_smoke.py --moe           # phases 1-2 and 13 (mixture of experts) alone
    python3 chip_smoke.py --parallel      # phases 1-2 and 14 (data and tensor parallelism) alone
    python3 chip_smoke.py --seq-parallel  # phases 1-2 and 15 (sequence, expert parallelism) alone
    python3 chip_smoke.py --pipeline      # phases 1-2 and 16 (pipeline, pp/tp LM serving) alone
    python3 chip_smoke.py --cluster       # phases 1-2 and 17 (a port cluster serving jobs) alone
    python3 chip_smoke.py --ingress       # phases 1-2 and 18 (per-request traffic) alone
    python3 chip_smoke.py --families      # phases 1-2 and 19 (the other image families) alone
    python3 chip_smoke.py --groups        # phases 1-2 and 20 (the worker groups' backends) alone
    python3 chip_smoke.py --cli           # phases 1-2 and 21 (python -m dml_tpu_torch) alone
    python3 chip_smoke.py --measure       # phases 1-2 and 22 (the measuring half) alone
    python3 chip_smoke.py --seq-parallel --measure  # phases 1-2, 15 and 22

Phases, each printing one JSON line (with `t_s`, the seconds since the
script started); any failure exits non-zero:

1. device: the card's name, capability (must be 9.x, Hopper) and power
   limit;
2. build: nvcc builds the four kernel libraries (normalize, flash
   attention forward and backward, decode attention) from
   dml_tpu_torch/csrc/, and g++ the native JPEG loader
   (dml_tpu_torch/native/), all started together, with seconds for each;
   beside them ptxas reports the normalize, flash forward, backward and
   decode kernels (registers, spills; one `ptxas` line per source, with
   the wgmma kernels' setmaxnreg counts); a spill in a wgmma kernel or
   in any normalize or decode kernel fails;
3. kernel: the normalize kernel (K1) against its plain PyTorch version
   on the card, in every mode (caffe, tf, unit) and output dtype (bf16,
   f32), at [32,224,224,3], [32,299,299,3] and the pixel counts that
   reach each of its routes (1, 15, 16, 17 and 105 pixels: tail only,
   one group, a group and a tail, [3,7,5,3]), and on contiguous views
   whose base is not 16-byte aligned (the wrapper's copy route).
   float32 must agree within 1e-6 and bf16 within one
   bf16 ulp, and every element must be bit-identical (the count that is
   not is printed). Launches through the C entry into the middle of a
   larger buffer holding a sentinel must change no value outside their
   pixels; a misaligned output must be refused. At ResNet50 b32 caffe,
   InceptionV3 b32 tf and [32,224,224,3] tf (MobileNetV2's and
   ViT-B16's batch), bf16 and f32, the kernel, `x.to(dtype)` (the
   `raw` mode's one PyTorch call on the same bytes), the launch floor
   (the wrapper on one 16-pixel group) and the plain version are timed
   in turns (kernel, to, floor, plain, floor, to, kernel) by CUDA events
   under three
   conditions: the L2 flushed by writes before each launch, flushed by
   reads, and the engine's order (the batch freshly copied in from
   pinned host memory, no flush), each beside the device-memory byte
   bound, its share and GB/s;
4. ResNet50 and 5. InceptionV3, bf16 at batch 32, served through the
   port's InferenceEngine on cuda with seeded weights: infer_arrays on
   40 images (2 padded chunks), infer_arrays_nowait on the same,
   infer_files on 8 PNGs and on the same 8 as JPEGs. The kernel's launch
   count over that run must equal the number of forward chunks. A
   `loader` line says whether the JPEG batch went through the native
   loader or PIL, with the build error if any. Probabilities must be finite and
   sum to 1; top-1 must match the same module fed by the plain
   normalize, and, on 4 images, the port's float32 CPU engine (both the
   bf16 engine and a float32 CUDA engine with TF32 off). Per-batch
   latency p50/p90/p99 over 1000 batches and images/s at batch 32, the
   device time of one forward, and a torch.profiler breakdown of where
   a batch's time goes, with the normalize kernel's share of the busy
   time and the device operations that follow it into the stem conv;
6. flash_check: the flash attention forward against its plain version
   (out and lse), each case naming its route (`kernel_route`): the LM's
   prefill shape (q [8,2048,16,64], GQA-4 k/v [8,2048,4,64], bf16,
   causal, v a strided view of the qkv output) and B=1, the training
   forward ([1,2048,16,64], k/v repeated from 4 heads), D=128 (MHA, and
   GQA-4 at B=2 T=2048), ragged T=100 and T=1000, a poisoned tail (k/v
   [:, :1000] views of longer buffers holding +-1e4 past row 1000: the
   output must equal the clean copies'), non-causal cross attention
   (Tq=64, Tk=192; Tq=200, Tk=1000 GQA-4), ViT-B16's non-causal
   self-attention (vit_b16: [32,197,12,64], q/k/v strided views of one
   [32,197,2304] qkv output), bf16 D=32 (the mma.sync
   route) and float32 cases; tolerances float32 2e-5 (out and lse),
   bf16 out 2e-2 and lse 1e-4. At prefill_b8, prefill_b1, mha_b1 and vit_b16 the
   wgmma kernel, the mma.sync kernel (checked too), SDPA and the plain
   version are timed in turns (new, mma.sync, SDPA, plain, SDPA,
   mma.sync, new) beside the tensor-core operation bound, with TFLOP/s
   and share of the bound;
7. decode_check: the one-launch decode kernel against the plain
   version within 2e-5 for bf16, f32 and int8 caches; GQA-4, MQA and
   MHA; B=1 and B=8 at T=4096 with mixed per-slot positions, the LM's
   own decode shape, D 16 int8, D 32 bf16, D 128 bf16 and f32, pos 0,
   T=1001, B=64 with short positions; q in bf16 (as generate gives it,
   int8 caches too), in f32, bf16 over an f32 cache (D 16, 64, 128), f32
   over a bf16 cache, and a strided view; each case run twice, bit-equal,
   with a call at another (B, KV) between the two; rows past each slot's
   position poisoned with +-1e4 must not change the output. A profiler
   line shows one device kernel per call. At lm_b8, gqa4_b8, gqa4_b1,
   mqa_b8, mha_b1 and int8_gqa4_b8 the kernel, SDPA (bf16) and the plain
   version are timed in turns (kernel, SDPA, plain, SDPA, kernel) beside
   the byte bound of the valid cache rows (lm_b8 also under an L2
   flushed by reads);
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
   device memory, a torch.profiler breakdown of one prefill and one
   decode step, and the decode kernel's time in that step beside 12 x
   its time alone on one layer's cache (`decode_in_step`);
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
   (Tq=64, Tk=192; Tq=200, Tk=1000 GQA-4), ViT-B16's shape (vit_b16:
   [32,197,12,64] non-causal, strided as above), bf16 D=32 (the mma.sync
   route) and float32 at T=1000, cross and D=16; float32 within atol
   5e-5 + rtol 5e-4, bf16 within 1e-2 of the largest reference
   magnitude. The delta kernel's row arrays against `bwd_rows_plain`
   (lse and the pad rows exact, delta within 1e-4). Two backwards on the
   same inputs give bit-equal dq, dk and dv (train, gqa4, vit_b16). At the
   training shape and at vit_b16 the new pair, the mma.sync pair (checked too), the
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
   a torch.profiler breakdown of one step;
11. image_train: the port's image Trainer (`parallel.train`) on cuda:
   ResNet50 at its published width and depth, 224x224 caffe, bf16,
   batch 32, float32 master weights, AdamW lr 1e-3, seeded weights: 1
   warm-up and 20 steps on one seeded batch on the card. Every loss
   finite, the last below the first; each step exactly one normalize
   (K1) launch and no other kernel of the port, one more for
   `evaluate`, which moves neither the step nor the running statistics.
   Under cuDNN's deterministic algorithms: a checkpoint save and restore
   repeats the next two losses within 1e-5 relative, and `remat=True`
   from the same state repeats 3 plain steps' losses and running
   statistics within 1e-5 relative. `export_variables` loads into the
   port's CUDA InferenceEngine, whose accuracy on the training batch
   equals `evaluate`'s. A `Prefetcher(device="cuda")` loop over 64
   seeded JPEGs feeds two more steps (each batch bit-equal to the host
   decode; a `loader` line names the decoder). InceptionV3 b32 299x299
   tf trains 5 steps (finite losses, one K1 launch a step, no trainable
   BN scale). Float32 parity: a narrow ResNet (depths 1,1,1,1, 10
   classes, 64x64, batch 8, lr 1e-4) trained 3 steps on cuda (TF32
   off) and on the CPU gives losses within 1e-4 relative. Step ms
   median and p90, images/s, peak device memory, and a torch.profiler
   breakdown of one step with K1's share of the busy time;
12. lm_server: the port's continuous-batching LMServer on cuda at the
   same LM config, bf16, seeded weights. (a) bench.py's mixed-budget
   stream (32 requests of 12 prompt tokens, budgets from 32..512 drawn
   by RandomState(3), 8 slots, max_len 1024, chunk 32): a warm-up, in
   which K4 is held to its plain version (2e-5) on the live cache with
   the live ragged positions and a freed slot pinned at max_len - 1;
   then continuous refill, run step by step under
   torch.cuda.set_sync_debug_mode("warn") (the submit must make no
   synchronizing call and each step exactly one), and waves of 8, with
   tokens/s, the speedup, steps, mean slot occupancy, latency and TTFT
   p50/p99; the two modes' tokens must be equal. (b) 16 prompts of
   256-2048 tokens, budget 64, max_len 4096, chunk 16. On every counted
   server run K2 must launch 12 x the server's placement prefills and
   K4 12 x chunk x its chunk steps (plus the draft's launches under
   speculation), and K1, K3 and delta never. bf16 tokens of (b) equal
   each request's lone generate path up to its first near-tie (top-1
   minus top-2 logit margin under TIE_MARGIN); sampled tokens
   (temperature 0.8, top_k 40) of a request equal with 7 grid-mates and
   with 1; in float32 with TF32 off, 4 requests of (a) equal their lone
   generate exactly, and speculative decoding (k=4) with the target as
   its own draft accepts every proposal and with a 2-layer
   draft_lm_spec draft prints its acceptance, both giving the plain
   server's tokens. The KV prefix cache warm-starts second turns (hits
   and saved tokens > 0; warm and cold tokens against the lone run as
   above; TTFT warm and cold); an int8 server (int8 weights and KV
   cache); LMDriver with 4 threads of 8 requests equals a serial run;
   LMBackend.serve_files over prompt files with budget directives, and
   from_spec over a weights file written by the port's
   variables_to_bytes, give the server's tokens. A torch.profiler
   breakdown of one chunk step;
13. moe: lm_moe8, the same LM with the repo's MoE option on (8 experts
   in every second block, capacity factor 1.25; 550.05M parameters at
   12 blocks), cut to 6 blocks (3 MoE blocks, every width kept),
   seeded weights, bf16, on cuda; the launch counts below are per
   block, 6 where they say 12. (a) generate at B=8, 2048-token
   prompts, 64 new tokens (K2 12, K4 12 x 63, no other kernel; equal to
   prefill plus decode steps), the int8 form (int8 weights and KV cache,
   16 tokens); prefill ms, decode ms a step and tokens/s, peak memory,
   and a torch.profiler breakdown of one prefill and one decode step
   with the expert einsums' share of the busy time. (b) MoEMLP and the
   serving FFN (`generate._moe_ffn`) at lm_moe8's widths in float32,
   TF32 off, at 300 and 1100 tokens (chunked): the card within 1e-4 of
   the CPU; greedy f32 tokens of 2 prompts of 32 tokens equal to the
   CPU run's. (c) LMServer over bench.py's mixed-budget stream as in
   12(a): K2 and K4 by phase 12's formula, no synchronizing call at
   submit and one a step, bf16 tokens equal each request's lone
   generate path up to its first near-tie, 4 requests in f32 exactly.
   (d) LongContextLM(num_experts=8, moe_every=2) at B=1, T=2048, AdamW
   lr 3e-4, 1 warm-up and 10 steps: losses finite and falling, each step
   12 K2, 12 K3 and 12 delta launches, the first step's loss minus the
   bare lm_loss of the same params equal to 1e-2 x the mean aux within
   1e-5 of the loss; step ms median and p90, tokens/s, peak memory, a
   profile of one step; 16 tokens served from the trained weights.

14. parallel: the dp and tp forms over torch.distributed, ResNet50 at
   224x224 with seeded weights. (a) NCCL at world size 1 on cuda:0 in
   this process (real collectives on groups of one): ShardedInference
   over local_mesh(dp=1), b32, float32 and bf16, both forms (one K1
   launch a call; at tp 1 the two forms must agree bit for bit), the
   Trainer through the mesh path (bf16, b32, 1 warm-up and 20 steps,
   one K1 launch a step, losses finite and falling, one more for
   `evaluate`), and the narrow float32 ResNet 3 steps with TF32 off;
   K1 must have launched exactly that often and no other kernel. Then,
   not counted, the mesh Trainer and the one-device Trainer in turns
   (10, 10, 10, 10 steps): step ms median and p90 and images/s of each,
   and profiles with the collectives' share. (b) Two gloo ranks, both
   on cuda:0, spawned: at (dp 2, tp 1) and (dp 1, tp 2),
   ShardedInference in float32 and bf16, both forms: float32
   param-gather bitwise equal to world 1, the Megatron form within rtol
   2e-4 atol 2e-5 of it, bf16 top-1 equal; wall ms a call, K1 launches,
   peak memory and the collectives' share per rank; ResNet50 b32 bf16
   Trainer at dp 2, 5 steps (finite, falling, one K1 launch per rank a
   step), its checkpoint restored bitwise at world 1; the narrow float32
   ResNet at dp 2 and at tp 2 within 1e-4 relative of world 1; whether
   gloo's own CUDA path took an all_gather (the forms always stage
   through the host). A rank that exits non-zero fails the phase.
15. seq_parallel: the sequence and expert forms over torch.distributed.
   (a) NCCL at world size 1 on cuda:0 in this process: ring_attention
   and ulysses_attention over local_mesh() (sp 1) on the LM's attention
   shape, [1, 2048, 16, 64] bf16 causal, each exactly one K2 launch and
   bit-equal to flash_attention; LongContextLM over local_mesh() at the
   LM's full width, bf16, B=1, T=2048, 3 steps through the mesh's loss
   and gradient reductions (groups of one), each step 12 K2, 12 K3 and
   12 delta launches, losses finite and falling. (b) Two gloo ranks,
   both on cuda:0, spawned: at (dp 1, sp 2), q/k/v [1, 8192, 16, 64]
   (4096 rows a rank) through ring and Ulysses, causal and full, bf16
   and float32: each rank's output within K2's bars (float32 2e-5, bf16
   2e-2) of the one-device K2 on the whole sequence, float32 gradients
   of sum(sin(out)) within atol 5e-5, rtol 5e-4 of the one-device K3,
   launches by formula (causal ring: sp-rank r makes r + 1 K2 and r + 1
   K3; full ring 2 of each; Ulysses 1; one delta kernel a backward), and
   the two forms' forward timed in turns, then (not counted) their bf16
   causal forwards once more under `parallel.mesh.record_collectives()`
   beside `tools.ring_vs_ulysses.point_on_mesh` at the same point, which
   phase 22 holds equal; the LM at full width, bf16,
   B=1, T=2048 (1024 tokens a rank), AdamW lr 3e-4, 5 steps and a
   profiled one with the ring and as many with Ulysses: losses finite
   and falling and equal on both ranks, each step 12 x the formula's K2
   and K3 and 12 delta launches, step ms median and p90, tokens/s, peak
   memory and the `mesh.*` ranges' share of the profiled step; then 16
   tokens served from the trained weights on each rank (K2 12, K4 12 x
   15), equal on both; lm_moe8 at (dp 1, ep 2), 4 experts a rank (half
   of world 1's expert parameters): the bf16 logits of one 2048-token
   row against the one-device model's, top-1 equal wherever its top-2
   margin is at least TIE_MARGIN, 3 train steps finite (12 K2, 12 K3,
   12 delta each), peak memory; the float32 narrow LM (d 128, 2 layers,
   GQA-2, an MoE block, T 2048 so that routing groups sit inside each
   shard, TF32 off) at (dp 1, sp 2) ring, (dp 1, sp 2) Ulysses, (dp 1,
   ep 2) and (dp 2): 3 steps' losses within 1e-4 relative of the one
   device's; its dp-2 checkpoint restored bitwise at one device. A rank
   that exits non-zero fails the phase.
16. pipeline: the pp and tp LM serving forms (`inference.lm_sharded`)
   over torch.distributed, the 198M LM in bf16 with seeded weights.
   First, not counted: K2 on GQA's kv head h // G (what a pipeline
   stage launches) bit-equal to K2 on k/v repeated to 16 heads (JAX's
   pipelined prefill) at a stage's prefill shape, [4, 2048, 16, 64];
   the references (one device's server on 8 requests of phase 12's
   stream, budgets capped at 64, each request's lone greedy run with its
   margins, the float32
   narrow LM's lone tokens). (a) NCCL at world size 1 on cuda:0 in this
   process: `sharded_lm_backend` in both forms at (dp 1, tp 1) over the
   8 requests, tokens equal to `LMBackend`'s server's, K2 12 x placement
   prefills and K4 12 x chunk x chunk steps; `LMPrefillBackend` (12 K2
   a prompt; `slabs_bytes` equal to its `prefill_one` entries' blob) ->
   `kv_slab_from_bytes` (rows bit-equal, the blob re-serialized
   byte-equal, in bf16 and int8 kv_quant) -> `LMBackend.
   serve_prefilled` (K4 by formula, no K2), tokens equal to the lone
   runs up to a near-tie (TIE_MARGIN) and counted where equal to the
   local serve's; the float32 narrow LM's slabs (TF32 off) adopted with
   tokens equal to its local serve's. (b) Two gloo ranks, both on cuda:0, spawned: at pp 2
   `PipelinedLMBackend` (6 blocks a stage, 2 microbatches) on 8 prompts
   of 256-2048 tokens with budgets up to 64: a warm-up, 2 timed and a
   profiled batch, each (n_layers / pp) x microbatches = 12 K2 launches
   a rank, tokens equal on both ranks and to each prompt's lone run up
   to a near-tie, each rank's weight bytes `pp_hbm_report`'s
   per-member bytes, ms a batch, tokens/s, peak memory and the
   `mesh.ring_shift.pp` share of the profiled batch; at tp 2 both
   `sharded_lm_backend` forms over the first 4 of those requests
   (budgets 64, 32, 64, 64): K2 and K4 by phase 12's formula on each
   rank, tokens equal on both ranks and to the lone runs up to a
   near-tie, tokens/s, peak memory and the `mesh.all_gather.tp` share
   of a profiled serve (2 requests, one chunk); the float32 narrow
   dense LM (d 128, 4 layers, GQA-2, TF32 off) at pp 2 and at tp 2 in
   both forms: tokens exactly one device's. A rank that exits non-zero
   fails the phase.
17. cluster: the job pipeline. In this process, on 127.0.0.1 with ports
   probed free at run time: the introducer and 4 port nodes H1-H4, each
   Node + StoreService + JobService, all four sharing one
   InferenceEngine (cuda, bf16, batch 32, seeded weights) and each with
   an LMBackend of the 198M LM (phase 12's settings) registered with
   register_lm. 64 seeded JPEGs are put into the store; ResNet50 512
   and InceptionV3 512 are submitted together (the reference's
   two-model fair-share mix), then ResNet50 256, during which a worker
   holding one of its batches is stopped after the job's first ACK;
   then an LM job of 8 prompt files cut from phase 12's mixed-budget
   stream. Every query of every job must have an output after
   get-output, worker_batch_failures_total must not move, K1 must have
   launched once per chunk the engine dispatched (and more than once),
   and no other kernel; the killed-worker job completes with its
   requeues counted; each job's top-5 equals the engine's infer_files
   on the same files (scores within 1e-6); K2 and K4 match phase 12's
   formula from the server's counters, and the LM job's tokens equal a
   lone LMBackend serve of the same files up to a near-tie
   (TIE_MARGIN). Per model C1 images/s over each job and C2 p50/p99,
   the per-batch fetch/decode/infer/put medians, the committed
   pipeline depth and LM tokens/s.
18. ingress: the request front door. A port `cluster.chaos.LocalCluster`
   of 4 nodes with the front door (a RequestRouter on every node), on
   probed ports, every node a JobService on one InferenceEngine (cuda,
   bf16, ResNet50 b32, seeded weights) and its own LMBackend of the
   198M LM (8 slots, chunk 32, a KV prefix cache). Arm 1: an open-loop
   trace of 128 interactive ResNet50 requests at 100/s, each pinned to
   one of 64 seeded JPEGs in the store. Arm 2: 3 streamed sessions of 3
   turns (batch class, 16-token suffixes, budget 32) through
   `loadgen.run_sessions`. Arm 3: arm 1's trace with the leader crashed
   when half the requests were submitted. Every request reaches exactly
   one terminal, none completes twice, none of arm 1 is lost; completed
   top-5 equals the engine's infer_files (scores within 1e-6); each
   turn equals a lone LMBackend serve of the same history up to a
   near-tie; K1 launched once per engine chunk, K2 and K4 by phase 12's
   formula. Per arm: completed, shed, rejected, lost, e2e p50/p99 and
   completions a second; tokens a second, TTFT p50/p99 by turn and the
   session-affinity hits and misses for arm 2.
19. families: MobileNetV2 (tf), EfficientNet-B0 (raw), EfficientNet-B4
   at 380x380 (raw) and ViT-B16 (tf), the registry's published widths
   and depths, seeded weights, bf16 at batch 32, served through the
   port's InferenceEngine on cuda (40 images, 2 chunks): K1 must launch
   once a chunk for the tf models and never for the raw ones (their
   normalization is in the graph), K2 12 times a ViT-B16 chunk (one a
   block), and no other kernel; probabilities finite, rows summing to 1;
   top-1 equal to the same module fed by the plain normalize; on 4
   images the float32 CUDA engine (TF32 off) has the float32 CPU
   engine's top-1 and probabilities within 1e-4, and the bf16 one its
   top-1 wherever the CPU's top-1 leads
   by TIE_MARGIN in log-probability. The device time of one forward;
   EfficientNet-B4 served once more with the space-to-depth stem on the
   same weights (max difference, top-1 agreement, both forwards timed
   in turns). Then each model trains 1 warm-up and 3 steps at batch 16
   through the image Trainer (AdamW lr 1e-3, float32 masters): losses
   finite, each step one K1 launch for the tf models (none for the raw
   ones) and for ViT-B16 12 K2, 12 K3 and 12 delta launches, and no
   other kernel; step ms and images/s, peak memory.
20. groups: the worker groups' sharded backends, on two 4-node port
   `LocalCluster`s in this process sharing one cuda engine (H1 leads,
   H2 is the standby, so the group H3 + H4 is the whole pool). A group
   mesh resolves over this process's world (1 rank): dp 1 x tp 1.
   img0: every node wired by `jobs.groups.wire_group_backend`, H3's
   lazy `group_engine_backend` given the engine's weights through the
   store (publish, then load, which calls its `set_variables`), a
   ResNet50 job of 64 queries over 64 seeded 256x256 JPEGs: every batch
   group-served, top-5 wnids equal to the engine's `infer_files`,
   scores within 1e-6, K1 once a group-engine chunk and no other
   kernel. tp0: every node wired by `inference.lm_sharded.wire_lm_group`
   with the 198M LM (H3 the `DisaggLMBackend` decode primary over the
   resident form, H4 the prefill role): (a) a job of phase 12's first 8
   prompts, streamed handoff: 8 handoffs, 0 fallbacks; (b) the 8
   prompts with H3's data plane failing every pull (whole-slab form): 8
   local fallbacks; (c) the first 4, whole-slab form: 4 handoffs. Each
   arm's tokens equal the lone `LMBackend.serve_files` up to a near-tie
   (TIE_MARGIN); K2 = 12 x (the prefill member's prefills + the decode
   server's placement prefills), K4 = 12 x chunk x the decode server's
   steps. Then H4 is crashed and H3's backend refuses a batch
   (GroupDegraded).
21. cli: the port started as an operator starts it, as processes:
    `python -m dml_tpu_torch localspec -n 3` (ports probed free; the
    introducer, store root and timing edited into its JSON), `introducer
    --spec` and three `node` processes, H1, H2 and H3, whose REPLs this
    phase drives over stdin (each verb with its own time limit), all on
    cuda, each with `--lm-spec` of the 198M LM (seed 0). Verbs on H1:
    `load-testfiles` (32 seeded JPEGs), `submit-job ResNet50 32` twice,
    `get-output`, `ls-all`, `C2 ResNet50`, `put` of 4 prompt files (phase
    12's first 4 requests), `submit-job LM198M 4`, `get-output`, `profile
    metrics cluster` around each job, `models`, `predict-locally
    ResNet50` on 2 files, `C1`, `profile metrics`, `quit`; on all three,
    `profile trace start` before the first job and `profile trace stop`
    after predict-locally; then SIGTERM to the others. Every process exits
    0; no process builds a kernel library (the build phase's serve them
    all). Each ResNet50 result (job and predict-locally) equals this
    process's `InferenceEngine().infer_files` top-5 on the same files
    (scores within 1e-6); the LM job's tokens equal a lone
    `LMBackend.from_spec` serve up to a near-tie (TIE_MARGIN). The path's
    launches are the K1, K2 and K4 kernels in the three processes'
    torch.profiler traces, which must equal the formula from the
    cluster's counters: K1 = the jobs' batches + 2 warm-up forwards a
    process that loaded ResNet50 + predict-locally's chunk (and warm-up),
    K2 = 12 x placement prefills, K4 = 12 x chunk x chunk steps. J1
    images/s and LM tokens/s (both under the traces), C2's per-image
    time over the batches (one sample a batch), and each process's
    start-to-joined seconds (from its `joined` log line).
22. measure: the port's measuring half (`benchmarks`,
    `tools.conv_roofline`, `tools.ring_vs_ulysses`, `lm_sharded`'s bench
    arms). (a) An 8192^3 bf16 matmul through `device_seconds_per_iter`
    (slopes on CUDA events): TF/s and its share of 989 TF/s, which must
    lie in 0.5-1.05. (b) ResNet50 b32 224x224 and InceptionV3 b32
    299x299, bf16, seeded weights, through the engine's `_forward` (K1,
    then the model): `forward_rate_stats` at bench.py's b32 chains
    (20, 120) and (15, 90), 5 reps: images/s with its range, MFU =
    `compiled_flops` / slope / `peak_flops`, `dispatch_latency` p50/p99,
    beside the busy times phases 4-5 measured; K1 once a forward (the
    chains, the FLOP count's forward, 21 latency forwards). (c)
    `conv_roofline.analyze` of ResNet50, InceptionV3 and EfficientNetB4
    at b32 and b128, `microbench("EfficientNetB4", 128)` (each unique
    conv shape slope-timed alone: the measured class bandwidths of
    `eff_bw`) and `concat_microbench("InceptionV3", 128)`. (d) K2 and K4
    on float32 inputs at the arms' shapes against their plain versions
    (2e-5), then `bench_specdec_arm` (8 prompts, 32 tokens, k 4) and
    `bench_cb_arm` (6 waves of 2, 16 tokens) on the 198M LM in float32,
    TF32 off, max_slots 4, max_len 128, chunk 8: `outputs_equal` (tokens
    exactly `generate`'s) and the random draft auto-disabled
    ("acceptance", tokens exact) must hold; speedup and both arms' TTFT
    p99; K2 and K4 launches equal to the formula from the arms'
    dispatches (12 a `generate` prefill and 12 x (n - 1) its decode
    steps; the layers of target or draft a server placement prefill;
    12 x chunk a chunk step; the draft's layers x k a proposal). (e)
    Phase 15's two gloo ranks ran their bf16 causal ring and Ulysses
    forwards once more under `parallel.mesh.record_collectives()`, and
    `ring_vs_ulysses.point_on_mesh` (analyze_point's body) at [1, 8192,
    16, 64], sp 2, on the same mesh: the calls and bytes must be equal
    and be 1 shift of 2 x the activation (ring) and 2 all-to-alls of 4 x
    it (Ulysses). No process is spawned.

Then the card's name and power limit as nvidia-smi prints them, the
kernels' summary line (K1's launches by path: serving, training,
cluster, ingress, measure and, for ResNet50, parallel, groups and cli, and a row at
the families' [32,224,224,3] tf shape with the families path; K2's and
K4's: generate, train, lm_server, moe, seq_parallel, pipeline, cluster,
ingress, families, groups, cli and measure, K2 timed at the LM's shapes and ViT-B16's; K3's
and the delta kernel's: train, moe, seq_parallel and families), and
last `{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import contextlib
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
#: what an earlier phase measured for a later one (phase 22 reads the
#: models' busy times of phases 4-5 and phase 15's recorded collectives)
SHARED = {}


def check(ok, msg):
    """A check that stays under `python -O` (unlike assert)."""
    if not ok:
        raise AssertionError(msg)


_T0 = time.monotonic()


def emit(**kw):
    """One JSON line, with the seconds since the script started (`t_s`)."""
    print(json.dumps(dict(kw, t_s=round(time.monotonic() - _T0, 1))), flush=True)


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

    def ms(self, fn, iters=30, warmup=3, clean=False):
        """Median ms of `fn`. clean=True flushes by reading the 256 MB
        instead of writing it, so the L2 holds no dirty lines that the
        timed call must write back as it evicts them."""
        import torch

        for _ in range(warmup):
            fn()
        pairs = []
        for _ in range(iters):
            if clean:
                self.flush.max()
            else:
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


# K1 at the two serving batches, in each model's mode, timed in both dtypes
K1_TIMED = (("ResNet50", (32, 224, 224, 3), "caffe"), ("InceptionV3", (32, 299, 299, 3), "tf"),
            ("MobileNetV2, ViT-B16", (32, 224, 224, 3), "tf"))
# pixel counts that reach each route of K1: tail pixels only (1, 15), one
# group (16), a group and a tail pixel (17), 6 groups and 9 tail pixels (105)
K1_SMALL = ((1, 1, 1, 3), (1, 3, 5, 3), (1, 4, 4, 3), (1, 1, 17, 3), (3, 7, 5, 3))


def ms_after_copy(fn, pinned, iters=30, warmup=3):
    """Median ms of fn(x) in the engine's order: x freshly copied in from
    pinned host memory with non_blocking=True, as `_dispatch_chunk` does
    just before `_forward` launches K1; no flush, events around fn alone.
    The copy (~0.2 ms) outlasts the host's enqueue of fn."""
    import torch

    for _ in range(warmup):
        fn(pinned.to("cuda", non_blocking=True))
    pairs = []
    for _ in range(iters):
        x = pinned.to("cuda", non_blocking=True)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn(x)
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def k1_held(got, want, dtype):
    """(max abs error, elements not bit-identical, within tolerance):
    float32 within 1e-6, bf16 within one bf16 ulp."""
    err = (got.float() - want.float()).abs()
    max_err = float(err.max()) if err.numel() else 0.0
    ok = max_err <= 1e-6 if dtype.itemsize == 4 else bool((err <= bf16_ulp(want)).all())
    return max_err, int((got != want).sum()), ok


def k1_c_entry_checks(lib, x, mode, dtype, plain):
    """Launch through the C entry into the middle of a larger output
    buffer that holds a sentinel: the pixels land where they belong and
    no value before or past them changes. A misaligned output is refused
    with nothing written."""
    import torch
    from dml_tpu_torch.ops import preprocess as ops

    n = x.numel() // 3
    lead = 64  # elements: a 16-byte aligned start in either dtype
    buf = torch.full((lead + 3 * n + 256,), -8192.0, dtype=dtype, device="cuda")
    sentinel = buf.clone()
    el = buf.element_size()
    stream = torch.cuda.current_stream().cuda_stream
    bf16 = int(dtype == torch.bfloat16)
    mode_id = ops._MODES[mode]
    name = f"{mode} {dtype} n={n}"
    err = lib.dml_normalize_u8(x.data_ptr(), buf.data_ptr() + lead * el, n, mode_id, bf16, stream)
    check(err == 0, f"C entry refused a launch ({err}): {name}")
    torch.cuda.synchronize()
    check(torch.equal(buf[lead:lead + 3 * n], plain.flatten()),
          f"C entry into a larger buffer: {name}")
    check(torch.equal(buf[:lead], sentinel[:lead])
          and torch.equal(buf[lead + 3 * n:], sentinel[lead + 3 * n:]),
          f"C entry wrote outside its pixels: {name}")
    buf.copy_(sentinel)
    refused = lib.dml_normalize_u8(x.data_ptr(), buf.data_ptr() + lead * el + el, n, mode_id,
                                   bf16, stream)
    torch.cuda.synchronize()
    check(refused == 1 and torch.equal(buf, sentinel),
          f"C entry took a misaligned output: {refused}")


def phase_kernel(timer):
    """K1 against its plain version on every route, then timed in turns
    beside x.to(dtype) (the `raw` mode's one call on
    the same bytes) and the plain version, under three L2 conditions."""
    import torch
    from dml_tpu_torch.ops import preprocess as ops
    from dml_tpu_torch.models.preprocess import normalize_on_device

    lib = ops._library()
    g = torch.Generator(device="cuda").manual_seed(0)
    modes, dtypes = ("caffe", "tf", "unit"), (torch.bfloat16, torch.float32)

    def images(*shape):
        return torch.randint(0, 256, shape, dtype=torch.uint8, device="cuda", generator=g)

    # (name, uint8 batch, also launched through the C entry)
    cases = [(str(list(shape)), images(*shape), shape[0] != 32 or shape[1] == 224)
             for shape in list(dict.fromkeys(shape for _, shape, _ in K1_TIMED)) + list(K1_SMALL)]
    # contiguous views whose base is not 16-byte aligned: the copy route
    cases += [("[33,299,299,3][1:]", images(33, 299, 299, 3)[1:], False),
              ("[4,7,5,3][1:]", images(4, 7, 5, 3)[1:], False)]
    for name, x, c_entry in cases:
        offset = x.data_ptr() % 16
        check(x.is_contiguous() and (offset != 0) == name.endswith("[1:]"),
              f"{name}: base offset {offset}")
        for mode in modes:
            for dtype in dtypes:
                want = normalize_on_device(x, mode, dtype)
                before = ops.normalize_launches
                got = ops.fused_normalize(x, mode, dtype)
                torch.cuda.synchronize()
                check(ops.normalize_launches == before + 1, "one counted launch a wrapper call")
                check(got.dtype == dtype and got.shape == x.shape and got.is_contiguous(),
                      f"kernel output {got.dtype} {tuple(got.shape)}")
                max_err, n_diff, ok = k1_held(got, want, dtype)
                ok = ok and n_diff == 0
                case = dict(phase="kernel_check", case=name, shape=list(x.shape), mode=mode,
                            dtype=dtype_name(dtype), base_offset_bytes=offset,
                            max_abs_err=max_err, n_not_identical=n_diff, ok=ok)
                emit(**case)
                if not ok:
                    raise AssertionError(f"normalize kernel disagrees: {case}")
                if c_entry:
                    k1_c_entry_checks(lib, x, mode, dtype, want)
    emit(phase="kernel_c_entry", ok=True, cases=[name for name, _, c in cases if c],
         refuses=["misaligned output"])
    inputs = {name: x for name, x, _ in cases}

    timings = {}
    tiny = inputs["[1, 4, 4, 3]"]
    order = ["kernel", "to", "floor_16px", "plain", "floor_16px", "to", "kernel"]
    for model, shape, mode in K1_TIMED:
        x = inputs[str(list(shape))]
        pinned = x.cpu().pin_memory()
        for dtype in dtypes:
            runs = {"kernel": lambda x: ops._normalize_cuda(x, mode, dtype),
                    "to": lambda x: x.to(dtype)}
            runs["plain"] = lambda x: normalize_on_device(x, mode, dtype)
            # the launch floor: the wrapper on one 16-pixel group
            runs["floor_16px"] = lambda x: ops.fused_normalize(tiny, mode, dtype)
            nbytes = x.numel() * (1 + dtype.itemsize)
            bound = nbytes / HBM_BYTES_PER_S * 1e3
            by_cond = {}
            for cond in ("write_flush", "read_flush", "after_copy"):
                turns = {k: [] for k in runs}
                for k in order:  # in turns: kernel, to, floor, plain, and back
                    if cond == "after_copy":
                        turns[k].append(ms_after_copy(runs[k], pinned))
                    else:
                        turns[k].append(timer.ms(lambda k=k: runs[k](x),
                                                 clean=cond == "read_flush"))
                ms = {k: statistics.mean(v) for k, v in turns.items()}
                by_cond[cond] = ms
                emit(phase="kernel_time", model=model, shape=list(shape), mode=mode,
                     dtype=dtype_name(dtype), condition=cond,
                     bytes=nbytes, bound_ms=bound, ms=ms,
                     share_of_bound={k: bound / v for k, v in ms.items()},
                     gb_s={k: nbytes / (v * 1e-3) / 1e9 for k, v in ms.items()}, turns_ms=turns)
            want = normalize_on_device(x, mode, dtype)
            a = by_cond["write_flush"]
            timings[(shape, mode, dtype)] = dict(
                ms=a["kernel"], plain_ms=a["plain"], bound_ms=bound, library_ms=a["to"],
                max_abs_err=k1_held(ops.fused_normalize(x, mode, dtype), want, dtype)[0],
                read_flush_ms=by_cond["read_flush"]["kernel"],
                after_copy_ms=by_cond["after_copy"]["kernel"])
    del inputs, cases
    torch.cuda.empty_cache()
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


def write_images(dirname, imgs, fmt):
    """PNG or JPEG (quality 90) files of `imgs`."""
    from PIL import Image

    files = []
    for i, im in enumerate(imgs):
        p = os.path.join(dirname, f"img{i}.{fmt}")
        Image.fromarray(im).save(p, **({"quality": 90} if fmt == "jpeg" else {}))
        files.append(p)
    return files


def phase_model(name, mode, timer):
    import torch
    from dml_tpu_torch.inference import InferenceEngine
    from dml_tpu_torch.models import preprocess
    from dml_tpu_torch.models.preprocess import normalize_on_device
    from dml_tpu_torch.models.registry import get_model
    from dml_tpu_torch.native import loader as native_loader

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
        files = write_images(tmp, imgs[:N_FILES], "png")
        jpegs = write_images(tmp, imgs[:N_FILES], "jpeg")
        # ---- the main path, counted ----
        reset_launch_counts()
        decoded = preprocess.decoded_batches
        decoded.update(native=0, pil=0)
        probs = eng.infer_arrays(name, imgs)
        probs_nw = eng.infer_arrays_nowait(name, imgs)()
        res = eng.infer_files(name, files)
        res_jpeg = eng.infer_files(name, jpegs)
        torch.cuda.synchronize()
        counts = launch_counts()
    # which decoder served the JPEG batch (the PNG batch is PIL's)
    emit(phase="loader", model=name, jpeg_batch_decoder="native" if decoded["native"] else "pil",
         decoded_batches=dict(decoded), native_available=native_loader.native_available(),
         build_error=native_loader.build_error())
    check(decoded["native"] + decoded["pil"] == 2, f"{name}: decoded batches {decoded}")
    check(len(res_jpeg.top5) == N_FILES, f"{name}: infer_files on JPEGs malformed")
    launches = counts["normalize"]
    chunks = 2 * -(-N_IMAGES // BATCH) + 2 * -(-N_FILES // BATCH)
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
    prof = profile_calls(lambda: eng.infer_arrays(name, batch), 5, IMAGE_KINDS, after="normalize_")
    SHARED[f"busy/{name}"] = {"forward_device_ms": fwd_ms,
                              "infer_arrays_device_busy_ms": prof["device_busy_ms_per_call"]}
    emit(phase="profile", model=name,
         normalize_share_of_busy=prof["by_kind_ms_per_call"].get("normalize", 0.0)
         / prof["device_busy_ms_per_call"], **prof)
    eng.unload_model(name)
    return launches


IMAGE_KINDS = (
    ("normalize_", "normalize"), ("Memcpy HtoD", "copy_h2d"),
    ("Memcpy DtoH", "copy_d2h"), ("fprop", "conv"), ("implicit_gemm", "conv"),
    ("conv", "conv"), ("batch_norm", "batch_norm"), ("pool", "pool"),
    ("CatArray", "concat"), ("gemm", "dense"), ("softmax", "softmax"),
    ("clamp", "relu"), ("CUDAFunctor_add", "add"), ("reduce", "mean"))
LM_KINDS = (
    ("flash_fwd_", "flash_attention"), ("decode_kernel", "decode_attention"),
    ("decode_split_kernel", "decode_attention"), ("decode_merge_kernel", "decode_attention"),
    ("index_put", "cache_write"),
    ("gemm", "matmul"), ("gemv", "matmul"), ("nvjet", "matmul"), ("xmma", "matmul"),
    ("cutlass", "matmul"), ("Memcpy", "copy"), ("Memset", "copy"), ("reduce", "reduce"),
    ("index", "gather"), ("CatArray", "concat"), ("elementwise", "elementwise"))


def profile_calls(fn, iters, kinds, after=None, ranges=()):
    """Where a call's time goes: torch.profiler over `iters` calls of
    `fn`. Device time by kernel (top 8 and by kind, first substring
    match in `kinds` wins), device operations per call, and the device's
    idle share of the wall time (the profiler's own host overhead
    lengthens the wall time, so this share is an upper bound for the
    unprofiled run). `after`: also the first device operation whose name
    holds it and the six that follow, in time order, with their ms.
    `ranges`: also, for each named host range (a `record_function`),
    the device time of the kernels launched inside it, by kind, ms a
    call, and its share of the busy time."""
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
    extra = {}
    if after:
        dev = sorted((e for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA
                      and not getattr(e, "is_user_annotation", False)),
                     key=lambda e: e.time_range.start)
        i = next((i for i, e in enumerate(dev) if after in e.name), None)
        extra[f"after_{after.strip('_')}"] = None if i is None else [
            (e.name[:120], e.time_range.elapsed_us() / 1e3) for e in dev[i:i + 7]]
    for name in ranges:
        within = {}

        def walk(e):
            for k in e.kernels:
                kind = next((v for key, v in kinds if key in k.name), "other")
                within[kind] = within.get(kind, 0.0) + k.duration
            for c in e.cpu_children:
                walk(c)

        for e in prof.events():
            if e.name == name and e.device_type == torch.autograd.DeviceType.CPU:
                walk(e)
        us = sum(within.values())
        extra[name] = {"ms_per_call": us / iters / 1e3,
                       "share_of_busy": us / busy if busy else None,
                       "by_kind_ms_per_call": {k: v / iters / 1e3 for k, v in sorted(within.items())},
                       "by_kind_share_of_busy": {k: v / busy if busy else None
                                                 for k, v in sorted(within.items())}}
    return dict(
        iters=iters, wall_ms_per_call=wall_us / iters / 1e3,
        device_busy_ms_per_call=busy / iters / 1e3 if busy else None,
        device_idle_share=1 - busy / wall_us if busy else None,
        device_ops_per_call=n_kernels / iters,
        by_kind_ms_per_call={k: v / iters / 1e3 for k, v in sorted(by_kind.items())},
        top_kernels=[(k[:120], us / iters / 1e3) for us, k in per_kernel[:8]],
        **extra,
    )


def build_all(kernel_only=False):
    """nvcc for every kernel library at once, one thread (and one nvcc)
    each; seconds per library. kernel_only: the normalize library alone."""
    from concurrent.futures import ThreadPoolExecutor

    from dml_tpu_torch.native import loader
    from dml_tpu_torch.ops import _build, decode_attention, flash_attention, preprocess

    libs = {"normalize": preprocess._library, "flash_attention": flash_attention._library,
            "flash_attention_bwd": flash_attention._bwd_library,
            "decode_attention": decode_attention._library,
            "jpeg_loader": loader.get_loader}  # g++, host code; None if it cannot build

    def timed(fn):
        t0 = time.monotonic()
        fn()
        return time.monotonic() - t0

    sources = ("normalize.cu", "flash_attention.cu", "flash_attention_bwd.cu",
               "decode_attention.cu")
    if kernel_only:
        libs, sources = {"normalize": libs["normalize"]}, sources[:1]
    t0 = time.monotonic()
    with ThreadPoolExecutor(len(libs) + len(sources)) as ex:
        reports = {src: ex.submit(_build.ptxas_report, [src]) for src in sources}
        futures = {k: ex.submit(timed, fn) for k, fn in libs.items()}
        seconds = {k: f.result() for k, f in futures.items()}
        ptxas = {src: ptxas_usage(r.result()) for src, r in reports.items()}
    emit(phase="build", seconds=seconds, wall_seconds=time.monotonic() - t0)
    for src in sources:
        wgmma = src.startswith("flash")
        emit(phase="ptxas", source=f"dml_tpu_torch/csrc/{src}", kernels=ptxas[src],
             **({"setmaxnreg": setmaxnreg_counts(src)} if wgmma else {}))
        check(ptxas[src], f"ptxas reported no kernel of {src}")
        # the wgmma kernels of the flash sources, every kernel of the others
        spills = {k: u for k, u in ptxas[src].items()
                  if ("wgmma" in k or not wgmma) and (u.get("spill_stores") or u.get("spill_loads"))}
        check(not spills, f"{src}: kernels spill registers: {spills}")


def ptxas_usage(report):
    """{kernel<template args>: {registers, spill_stores, spill_loads}}
    from ptxas -v."""
    import re

    types = {"f": "float", "a": "int8", "13__nv_bfloat16": "bf16"}
    usage, name = {}, None
    for line in report.splitlines():
        m = re.search(r"Function properties for \S*?(flash_(?:fwd|bwd)_\w+?_kernel)I((?:Li\d+E)+)E", line)
        if m:
            name = f"{m.group(1)}<{','.join(re.findall(r'Li(\d+)E', m.group(2)))}>"
            usage[name] = {}
            continue
        m = re.search(r"Function properties for \S*?(decode_(?:split_)?kernel)I(f|a|13__nv_bfloat16)"
                      r"((?:Li\d+E)*)E", line)
        if m:
            args = [types[m.group(2)], *re.findall(r"Li(\d+)E", m.group(3))]
            name = f"{m.group(1)}<{','.join(args)}>"
            usage[name] = {}
            continue
        m = re.search(r"Function properties for \S*?(normalize_vec_kernel)"
                      r"I(f|13__nv_bfloat16)((?:Li\d+E)*)E", line)
        if m:
            args = [types[m.group(2)], *re.findall(r"Li(\d+)E", m.group(3))]
            name = f"{m.group(1)}<{','.join(args)}>"
            usage[name] = {}
            continue
        if re.search(r"Function properties for \S*?decode_merge_kernel", line):
            name = "decode_merge_kernel"
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
        ("vit_b16", BATCH, 197, 197, 12, 12, 64, False, bf16),
        ("d32", 2, 300, 300, 4, 2, 32, True, bf16),
        ("f32_t1000", 2, 1000, 1000, 8, 2, 64, True, f32),
        ("f32_cross", 2, 64, 192, 4, 4, 32, False, f32),
        ("f32_d16", 1, 130, 130, 2, 1, 16, True, f32),
    )
    timed = ("prefill_b8", "prefill_b1", "mha_b1", "vit_b16")
    timings = {}
    for name, b, tq, tk, h, kv, d, causal, dtype in cases:
        q = torch.randn((b, tq, h, d), generator=g, device="cuda").to(dtype)
        clean = None
        if name.startswith("prefill"):
            # the LM's layout: k contiguous after rope, v a strided view of the qkv output
            qkv = torch.randn((b, tk, (h + 2 * kv) * d), generator=g, device="cuda").to(dtype)
            k = qkv[..., h * d:(h + kv) * d].reshape(b, tk, kv, d).contiguous()
            v = qkv[..., (h + kv) * d:].reshape(b, tk, kv, d)
        elif name == "vit_b16":
            # ViT-B16's self-attention: q, k and v cut from one qkv output
            qkv = torch.randn((b, tq, 3 * h * d), generator=g, device="cuda").to(dtype)
            q, k, v = (qkv[..., i * h * d:(i + 1) * h * d].view(b, tq, h, d) for i in range(3))
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


def _decode_inputs(g, b, kv, h, t, d, cdt, qname):
    """q, k, v, k_scale, v_scale for a decode case (scales None unless
    int8). `qname` is q's dtype, with "_strided" for a view whose heads
    lie 2 * d apart."""
    import torch

    if cdt == torch.int8:
        k, v = (torch.randint(-127, 128, (b, kv, t, d), generator=g, device="cuda").to(cdt)
                for _ in range(2))
        ks, vs = (torch.rand((b, kv, 1, t), generator=g, device="cuda") * 0.02 for _ in range(2))
    else:
        k, v = (torch.randn((b, kv, t, d), generator=g, device="cuda").to(cdt) for _ in range(2))
        ks = vs = None
    qdt = getattr(torch, qname.removesuffix("_strided"))
    if qname.endswith("_strided"):
        q = torch.randn((b, 1, h, 2 * d), generator=g, device="cuda").to(qdt)[..., :d]
    else:
        q = torch.randn((b, 1, h, d), generator=g, device="cuda").to(qdt)
    return q, k, v, ks, vs


def _decode_bytes(pos, kv, h, d, k, q, ks):
    """Bytes a decode call must move (valid cache rows, their scales, q,
    out, pos) and its operations (4 per cache element per query head)."""
    rows = sum(min(p + 1, k.shape[2]) for p in pos)
    nbytes = 2 * rows * kv * d * k.element_size() + (8 * rows * kv if ks is not None else 0) \
        + q.numel() * q.element_size() + q.numel() * 4 + len(pos) * 4
    return nbytes, 4 * rows * h * d


BF, F32 = "bfloat16", "float32"
DECODE_CASES = (  # name, b, kv, h, t, d, cache dtype, q dtype, positions (None: mixed, one at the end)
    ("lm_b8", 8, 4, 16, PROMPT_LEN + NEW_TOKENS, 64, BF, BF, [PROMPT_LEN + NEW_TOKENS // 2] * 8),
    ("gqa4_b8", 8, 4, 16, DECODE_CTX, 64, BF, BF, None),
    ("gqa4_b1", 1, 4, 16, DECODE_CTX, 64, BF, BF, [3000]),
    ("mqa_b8", 8, 1, 16, DECODE_CTX, 64, BF, BF, None),
    ("mha_b8", 8, 16, 16, DECODE_CTX, 64, BF, BF, None),
    ("mha_b1", 1, 16, 16, DECODE_CTX, 64, BF, BF, [DECODE_CTX - 1]),
    ("f32_gqa4_b8", 8, 4, 16, DECODE_CTX, 64, F32, F32, None),
    ("f32_mqa_b1", 1, 1, 16, DECODE_CTX, 64, F32, F32, [1234]),
    ("int8_gqa4_b8", 8, 4, 16, DECODE_CTX, 64, "int8", BF, None),  # generate's int8 form
    ("int8_mha_b1", 1, 16, 16, DECODE_CTX, 64, "int8", F32, [2047]),
    ("int8_d16", 4, 2, 8, 1000, 16, "int8", BF, None),
    ("bf16_d32", 4, 2, 8, 1000, 32, BF, BF, None),
    ("bf16_d128_gqa4", 4, 4, 16, 2048, 128, BF, BF, None),
    ("f32_d128", 2, 2, 8, 1500, 128, F32, F32, None),
    ("pos0", 4, 4, 16, 512, 64, BF, BF, [0, 0, 0, 0]),
    ("t_not_16", 3, 4, 16, 1001, 64, BF, BF, [1000, 17, 500]),
    ("b64_short", 64, 4, 16, DECODE_CTX, 64, BF, BF, "short"),
    ("bf16q_f32_gqa4", 4, 4, 16, 1000, 64, F32, BF, None),
    ("bf16q_f32_d16", 4, 2, 8, 700, 16, F32, BF, None),
    ("bf16q_f32_d128_mqa", 2, 1, 16, 1500, 128, F32, BF, None),
    ("f32q_bf16_d32", 4, 2, 8, 1000, 32, BF, F32, None),
    ("strided_q", 4, 4, 16, 1000, 64, BF, BF + "_strided", None),
)
DECODE_TIMED = ("lm_b8", "gqa4_b8", "gqa4_b1", "mqa_b8", "mha_b1", "int8_gqa4_b8")


def phase_decode(timer):
    """The decode kernel (one launch) against the plain version, every
    cache and q form, each case twice (bit-equal, with a call at another
    (B, KV) in between); poisoned rows; one device kernel per call; the
    kernel, SDPA and the plain version timed in turns at the LM's decode
    shapes."""
    import torch
    import torch.nn.functional as F
    from dml_tpu_torch.ops import decode_attention as da

    g = torch.Generator(device="cuda").manual_seed(2)
    other = _decode_inputs(g, 2, 3, 6, 300, 64, torch.bfloat16, BF)  # the call in between
    other_pos = torch.tensor([299, 100], dtype=torch.int32, device="cuda")
    timings = {}
    for name, b, kv, h, t, d, cname, qname, pos in DECODE_CASES:
        cdt = getattr(torch, cname)
        if pos is None:  # mixed per-slot positions, one slot at the end
            pos = torch.randint(0, t, (b,), generator=g, device="cuda").tolist()
            pos[0] = t - 1
        elif pos == "short":  # most blocks lie past their slot's position
            pos = torch.randint(0, 200, (b,), generator=g, device="cuda").tolist()
            pos[0] = t - 1
        pos_t = torch.tensor(pos, dtype=torch.int32, device="cuda")
        q, k, v, ks, vs = _decode_inputs(g, b, kv, h, t, d, cdt, qname)
        scale = d ** -0.5

        def new():
            return da.decode_attention(q, k, v, pos_t, k_scale=ks, v_scale=vs)

        out = new()
        da.decode_attention(*other[:3], other_pos)  # another (B, KV) between the two runs
        again = new()
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
              and torch.equal(poisoned, out) and torch.equal(again, out))
        plan = da.split_plan(b, kv, t, d, h // kv, k.element_size(), ks is not None,
                             da._sms(q.device))
        case = dict(phase="decode_check", case=name, b=b, kv=kv, h=h, t=t, d=d, cache=cname, q=qname,
                    pos=pos if b <= 8 else f"{b} slots, max {max(pos)}", max_abs_err=err,
                    rerun_bit_equal=torch.equal(again, out),
                    poisoned_rows_change_output=not torch.equal(poisoned, out),
                    plan=plan._asdict(), ok=ok)
        emit(**case)
        check(ok, f"decode kernel disagrees: {case}")
        del kp, vp, ksp, vsp, poisoned
        if name == "lm_b8":  # one device kernel per call
            before = da.decode_launches
            prof = profile_calls(new, 100, LM_KINDS)
            launched = da.decode_launches - before
            emit(phase="decode_launches_per_call", case=name, calls=100, wrapper_launches=launched,
                 device_ops_per_call=prof["device_ops_per_call"], top_kernels=prof["top_kernels"])
            # the profiler may drop a few records of a long run of short
            # kernels; it must show no other kernel and none beyond one a call
            check(launched == 100 and 0.95 <= prof["device_ops_per_call"] <= 1
                  and prof["by_kind_ms_per_call"].keys() == {"decode_attention"},
                  f"decode_attention is not one device kernel per call: {prof}")
        if name in DECODE_TIMED:
            runs = {"new": new}
            if cdt == torch.bfloat16:
                mask = (torch.arange(t, device="cuda")[None, :] <= pos_t[:, None])[:, None, None, :]
                qh = q.transpose(1, 2)

                def library():
                    return F.scaled_dot_product_attention(qh, k, v, attn_mask=mask,
                                                          enable_gqa=kv != h)

                runs["sdpa"] = library
            # in turns on one card: new, SDPA, plain, SDPA, new
            turns = {key: [] for key in runs}
            for key in ("new", "sdpa"):
                if key in runs:
                    turns[key].append(timer.ms(runs[key], iters=50))
            p_ms = timer.ms(lambda: da.decode_attention_plain(q, k, v, pos_t, k_scale=ks,
                                                             v_scale=vs), iters=20)
            for key in ("sdpa", "new"):
                if key in runs:
                    turns[key].append(timer.ms(runs[key], iters=50))
            k_ms = statistics.mean(turns["new"])
            l_ms = statistics.mean(turns["sdpa"]) if "sdpa" in turns else None
            nbytes, ops = _decode_bytes(pos, kv, h, d, k, q, ks)
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = ops / PEAK_FLOPS["float32"] * 1e3
            timings[name] = dict(ms=k_ms, plain_ms=p_ms, library_ms=l_ms,
                                 bound_ms=max(t_bytes, t_ops),
                                 bound_by="bytes" if t_bytes >= t_ops else "operations",
                                 max_abs_err=err)
            extra = {}
            if name == "lm_b8":  # the same, with an L2 flushed by reads (no dirty lines)
                clean = {key: timer.ms(runs[key], iters=50, clean=True) for key in runs}
                extra = {"clean_flush_ms": clean,
                         "clean_flush_share_of_bound": max(t_bytes, t_ops) / clean["new"]}
            emit(phase="decode_time", case=name, ms=k_ms, plain_ms=p_ms,
                 sdpa_ms=l_ms, turns_ms=turns, bytes=nbytes, bytes_bound_ms=t_bytes,
                 ops_bound_ms=t_ops, achieved_gb_s=nbytes / (k_ms * 1e-3) / 1e9,
                 share_of_bound=max(t_bytes, t_ops) / k_ms,
                 vs_sdpa=k_ms / l_ms if l_ms else None,
                 grid=[plan.n_split, kv, b], chunk=plan.chunk, **extra)
        del q, k, v, ks, vs, out, again, plain
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


def phase_lm(timer):
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
            # K4 inside the step against K4 alone on one layer's cache at
            # the same context (the L2 flushed before each launch)
            from dml_tpu_torch.ops import decode_attention as da

            lay = cache["block_0"]
            q1 = torch.randn((b, 1, cfg.n_heads, cfg.head_dim), device="cuda").to(cfg.dtype)
            alone = timer.ms(lambda: da.decode_attention(q1, lay["k"], lay["v"], pos), iters=50)
            in_step = prof_decode["by_kind_ms_per_call"].get("decode_attention", 0.0)
            emit(phase="decode_in_step", batch=b, context=DECODE_CTX + 45,
                 cache_rows=int(lay["k"].shape[2]), k4_ms_per_step_in_profile=in_step,
                 k4_ms_alone=alone, k4_ms_alone_x_layers=cfg.n_layers * alone,
                 in_step_over_alone=in_step / (cfg.n_layers * alone))
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
    if name in ("strided", "vit_b16"):
        # q, k, v cut from a qkv projection's output (ViT-B16's layout);
        # dO made head-major
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
        ("vit_b16", BATCH, 197, 197, 12, 12, 64, False, bf16),
        ("d32", 2, 300, 300, 4, 2, 32, True, bf16),
        ("f32_t1000", 2, 1000, 1000, 8, 2, 64, True, f32),
        ("f32_cross", 2, 64, 192, 4, 4, 32, False, f32),
        ("f32_d16", 1, 130, 130, 2, 1, 16, True, f32),
    )
    deterministic = ("train", "gqa4", "vit_b16")
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
        if name in ("train", "vit_b16"):
            timings[name] = time_flash_bwd(timer, name, q, k, v, out, lse, dout, causal, errs)
        del q, k, v, dout, out, lse, clean
    torch.cuda.empty_cache()
    return timings


def time_flash_bwd(timer, case, q, k, v, out, lse, dout, causal, errs):
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
    emit(phase="flash_bwd_time", case=case, route=fa.bwd_kernel_route(q.dtype, d),
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


# the image training path: ResNet50 at its published width and depth,
# 224x224 caffe, bf16, batch 32 (the serving batch), AdamW lr 1e-3
IMAGE_TRAIN_STEPS, INCEPTION_TRAIN_STEPS, REMAT_STEPS, PREFETCH_IMAGES = 20, 5, 3, 64
IMAGE_TRAIN_KINDS = (
    ("normalize_", "normalize"), ("dgrad", "conv_backward"), ("wgrad", "conv_backward"),
    ("Adam", "optimizer"), ("multi_tensor_apply", "optimizer"),
    ("bn_bw", "batch_norm"), ("batch_norm", "batch_norm"), ("bn_fw", "batch_norm"),
    ("fprop", "conv"), ("implicit_gemm", "conv"), ("conv", "conv"), ("pool", "pool"),
    ("gemm", "gemm"), ("nvjet", "gemm"), ("softmax", "softmax"), ("Memcpy", "copy"),
    ("Memset", "copy"), ("reduce", "reduce"), ("CatArray", "concat"),
    ("elementwise", "elementwise"))


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN's deterministic algorithms within the block: a comparison of
    two runs that must agree (a resume, remat against plain) then sees
    the state and the recomputation, not cuDNN's run-to-run order of
    atomic adds."""
    import torch

    before = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = before


def _seeded_batch(rng, n, h, w, classes):
    imgs = rng.randint(0, 256, (n, h, w, 3)).astype(np.uint8)
    imgs = np.clip(imgs // 2 + rng.randint(0, 128, (n, 1, 1, 3)), 0, 255).astype(np.uint8)
    return imgs, rng.randint(0, classes, n).astype(np.int64)


def _counted_steps(tr, x, y, n, per_step=None):
    """n train steps, each checked to launch the kernels of `per_step`
    exactly that often (default: K1 once and no other kernel of the
    port); (losses, accuracies, step ms)."""
    import torch

    per_step = per_step or {"normalize": 1, "flash_attention": 0, "flash_bwd": 0,
                            "flash_bwd_delta": 0, "decode_attention": 0}
    losses, accs, step_ms = [], [], []
    for _ in range(n):
        before = launch_counts()
        t0 = time.monotonic()
        m = tr.step(x, y)  # float(loss) waits for the whole step
        step_ms.append((time.monotonic() - t0) * 1e3)
        after = launch_counts()
        moved = {k: after[k] - before[k] for k in after}
        check(moved == per_step, f"an image train step launched {moved}, want {per_step}")
        losses.append(m["loss"])
        accs.append(m["accuracy"])
    torch.cuda.synchronize()
    return losses, accs, step_ms


def phase_image_train():
    """The image training path: `parallel.train.Trainer` on cuda, counted.
    Returns K1's launches on it, by model."""
    import torch
    from dml_tpu_torch.data import ImageDataset, Prefetcher
    from dml_tpu_torch.inference import InferenceEngine
    from dml_tpu_torch.models import preprocess
    from dml_tpu_torch.models.registry import get_model
    from dml_tpu_torch.native import loader as native_loader
    from dml_tpu_torch.parallel.train import Trainer

    h, w = get_model("ResNet50").input_size
    x_np, y_np = _seeded_batch(np.random.RandomState(9), BATCH, h, w, 1000)
    # the batch on the card, as Prefetcher(device="cuda") yields it
    x, y = torch.from_numpy(x_np).cuda(), torch.from_numpy(y_np).cuda()
    t0 = time.monotonic()
    tr = Trainer("ResNet50", batch_size=BATCH, dtype=torch.bfloat16, seed=0)  # device None -> cuda
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    check(tr.device.type == "cuda", f"Trainer on {tr.device}")
    check(all(p.dtype == torch.float32 for p in tr.params.values()), "master weights not float32")
    warm = tr.step(x, y)  # warm-up: cuDNN's algorithm choice, the optimizer's state
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # ---- the main path, counted ----
    reset_launch_counts()
    losses, accs, step_ms = _counted_steps(tr, x, y, IMAGE_TRAIN_STEPS)
    stats_before = {k: v.clone() for k, v in tr.state["batch_stats"].items()}
    step_before = tr.state["step"]
    before = launch_counts()["normalize"]
    ev = tr.evaluate(x, y)
    eval_launches = launch_counts()["normalize"] - before
    launches = launch_counts()
    peak_mb = torch.cuda.max_memory_allocated() / 1e6
    check(all(np.isfinite(losses)), f"non-finite loss: {losses}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses[0]} -> {losses[-1]}")
    check(eval_launches == 1, f"evaluate launched K1 {eval_launches} times")
    check(tr.state["step"] == step_before == 1 + IMAGE_TRAIN_STEPS, "evaluate moved the step")
    check(all(torch.equal(v, stats_before[k]) for k, v in tr.state["batch_stats"].items()),
          "evaluate moved the running statistics")
    check(np.isfinite(ev["loss"]), f"evaluate loss {ev}")

    with tempfile.TemporaryDirectory() as ck, deterministic_cudnn():
        # checkpoint round trip on the card: the next two losses repeat
        t0 = time.monotonic()
        tr.save_checkpoint(ck)
        save_s = time.monotonic() - t0
        ahead = [tr.step(x, y)["loss"] for _ in range(2)]
        t0 = time.monotonic()
        check(tr.restore_checkpoint(ck) == step_before, "restored the wrong step")
        restore_s = time.monotonic() - t0
        again = [tr.step(x, y)["loss"] for _ in range(2)]
        ck_rel = max(_rel(a, b) for a, b in zip(again, ahead))
        check(ck_rel <= 1e-5, f"losses after restore {again} != {ahead}")
        # remat against the plain step from the same state
        check(tr.restore_checkpoint(ck) == step_before, "restored the wrong step")
        plain = [tr.step(x, y)["loss"] for _ in range(REMAT_STEPS)]
        plain_stats = tr.state["batch_stats"]
        rt = Trainer("ResNet50", batch_size=BATCH, dtype=torch.bfloat16, remat=True)
        rt.restore_checkpoint(ck)
        remat = [rt.step(x, y)["loss"] for _ in range(REMAT_STEPS)]
        remat_rel = max(_rel(a, b) for a, b in zip(remat, plain))
        stats_rel = max(float(((v - plain_stats[k]).abs() / plain_stats[k].abs().clamp_min(1e-3)).max())
                        for k, v in rt.state["batch_stats"].items())
        del rt
    check(remat_rel <= 1e-5, f"remat losses {remat} != plain {plain}")
    check(stats_rel <= 1e-5, f"remat running statistics differ by {stats_rel} relative")

    # the trained weights served by the engine: the same accuracy
    ev_export = tr.evaluate(x, y)
    eng = InferenceEngine(dtype=torch.bfloat16)
    eng.load_model("ResNet50", variables=tr.export_variables(), batch_size=BATCH)
    probs = eng.infer_arrays("ResNet50", x_np)
    engine_acc = float((probs.argmax(-1) == y_np).mean())
    check(engine_acc == ev_export["accuracy"],
          f"engine accuracy {engine_acc} != evaluate's {ev_export['accuracy']}")
    del eng

    prof = profile_calls(lambda: tr.step(x, y), 3, IMAGE_TRAIN_KINDS)
    prof["normalize_share_of_busy"] = (prof["by_kind_ms_per_call"].get("normalize", 0.0)
                                       / prof["device_busy_ms_per_call"])

    # the input pipeline into the trainer: JPEGs decoded on the host,
    # copied by the Prefetcher from pinned memory on its own stream
    p_np, p_labels = _seeded_batch(np.random.RandomState(10), PREFETCH_IMAGES, h, w, 1000)
    with tempfile.TemporaryDirectory() as tmp:
        files = write_images(tmp, p_np, "jpeg")
        ds = ImageDataset(list(zip(files, p_labels.tolist())), (h, w), BATCH, seed=1)
        decoded = preprocess.decoded_batches
        decoded.update(native=0, pil=0)
        reset_launch_counts()
        pf_losses, pf_equal = [], []
        for (images, labels), (want, want_labels) in zip(Prefetcher(ds, device="cuda"),
                                                         ds.epoch(0)):
            check(images.device.type == "cuda" and images.dtype == torch.uint8
                  and tuple(images.shape) == (BATCH, h, w, 3), f"prefetched {images.shape}")
            pf_losses.append(tr.step(images, labels)["loss"])
            pf_equal.append(bool(np.array_equal(images.cpu().numpy(), want))
                            and bool(np.array_equal(labels.cpu().numpy(), want_labels)))
        pf_launches = launch_counts()["normalize"]
    emit(phase="loader", model="ResNet50", path="image_train Prefetcher",
         jpeg_batch_decoder="native" if decoded["native"] else "pil",
         decoded_batches=dict(decoded), native_available=native_loader.native_available(),
         build_error=native_loader.build_error())
    n_batches = PREFETCH_IMAGES // BATCH
    check(len(pf_losses) == n_batches and all(pf_equal), f"prefetched batches {pf_equal}")
    check(pf_launches == n_batches and all(np.isfinite(pf_losses)),
          f"prefetch loop: {pf_launches} K1 launches, losses {pf_losses}")
    del tr
    torch.cuda.empty_cache()

    # InceptionV3 b32 299x299 tf: no trainable BN scale
    ih, iw = get_model("InceptionV3").input_size
    xi_np, yi_np = _seeded_batch(np.random.RandomState(11), BATCH, ih, iw, 1000)
    xi, yi = torch.from_numpy(xi_np).cuda(), torch.from_numpy(yi_np).cuda()
    ti = Trainer("InceptionV3", batch_size=BATCH, dtype=torch.bfloat16, seed=0)
    check(not any("batch_normalization" in n and n.endswith(".weight") for n in ti.params),
          "InceptionV3 has a trainable BN scale")
    inc_warm = ti.step(xi, yi)
    reset_launch_counts()
    inc_losses, inc_accs, inc_ms = _counted_steps(ti, xi, yi, INCEPTION_TRAIN_STEPS)
    inc_launches = launch_counts()
    check(all(np.isfinite(inc_losses)), f"InceptionV3 non-finite loss: {inc_losses}")
    del ti
    torch.cuda.empty_cache()

    # float32: the card (TF32 off) against the port's CPU path, on a
    # narrow ResNet
    register_narrow_resnet()
    xs, ys = _seeded_batch(np.random.RandomState(12), 8, 64, 64, 10)
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        g32 = Trainer("ResNetNarrow", batch_size=8, dtype=torch.float32, num_classes=10, seed=1,
                      learning_rate=1e-4)
        cuda_losses = [g32.step(xs, ys)["loss"] for _ in range(3)]
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    c32 = Trainer("ResNetNarrow", batch_size=8, dtype=torch.float32, num_classes=10, seed=1,
                  learning_rate=1e-4, device="cpu")
    cpu_losses = [c32.step(xs, ys)["loss"] for _ in range(3)]
    f32_rel = max(_rel(a, b) for a, b in zip(cuda_losses, cpu_losses))
    check(f32_rel <= 1e-4, f"f32 cuda losses {cuda_losses} != cpu {cpu_losses}")
    del g32, c32

    med = statistics.median(step_ms)
    emit(phase="image_train", config=dict(model="ResNet50", image=[h, w], mode="caffe",
                                          dtype="bfloat16", batch=BATCH,
                                          optimizer="AdamW lr 1e-3 wd 1e-4",
                                          params="float32 masters"),
         init_s=init_s, warmup_loss=warm["loss"], steps=IMAGE_TRAIN_STEPS, losses=losses,
         accuracies=accs, launches=launches, evaluate=ev, evaluate_launches=eval_launches,
         step_ms=step_ms, step_ms_median=med, step_ms_p90=float(np.percentile(step_ms, 90)),
         images_per_s=BATCH / (med / 1e3), max_memory_allocated_mb=peak_mb,
         checkpoint_save_s=save_s, checkpoint_restore_s=restore_s, losses_ahead=ahead,
         losses_after_restore=again, restore_max_rel_diff=ck_rel,
         remat_losses=remat, plain_losses=plain, remat_max_rel_diff=remat_rel,
         remat_batch_stats_max_rel_diff=stats_rel,
         export_engine_accuracy=engine_acc, export_evaluate=ev_export,
         prefetch_losses=pf_losses, prefetch_launches=pf_launches,
         inception=dict(image=[ih, iw], mode="tf", warmup_loss=inc_warm["loss"],
                        losses=inc_losses, launches=inc_launches, step_ms=inc_ms,
                        step_ms_median=statistics.median(inc_ms),
                        images_per_s=BATCH / (statistics.median(inc_ms) / 1e3)),
         f32_cuda_losses=cuda_losses, f32_cpu_losses=cpu_losses, f32_max_rel_diff=f32_rel)
    emit(phase="profile", path=f"image_train_step_resnet50_b{BATCH}", **prof)
    return {"ResNet50": launches["normalize"], "InceptionV3": inc_launches["normalize"]}


# ---------------------------------------------------------------------------
# phase 12: the continuous-batching LM server
# ---------------------------------------------------------------------------

# bench.py's lm.mixed_budget_batching (bench.py:3373-3421): 32 requests of 12
# prompt tokens, budgets drawn from 32..512, 8 slots, max_len 1024, chunk 32
LMS_SLOTS, LMS_MAX_LEN, LMS_CHUNK = 8, 1024, 32
# long prompts, so that K2 runs at real lengths: 16 requests of 256-2048 tokens
LONG_REQS, LONG_BUDGET, LONG_MAX_LEN, LONG_CHUNK = 16, 64, 4096, 16
# bf16 token checks: equal up to the first position where the lone run's top-1
# minus top-2 logit margin is under this (a bf16 rounding of the residual
# stream moves a logit by a few 1e-3; 0.1 is 20-50 times that)
TIE_MARGIN = 0.1


def mixed_requests(vocab):
    rng = np.random.RandomState(3)
    return [(rng.randint(0, vocab, 12).astype(np.int32), int(b))
            for b in rng.choice([32, 64, 128, 256, 512], size=32)]


def server_dispatches():
    """The servers' own dispatch counters (process-wide, read as deltas):
    placement group prefills, decode dispatches (chunk steps and spec
    rounds), and the slot-occupancy samples."""
    from dml_tpu_torch.observability import METRICS

    pre = METRICS.histogram("lm_server_prefill_dispatch_seconds").items()
    occ = METRICS.histogram("lm_server_slot_occupancy").items()
    return {"prefill": sum(st[0] for _, st in pre),
            "steps": int(METRICS.counter("lm_server_steps_total").value()),
            "occupancy_sum": sum(st[1] for _, st in occ),
            "occupancy_n": sum(st[0] for _, st in occ)}


def check_server_launches(name, launches, d, n_layers, chunk, spec=None):
    """K2 = layers x placement prefills (+ the draft's layers per prefill),
    K4 = layers x chunk x chunk steps (+ the draft's layers x k per spec
    round); no other kernel."""
    rounds = spec["rounds"] if spec else 0
    want = {"normalize": 0, "flash_bwd": 0, "flash_bwd_delta": 0,
            "flash_attention": n_layers * d["prefill"],
            "decode_attention": n_layers * chunk * (d["steps"] - rounds)}
    if spec:
        want["flash_attention"] += spec["draft_layers"] * d["prefill"]
        want["decode_attention"] += spec["draft_layers"] * spec["k"] * rounds
    check(launches == want, f"{name}: launched {launches}, the server's dispatches {d} "
                            f"give {want}")
    return want


def _pct(xs, q):
    return float(np.percentile(np.asarray(xs, np.float64), q)) if xs else None


def serve_stream(srv, reqs, waves=None, count_syncs=False):
    """Submit `reqs` ([(prompt, budget)]) at once (continuous refill) or in
    waves of `waves` each drained to its slowest request, and run to the
    end. Per request: submit, first-token and last-token times from the
    on_token stream. count_syncs: step by step under
    torch.cuda.set_sync_debug_mode("warn"), counting the synchronizing
    calls of the submit and of each step."""
    import warnings

    import torch

    n = len(reqs)
    t_sub, t_first, t_last, outs = [0.0] * n, [None] * n, [None] * n, [None] * n
    syncs = {"submit": [], "steps": [], "where": {}}

    def cb(i):
        def fire(_tok):
            now = time.monotonic()
            if t_first[i] is None:
                t_first[i] = now
            t_last[i] = now
        return fire

    def n_syncs(w, since):
        hits = [x for x in w[since:] if "called a synchronizing CUDA operation" in str(x.message)]
        for x in hits:  # where each synchronizing call came from
            where = f"{os.path.relpath(x.filename)}:{x.lineno}"
            syncs["where"][where] = syncs["where"].get(where, 0) + 1
        return len(hits)

    groups = [list(range(n))] if waves is None else [
        list(range(i, min(n, i + waves))) for i in range(0, n, waves)]
    d0 = server_dispatches()
    t0 = time.monotonic()
    for g in groups:
        now = time.monotonic()
        for i in g:
            t_sub[i] = now
        args = ([reqs[i][0] for i in g], [reqs[i][1] for i in g])
        if count_syncs:
            with warnings.catch_warnings(record=True) as w:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    rids = srv.submit_many(*args, on_token=[cb(i) for i in g])
                    syncs["submit"].append(n_syncs(w, 0))
                    while srv.has_work():
                        k = len(w)
                        srv.step()
                        syncs["steps"].append(n_syncs(w, k))
                finally:
                    torch.cuda.set_sync_debug_mode(0)
            done = srv.take_done()
        else:
            rids = srv.submit_many(*args, on_token=[cb(i) for i in g])
            done = srv.run(rids)
        for i, rid in zip(g, rids):
            outs[i] = done[rid]
    wall = time.monotonic() - t0
    d = {k: v - d0[k] for k, v in server_dispatches().items()}
    tokens = sum(len(o) for o in outs)
    check(all(len(o) == b for o, (_, b) in zip(outs, reqs)), "a request's token count != its budget")
    stats = dict(wall_s=wall, tokens=tokens, tokens_per_s=tokens / wall, steps=d["steps"],
                 prefill_dispatches=d["prefill"],
                 mean_slot_occupancy=d["occupancy_sum"] / max(d["occupancy_n"], 1),
                 latency_ms_p50=_pct([(b - a) * 1e3 for a, b in zip(t_sub, t_last)], 50),
                 latency_ms_p99=_pct([(b - a) * 1e3 for a, b in zip(t_sub, t_last)], 99),
                 ttft_ms_p50=_pct([(b - a) * 1e3 for a, b in zip(t_sub, t_first)], 50),
                 ttft_ms_p99=_pct([(b - a) * 1e3 for a, b in zip(t_sub, t_first)], 99))
    if count_syncs:
        stats["syncs"] = syncs
    return outs, d, stats


def prefix_agreement(outs, ref):
    """The share of equal tokens over each pair's common length."""
    same = sum(int((a[:len(b)] == b[:len(a)]).sum()) for a, b in zip(outs, ref))
    return same / sum(min(len(a), len(b)) for a, b in zip(outs, ref))


def lone_greedy(gen, params, cfg, prompt, n):
    """A request's lone greedy tokens through prefill and decode steps
    (generate's path at B=1), with the top-1 minus top-2 margin of each."""
    import torch

    toks, margins = greedy_with_margins(gen, params, cfg,
                                        torch.from_numpy(prompt[None]).cuda(), n)
    return toks[0].tolist(), [m[0] for m in margins]


def tie_compare(got, want, margins, bound=TIE_MARGIN):
    """(held, compared, first near-tie, smallest margin up to the first
    mismatch): `got` equals `want` everywhere, or up to its first
    mismatch, at or after a position where the lone run's margin is
    under `bound` (a near-tie, where bf16 rounding may choose either
    token)."""
    got = [int(t) for t in got]
    tie = next((i for i, m in enumerate(margins) if m < bound), None)
    mism = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b), None)
    if mism is None:
        return True, len(want), tie, None
    return tie is not None and tie <= mism, mism, tie, min(margins[:mism + 1])


def k4_live_check(srv, cfg):
    """K4 on the server's live cache against its plain version: the live
    ragged positions, clamped as the chunk clamps them, with one freed slot
    pinned at max_len - 1 (where the clamp holds a freed slot)."""
    import torch
    from dml_tpu_torch.ops import decode_attention as da

    free = [s for s, r in enumerate(srv._slot_req) if r is None]
    pos = srv._pos_dev.clamp(max=srv.max_len - 1)
    pos[free[0]] = srv.max_len - 1
    g = torch.Generator(device=srv.device).manual_seed(12)
    q = torch.randn((srv.max_slots, 1, cfg.n_heads, cfg.head_dim), device=srv.device,
                    generator=g).to(cfg.dtype)
    errs = {}
    for name in ("block_0", f"block_{cfg.n_layers - 1}"):
        lay = srv.cache[name]
        got = da.decode_attention(q, lay["k"], lay["v"], pos)
        want = da.decode_attention_plain(q, lay["k"], lay["v"], pos)
        errs[name] = float((got - want).abs().max())
        check(errs[name] <= 2e-5, f"K4 on the live cache ({name}): max |err| {errs[name]} > 2e-5")
    return {"pos": pos.tolist(), "free_slots": free, "max_abs_err": errs}


def phase_lm_server(timer):
    """The continuous-batching LM server at full width and depth (phase 12)."""
    import dataclasses

    import torch
    from dml_tpu_torch.config import draft_lm_spec
    from dml_tpu_torch.inference import generate as gen
    from dml_tpu_torch.inference.kv_cache import KVPrefixCache
    from dml_tpu_torch.inference.lm_backend import LMBackend, lm_spec_parts, write_prompt_file
    from dml_tpu_torch.inference.lm_server import LMDriver, LMServer, _bucket
    from dml_tpu_torch.inference.quantize import quantize_lm_params
    from dml_tpu_torch.models.lm_params import init_lm_params
    from dml_tpu_torch.models.params_io import variables_to_bytes

    t_phase = time.monotonic()
    cfg = gen.LMConfig(**LM_CFG, dtype=torch.bfloat16)
    nl = cfg.n_layers
    p32 = init_lm_params(cfg, seed=0)  # device None -> cuda
    params = gen.serving_params(p32, cfg)
    reqs = mixed_requests(cfg.vocab_size)
    out = {"config": dict(LM_CFG, dtype="bfloat16"), "slots": LMS_SLOTS,
           "max_len": LMS_MAX_LEN, "chunk": LMS_CHUNK, "requests": len(reqs),
           "budgets": [b for _, b in reqs], "tie_margin": TIE_MARGIN}

    # ---- (a) the mixed-budget stream: a warm-up with K4 checked on the
    # live cache mid-serve, then continuous refill (counted, every
    # synchronizing call counted) and waves of 8 (counted)
    srv = LMServer(params, cfg, max_slots=LMS_SLOTS, max_len=LMS_MAX_LEN, chunk=LMS_CHUNK)
    srv.submit_many([p for p, _ in reqs], [b for _, b in reqs])
    live = None
    while srv.has_work():
        srv.step()
        n_free = srv.free_slot_count()
        if live is None and not srv._queue and 0 < n_free < LMS_SLOTS:
            live = k4_live_check(srv, cfg)
    srv.take_done()
    check(live is not None, "no mid-serve state with a freed slot beside a live one")
    torch.cuda.synchronize()
    reset_launch_counts()
    cont, d, out["continuous"] = serve_stream(srv, reqs, count_syncs=True)
    launches = launch_counts()
    check_server_launches("continuous", launches, d, nl, LMS_CHUNK)
    syncs = out["continuous"]["syncs"]
    check(syncs["submit"] == [0] and syncs["steps"] and all(s == 1 for s in syncs["steps"]),
          f"synchronizing calls: submit {syncs['submit']}, per step {syncs['steps']} "
          f"(want 0 and exactly 1), from {syncs['where']}")
    out["continuous"]["syncs"] = {"submit": syncs["submit"][0], "per_step": sorted(set(syncs["steps"])),
                                  "steps": len(syncs["steps"]), "where": syncs["where"]}
    reset_launch_counts()
    waves, d, out["waves"] = serve_stream(srv, reqs, waves=LMS_SLOTS)
    wl = launch_counts()
    check_server_launches("waves", wl, d, nl, LMS_CHUNK)
    check(all(np.array_equal(a, b) for a, b in zip(cont, waves)),
          "continuous and wave tokens differ (a row's tokens depend on its grid-mates)")
    out["speedup_continuous_over_waves"] = out["waves"]["wall_s"] / out["continuous"]["wall_s"]
    out["k4_live"] = live
    lm_server = {k: launches[k] + wl[k] for k in launches}

    # a steady chunk step's device profile: 8 slots busy for 3+ steps
    prof_reqs = [(p, 4 * LMS_CHUNK) for p, _ in reqs[:LMS_SLOTS]]
    srv.submit_many([p for p, _ in prof_reqs], [b for _, b in prof_reqs])
    srv.step()
    prof_step = profile_calls(srv.step, 2, LM_KINDS)
    srv.run()
    del srv

    # ---- (b) long prompts: K2 at 256-2048 tokens, counted
    rng = np.random.RandomState(5)
    long_reqs = [(rng.randint(0, cfg.vocab_size, int(t)).astype(np.int32), LONG_BUDGET)
                 for t in rng.randint(256, 2049, size=LONG_REQS)]
    lsrv = LMServer(params, cfg, max_slots=LMS_SLOTS, max_len=LONG_MAX_LEN, chunk=LONG_CHUNK)
    serve_stream(lsrv, long_reqs[:2])  # warm-up: two prompts, two buckets
    torch.cuda.synchronize()
    reset_launch_counts()
    long_out, d, out["long"] = serve_stream(lsrv, long_reqs)
    ll = launch_counts()
    check_server_launches("long prompts", ll, d, nl, LONG_CHUNK)
    lm_server = {k: lm_server[k] + ll[k] for k in ll}
    out["long"]["prompt_lens"] = [len(p) for p, _ in long_reqs]
    del lsrv

    # ---- check 4, bf16: each long request against its lone generate path;
    # the logit noise between a grid-shaped prefill (bucket-padded, 8 rows)
    # and the lone one says how near a tie has to be to flip
    ties = mism = 0
    compared, noise, at_mismatch = [], [], []
    for i, ((p, n), got) in enumerate(zip(long_reqs, long_out)):
        want, margins = lone_greedy(gen, params, cfg, p, n)
        held, upto, tie, low = tie_compare(got, want, margins)
        check(held, f"bf16 server tokens differ from the lone run at {upto} with no near-tie "
                    f"before it (margins {margins[:upto + 1]})")
        ties += tie is not None
        mism += upto < n
        compared.append(upto)
        if low is not None:
            at_mismatch.append(low)
        if i < 4:
            lone = gen.prefill(params, cfg, torch.from_numpy(p[None]).cuda(), len(p) + 1)[0]
            bucket = min(_bucket(len(p)), LONG_MAX_LEN)
            grid = np.repeat(np.concatenate([p, np.full(bucket - len(p), p[-1], np.int32)])[None],
                             LMS_SLOTS, axis=0)
            glog = gen.prefill(params, cfg, torch.from_numpy(grid).cuda(), LONG_MAX_LEN,
                               logits_index=torch.full((LMS_SLOTS,), len(p) - 1).cuda())[0]
            noise.append(float((glog[0] - lone[0]).abs().max()))
    out["bf16_vs_lone"] = {"requests": len(long_reqs), "near_ties": ties,
                           "stopped_at_a_tie": mism, "tokens_compared": compared,
                           "first_token_logit_noise": noise,
                           "least_margin_up_to_each_mismatch": at_mismatch}

    # ---- check 5: sampled tokens do not depend on the grid-mates
    sreqs = [(p, 64) for p, _ in reqs[:LMS_SLOTS]]
    sampled = []
    for share in (sreqs, sreqs[:2]):  # rid 1 beside 7 others, then beside 1
        s = LMServer(params, cfg, max_slots=LMS_SLOTS, max_len=LMS_MAX_LEN, chunk=LMS_CHUNK,
                     temperature=0.8, top_k=40, seed=11)
        toks, _, _ = serve_stream(s, share)
        sampled.append(toks)
    check(np.array_equal(sampled[0][0], sampled[1][0]) and np.array_equal(sampled[0][1], sampled[1][1]),
          "a sampled request's tokens changed with its grid-mates")
    check(all(0 <= int(t) < cfg.vocab_size for o in sampled[0] for t in o), "sampled token out of range")
    out["sampled_independent_of_grid"] = True
    out["sampled_agreement_with_greedy"] = prefix_agreement(sampled[0], cont)

    # ---- float32, TF32 off: check 4's exact form and check 6 (spec)
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
        s32 = LMServer(p32, cfg32, max_slots=LMS_SLOTS, max_len=LMS_MAX_LEN, chunk=LMS_CHUNK)
        f32_out, _, _ = serve_stream(s32, reqs[:4])
        for (p, n), got in zip(reqs[:4], f32_out):
            want = gen.generate(p32, cfg32, torch.from_numpy(p[None]).cuda(), n)[0].cpu().numpy()
            check(np.array_equal(got, want), "f32 server tokens != the lone f32 generate's")
        out["f32_exact_vs_lone"] = {"requests": 4, "tokens": int(sum(n for _, n in reqs[:4]))}
        spec_reqs = [(p, 64) for p, _ in reqs[:LMS_SLOTS]]
        plain32, _, plain_st = serve_stream(s32, spec_reqs)
        del s32
        spec_lm = dict(LM_CFG, dtype="float32", seed=0)
        draft_spec = draft_lm_spec(spec_lm, n_layers=2)
        dparams, dcfg = lm_spec_parts(draft_spec, device="cuda")
        spec_out = {}
        for name, (dp, dc) in (("self_draft", (p32, cfg32)), ("draft_2_layer", (dparams, dcfg))):
            s = LMServer(p32, cfg32, max_slots=LMS_SLOTS, max_len=LMS_MAX_LEN, chunk=LMS_CHUNK)
            s.enable_spec_decode(4, draft_params=dp, draft_cfg=dc)
            reset_launch_counts()
            toks, d, st = serve_stream(s, spec_reqs)
            sp = s.spec_stats()
            check_server_launches(name, launch_counts(), d, nl, LMS_CHUNK,
                                  spec=dict(sp, draft_layers=dc.n_layers))
            check(all(np.array_equal(a, b) for a, b in zip(toks, plain32)),
                  f"spec ({name}) tokens != the plain server's")
            spec_out[name] = dict(sp, wall_s=st["wall_s"], tokens_per_s=st["tokens_per_s"],
                                  steps=st["steps"])
            del s
        sd = spec_out["self_draft"]
        check(sd["enabled"] and sd["proposed"] > 0 and sd["accepted"] == sd["proposed"],
              f"self-draft spec: {sd}")
        out["spec_f32"] = spec_out
        out["spec_f32"]["plain"] = {"tokens_per_s": plain_st["tokens_per_s"],
                                    "wall_s": plain_st["wall_s"], "steps": plain_st["steps"]}
        out["spec_f32"]["draft_spec"] = {k: draft_spec[k] for k in ("d_model", "n_layers", "d_ff")}
        del dparams
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32

    # ---- check 7: the KV prefix cache, warm second turns against cold
    turn1 = [(rng.randint(0, cfg.vocab_size, 500).astype(np.int32), 32) for _ in range(LMS_SLOTS)]
    wsrv = LMServer(params, cfg, max_slots=LMS_SLOTS, max_len=LMS_MAX_LEN, chunk=LMS_CHUNK)
    kv = KVPrefixCache(4 << 30)
    wsrv.enable_kv_cache(kv)
    first, _, _ = serve_stream(wsrv, turn1)
    turn2 = [(np.concatenate([p, o, rng.randint(0, cfg.vocab_size, 16).astype(np.int32)]), 32)
             for (p, _), o in zip(turn1, first)]
    reset_launch_counts()
    warm, d, wst = serve_stream(wsrv, turn2)
    check_server_launches("warm turn", launch_counts(), d, nl, LMS_CHUNK)
    kst = kv.stats()
    check(kst["hits"] > 0 and kst["tokens_saved"] > 0, f"KV prefix cache: {kst}")
    csrv = LMServer(params, cfg, max_slots=LMS_SLOTS, max_len=LMS_MAX_LEN, chunk=LMS_CHUNK)
    serve_stream(csrv, turn2[:1])  # warm-up of the 1024 bucket
    cold, _, cst = serve_stream(csrv, turn2)
    kties = 0
    for (p, n), w_, c_ in zip(turn2, warm, cold):
        want, margins = lone_greedy(gen, params, cfg, p, n)
        for got in (w_, c_):
            held, upto, tie, _ = tie_compare(got, want, margins)
            check(held, f"second turn differs from the lone run at {upto} with no near-tie")
        kties += tie is not None
    out["kv_cache"] = {"stats": kst, "near_ties": kties, "turn2_prompt_lens": [len(p) for p, _ in turn2],
                       "ttft_ms_p50_warm": wst["ttft_ms_p50"], "ttft_ms_p50_cold": cst["ttft_ms_p50"],
                       "ttft_ms_p99_warm": wst["ttft_ms_p99"], "ttft_ms_p99_cold": cst["ttft_ms_p99"],
                       "wall_s_warm": wst["wall_s"], "wall_s_cold": cst["wall_s"]}
    del wsrv, csrv, kv

    # ---- check 8: int8 weights and an int8 KV cache
    qcfg = dataclasses.replace(cfg, kv_quant=True)
    qsrv = LMServer(quantize_lm_params(p32), qcfg, max_slots=LMS_SLOTS, max_len=LMS_MAX_LEN,
                    chunk=LMS_CHUNK)
    serve_stream(qsrv, sreqs[:1])
    reset_launch_counts()
    qtoks, d, qst = serve_stream(qsrv, sreqs)
    check_server_launches("int8", launch_counts(), d, nl, LMS_CHUNK)
    check(all(0 <= int(t) < cfg.vocab_size for o in qtoks for t in o), "int8 token out of range")
    out["int8"] = {"tokens_per_s": qst["tokens_per_s"], "wall_s": qst["wall_s"],
                   "agreement_with_bf16": prefix_agreement(qtoks, cont)}
    del qsrv

    # ---- check 9: LMDriver, 4 threads x a ticket of 8, against a serial run
    import threading

    dsrv = LMServer(params, cfg, max_slots=LMS_SLOTS, max_len=LMS_MAX_LEN, chunk=LMS_CHUNK)
    tickets = [[(p, min(b, 64)) for p, b in reqs[i:i + 8]] for i in range(0, 32, 8)]
    serial = []
    for t in tickets:
        o, _, _ = serve_stream(dsrv, t)
        serial.append(o)
    drv = LMDriver(dsrv)
    results, errors = [None] * 4, []

    def worker(i):
        try:
            results[i] = drv.serve([p for p, _ in tickets[i]], [b for _, b in tickets[i]])
        except BaseException as e:  # surfaced below
            errors.append(e)

    reset_launch_counts()
    d0 = server_dispatches()
    threads = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
    t0 = time.monotonic()
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        drv.stop()
    driver_s = time.monotonic() - t0
    check(not errors and all(r is not None for r in results), f"LMDriver: {errors}")
    d = {k: v - d0[k] for k, v in server_dispatches().items()}
    check_server_launches("driver", launch_counts(), d, nl, LMS_CHUNK)
    check(all(np.array_equal(a, b) for r, s in zip(results, serial) for a, b in zip(r, s)),
          "LMDriver tokens != the serial run's")
    out["driver"] = {"threads": 4, "wall_s": driver_s, "steps": drv.steps,
                     "tokens_per_s": sum(b for t in tickets for _, b in t) / driver_s}
    del dsrv, drv

    # ---- check 10: LMBackend over prompt files, and from_spec over a weights
    # file written by the port's codec
    with tempfile.TemporaryDirectory() as tmp:
        paths = []
        for i, (p, b) in enumerate(reqs[:LMS_SLOTS]):
            paths.append(os.path.join(tmp, f"p{i}.tokens.txt"))
            write_prompt_file(paths[-1], p, max_new_tokens=min(b, 48))
        be = LMBackend(params, cfg, max_new_tokens=32, max_slots=LMS_SLOTS, max_len=LMS_MAX_LEN,
                       chunk=LMS_CHUNK)
        try:
            res, be_s, _ = be.serve_files(paths)
        finally:
            be.close()
        for (p, b), path, o in zip(reqs, paths, cont):
            check(res[path]["tokens"] == [int(t) for t in o[:min(b, 48)]],
                  "serve_files tokens != the server's")
        wpath = os.path.join(tmp, "lm.msgpack")
        t0 = time.monotonic()
        with open(wpath, "wb") as f:
            f.write(variables_to_bytes({"params": p32}))
        write_s = time.monotonic() - t0
        spec = dict(LM_CFG, name="LM198M", dtype="bfloat16", max_new_tokens=32,
                    max_slots=LMS_SLOTS, max_len=LMS_MAX_LEN, chunk=LMS_CHUNK, weights=wpath)
        t0 = time.monotonic()
        be2 = LMBackend.from_spec(spec)  # device None -> cuda
        load_s = time.monotonic() - t0
        try:
            res2, _, _ = be2.serve_files(paths)
        finally:
            be2.close()
        check(res2 == res, "from_spec over the port's weights file gives other tokens")
        out["backend"] = {"files": len(paths), "serve_files_s": be_s,
                          "weights_file_mb": os.path.getsize(wpath) / 1e6,
                          "write_s": write_s, "from_spec_load_s": load_s}
    del p32, params
    out["profile_step"] = prof_step
    out["phase_s"] = time.monotonic() - t_phase
    emit(phase="lm_server", **out)
    emit(phase="profile", path=f"lm_server_step_b{LMS_SLOTS}_chunk{LMS_CHUNK}", **prof_step)
    return lm_server


# ---------------------------------------------------------------------------
# phase 13: mixture of experts
# ---------------------------------------------------------------------------

# lm_moe8: the LM above with the repo's own MoE option on: TransformerLM's
# num_experts=8 and its moe_every=2, capacity_factor=1.25 defaults
# (dml_tpu/models/transformer.py:117-121), 6 MoE blocks of 8 experts at
# d_ff 4096, 550.05M parameters
MOE = dict(num_experts=8, moe_every=2)
# phase 13 runs lm_moe8 cut to 6 of its 12 blocks (3 MoE blocks), every
# width kept: half the depth pays for phase 17
MOE_LM_CFG = dict(LM_CFG, n_layers=6)
MOE_LAYER_TOKENS = (300, 1100)  # one serving chunk, and three (chunked)
MOE_TRAIN_STEPS = 10


def tree_cpu(tree):
    """A params tree's tensors copied to the CPU."""
    return {k: tree_cpu(v) if isinstance(v, dict) else v.cpu() for k, v in tree.items()}


def tree_cuda(tree):
    """A params tree's tensors copied to the card."""
    return {k: tree_cuda(v) if isinstance(v, dict) else v.cuda() for k, v in tree.items()}


def phase_moe(timer):
    """The MoE LM served by generate and LMServer and trained by
    LongContextLM on cuda (phase 13); returns each kernel's launches over
    the counted runs."""
    import dataclasses

    import torch
    from dml_tpu_torch.inference import generate as gen
    from dml_tpu_torch.inference.lm_server import LMServer
    from dml_tpu_torch.inference.quantize import quantize_lm_params, quantized_bytes
    from dml_tpu_torch.models.lm_params import init_lm_params
    from dml_tpu_torch.parallel import moe as moe_mod
    from dml_tpu_torch.parallel.long_context import LongContextLM, lm_loss

    t_phase = time.monotonic()
    nl = MOE_LM_CFG["n_layers"]
    cfg = gen.LMConfig(**MOE_LM_CFG, dtype=torch.bfloat16)
    t0 = time.monotonic()
    p32 = init_lm_params(cfg, seed=0, **MOE)  # device None -> cuda
    params = gen.serving_params(p32, cfg)
    torch.cuda.synchronize()
    out = {"config": dict(MOE_LM_CFG, **MOE, capacity_factor=1.25, dtype="bfloat16"),
           "params_millions": quantized_bytes(p32)[1] / 4e6, "load_s": time.monotonic() - t0,
           "moe_blocks": [i for i in range(nl) if "moe" in p32[f"block_{i}"]]}
    check(out["moe_blocks"] == list(range(1, nl, 2)), f"MoE blocks {out['moe_blocks']}")
    total = {k: 0 for k in launch_counts()}

    def count(launches):
        for k, v in launches.items():
            total[k] += v

    # ---- (a) generate: B=8, 2048-token prompts, 64 new tokens; int8
    rng = np.random.RandomState(3)
    prompts = torch.from_numpy(
        rng.randint(0, cfg.vocab_size, (LM_BATCH, PROMPT_LEN)).astype(np.int32)).cuda()
    gen.generate(params, cfg, prompts[:, :64], 2)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.monotonic()
    toks = gen.generate(params, cfg, prompts, NEW_TOKENS)
    torch.cuda.synchronize()
    gen_s = time.monotonic() - t0
    launches = launch_counts()
    peak_mb = torch.cuda.max_memory_allocated() / 1e6
    want = {"normalize": 0, "flash_attention": nl, "flash_bwd": 0, "flash_bwd_delta": 0,
            "decode_attention": nl * (NEW_TOKENS - 1)}
    check(launches == want, f"MoE generate launched {launches}, want {want}")
    count(launches)
    check(tuple(toks.shape) == (LM_BATCH, NEW_TOKENS) and 0 <= int(toks.min())
          and int(toks.max()) < cfg.vocab_size, "MoE tokens out of range")
    manual, _ = greedy_with_margins(gen, params, cfg, prompts, NEW_TOKENS)
    check(torch.equal(manual, toks), "MoE prefill + batched_decode_step tokens != generate's")
    qparams = quantize_lm_params(p32)
    qcfg = dataclasses.replace(cfg, kv_quant=True)
    reset_launch_counts()
    qtoks = gen.generate(qparams, qcfg, prompts, 16)
    torch.cuda.synchronize()
    q_launches = launch_counts()
    q_want = dict(want, decode_attention=nl * 15)
    check(q_launches == q_want, f"MoE int8 generate launched {q_launches}, want {q_want}")
    count(q_launches)
    check(0 <= int(qtoks.min()) and int(qtoks.max()) < cfg.vocab_size, "int8 token out of range")
    out["generate"] = {
        "batch": LM_BATCH, "prompt_len": PROMPT_LEN, "new_tokens": NEW_TOKENS, "generate_s": gen_s,
        "launches": launches, "int8_launches": q_launches,
        "max_memory_allocated_mb": peak_mb,
        "int8_vs_bf16_token_agreement": float((qtoks == toks[:, :16]).float().mean()),
        "weight_bytes": {"bf16_serving": quantized_bytes(params)[0],
                         "int8": quantized_bytes(qparams)[0], "f32": quantized_bytes(p32)[0]}}
    del qparams
    pb = prompts
    out["generate"]["prefill_ms_b8"] = wall_ms(lambda: gen.prefill(params, cfg, pb, PROMPT_LEN + 1))
    logits, cache = gen.prefill(params, cfg, prompts, PROMPT_LEN + 48)
    cur = logits.argmax(-1).to(torch.int32)
    for i in range(3):  # warm-up
        logits, cache = gen.decode_step(params, cfg, cache, cur, PROMPT_LEN + i)
    steps = 40
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for i in range(steps):
        logits, cache = gen.decode_step(params, cfg, cache, cur, PROMPT_LEN + 3 + i)
        cur = logits.argmax(-1).to(torch.int32)
    torch.cuda.synchronize()
    step_ms = (time.monotonic() - t0) * 1e3 / steps
    out["generate"].update({f"decode_ms_per_step_b8_ctx{PROMPT_LEN}": step_ms,
                            f"decode_tokens_per_s_b8_ctx{PROMPT_LEN}": LM_BATCH * 1e3 / step_ms})
    pos = torch.full((LM_BATCH,), PROMPT_LEN + 44, dtype=torch.int32, device=prompts.device)
    # the serving FFN inside a named range, for the profiles only: its
    # matmul kernels are the expert products (with the router's [n, d] x
    # [d, 8] and the gate-weighted combine)
    moe_ffn = gen._moe_ffn

    def ranged_moe_ffn(*a):
        with torch.profiler.record_function("moe_ffn"):
            return moe_ffn(*a)

    gen._moe_ffn = ranged_moe_ffn
    try:
        prof_decode = profile_calls(lambda: gen.batched_decode_step(params, cfg, cache, cur, pos),
                                    5, LM_KINDS, ranges=("moe_ffn",))
        del cache, logits
        prof_prefill = profile_calls(lambda: gen.prefill(params, cfg, prompts, PROMPT_LEN + 1), 2,
                                     LM_KINDS, ranges=("moe_ffn",))
    finally:
        gen._moe_ffn = moe_ffn

    # ---- (b) the layer on the card against the CPU, float32, TF32 off
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        blk = p32["block_1"]["moe"]
        cpu_blk = {"router": {"kernel": blk["router"]["kernel"].cpu()},
                   "w_up": blk["w_up"].cpu(), "w_down": blk["w_down"].cpu()}
        layer = moe_mod.MoEMLP(cfg.d_model, MOE["num_experts"], cfg.d_ff, dtype=torch.float32)
        layer.load_state_dict({"router.kernel": cpu_blk["router"]["kernel"],
                               "w_up": cpu_blk["w_up"], "w_down": cpu_blk["w_down"]})
        layer_cuda = moe_mod.MoEMLP(cfg.d_model, MOE["num_experts"], cfg.d_ff,
                                    dtype=torch.float32).cuda()
        layer_cuda.load_state_dict(layer.state_dict())
        g = torch.Generator().manual_seed(13)
        layer_errs = {}
        with torch.no_grad():
            for n in MOE_LAYER_TOKENS:
                x = torch.randn((1, n, cfg.d_model), generator=g)
                y_c, aux_c = layer(x)
                y_g, aux_g = layer_cuda(x.cuda())
                f_c = gen._moe_ffn(cpu_blk, x, torch.float32)
                f_g = gen._moe_ffn(blk, x.cuda(), torch.float32)
                errs = {"moe_mlp": float((y_g.cpu() - y_c).abs().max()),
                        "moe_mlp_aux": abs(float(aux_g) - float(aux_c)),
                        "moe_ffn": float((f_g.cpu() - f_c).abs().max()),
                        "max_abs_ref": float(f_c.abs().max())}
                layer_errs[f"tokens_{n}"] = errs
                check(max(v for k, v in errs.items() if k != "max_abs_ref") <= 1e-4,
                      f"MoE layer on the card != the CPU at {n} tokens: {errs}")
        del layer, layer_cuda, cpu_blk
        cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
        small = prompts[:2, :32]
        g32 = gen.generate(p32, cfg32, small, 8).cpu()
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    cpu_params = tree_cpu(p32)
    c32, margins = greedy_with_margins(gen, cpu_params, cfg32, small.cpu(), 8)
    check(torch.equal(g32, c32), f"MoE f32 cuda tokens {g32.tolist()} != cpu {c32.tolist()}")
    del cpu_params
    out["layer_f32_vs_cpu"] = dict(layer_errs, bar=1e-4, tf32=False)
    out["f32_greedy"] = {"cuda": g32.tolist(), "cpu": c32.tolist(), "cpu_top1_margins": margins}

    # ---- (c) LMServer: bench.py's mixed-budget stream
    reqs = mixed_requests(cfg.vocab_size)
    srv = LMServer(params, cfg, max_slots=LMS_SLOTS, max_len=LMS_MAX_LEN, chunk=LMS_CHUNK)
    serve_stream(srv, reqs[:LMS_SLOTS])  # warm-up
    torch.cuda.synchronize()
    reset_launch_counts()
    cont, d, st = serve_stream(srv, reqs, count_syncs=True)
    s_launches = launch_counts()
    check_server_launches("moe continuous", s_launches, d, nl, LMS_CHUNK)
    count(s_launches)
    syncs = st.pop("syncs")
    check(syncs["submit"] == [0] and syncs["steps"] and all(n == 1 for n in syncs["steps"]),
          f"MoE server synchronizing calls: submit {syncs['submit']}, per step {syncs['steps']} "
          f"(want 0 and exactly 1), from {syncs['where']}")
    st["syncs"] = {"submit": 0, "per_step": 1, "steps": len(syncs["steps"])}
    del srv
    ties = mism = 0
    compared = []
    for (p, n), got in zip(reqs, cont):
        want_t, margins_t = lone_greedy(gen, params, cfg, p, n)
        held, upto, tie, _ = tie_compare(got, want_t, margins_t)
        check(held, f"MoE bf16 server tokens differ from the lone run at {upto} with no "
                    f"near-tie before it")
        ties += tie is not None
        mism += upto < n
        compared.append(upto)
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        s32 = LMServer(p32, cfg32, max_slots=LMS_SLOTS, max_len=LMS_MAX_LEN, chunk=LMS_CHUNK)
        f32_out, _, _ = serve_stream(s32, reqs[:4])
        for (p, n), got in zip(reqs[:4], f32_out):
            want_t = gen.generate(p32, cfg32, torch.from_numpy(p[None]).cuda(), n)[0].cpu().numpy()
            check(np.array_equal(got, want_t), "MoE f32 server tokens != the lone f32 generate's")
        del s32
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    out["lm_server"] = dict(st, slots=LMS_SLOTS, max_len=LMS_MAX_LEN, chunk=LMS_CHUNK,
                            requests=len(reqs), launches=s_launches,
                            bf16_vs_lone={"near_ties": ties, "stopped_at_a_tie": mism,
                                          "tokens_compared": compared},
                            f32_exact_vs_lone={"requests": 4,
                                               "tokens": int(sum(n for _, n in reqs[:4]))})
    del p32, params
    torch.cuda.empty_cache()

    # ---- (d) training: B=1, T=2048, AdamW lr 3e-4 (T1's settings)
    lm = LongContextLM(seq_len=TRAIN_T, dtype=torch.bfloat16, seed=0, **MOE, **MOE_LM_CFG)
    trng = np.random.RandomState(5)
    ttoks = torch.from_numpy(
        trng.randint(0, MOE_LM_CFG["vocab_size"], (1, TRAIN_T)).astype(np.int32)).cuda()
    warm = lm.train_step(ttoks)
    with torch.no_grad():  # the objective's terms at the next step's params
        logits, aux = lm.model(ttoks, return_aux=True)
        bare = float(lm_loss(logits, ttoks))
        aux_mean = float(sum(aux) / len(aux))
    del logits
    check(len(aux) == nl // 2, f"{len(aux)} aux terms, want {nl // 2}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    losses, t_ms = [], []
    per_step = {"normalize": 0, "flash_attention": nl, "flash_bwd": nl, "flash_bwd_delta": nl,
                "decode_attention": 0}
    for _ in range(MOE_TRAIN_STEPS):
        before = launch_counts()
        t0 = time.monotonic()
        losses.append(lm.train_step(ttoks))
        t_ms.append((time.monotonic() - t0) * 1e3)
        after = launch_counts()
        moved = {k: after[k] - before[k] for k in after}
        check(moved == per_step, f"an MoE train step launched {moved}, want {per_step}")
    t_launches = launch_counts()
    count(t_launches)
    t_peak = torch.cuda.max_memory_allocated() / 1e6
    check(all(np.isfinite(losses)), f"non-finite MoE loss: {losses}")
    check(losses[-1] < losses[0], f"MoE loss did not fall: {losses[0]} -> {losses[-1]}")
    aux_rel = abs((losses[0] - bare) - 1e-2 * aux_mean) / abs(losses[0])
    check(aux_rel <= 1e-5, f"train loss {losses[0]} - bare {bare} != 1e-2 x mean aux {aux_mean}")
    reset_launch_counts()
    served = lm.generate(ttoks[:, :128].cpu().numpy(), TRAIN_NEW_TOKENS)
    torch.cuda.synchronize()
    g_launches = launch_counts()
    g_want = dict(want, decode_attention=nl * (TRAIN_NEW_TOKENS - 1))
    check(g_launches == g_want, f"MoE generate after training launched {g_launches}, want {g_want}")
    count(g_launches)
    check(served.shape == (1, TRAIN_NEW_TOKENS) and 0 <= served.min()
          and served.max() < MOE_LM_CFG["vocab_size"], f"served tokens {served}")
    prof_train = profile_calls(lambda: lm.train_step(ttoks), 3, TRAIN_KINDS)
    del lm
    torch.cuda.empty_cache()
    med = statistics.median(t_ms)
    out["train"] = {"config": dict(MOE_LM_CFG, **MOE, dtype="bfloat16", seq_len=TRAIN_T, batch=1,
                                   optimizer="AdamW lr 3e-4 wd 1e-4", moe_aux_weight=1e-2),
                    "routing": {"group": 1024, "capacity": 160},
                    "warmup_loss": warm, "losses": losses, "launches": t_launches,
                    "launches_per_step": per_step, "step_ms": t_ms, "step_ms_median": med,
                    "step_ms_p90": float(np.percentile(t_ms, 90)),
                    "tokens_per_s": TRAIN_T / (med / 1e3), "max_memory_allocated_mb": t_peak,
                    "bare_lm_loss": bare, "aux_mean": aux_mean,
                    "aux_term_rel_err": aux_rel, "generate_launches": g_launches,
                    "generated": served.tolist()}
    out["launches"] = total
    out["phase_s"] = time.monotonic() - t_phase
    emit(phase="moe", **out)
    emit(phase="profile", path=f"moe_prefill_b{LM_BATCH}_t{PROMPT_LEN}", **prof_prefill)
    emit(phase="profile", path=f"moe_decode_step_b{LM_BATCH}_ctx{PROMPT_LEN + 45}", **prof_decode)
    emit(phase="profile", path=f"moe_train_step_b1_t{TRAIN_T}", **prof_train)
    return total


# ---------------------------------------------------------------------------
# phase 14: data and tensor parallelism over torch.distributed
# ---------------------------------------------------------------------------

PAR_STEPS, PAR_GLOO_STEPS, PAR_NARROW_STEPS, PAR_SERVE_CALLS = 20, 5, 3, 3
PAR_MESHES = ((2, 1), (1, 2))  # (dp, tp) of the two gloo ranks
PAR_KINDS = (("nccl", "collective"),) + IMAGE_TRAIN_KINDS


def register_narrow_resnet():
    from dml_tpu_torch.models.registry import CostDefaults, ModelSpec, register
    from dml_tpu_torch.models.resnet import ResNet

    register(ModelSpec(
        name="ResNetNarrow", input_size=(64, 64), preprocess="caffe",
        builder=lambda num_classes, dtype, param_dtype=None: ResNet(
            (1, 1, 1, 1), num_classes, dtype, param_dtype),
        cost=CostDefaults(load_time=0.1, first_query=0.1, per_query=0.01)))


def collectives_profile(fn, iters=2):
    """The collectives' share of a call: host time inside the mesh's
    `mesh.*` ranges (under gloo: the copies to and from the host and the
    collective itself) over the wall time, and the device time of NCCL's
    kernels over the device's busy time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.monotonic()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.monotonic() - t0) * 1e6
    host, busy, nccl = {}, 0.0, 0.0
    for e in prof.key_averages():
        # a range also appears as an annotation on the device's timeline,
        # under the same key: its host time is the CPU entry's
        if e.key.startswith("mesh.") and e.device_type == torch.autograd.DeviceType.CPU:
            host[e.key] = host.get(e.key, 0.0) + e.cpu_time_total
        if (e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
                and not getattr(e, "is_user_annotation", False)):
            busy += e.self_device_time_total
            nccl += e.self_device_time_total if "nccl" in e.key.lower() else 0.0
    return {"wall_ms_per_call": wall_us / iters / 1e3,
            "collective_host_ms_per_call": sum(host.values()) / iters / 1e3,
            "collective_host_share_of_wall": sum(host.values()) / wall_us,
            "collective_host_ms_by_range": {k: v / iters / 1e3 for k, v in sorted(host.items())},
            "device_busy_ms_per_call": busy / iters / 1e3,
            "nccl_device_ms_per_call": nccl / iters / 1e3,
            "nccl_share_of_busy": nccl / busy if busy else None}


def _serve_timed(sh, x_np):
    """The first call (warm-up: cuDNN's choices), then PAR_SERVE_CALLS
    timed calls, each checked to launch K1 once; (output, wall ms per
    call, K1 launches of the timed calls)."""
    import torch
    from dml_tpu_torch.ops import preprocess

    out = sh(x_np)
    ms, launches = [], 0
    for _ in range(PAR_SERVE_CALLS):
        before = preprocess.normalize_launches
        t0 = time.monotonic()
        again = sh(x_np)  # numpy: waits for the call
        ms.append((time.monotonic() - t0) * 1e3)
        moved = preprocess.normalize_launches - before
        check(moved == 1, f"a ShardedInference call launched K1 {moved} times")
        check(np.array_equal(again, out), "a repeated ShardedInference call changed its output")
        launches += moved
    torch.cuda.synchronize()
    return out, statistics.median(ms), launches


def _parallel_rank(rank, world, tmp):
    """One of the gloo ranks, both on cuda:0. Writes its results to
    tmp/rank<r>.pt; a failure exits non-zero."""
    import torch
    import torch.distributed as dist
    from dml_tpu_torch.config import MeshSpec
    from dml_tpu_torch.models.registry import get_model
    from dml_tpu_torch.ops import preprocess
    from dml_tpu_torch.parallel.inference import ShardedInference
    from dml_tpu_torch.parallel.mesh import make_mesh
    from dml_tpu_torch.parallel.train import Trainer

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rendezvous_gloo",
                            world_size=world, rank=rank)
    register_narrow_resnet()
    weights = torch.load(os.path.join(tmp, "weights.pt"), weights_only=True)
    x_np, y_np = _seeded_batch(np.random.RandomState(14), BATCH,
                               *get_model("ResNet50").input_size, 1000)
    xs, ys = _seeded_batch(np.random.RandomState(12), 8, 64, 64, 10)
    res = {"serve": {}, "launches": 0}
    try:  # whether gloo's own CUDA path takes an all_gather here (the forms always stage)
        t = torch.full((4,), float(rank + 1)).cuda()
        parts = [torch.empty_like(t) for _ in range(world)]
        dist.all_gather(parts, t)
        res["gloo_cuda_all_gather"] = [float(p[0]) for p in parts] == [1.0, 2.0]
    except RuntimeError as e:
        res["gloo_cuda_all_gather"] = str(e).splitlines()[0][:200]
    for dp, tp in PAR_MESHES:
        mesh = make_mesh(MeshSpec(dp=dp, tp=tp))
        for dtype in (torch.float32, torch.bfloat16):
            for pg in (True, False):
                torch.cuda.reset_peak_memory_stats()
                sh = ShardedInference("ResNet50", mesh, BATCH, variables=weights, dtype=dtype,
                                      param_gather=pg)
                out, ms, launches = _serve_timed(sh, x_np)
                prof = collectives_profile(lambda: sh(x_np), 1)
                res["launches"] += launches
                res["serve"][f"dp{dp}_tp{tp}/{dtype_name(dtype)}/{'gather' if pg else 'megatron'}"] = {
                    "out": out, "wall_ms_per_call": ms, "k1_launches": launches,
                    "max_memory_allocated_mb": torch.cuda.max_memory_allocated() / 1e6,
                    "collectives": prof}
                del sh
        torch.cuda.empty_cache()
    # ResNet50 b32 bf16 training at dp 2: one K1 launch per rank per step
    mesh = make_mesh(MeshSpec(dp=2, tp=1))
    torch.cuda.reset_peak_memory_stats()
    tr = Trainer("ResNet50", mesh, batch_size=BATCH, dtype=torch.bfloat16, variables=weights)
    x, y = torch.from_numpy(x_np).cuda(), torch.from_numpy(y_np).cuda()
    warm = tr.step(x, y)["loss"]
    before = preprocess.normalize_launches
    losses, accs, step_ms = _counted_steps(tr, x, y, PAR_GLOO_STEPS)
    res["launches"] += preprocess.normalize_launches - before
    res["train"] = {"warmup_loss": warm, "losses": losses, "step_ms": step_ms,
                    "k1_launches": preprocess.normalize_launches - before,
                    "max_memory_allocated_mb": torch.cuda.max_memory_allocated() / 1e6,
                    "collectives": collectives_profile(lambda: tr.step(x, y), 1)}
    state = tr.state
    tr.save_checkpoint(os.path.join(tmp, "ck_dp2"))
    if rank == 0:
        torch.save(state, os.path.join(tmp, "ck_dp2_state.pt"))
    del tr, state
    torch.cuda.empty_cache()
    # the narrow float32 ResNet at dp 2 and at tp 2, TF32 off
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    res["narrow"] = {}
    for dp, tp in PAR_MESHES:
        mesh = make_mesh(MeshSpec(dp=dp, tp=tp))
        tn = Trainer("ResNetNarrow", mesh, batch_size=8, dtype=torch.float32, num_classes=10,
                     seed=1, learning_rate=1e-4)
        res["narrow"][f"dp{dp}_tp{tp}"] = [tn.step(xs, ys)["loss"]
                                           for _ in range(PAR_NARROW_STEPS)]
    torch.save(res, os.path.join(tmp, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


def phase_parallel():
    """Data and tensor parallelism: NCCL at world size 1 on cuda:0 in
    this process, then two gloo ranks sharing the card. Returns K1's
    launches on the path (this process's and both ranks')."""
    import multiprocessing

    import torch
    import torch.distributed as dist
    from dml_tpu_torch.models.registry import get_model
    from dml_tpu_torch.ops import preprocess
    from dml_tpu_torch.parallel.inference import ShardedInference
    from dml_tpu_torch.parallel.mesh import local_mesh
    from dml_tpu_torch.parallel.train import Trainer

    t_phase = time.monotonic()
    register_narrow_resnet()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_parallel_")
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{tmp}/rendezvous_nccl",
                            world_size=1, rank=0)
    out = {"world1": {}, "note": "world 1: NCCL, real collectives on groups of one; two ranks: "
           "both on the one card (cuda:0), gloo, every collective staged through the host"}
    try:
        mesh = local_mesh(dp=1)
        weights = seeded_weights(get_model("ResNet50"), 0)
        torch.save(weights, os.path.join(tmp, "weights.pt"))
        x_np, y_np = _seeded_batch(np.random.RandomState(14), BATCH,
                                   *get_model("ResNet50").input_size, 1000)

        # ---- the main path (world 1), counted ----
        reset_launch_counts()
        ref, served = {}, {}
        for dtype in (torch.float32, torch.bfloat16):
            for pg in (True, False):
                torch.cuda.reset_peak_memory_stats()
                sh = ShardedInference("ResNet50", mesh, BATCH, variables=weights, dtype=dtype,
                                      param_gather=pg)
                probs, ms, launches = _serve_timed(sh, x_np)
                check(probs.shape == (BATCH, 1000) and np.isfinite(probs).all()
                      and np.allclose(probs.sum(1), 1.0, atol=1e-2), f"world-1 probs {probs.shape}")
                key = f"{dtype_name(dtype)}/{'gather' if pg else 'megatron'}"
                ref[key], served[key] = probs, sh
                out["world1"][f"serve/{key}"] = {
                    "wall_ms_per_call": ms, "k1_launches": launches,
                    "max_memory_allocated_mb": torch.cuda.max_memory_allocated() / 1e6}
            # tp = 1: the two forms run one program
            name = dtype_name(dtype)
            check(np.array_equal(ref[f"{name}/gather"], ref[f"{name}/megatron"]),
                  f"world-1 forms differ in {name}")
        x, y = torch.from_numpy(x_np).cuda(), torch.from_numpy(y_np).cuda()
        torch.cuda.reset_peak_memory_stats()
        tr = Trainer("ResNet50", mesh, batch_size=BATCH, dtype=torch.bfloat16, variables=weights)
        warm = tr.step(x, y)["loss"]
        losses, _, _ = _counted_steps(tr, x, y, PAR_STEPS)
        check(all(np.isfinite(losses)) and losses[-1] < losses[0], f"world-1 mesh losses {losses}")
        before = preprocess.normalize_launches
        ev = tr.evaluate(x, y)
        check(preprocess.normalize_launches - before == 1, "evaluate launched K1 more than once")
        train_peak_mb = torch.cuda.max_memory_allocated() / 1e6
        # the narrow float32 ResNet at world 1, TF32 off: the gloo ranks' reference
        tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
        try:
            xs, ys = _seeded_batch(np.random.RandomState(12), 8, 64, 64, 10)
            tn = Trainer("ResNetNarrow", mesh, batch_size=8, dtype=torch.float32, num_classes=10,
                         seed=1, learning_rate=1e-4)
            narrow_ref = [tn.step(xs, ys)["loss"] for _ in range(PAR_NARROW_STEPS)]
        finally:
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
        world1 = launch_counts()
        want = 4 * (1 + PAR_SERVE_CALLS) + 1 + PAR_STEPS + 1 + PAR_NARROW_STEPS
        check(world1 == {**{k: 0 for k in world1}, "normalize": want},
              f"the world-1 path launched {world1}, want K1 {want} times and nothing else")
        par_launches = world1["normalize"]

        # not counted: world 1 serving BATCH / 2 rows a call, the program each
        # of two dp ranks runs (cuDNN picks its algorithms by batch size)
        half = ShardedInference("ResNet50", mesh, BATCH // 2, variables=weights,
                                dtype=torch.float32, param_gather=True)
        ref["float32/gather/half"] = half(x_np)
        del half
        # not counted: where the time goes, and the distributed form's cost
        # at world 1, in turns with the one-device Trainer on the same card
        for key, sh in served.items():
            out["world1"][f"serve/{key}"]["collectives"] = collectives_profile(
                lambda: sh(x_np), 1)
        del served, sh
        one = Trainer("ResNet50", batch_size=BATCH, dtype=torch.bfloat16, variables=weights)
        one.step(x, y)
        runs = {"mesh": [], "one_device": []}
        for turn in ("mesh", "one_device", "one_device", "mesh"):
            runs[turn].extend(_counted_steps(tr if turn == "mesh" else one, x, y,
                                             PAR_STEPS // 2)[2])
        i1 = {turn: {"step_ms_median": statistics.median(ms),
                     "step_ms_p90": float(np.percentile(ms, 90)),
                     "images_per_s": BATCH / (statistics.median(ms) / 1e3)}
              for turn, ms in runs.items()}
        out["world1"]["train"] = dict(
            i1, warmup_loss=warm, losses=losses, evaluate=ev, k1_launches_per_step=1,
            mesh_over_one_device_step_ms=i1["mesh"]["step_ms_median"]
            / i1["one_device"]["step_ms_median"],
            max_memory_allocated_mb=train_peak_mb,
            collectives=collectives_profile(lambda: tr.step(x, y), 2),
            profile_mesh=profile_calls(lambda: tr.step(x, y), 2, PAR_KINDS),
            profile_one_device=profile_calls(lambda: one.step(x, y), 2, PAR_KINDS))
        out["world1"]["narrow_f32_losses"] = narrow_ref
        del tr, one, tn
        torch.cuda.empty_cache()

        # ---- two gloo ranks on the one card ----
        t0 = time.monotonic()
        ctx = multiprocessing.get_context("spawn")
        procs = [ctx.Process(target=_parallel_rank, args=(r, 2, tmp)) for r in range(2)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout=600)
        codes = [p.exitcode for p in procs]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        check(codes == [0, 0], f"gloo ranks exited {codes}")
        gloo_s = time.monotonic() - t0
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                 for r in range(2)]
        gloo = {"wall_s": gloo_s, "gloo_cuda_all_gather": [r["gloo_cuda_all_gather"] for r in ranks],
                "serve": {}, "k1_launches_per_rank": [r["launches"] for r in ranks]}
        for key in ranks[0]["serve"]:
            cfg, name, form = key.split("/")
            want = ref[f"{name}/gather"]
            # the program a rank runs: world 1 at the rank's rows a call
            same_rows = ref["float32/gather/half"] if cfg.startswith("dp2") else want
            got = [r["serve"][key]["out"] for r in ranks]
            check(np.array_equal(got[0], got[1]), f"{key}: the two ranks return different outputs")
            err = float(np.abs(got[0] - want).max())
            row = {"max_abs_err": err, "bitwise_equal_world1": bool(np.array_equal(got[0], want)),
                   "top1_equal_world1": bool((got[0].argmax(1) == want.argmax(1)).all()),
                   "max_abs_err_world1_same_rows": float(np.abs(got[0] - same_rows).max()),
                   "bitwise_equal_world1_same_rows": bool(np.array_equal(got[0], same_rows)),
                   **{k: [r["serve"][key][k] for r in ranks]
                      for k in ("wall_ms_per_call", "k1_launches", "max_memory_allocated_mb")},
                   "collectives": [r["serve"][key]["collectives"] for r in ranks]}
            gloo["serve"][key] = row
            if name == "float32" and form == "gather":
                check(row["bitwise_equal_world1_same_rows"],
                      f"{key}: not bitwise equal to world 1 at the rank's rows a call: {row}")
            if name == "float32":
                check(np.allclose(got[0], want, rtol=2e-4, atol=2e-5),
                      f"{key}: {err} from world 1")
            else:
                check(row["top1_equal_world1"], f"{key}: top-1 differs from world 1")
        tl = [r["train"] for r in ranks]
        for r, t in enumerate(tl):
            check(all(np.isfinite(t["losses"])) and t["losses"][-1] < t["losses"][0],
                  f"rank {r} dp-2 losses {t['losses']}")
            check(t["k1_launches"] == PAR_GLOO_STEPS, f"rank {r} K1 launches {t['k1_launches']}")
        check(tl[0]["losses"] == tl[1]["losses"], "the two ranks report different losses")
        gloo["train_dp2"] = {k: [t[k] for t in tl] for k in tl[0]}
        narrow = {}
        for cfg in ranks[0]["narrow"]:
            got = ranks[0]["narrow"][cfg]
            rel = max(_rel(a, b) for a, b in zip(got, narrow_ref))
            narrow[cfg] = {"losses": got, "max_rel_diff_world1": rel}
            check(rel <= 1e-4, f"narrow f32 {cfg} losses {got} != world 1 {narrow_ref}")
        gloo["narrow_f32"] = dict(narrow, world1_losses=narrow_ref)

        # the dp-2 checkpoint restores bitwise at world 1
        tr = Trainer("ResNet50", mesh, batch_size=BATCH, dtype=torch.bfloat16, seed=5)
        step = tr.restore_checkpoint(os.path.join(tmp, "ck_dp2"))
        saved = torch.load(os.path.join(tmp, "ck_dp2_state.pt"), weights_only=True)
        got = tr.state
        same = all(torch.equal(got[k][n].cpu(), saved[k][n].cpu())
                   for k in ("params", "batch_stats") for n in saved[k])
        same = same and all(torch.equal(got["opt_state"][m][n].cpu(), saved["opt_state"][m][n].cpu())
                            for m in ("exp_avg", "exp_avg_sq") for n in saved["opt_state"][m])
        check(step == saved["step"] and same
              and got["opt_state"]["count"] == saved["opt_state"]["count"],
              f"dp-2 checkpoint restored at world 1: step {step}, bitwise {same}")
        gloo["checkpoint_dp2_to_world1"] = {"step": step, "bitwise": same}
        del tr
        out["gloo_2_ranks"] = gloo
        total = par_launches + sum(gloo["k1_launches_per_rank"])
        out["k1_launches"] = {"world1": par_launches, "gloo_ranks": gloo["k1_launches_per_rank"],
                              "total": total}
    finally:
        dist.destroy_process_group()
        torch.cuda.empty_cache()
    out["phase_s"] = time.monotonic() - t_phase
    emit(phase="parallel", **out)
    return total


# ---------------------------------------------------------------------------
# phase 15: sequence and expert parallelism over torch.distributed
# ---------------------------------------------------------------------------

SP_T = 8192  # the long-context attention: q/k/v [1, 8192, 16, 64], 4096 rows a rank
SP_LM_STEPS, SP_MOE_STEPS, SP_NARROW_STEPS, SP_NEW_TOKENS = 5, 3, 3, 16
# the float32 narrow LM: GQA-2 and an MoE block; T 2048 puts MoE's routing
# groups (1024 tokens) inside each sp shard, so sp 2 routes as world 1 does
SP_NARROW = dict(vocab_size=512, d_model=128, n_heads=4, n_kv_heads=2, n_layers=2, d_ff=256,
                 num_experts=4, moe_every=2)
SP_NARROW_T, SP_NARROW_B = 2048, 2
SP_ATTN_BARS = {"float32": 2e-5, "bfloat16": 2e-2}  # K2's bars against its plain version


def torch_from_seed(seed, shape, vocab):
    """int32 tokens drawn by numpy's RandomState(seed), on cuda."""
    import torch

    return torch.from_numpy(
        np.random.RandomState(seed).randint(0, vocab, shape).astype(np.int32)).cuda()


def _counted(fn):
    """(fn(), the launches it made by kernel)."""
    before = launch_counts()
    out = fn()
    after = launch_counts()
    return out, {k: after[k] - before[k] for k in after}


def _kernels(k2=0, k3=0, delta=0, k4=0):
    return {"normalize": 0, "flash_attention": k2, "flash_bwd": k3, "flash_bwd_delta": delta,
            "decode_attention": k4}


def _add(total, moved):
    for k, v in moved.items():
        total[k] = total.get(k, 0) + v


def ring_k2(form, causal, r, sp=2):
    """K2 (and K3) launches of one attention call on sp-rank r: the ring
    runs r + 1 blocks causal, sp full; Ulysses one."""
    if form == "ulysses":
        return 1
    return r + 1 if causal else sp


def _seq_parallel_rank(rank, world, tmp):
    """One of the two gloo ranks, both on cuda:0 (sp rank = rank). Writes
    its results to tmp/sp_rank<r>.pt; a failure exits non-zero."""
    import torch
    import torch.distributed as dist
    from dml_tpu_torch.config import MeshSpec
    from dml_tpu_torch.ops.flash_attention import flash_attention
    from dml_tpu_torch.parallel.long_context import LongContextLM
    from dml_tpu_torch.parallel.mesh import make_mesh, record_collectives
    from dml_tpu_torch.parallel.ring_attention import ring_attention
    from dml_tpu_torch.parallel.ulysses import ulysses_attention
    from dml_tpu_torch.tools import ring_vs_ulysses as rvu

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rendezvous_gloo",
                            world_size=world, rank=rank)
    sp_mesh = make_mesh(MeshSpec(dp=1, sp=2))
    ep_mesh = make_mesh(MeshSpec(dp=1, ep=2))
    dp_mesh = make_mesh(MeshSpec(dp=2))
    s = sp_mesh.coords["sp"]
    res = {"attention": {}, "launches": {}}
    forms = {"ring": ring_attention, "ulysses": ulysses_attention}

    # ---- 1. attention at long context, (dp 1, sp 2) ----
    tl = SP_T // 2
    for dtype in (torch.float32, torch.bfloat16):
        g = torch.Generator(device="cuda").manual_seed(15)
        q, k, v = (torch.randn(1, SP_T, 16, 64, generator=g, device="cuda", dtype=dtype)
                   for _ in range(3))
        for causal in (True, False):
            # the one-device reference: K2 (and K3 in float32) on the whole sequence
            full = [t.clone().requires_grad_(dtype == torch.float32) for t in (q, k, v)]
            ref = flash_attention(*full, causal=causal)
            if dtype == torch.float32:
                torch.sin(ref).sum().backward()
            for form, fn in forms.items():
                mine = [t[:, s * tl:(s + 1) * tl].detach().clone().requires_grad_(
                    dtype == torch.float32) for t in (q, k, v)]

                def run():
                    out = fn(*mine, sp_mesh, causal=causal)
                    if dtype == torch.float32:
                        torch.sin(out).sum().backward()
                    torch.cuda.synchronize()
                    return out

                out, moved = _counted(run)
                _add(res["launches"], moved)
                n = ring_k2(form, causal, s)
                f32 = dtype == torch.float32
                err = out.detach().float() - ref[:, s * tl:(s + 1) * tl].detach().float()
                row = {"moved": moved, "want": _kernels(n, n if f32 else 0, 1 if f32 else 0),
                       "max_abs_err": float(err.abs().max())}
                if f32:
                    row["grad_ok"] = all(torch.allclose(m.grad, f.grad[:, s * tl:(s + 1) * tl],
                                                        atol=5e-5, rtol=5e-4)
                                         for m, f in zip(mine, full))
                    row["grad_max_abs_err"] = max(
                        float((m.grad - f.grad[:, s * tl:(s + 1) * tl]).abs().max())
                        for m, f in zip(mine, full))
                res["attention"][f"{form}/{dtype_name(dtype)}/{'causal' if causal else 'full'}"] = row
            del full, ref
        # not counted: the forward alone, ring and Ulysses in turns (bf16 and
        # float32, causal), wall ms a call on this rank
        mine = [t[:, s * tl:(s + 1) * tl].contiguous() for t in (q, k, v)]
        ms = {f: [] for f in forms}
        for f in ("ring", "ulysses", "ulysses", "ring"):
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.monotonic()
                forms[f](*mine, sp_mesh, causal=True)
                torch.cuda.synchronize()
                ms[f].append((time.monotonic() - t0) * 1e3)
        res["attention"][f"forward_ms/{dtype_name(dtype)}/causal"] = {
            f: statistics.median(v) for f, v in ms.items()}
        if dtype == torch.bfloat16:
            # not counted: the same bf16 causal forwards once more under the
            # collective recorder, and the footprint tool's own body at this
            # point on this mesh (phase 22 holds the two equal)
            calls = {}
            with torch.no_grad():
                for f, fn in forms.items():
                    with record_collectives() as rec:
                        fn(*mine, sp_mesh, causal=True)
                    calls[f] = rvu.collective_footprint(rec)
                point = rvu.point_on_mesh(sp_mesh, SP_T, 16, head_dim=64, batch=1, device="cuda")
            res["footprint"] = {"calls": calls, "point": point}
        del q, k, v, mine
    torch.cuda.empty_cache()

    # ---- 2. the LM at full width, (dp 1, sp 2): ring and Ulysses ----
    nl = LM_CFG["n_layers"]
    toks = torch_from_seed(5, (1, TRAIN_T), LM_CFG["vocab_size"])
    res["lm"] = {}
    for form in ("ring", "ulysses"):
        torch.cuda.reset_peak_memory_stats()
        lm = LongContextLM(sp_mesh, seq_len=TRAIN_T, dtype=torch.bfloat16, seed=0,
                           seq_parallel=form, **LM_CFG)
        n = ring_k2(form, True, s)
        want = _kernels(nl * n, nl * n, nl)
        losses, step_ms, moves = [], [], []
        for _ in range(SP_LM_STEPS):
            t0 = time.monotonic()
            loss, moved = _counted(lambda: lm.train_step(toks))
            step_ms.append((time.monotonic() - t0) * 1e3)
            losses.append(loss)
            moves.append(moved)
            _add(res["launches"], moved)
        prof, moved = _counted(lambda: collectives_profile(lambda: lm.train_step(toks), 1))
        moves.append(moved)
        _add(res["launches"], moved)
        gen, gmoved = _counted(lambda: lm.generate(toks[:, :128].cpu().numpy(), SP_NEW_TOKENS))
        _add(res["launches"], gmoved)
        med = statistics.median(step_ms)
        res["lm"][form] = {
            "losses": losses, "step_ms": step_ms, "step_ms_median": med,
            "step_ms_p90": float(np.percentile(step_ms, 90)), "tokens_per_s": TRAIN_T / (med / 1e3),
            "max_memory_allocated_mb": torch.cuda.max_memory_allocated() / 1e6,
            "collectives": prof, "moves": moves, "want": want, "generated": gen,
            "generate_moved": gmoved,
            "generate_want": _kernels(nl, 0, 0, nl * (SP_NEW_TOKENS - 1))}
        del lm
        torch.cuda.empty_cache()

    # ---- 3. lm_moe8 at (dp 1, ep 2) ----
    torch.cuda.reset_peak_memory_stats()
    lm = LongContextLM(ep_mesh, seq_len=TRAIN_T, dtype=torch.bfloat16, seed=0, **MOE, **LM_CFG)
    experts = sum(p.numel() for n, p in lm.model.named_parameters() if n.endswith(("w_up", "w_down")))
    held = sum(p.numel() for _, p in lm._named)
    logits = lm.forward(toks)[0]
    w1 = torch.load(os.path.join(tmp, "moe8_world1.pt"), weights_only=True)
    top = logits.argmax(-1).cpu()
    margin_ok = w1["margin"] >= TIE_MARGIN
    res["moe"] = {"expert_params": experts, "params_held": held,
                  "logits_max_abs_err": float((logits.cpu() - w1["logits"]).abs().max()),
                  "top1_equal": int((top == w1["top1"]).sum()),
                  "top1_differ_at_margin": int(((top != w1["top1"]) & margin_ok).sum()),
                  "near_ties": int((~margin_ok).sum())}
    del logits, w1
    losses, moves = [], []
    for _ in range(SP_MOE_STEPS):
        loss, moved = _counted(lambda: lm.train_step(toks))
        losses.append(loss)
        moves.append(moved)
        _add(res["launches"], moved)
    res["moe"].update(losses=losses, moves=moves, want=_kernels(nl, nl, nl),
                      max_memory_allocated_mb=torch.cuda.max_memory_allocated() / 1e6)
    del lm
    torch.cuda.empty_cache()

    # ---- 4. the float32 narrow LM, TF32 off ----
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    ntoks = torch_from_seed(6, (SP_NARROW_B, SP_NARROW_T), SP_NARROW["vocab_size"])
    res["narrow"] = {}
    for name, mesh, form in (("sp2_ring", sp_mesh, "ring"), ("sp2_ulysses", sp_mesh, "ulysses"),
                             ("ep2", ep_mesh, "ring"), ("dp2", dp_mesh, "ring")):
        nlm = LongContextLM(mesh, seq_len=SP_NARROW_T, dtype=torch.float32, seed=1,
                            seq_parallel=form, **SP_NARROW)
        losses = []
        for _ in range(SP_NARROW_STEPS):
            loss, moved = _counted(lambda: nlm.train_step(ntoks))
            losses.append(loss)
            _add(res["launches"], moved)
        res["narrow"][name] = losses
        if name == "dp2":
            nlm.save_checkpoint(os.path.join(tmp, "ck_dp2_lm"))
            state = nlm.state
            if rank == 0:
                torch.save(state, os.path.join(tmp, "ck_dp2_lm_state.pt"))
        del nlm
    torch.save(res, os.path.join(tmp, f"sp_rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


def phase_seq_parallel():
    """Sequence and expert parallelism: NCCL at world size 1 on cuda:0 in
    this process, then two gloo ranks sharing the card. Returns K2's, K3's
    and the delta kernel's launches on the path (this process's and both
    ranks')."""
    import multiprocessing

    import torch
    import torch.distributed as dist
    from dml_tpu_torch.ops.flash_attention import flash_attention
    from dml_tpu_torch.parallel.long_context import LongContextLM
    from dml_tpu_torch.parallel.mesh import local_mesh
    from dml_tpu_torch.parallel.ring_attention import ring_attention
    from dml_tpu_torch.parallel.ulysses import ulysses_attention

    t_phase = time.monotonic()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_seq_parallel_")
    torch.cuda.set_device(0)
    nl = LM_CFG["n_layers"]
    out = {"note": "world 1: NCCL, groups of one, sp 1 (no sequence collective); two ranks: "
           "both on the one card (cuda:0), gloo, every collective staged through the host"}
    dist.init_process_group("nccl", init_method=f"file://{tmp}/rendezvous_nccl",
                            world_size=1, rank=0)
    try:
        mesh = local_mesh()
        g = torch.Generator(device="cuda").manual_seed(15)
        q, k, v = (torch.randn(1, TRAIN_T, 16, 64, generator=g, device="cuda",
                               dtype=torch.bfloat16) for _ in range(3))
        want = flash_attention(q, k, v, causal=True)  # not counted: the reference

        # ---- the main path (world 1), counted ----
        reset_launch_counts()
        w1 = {}
        for name, fn in (("ring", ring_attention), ("ulysses", ulysses_attention)):
            got, moved = _counted(lambda: fn(q, k, v, mesh, causal=True))
            check(moved == _kernels(1), f"world-1 {name} launched {moved}, want one K2")
            check(torch.equal(got, want), f"world-1 {name} is not bit-equal to flash_attention")
            w1[name] = {"launches": moved, "bit_equal": True}
        del q, k, v, want, got
        toks = torch_from_seed(5, (1, TRAIN_T), LM_CFG["vocab_size"])
        lm = LongContextLM(mesh, seq_len=TRAIN_T, dtype=torch.bfloat16, seed=0, **LM_CFG)
        losses, step_ms = [], []
        for _ in range(3):
            t0 = time.monotonic()
            loss, moved = _counted(lambda: lm.train_step(toks))
            step_ms.append((time.monotonic() - t0) * 1e3)
            check(moved == _kernels(nl, nl, nl), f"a world-1 mesh step launched {moved}")
            losses.append(loss)
        check(all(np.isfinite(losses)) and losses[-1] < losses[0], f"world-1 losses {losses}")
        w1["train"] = {"losses": losses, "step_ms": step_ms}
        world1 = launch_counts()
        # not counted: where a world-1 mesh step's time goes (the flat
        # gradient buffer and its all-reduce over the dp x sp plane)
        prof_w1 = profile_calls(lambda: lm.train_step(toks), 2, PAR_KINDS[:1] + TRAIN_KINDS,
                                ranges=("mesh.all_reduce.dp+sp",))
        del lm
        torch.cuda.empty_cache()

        # not counted: the references the ranks are held to, on one device
        moe = LongContextLM(seq_len=TRAIN_T, dtype=torch.bfloat16, seed=0, **MOE, **LM_CFG)
        w1_experts = sum(p.numel() for n, p in moe.model.named_parameters()
                         if n.endswith(("w_up", "w_down")))
        logits = moe.forward(toks)[0]
        top2 = logits.topk(2, dim=-1).values
        torch.save({"logits": logits.cpu(), "top1": logits.argmax(-1).cpu(),
                    "margin": (top2[:, 0] - top2[:, 1]).cpu()},
                   os.path.join(tmp, "moe8_world1.pt"))
        del moe, logits, top2
        torch.cuda.empty_cache()
        tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
        try:
            ntoks = torch_from_seed(6, (SP_NARROW_B, SP_NARROW_T), SP_NARROW["vocab_size"])
            nlm = LongContextLM(seq_len=SP_NARROW_T, dtype=torch.float32, seed=1, **SP_NARROW)
            narrow_ref = [nlm.train_step(ntoks) for _ in range(SP_NARROW_STEPS)]
            del nlm
        finally:
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.cuda.empty_cache()

        # ---- two gloo ranks on the one card ----
        t0 = time.monotonic()
        ctx = multiprocessing.get_context("spawn")
        procs = [ctx.Process(target=_seq_parallel_rank, args=(r, 2, tmp)) for r in range(2)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout=900)
        codes = [p.exitcode for p in procs]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        check(codes == [0, 0], f"gloo ranks exited {codes}")
        ranks = [torch.load(os.path.join(tmp, f"sp_rank{r}.pt"), weights_only=False)
                 for r in range(2)]
        gloo = {"wall_s": time.monotonic() - t0, "attention": {}, "lm": {}}
        for key in ranks[0]["attention"]:
            rows = [r["attention"][key] for r in ranks]
            if key.startswith("forward_ms"):
                gloo["attention"][key] = rows
                continue
            dtype = key.split("/")[1]
            for r, row in enumerate(rows):
                check(row["moved"] == row["want"],
                      f"rank {r} {key} launched {row['moved']}, want {row['want']}")
                check(row["max_abs_err"] <= SP_ATTN_BARS[dtype],
                      f"rank {r} {key}: {row['max_abs_err']} from the one-device K2")
                if "grad_ok" in row:
                    check(row["grad_ok"], f"rank {r} {key} gradients: {row['grad_max_abs_err']} "
                          f"from the one-device K3")
            gloo["attention"][key] = {
                "max_abs_err": [row["max_abs_err"] for row in rows],
                "grad_max_abs_err": [row.get("grad_max_abs_err") for row in rows],
                "launches": [row["moved"] for row in rows]}
        for form in ("ring", "ulysses"):
            rows = [r["lm"][form] for r in ranks]
            for r, row in enumerate(rows):
                check(all(m == row["want"] for m in row["moves"]),
                      f"rank {r} {form} LM steps launched {row['moves']}, want {row['want']}")
                check(all(np.isfinite(row["losses"])) and row["losses"][-1] < row["losses"][0],
                      f"rank {r} {form} losses {row['losses']}")
                check(row["generate_moved"] == row["generate_want"],
                      f"rank {r} {form} generate launched {row['generate_moved']}")
            check(rows[0]["losses"] == rows[1]["losses"], f"{form}: the ranks' losses differ")
            check(np.array_equal(rows[0]["generated"], rows[1]["generated"]),
                  f"{form}: the ranks served different tokens")
            gloo["lm"][form] = {
                "losses": rows[0]["losses"], "generated": rows[0]["generated"].tolist(),
                "launches_per_step": [row["want"] for row in rows],
                **{k: [row[k] for row in rows]
                   for k in ("step_ms", "step_ms_median", "step_ms_p90", "tokens_per_s",
                             "max_memory_allocated_mb", "collectives")}}
        mrows = [r["moe"] for r in ranks]
        for r, row in enumerate(mrows):
            check(row["top1_differ_at_margin"] == 0,
                  f"rank {r} lm_moe8 ep 2: top-1 differs from world 1's at "
                  f"{row['top1_differ_at_margin']} positions with a margin >= {TIE_MARGIN}")
            check(all(m == row["want"] for m in row["moves"]), f"rank {r} moe moves {row['moves']}")
            check(all(np.isfinite(row["losses"])), f"rank {r} moe losses {row['losses']}")
            check(2 * row["expert_params"] == w1_experts,
                  f"rank {r} holds {row['expert_params']} expert parameters of {w1_experts}")
        gloo["moe8_ep2"] = {k: [row[k] for row in mrows] for k in mrows[0]
                            if k not in ("moves", "want")}
        gloo["moe8_ep2"]["world1_expert_params"] = w1_experts
        narrow = {}
        for name in ranks[0]["narrow"]:
            got = ranks[0]["narrow"][name]
            check(got == ranks[1]["narrow"][name], f"narrow {name}: the ranks' losses differ")
            rel = max(_rel(a, b) for a, b in zip(got, narrow_ref))
            narrow[name] = {"losses": got, "max_rel_diff_world1": rel}
            check(rel <= 1e-4, f"narrow f32 {name} losses {got} != world 1 {narrow_ref}")
        gloo["narrow_f32"] = dict(narrow, world1_losses=narrow_ref)
        # the dp-2 checkpoint restores bitwise at world 1
        nlm = LongContextLM(seq_len=SP_NARROW_T, dtype=torch.float32, seed=7, **SP_NARROW)
        step = nlm.restore_checkpoint(os.path.join(tmp, "ck_dp2_lm"))
        saved = torch.load(os.path.join(tmp, "ck_dp2_lm_state.pt"), map_location="cpu",
                           weights_only=True)
        got = nlm.state
        same = all(torch.equal(got["params"][n].cpu(), t) for n, t in saved["params"].items())
        same = same and all(torch.equal(got["opt_state"][m][n].cpu(), t)
                            for m in ("exp_avg", "exp_avg_sq")
                            for n, t in saved["opt_state"][m].items())
        check(step == saved["step"] == SP_NARROW_STEPS and same
              and got["opt_state"]["count"] == saved["opt_state"]["count"],
              f"dp-2 LM checkpoint restored at world 1: step {step}, bitwise {same}")
        gloo["checkpoint_dp2_to_world1"] = {"step": step, "bitwise": same}
        del nlm
        out["world1"] = w1
        out["gloo_2_ranks"] = gloo
        SHARED["sp_footprint"] = ranks[0]["footprint"]  # phase 22 reads it
        total = dict(world1)
        per_rank = [r["launches"] for r in ranks]
        for moved in per_rank:
            _add(total, moved)
        out["launches"] = {"world1": world1, "gloo_ranks": per_rank, "total": total}
    finally:
        dist.destroy_process_group()
        torch.cuda.empty_cache()
    out["phase_s"] = time.monotonic() - t_phase
    emit(phase="seq_parallel", **out)
    emit(phase="profile", path=f"seq_parallel_world1_mesh_step_b1_t{TRAIN_T}", **prof_w1)
    return total


# ---------------------------------------------------------------------------
# phase 16: the pipeline form and the pp/tp LM serving forms
# ---------------------------------------------------------------------------

# the 198M LM behind phase 12's server settings; the pipeline's max_len
# holds its longest prompt (2048) and budget (64)
LM_SPEC = dict(LM_CFG, name="lm198m", dtype="bfloat16", seed=0, max_new_tokens=64,
               max_slots=LMS_SLOTS, max_len=LMS_MAX_LEN, chunk=LMS_CHUNK)
PIPE_MICRO, PIPE_TIMED = 2, 2  # microbatches, timed batches
PIPE_LENS = (256, 2048)  # prompt lengths: the least, and the most (the first prompt's)
PIPE_BUDGETS = [64, 16, 48, 32, 64, 8, 40, 24]  # one per prompt
PIPE_SPEC = dict(LM_SPEC, max_len=PIPE_LENS[1] + max(PIPE_BUDGETS))
# the served requests: phase 12's mixed-budget stream cut to its first 8
# (world 1) and 4 (tp 2) requests, budgets capped at 64 (its 128 and 256
# cut): every collective of the resident form goes through the host under
# gloo, about 50 a token
SERVE_CAP, TP_REQS = 64, 4
# the float32 narrow dense LM, held to one device's tokens exactly
NARROW_SPEC = dict(vocab_size=512, d_model=128, n_heads=4, n_kv_heads=2, n_layers=4, d_ff=256,
                   name="narrow", dtype="float32", seed=1, max_new_tokens=16, max_slots=4,
                   max_len=256, chunk=8)
NARROW_BUDGETS = [16, 5, 1, 9]


def pipe_requests(vocab):
    rng = np.random.RandomState(16)
    lens = rng.randint(PIPE_LENS[0], PIPE_LENS[1] + 1, size=len(PIPE_BUDGETS))
    lens[0] = PIPE_LENS[1]  # the longest prompt fills the bucket
    return [(rng.randint(0, vocab, int(t)).astype(np.int32), b)
            for t, b in zip(lens, PIPE_BUDGETS)]


def narrow_requests():
    rng = np.random.RandomState(17)
    return [(rng.randint(0, NARROW_SPEC["vocab_size"], int(t)).astype(np.int32), b)
            for t, b in zip((20, 45, 77, 100), NARROW_BUDGETS)]


@contextlib.contextmanager
def tf32_off():
    import torch

    was = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = was


def held_to_lone(name, got, lone):
    """Each request's tokens against its lone greedy run up to a near-tie
    (`tie_compare`); returns {requests equal throughout, requests with a
    near-tie, tokens compared (up to the first mismatch) of each}."""
    exact = ties = 0
    compared = []
    for i, (toks, (want, margins)) in enumerate(zip(got, lone)):
        held, upto, tie, low = tie_compare(toks, want, margins)
        check(held, f"{name} request {i}: tokens differ from the lone run at {upto} with no "
                    f"near-tie before it (least margin {low})")
        exact += upto == len(want)
        ties += tie is not None
        compared.append(upto)
    return {"equal_to_lone": exact, "near_ties": ties, "tokens_compared": compared}


def _pipeline_rank(rank, world, tmp):
    """One of the two gloo ranks, both on cuda:0: pp 2 (stage = rank) and
    tp 2 (tp index = rank). Writes its results to tmp/pipe_rank<r>.pt; a
    failure exits non-zero."""
    import torch
    import torch.distributed as dist
    from dml_tpu_torch.config import MeshSpec
    from dml_tpu_torch.inference.lm_sharded import PipelinedLMBackend, sharded_lm_backend
    from dml_tpu_torch.parallel.mesh import make_mesh

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rendezvous_gloo",
                            world_size=world, rank=rank)
    pp_mesh = make_mesh(MeshSpec(dp=1, pp=2))
    tp_mesh = make_mesh(MeshSpec(dp=1, tp=2))
    refs = torch.load(os.path.join(tmp, "pipe_refs.pt"), weights_only=False)
    res = {"launches": {}}
    reset_launch_counts()

    # ---- pp 2: the 198M LM, 6 blocks a stage ----
    torch.cuda.reset_peak_memory_stats()
    be = PipelinedLMBackend(PIPE_SPEC, pp_mesh, microbatches=PIPE_MICRO)
    prompts, budgets = refs["pipe_prompts"], refs["pipe_budgets"]
    runs, ms, moves = [], [], []
    for _ in range(1 + PIPE_TIMED):  # the first is the warm-up
        torch.cuda.synchronize()
        t0 = time.monotonic()
        toks, moved = _counted(lambda: be.generate_batch(prompts, budgets))
        torch.cuda.synchronize()
        ms.append((time.monotonic() - t0) * 1e3)
        runs.append(toks)
        moves.append(moved)
    prof, moved = _counted(lambda: collectives_profile(
        lambda: be.generate_batch(prompts, budgets), iters=1))
    moves.append(moved)
    med = statistics.median(ms[1:])
    res["pp"] = {"tokens": runs[0], "repeat_equal": all(r == runs[0] for r in runs),
                 "batch_ms": ms, "batch_ms_median": med,
                 "tokens_per_s": sum(budgets) / (med / 1e3), "moves": moves,
                 "want": _kernels(be.l_per * PIPE_MICRO), "held_bytes": be.held_bytes(),
                 "hbm": be.hbm, "stage": be.stage,
                 "max_memory_allocated_mb": torch.cuda.max_memory_allocated() / 1e6,
                 "collectives": prof}
    del be
    torch.cuda.empty_cache()

    # ---- tp 2: both forms over the first TP_REQS requests of the stream ----
    reqs = refs["tp_reqs"]
    res["tp"] = {}
    for form in ("resident", "gather"):
        torch.cuda.reset_peak_memory_stats()
        be = sharded_lm_backend(LM_SPEC, tp_mesh, form=form)
        (toks, d, stats), moved = _counted(lambda: serve_stream(be.server, reqs))
        short = [(p, LMS_CHUNK) for p, _ in reqs[:2]]  # one placement group, one chunk step
        prof_box = {}

        def profiled():
            prof_box["serve"] = serve_stream(be.server, short)
        prof, pmoved = _counted(lambda: collectives_profile(profiled, iters=1))
        res["tp"][form] = {
            "tokens": [t.tolist() for t in toks], "dispatches": d, "moved": moved,
            "profile_dispatches": prof_box["serve"][1], "profile_moved": pmoved,
            "wall_s": stats["wall_s"], "tokens_per_s": stats["tokens_per_s"],
            "steps": stats["steps"], "ttft_ms_p50": stats["ttft_ms_p50"],
            "max_memory_allocated_mb": torch.cuda.max_memory_allocated() / 1e6,
            "collectives": prof,
            "qkv_piece": list(be.server.params["block_0"]["qkv"]["kernel"].shape)}
        del be
        torch.cuda.empty_cache()

    # ---- the float32 narrow dense LM at pp 2 and tp 2, TF32 off ----
    nreqs = refs["narrow_reqs"]
    with tf32_off():
        be = PipelinedLMBackend(NARROW_SPEC, pp_mesh)
        toks, moved = _counted(lambda: be.generate_batch([p for p, _ in nreqs],
                                                         [b for _, b in nreqs]))
        res["narrow"] = {"pp": {"tokens": toks, "moved": moved,
                                "want": _kernels(be.l_per * be.microbatches)}}
        del be
        for form in ("resident", "gather"):
            be = sharded_lm_backend(NARROW_SPEC, tp_mesh, form=form)
            (toks, d, _), moved = _counted(lambda: serve_stream(be.server, nreqs))
            res["narrow"][form] = {"tokens": [t.tolist() for t in toks], "dispatches": d,
                                   "moved": moved}
            del be
    res["launches"] = launch_counts()
    torch.save(res, os.path.join(tmp, f"pipe_rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


def phase_pipeline():
    """The pipeline form and the pp/tp LM serving forms: NCCL at world size
    1 on cuda:0 in this process, then two gloo ranks sharing the card.
    Returns K2's and K4's launches on the path (this process's and both
    ranks')."""
    import dataclasses
    import multiprocessing

    import torch
    import torch.distributed as dist
    from dml_tpu_torch.inference import generate as gen
    from dml_tpu_torch.inference.lm_backend import LMBackend, lm_spec_parts
    from dml_tpu_torch.inference.lm_sharded import (LMPrefillBackend, kv_slab_from_bytes,
                                                    kv_slab_to_bytes, lm_spec_parts_cached,
                                                    pp_hbm_report, sharded_lm_backend)
    from dml_tpu_torch.ops.flash_attention import flash_attention
    from dml_tpu_torch.parallel.mesh import local_mesh

    t_phase = time.monotonic()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_pipeline_")
    torch.cuda.set_device(0)
    # the host tree the sharded forms start from (built once), on the card
    host, cfg = lm_spec_parts_cached(LM_SPEC, device="cpu")
    params = tree_cuda(host)
    nl = cfg.n_layers
    reqs = [(p, min(b, SERVE_CAP)) for p, b in mixed_requests(cfg.vocab_size)[:LMS_SLOTS]]
    prompts, budgets = [p for p, _ in reqs], [b for _, b in reqs]
    out = {"note": "world 1: NCCL, tp 1 (every leaf whole, no collective); two ranks: both on "
                   "the one card (cuda:0), gloo, every collective staged through the host",
           "config": dict(LM_CFG, dtype="bfloat16"), "tie_margin": TIE_MARGIN}

    # ---- not counted: the references ----
    # K2 on GQA's kv head h // G (what the pipeline's stages launch)
    # against k/v repeated to H heads (what JAX's pipelined prefill
    # gives it), at a stage's prefill shape: bit for bit
    g = torch.Generator(device="cuda").manual_seed(16)
    shape = [len(PIPE_BUDGETS) // PIPE_MICRO, PIPE_LENS[1], cfg.n_heads, cfg.head_dim]
    q = torch.randn(*shape, generator=g, device="cuda", dtype=torch.bfloat16)
    k, v = (torch.randn(*shape[:2], cfg.kv_heads, cfg.head_dim, generator=g, device="cuda",
                        dtype=torch.bfloat16) for _ in range(2))
    grp = cfg.n_heads // cfg.kv_heads
    gqa = flash_attention(q, k, v, causal=True)
    rep = flash_attention(q, k.repeat_interleave(grp, 2), v.repeat_interleave(grp, 2),
                          causal=True)
    check(torch.equal(gqa, rep), "K2's GQA form differs from k/v repeated to every head")
    out["k2_gqa_equals_repeat"] = {"q": shape, "kv_heads": cfg.kv_heads, "bit_equal": True}
    del q, k, v, gqa, rep
    # one device's server, and each request's lone greedy run with its margins
    ref_srv = LMBackend(params, cfg, max_new_tokens=64, max_slots=LMS_SLOTS,
                        max_len=LMS_MAX_LEN, chunk=LMS_CHUNK).server
    ref_toks, _, _ = serve_stream(ref_srv, reqs)
    del ref_srv
    lone = [lone_greedy(gen, params, cfg, p, n) for p, n in reqs]
    out["one_device_server"] = held_to_lone("one-device server", ref_toks, lone)
    preqs = pipe_requests(cfg.vocab_size)
    pipe_lone = [lone_greedy(gen, params, cfg, p, n) for p, n in preqs]
    nparams, ncfg = lm_spec_parts(NARROW_SPEC)
    nreqs = narrow_requests()
    with tf32_off():
        narrow_ref = [gen.generate(nparams, ncfg, torch.from_numpy(p[None]).cuda(), n)[0].tolist()
                      for p, n in nreqs]
        nsrv = LMBackend(nparams, ncfg, max_new_tokens=16, max_slots=NARROW_SPEC["max_slots"],
                         max_len=NARROW_SPEC["max_len"], chunk=NARROW_SPEC["chunk"]).server
        narrow_local, _, _ = serve_stream(nsrv, nreqs)
        del nsrv
    check([t.tolist() for t in narrow_local] == narrow_ref,
          "the float32 narrow LM's server differs from its lone generate")
    torch.save({"pipe_prompts": [p for p, _ in preqs], "pipe_budgets": PIPE_BUDGETS,
                "tp_reqs": reqs[:TP_REQS], "narrow_reqs": nreqs},
               os.path.join(tmp, "pipe_refs.pt"))

    dist.init_process_group("nccl", init_method=f"file://{tmp}/rendezvous_nccl",
                            world_size=1, rank=0)
    try:
        # ---- the main path at world 1, counted ----
        mesh = local_mesh(dp=1)
        reset_launch_counts()
        w1 = {}
        for form in ("resident", "gather"):
            be = sharded_lm_backend(LM_SPEC, mesh, form=form)
            (toks, d, stats), moved = _counted(lambda: serve_stream(be.server, reqs))
            check_server_launches(f"world-1 {form}", moved, d, nl, LMS_CHUNK)
            check(all(np.array_equal(a, b) for a, b in zip(toks, ref_toks)),
                  f"world-1 {form}: tokens differ from LMBackend's on the same requests")
            w1[form] = {"launches": moved, "dispatches": d, "tokens_per_s": stats["tokens_per_s"],
                        "equal_to_lmbackend": True}
            del be
        # the slab path: LMPrefillBackend -> bytes -> LMBackend.serve_prefilled
        pf = LMPrefillBackend(params, cfg, max_len=LMS_MAX_LEN)
        entries, moved = _counted(lambda: [pf.prefill_one(p, b) for p, b in reqs])
        check(moved == _kernels(nl * len(reqs)), f"prefill_one launched {moved}")
        blob = kv_slab_to_bytes(entries)
        sblob, smoved = _counted(lambda: pf.slabs_bytes(prompts, budgets))
        check(smoved == _kernels(nl * len(reqs)), f"slabs_bytes launched {smoved}")
        check(sblob == blob, "slabs_bytes differs from the same prompts' prefill_one entries")
        slabs = kv_slab_from_bytes(blob)
        same = all(torch.equal(s["rows"][n][key], e["rows"][n][key])
                   for s, e in zip(slabs, entries) for n in e["rows"] for key in e["rows"][n])
        check(same and kv_slab_to_bytes(slabs) == blob, "the bf16 slab blob does not round-trip")
        be = LMBackend(params, cfg, max_new_tokens=64, max_slots=LMS_SLOTS, max_len=LMS_MAX_LEN,
                       chunk=LMS_CHUNK)
        d0 = server_dispatches()
        (adopted, infer_s), amoved = _counted(lambda: be.serve_prefilled(prompts, budgets, slabs))
        d = {key: val - d0[key] for key, val in server_dispatches().items()}
        check_server_launches("serve_prefilled", amoved, d, nl, LMS_CHUNK)
        exact = sum(np.array_equal(a, b) for a, b in zip(adopted, ref_toks))
        vs_lone = held_to_lone("serve_prefilled", adopted, lone)
        be.close()
        # in float32 (TF32 off) the 1-row slab prefill and the server's grid
        # prefill pick the same tokens: the adopted serve equals the local one
        with tf32_off():
            npf = LMPrefillBackend(nparams, ncfg, max_len=NARROW_SPEC["max_len"])
            nslabs, nmoved = _counted(lambda: kv_slab_from_bytes(npf.slabs_bytes(
                [p for p, _ in nreqs], [b for _, b in nreqs])))
            check(nmoved == _kernels(ncfg.n_layers * len(nreqs)), f"narrow slabs: {nmoved}")
            nbe = LMBackend(nparams, ncfg, max_new_tokens=16, max_slots=NARROW_SPEC["max_slots"],
                            max_len=NARROW_SPEC["max_len"], chunk=NARROW_SPEC["chunk"])
            d0 = server_dispatches()
            (nadopted, _), namoved = _counted(lambda: nbe.serve_prefilled(
                [p for p, _ in nreqs], [b for _, b in nreqs], nslabs))
            nd = {key: val - d0[key] for key, val in server_dispatches().items()}
            check_server_launches("narrow serve_prefilled", namoved, nd, ncfg.n_layers,
                                  NARROW_SPEC["chunk"])
            check([t.tolist() for t in nadopted] == [t.tolist() for t in narrow_local],
                  "float32 narrow LM: the adopted slabs' tokens differ from the local serve's")
            nbe.close()
        del nparams
        qcfg = dataclasses.replace(cfg, kv_quant=True)
        qentries, qmoved = _counted(lambda: [LMPrefillBackend(params, qcfg, max_len=LMS_MAX_LEN)
                                             .prefill_one(p, b) for p, b in reqs[:2]])
        check(qmoved == _kernels(nl * 2), f"int8 prefill_one launched {qmoved}")
        qblob = kv_slab_to_bytes(qentries)
        qback = kv_slab_from_bytes(qblob)
        qsame = all(torch.equal(s["rows"][n][key], e["rows"][n][key]) and
                    s["rows"][n][key].dtype == e["rows"][n][key].dtype
                    for s, e in zip(qback, qentries) for n in e["rows"] for key in e["rows"][n])
        check(qsame and kv_slab_to_bytes(qback) == qblob
              and qentries[0]["rows"]["block_0"]["k_q"].dtype == torch.int8,
              "the int8 (kv_quant) slab blob does not round-trip")
        w1["slabs"] = {"requests": len(reqs), "bytes": len(blob), "int8_bytes_2_requests": len(qblob),
                       "bit_exact_bf16": True, "bit_exact_int8": True,
                       "adopted_equal_to_local_serve": int(exact), "adopted_vs_lone": vs_lone,
                       "narrow_f32_adopted_equal_to_local_serve": len(nreqs), "adopted_s": infer_s,
                       "serve_prefilled_launches": amoved, "serve_prefilled_dispatches": d}
        world1 = launch_counts()
        out["world1"] = w1

        # ---- two gloo ranks on the one card ----
        t0 = time.monotonic()
        ctx = multiprocessing.get_context("spawn")
        procs = [ctx.Process(target=_pipeline_rank, args=(r, 2, tmp)) for r in range(2)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout=600)
        codes = [p.exitcode for p in procs]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        check(codes == [0, 0], f"gloo ranks exited {codes}")
        ranks = [torch.load(os.path.join(tmp, f"pipe_rank{r}.pt"), weights_only=False)
                 for r in range(2)]
        gloo = {"wall_s": time.monotonic() - t0}
        # pp 2
        rows = [r["pp"] for r in ranks]
        rep = pp_hbm_report(PIPE_SPEC, 2)
        for r, row in enumerate(rows):
            check(row["stage"] == r and row["repeat_equal"], f"rank {r} pp: stage {row['stage']}, "
                  f"repeats equal {row['repeat_equal']}")
            check(all(m == row["want"] for m in row["moves"]),
                  f"rank {r} pp batches launched {row['moves']}, want {row['want']} each")
            check(row["held_bytes"] == rep["per_member_bytes"] < rep["full_bytes"],
                  f"rank {r} holds {row['held_bytes']} weight bytes, pp_hbm_report {rep}")
        check(rows[0]["tokens"] == rows[1]["tokens"], "pp: the ranks decoded different tokens")
        gloo["pp"] = {
            "prompt_lens": [len(p) for p, _ in preqs], "budgets": PIPE_BUDGETS,
            "microbatches": PIPE_MICRO, **held_to_lone("pp 2", rows[0]["tokens"], pipe_lone),
            "k2_per_batch": [row["want"]["flash_attention"] for row in rows],
            "hbm_report": rep,
            **{key: [row[key] for row in rows]
               for key in ("batch_ms", "batch_ms_median", "tokens_per_s", "held_bytes",
                           "max_memory_allocated_mb", "collectives")}}
        # tp 2, both forms
        gloo["tp"] = {"requests": TP_REQS, "budgets": [b for _, b in reqs[:TP_REQS]]}
        for form in ("resident", "gather"):
            rows = [r["tp"][form] for r in ranks]
            for r, row in enumerate(rows):
                check_server_launches(f"rank {r} tp {form}", row["moved"], row["dispatches"], nl,
                                      LMS_CHUNK)
                check_server_launches(f"rank {r} tp {form} profiled", row["profile_moved"],
                                      row["profile_dispatches"], nl, LMS_CHUNK)
            check(rows[0]["tokens"] == rows[1]["tokens"], f"tp {form}: the ranks' tokens differ")
            one = sum(np.array_equal(a, b) for a, b in zip(rows[0]["tokens"], ref_toks))
            gloo["tp"][form] = {
                **held_to_lone(f"tp 2 {form}", rows[0]["tokens"], lone[:TP_REQS]),
                "equal_to_one_device_server": int(one),
                "qkv_piece": rows[0]["qkv_piece"],
                **{key: [row[key] for row in rows]
                   for key in ("dispatches", "wall_s", "tokens_per_s", "steps", "ttft_ms_p50",
                               "max_memory_allocated_mb", "collectives")}}
        # the float32 narrow LM: one device's tokens exactly
        narrow = {}
        for name in ("pp", "resident", "gather"):
            for r, rank_res in enumerate(ranks):
                row = rank_res["narrow"][name]
                check(row["tokens"] == narrow_ref,
                      f"rank {r} narrow f32 {name}: {row['tokens']} != one device {narrow_ref}")
                if name == "pp":
                    check(row["moved"] == row["want"], f"rank {r} narrow pp launched {row['moved']}")
                else:
                    check_server_launches(f"rank {r} narrow {name}", row["moved"],
                                          row["dispatches"], NARROW_SPEC["n_layers"],
                                          NARROW_SPEC["chunk"])
            narrow[name] = "equal to one device"
        gloo["narrow_f32"] = dict(narrow, tokens=narrow_ref)
        out["gloo_2_ranks"] = gloo
        total = dict(world1)
        per_rank = [r["launches"] for r in ranks]
        for moved in per_rank:
            _add(total, moved)
        out["launches"] = {"world1": world1, "gloo_ranks": per_rank, "total": total}
    finally:
        dist.destroy_process_group()
        torch.cuda.empty_cache()
    out["phase_s"] = time.monotonic() - t_phase
    emit(phase="pipeline", **out)
    return total


# ---------------------------------------------------------------------------
# phase 17: the job pipeline, a port cluster serving image and LM jobs
# ---------------------------------------------------------------------------

CLUSTER_NODES, CLUSTER_FILES = 4, 64
CLUSTER_MIX = (("ResNet50", 512), ("InceptionV3", 512))  # submitted together
CLUSTER_KILL_JOB = ("ResNet50", 256)  # a worker is stopped after its first ACK
CLUSTER_LM_PROMPTS = 8  # the first 8 requests of phase 12's mixed-budget stream
CLUSTER_PORTS = (50000, 54999)  # base ports probed here; the data plane at +10000


def free_port_block(n):
    """A base port B such that the introducer and the nodes can bind UDP at
    B-1 .. B+n-1 and their store data planes TCP at B+9999 .. B+n+9999 on
    127.0.0.1 now (TCP with SO_REUSEADDR, as asyncio's server binds, so an
    earlier listener's TIME_WAIT does not count as taken)."""
    import random
    import socket

    def free(kind, port):
        s = socket.socket(socket.AF_INET, kind)
        try:
            if kind == socket.SOCK_STREAM:
                s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            s.bind(("127.0.0.1", port))
            return True
        except OSError:
            return False
        finally:
            s.close()

    rng = random.Random(os.getpid())
    for _ in range(200):
        base = rng.randrange(CLUSTER_PORTS[0] + 1, CLUSTER_PORTS[1] - n)
        if all(free(socket.SOCK_DGRAM, p) and free(socket.SOCK_STREAM, p + 10000)
               for p in range(base - 1, base + n)):
            return base
    raise RuntimeError(f"no free block of {n + 1} ports in {CLUSTER_PORTS}")


def _median(xs):
    return float(statistics.median(xs)) if xs else None


async def _run_cluster(tmp, engine, lm_make, out):
    """The introducer and CLUSTER_NODES nodes (Node + StoreService +
    JobService sharing `engine`, an LM backend each from `lm_make`) on
    127.0.0.1; the image jobs, the killed-worker job and the LM job. Fills
    `out`; returns the launch counts of the image jobs and the LM job."""
    import asyncio
    import glob
    import threading

    import torch
    from dml_tpu_torch import config
    from dml_tpu_torch.cluster.introducer import IntroducerService
    from dml_tpu_torch.cluster.node import Node
    from dml_tpu_torch.cluster.store_service import StoreService
    from dml_tpu_torch.inference.lm_backend import write_prompt_file
    from dml_tpu_torch.jobs.service import JobService
    from dml_tpu_torch.observability import METRICS

    base = free_port_block(CLUSTER_NODES)
    spec = config.ClusterSpec.localhost(
        CLUSTER_NODES, base_port=base, introducer_port=base - 1,
        timing=config.Timing(ping_interval=0.2, ack_timeout=0.5, cleanup_time=1.5,
                             leader_rpc_timeout=20.0),
        store=config.StoreConfig(root=os.path.join(tmp, "roots"),
                                 download_dir=os.path.join(tmp, "dl")))
    dns = IntroducerService(spec)
    await dns.start()
    stack, backends = {}, []
    try:
        for n in spec.nodes:
            node = Node(spec, n)
            store = StoreService(node, root=os.path.join(tmp, f"st_{n.name}"))
            jobs = JobService(node, store, engine=engine)
            be = lm_make()
            backends.append(be)
            jobs.register_lm("LM198M", backend=be.backend, cost=be.cost())
            await node.start()
            await store.start()
            await jobs.start()
            stack[n.name] = (node, store, jobs)
        t0 = time.monotonic()
        while not all(nd.joined and nd.leader_unique
                      and len(nd.membership.alive_nodes()) == CLUSTER_NODES
                      for nd, _, _ in stack.values()):
            check(time.monotonic() - t0 < 30, "the port cluster did not converge in 30 s")
            await asyncio.sleep(0.1)
        out["converge_s"] = time.monotonic() - t0
        leader = stack["H1"][0].leader_unique
        check(leader == spec.node_by_name("H1").unique_name, f"leader {leader}, want H1")
        coord = stack["H1"][2]
        _, cstore, client = stack["H2"]
        rng = np.random.RandomState(17)
        imgs = np.clip(rng.randint(0, 256, (CLUSTER_FILES, 256, 256, 3)) // 2
                       + rng.randint(0, 128, (CLUSTER_FILES, 1, 1, 3)), 0, 255).astype(np.uint8)
        os.makedirs(os.path.join(tmp, "in"))
        files = write_images(os.path.join(tmp, "in"), imgs, "jpeg")
        for f in files:
            await cstore.put(f, os.path.basename(f))
        lm_files = []
        for i, (p, b) in enumerate(mixed_requests(LM_CFG["vocab_size"])[:CLUSTER_LM_PROMPTS]):
            lm_files.append(os.path.join(tmp, f"p{i}.tokens.txt"))
            write_prompt_file(lm_files[-1], p, max_new_tokens=b)
            await cstore.put(lm_files[-1], os.path.basename(lm_files[-1]))

        async def job(model, n, after_first_ack=None):
            t_sub = time.monotonic()
            jid = await client.submit_job(model, n)
            if after_first_ack is not None:
                while not coord.scheduler.jobs.get(jid) or \
                        not coord.scheduler.jobs[jid].completed_batches:
                    check(time.monotonic() - t_sub < 120, f"job {jid}: no ACK in 120 s")
                    await asyncio.sleep(0.005)
                await after_first_ack()
            done = await client.wait_job(jid, timeout=300.0)
            wall = time.monotonic() - t_sub
            check(done["total_queries"] == n, f"job {jid} {model}: {done}")
            merged = await client.get_output(jid, os.path.join(tmp, f"final_{jid}.json"))
            # one output file a batch (output_<job>_<batch>_<host>.json); a
            # batch's queries are its slice of the wrap-around sample
            bs = coord.scheduler.batch_size_of(model)
            parts = {}
            for p in sorted(glob.glob(os.path.join(client.store.cfg.download_path(),
                                                   f"output_{jid}_*.json"))):
                with open(p) as f:
                    parts.setdefault(int(os.path.basename(p).split("_")[2]), json.load(f))
            sizes = [min(bs, n - s) for s in range(0, n, bs)]
            check(sorted(parts) == list(range(len(sizes))),
                  f"job {jid} {model}: output files of batches {sorted(parts)}, want {len(sizes)}")
            check(all(len(parts[b]) == min(k, len(files)) for b, k in enumerate(sizes)),
                  f"job {jid} {model}: a batch's output misses one of its queries")
            return jid, wall, merged

        def fails():
            return sum(v for _, v in METRICS.counter("worker_batch_failures_total").items())

        # ---- image jobs: the two-model fair-share mix, then a worker stopped
        chunks, lock = {}, threading.Lock()
        dispatch = engine._dispatch_chunk

        def counted_dispatch(lm, chunk, *a, **kw):  # two workers' threads call it
            with lock:
                chunks[lm.spec.name] = chunks.get(lm.spec.name, 0) + 1
            return dispatch(lm, chunk, *a, **kw)

        engine._dispatch_chunk = counted_dispatch
        fails0 = fails()
        try:
            reset_launch_counts()
            mix = await asyncio.gather(*(job(m, n) for m, n in CLUSTER_MIX))
            requeues0 = coord.scheduler.requeue_count
            killed = {}

            async def stop_worker():
                # a worker holding a batch of the job: its requeue is the evidence
                busy = {nd.me.unique_name: k for k, (nd, _, _) in stack.items()
                        if k not in ("H1", "H2")}
                name = next((busy[u] for u in sorted(coord.scheduler.in_progress)
                             if u in busy), "H4")
                node, store, jobs = stack.pop(name)
                killed["t"] = time.monotonic()
                await jobs.stop()
                await store.stop()
                await node.stop()
                killed["name"] = name

            kill = await job(*CLUSTER_KILL_JOB, after_first_ack=stop_worker)
            torch.cuda.synchronize()
            image_launches = launch_counts()
        finally:
            engine._dispatch_chunk = dispatch
        check(killed.get("name") in ("H3", "H4"), "the worker was not stopped")
        requeues = coord.scheduler.requeue_count - requeues0
        check(requeues >= 1, f"the killed-worker job counted {requeues} requeues")
        check(fails() == fails0, f"worker_batch_failures_total rose by {fails() - fails0}")
        n_chunks = sum(chunks.values())
        check(n_chunks > 0 and image_launches == {
            "normalize": n_chunks, "flash_attention": 0, "flash_bwd": 0, "flash_bwd_delta": 0,
            "decode_attention": 0}, f"image jobs launched {image_launches} for {chunks} chunks")
        c2 = {m: await client.c2_stats(m) for m, _ in CLUSTER_MIX}
        jobs_out = {}
        for (m, n), (jid, wall, merged) in zip(CLUSTER_MIX + (CLUSTER_KILL_JOB,), mix + [kill]):
            check(len(merged) == CLUSTER_FILES and all(len(r) == 5 for r in merged.values()),
                  f"job {jid} {m}: merged output malformed")
            jobs_out[f"{m}_{n}" + ("_killed_worker" if jid == kill[0] else "")] = {
                "job": jid, "queries": n, "wall_s": wall, "c1_images_per_s": n / wall}
        timing = list(coord.batch_timing)
        out["image"] = {
            "jobs": jobs_out, "c1": coord.c1_stats(), "c2": c2,
            "batch_timing_ms_median": {
                "fetch": _median([s["fetch"] * 1e3 for s in timing]),
                "decode": _median([(s["backend"] - s["infer"]) * 1e3 for s in timing]),
                "infer": _median([s["infer"] * 1e3 for s in timing]),
                "put": _median([s["put"] * 1e3 for s in timing]),
                "exec": _median([s["exec"] * 1e3 for s in timing]), "batches": len(timing)},
            "pipeline_depth": coord.depth_controller_stats(),
            "killed_worker": {"name": killed["name"], "requeues": requeues,
                              "worker_batch_failures_total": fails() - fails0},
            "chunks": chunks, "launches": image_launches}
        merged_by_model = {m: mix[i][2] for i, (m, _) in enumerate(CLUSTER_MIX)}
        merged_by_model["ResNet50_killed"] = kill[2]

        # ---- the LM job through register_lm
        torch.cuda.synchronize()
        d0 = server_dispatches()
        reset_launch_counts()
        t_sub = time.monotonic()
        lm_jid = await client.submit_job("LM198M", CLUSTER_LM_PROMPTS)
        lm_done = await client.wait_job(lm_jid, timeout=300.0)
        lm_wall = time.monotonic() - t_sub
        torch.cuda.synchronize()
        lm_launches = launch_counts()
        d = {k: v - d0[k] for k, v in server_dispatches().items()}
        check(lm_done["total_queries"] == CLUSTER_LM_PROMPTS, f"LM job: {lm_done}")
        lm_merged = await client.get_output(lm_jid, os.path.join(tmp, f"final_{lm_jid}.json"))
        check(len(lm_merged) == CLUSTER_LM_PROMPTS, f"LM job answered {sorted(lm_merged)}")
        want = check_server_launches("cluster LM job", lm_launches, d,
                                     LM_CFG["n_layers"], LMS_CHUNK)
        tokens = sum(len(v["tokens"]) for v in lm_merged.values())
        out["lm"] = {"job": lm_jid, "prompts": CLUSTER_LM_PROMPTS, "wall_s": lm_wall,
                     "tokens": tokens, "tokens_per_s": tokens / lm_wall,
                     "server_dispatches": d, "launches": lm_launches, "formula": want}
        return image_launches, lm_launches, chunks, merged_by_model, files, lm_merged, lm_files
    finally:
        for nd, st, js in reversed(list(stack.values())):
            await js.stop()
            await st.stop()
            await nd.stop()
        await dns.stop()
        for be in backends:
            be.close()


def phase_cluster(timer):
    """A port cluster on 127.0.0.1 serving image and LM jobs end to end
    (phase 17); returns the cluster's launches: K1 by model, K2 and K4."""
    import asyncio

    import torch
    from dml_tpu_torch.inference import InferenceEngine
    from dml_tpu_torch.inference import generate as gen
    from dml_tpu_torch.inference.lm_backend import LMBackend
    from dml_tpu_torch.models.lm_params import init_lm_params
    from dml_tpu_torch.models.registry import get_model

    t_phase = time.monotonic()
    eng = InferenceEngine(dtype=torch.bfloat16)  # device None -> cuda
    check(eng.device.type == "cuda", f"engine on {eng.device}")
    for m, _ in CLUSTER_MIX:
        eng.load_model(m, variables=seeded_weights(get_model(m), seed=0), batch_size=BATCH)
    cfg = gen.LMConfig(**LM_CFG, dtype=torch.bfloat16)
    params = gen.serving_params(init_lm_params(cfg, seed=0), cfg)

    def lm_make():
        return LMBackend(params, cfg, max_new_tokens=64, max_slots=LMS_SLOTS,
                         max_len=LMS_MAX_LEN, chunk=LMS_CHUNK)

    out = {"nodes": CLUSTER_NODES, "files": CLUSTER_FILES,
           "engine": f"{eng.device} {eng.dtype} b{BATCH}, one for all nodes",
           "jobs": {"mix": CLUSTER_MIX, "killed_worker": CLUSTER_KILL_JOB,
                    "lm_prompts": CLUSTER_LM_PROMPTS}}
    with tempfile.TemporaryDirectory() as tmp:
        (image_launches, lm_launches, chunks, merged, files, lm_merged,
         lm_files) = asyncio.run(asyncio.wait_for(_run_cluster(tmp, eng, lm_make, out), 600))
        # the job outputs against the engine called directly on the same files
        worst = 0.0
        for key, got in merged.items():
            model = key.split("_")[0]
            direct = eng.infer_files(model, files).to_json_dict()
            direct = {os.path.basename(k): v for k, v in direct.items()}
            check(set(got) == set(direct), f"{key}: job keys != the files")
            for f, rows in got.items():
                check([r["wnid"] for r in rows] == [r["wnid"] for r in direct[f]],
                      f"{key} {f}: top-5 {[r['wnid'] for r in rows]} != the engine's "
                      f"{[r['wnid'] for r in direct[f]]}")
                err = max(abs(a["score"] - b["score"]) for a, b in zip(rows, direct[f]))
                worst = max(worst, err)
        check(worst <= 1e-6, f"job scores differ from the engine's by {worst} (> 1e-6)")
        out["image"]["vs_engine_infer_files"] = {"max_abs_score_diff": worst, "bar": 1e-6}
        # the LM job against the lone LMBackend serve of the same prompt files
        be = lm_make()
        try:
            lone, _, _ = be.serve_files(lm_files)
        finally:
            be.close()
        lone = {os.path.basename(k): v for k, v in lone.items()}
        ties = equal = 0
        reqs = mixed_requests(cfg.vocab_size)[:CLUSTER_LM_PROMPTS]
        for i, (p, b) in enumerate(reqs):
            got = lm_merged[f"p{i}.tokens.txt"]["tokens"]
            want = lone[f"p{i}.tokens.txt"]["tokens"]
            check(len(got) == b, f"LM prompt {i}: {len(got)} tokens, budget {b}")
            if got == want:
                equal += 1
                continue
            want_t, margins = lone_greedy(gen, params, cfg, p, b)
            held, upto, tie, _ = tie_compare(got, want_t, margins)
            check(held, f"LM prompt {i}: the job's tokens differ from the lone run at {upto} "
                        f"with no near-tie before it")
            ties += 1
        out["lm"]["vs_lone_backend"] = {"equal": equal, "held_to_a_near_tie": ties,
                                       "tie_margin": TIE_MARGIN}
    del params, eng
    torch.cuda.empty_cache()
    out["phase_s"] = time.monotonic() - t_phase
    emit(phase="cluster", **out)
    return {"normalize": chunks, "flash_attention": lm_launches["flash_attention"],
            "decode_attention": lm_launches["decode_attention"]}


# ---------------------------------------------------------------------------
# phase 18: the request front door, per-request traffic through a port
# LocalCluster
# ---------------------------------------------------------------------------

INGRESS_NODES, INGRESS_FILES = 4, 64
INGRESS_REQUESTS, INGRESS_QPS = 128, 100.0  # arms 1 and 3: one request each 10 ms on average
INGRESS_SESSIONS = dict(n_sessions=3, turns=3, suffix_len=16, budget=32)  # arm 2
INGRESS_KV_BYTES = 256 << 20  # each node's KV prefix cache
INGRESS_JOIN_SPAN = 132  # LocalCluster's runtime joiners take base + n + 100 onward


class _OneRequest:
    """A router's client verbs for one request, keeping its terminal (the
    load generator's Outcome keeps only whether it had a result)."""

    def __init__(self, ingress):
        self.ingress, self.rids, self.terminal = ingress, [], None

    async def submit(self, *a, **kw):
        rid = await self.ingress.submit(*a, **kw)
        self.rids.append(rid)
        return rid

    async def wait(self, rid, **kw):
        self.terminal = await self.ingress.wait(rid, **kw)
        return self.terminal


def _arm_summary(loadgen, outcomes, wall):
    s = loadgen.summarize(outcomes, wall)
    return {"requests": s["n"], "completed": s["completed"], "shed": s["shed"],
            "rejected": sum(o.terminal == "rejected" for o in outcomes),
            "lost": sum(o.terminal == "lost" for o in outcomes),
            "e2e_ms_p50": s["latency_ms"]["p50"], "e2e_ms_p99": s["latency_ms"]["p99"],
            "completed_per_s": s["completed"] / wall, "wall_s": wall,
            "shed_ratio": s["shed_ratio"]}


def _where_time_goes(metrics, js, since, model, wait0):
    """Medians (ms) of the coordinator's per-batch stages for `model`'s
    batches ACKed after `since` (a `batch_timing` length), and the router's
    mean admission-to-dispatch wait since the `wait0` snapshot."""
    rows = [r for r in list(js.batch_timing)[since:] if r["model"] == model]
    wait = _queue_wait(metrics)
    n, total = wait[0] - wait0[0], wait[1] - wait0[1]
    return dict({k: _median([r[k] * 1e3 for r in rows])
                 for k in ("fetch", "backend", "infer", "put", "exec")},
                batches=len(rows), queue_wait_ms_mean=total / n * 1e3 if n else None)


def _queue_wait(metrics):
    items = metrics.histogram("request_queue_wait_seconds").items()
    return sum(st[0] for _, st in items), sum(st[1] for _, st in items)


async def _run_ingress(tmp, engine, lm_make, out):
    """A port LocalCluster of INGRESS_NODES nodes with the front door,
    every node a JobService on `engine` and its own LM backend; arm 1
    (pinned image requests), arm 2 (streamed LM sessions), arm 3 (arm 1's
    trace with the leader crashed halfway). Fills `out`; returns what the
    checks after the main path need."""
    import asyncio
    import threading

    import torch
    from dml_tpu_torch.cluster.chaos import LocalCluster
    from dml_tpu_torch.config import Timing
    from dml_tpu_torch.ingress import loadgen
    from dml_tpu_torch.jobs.service import JobService
    from dml_tpu_torch.observability import METRICS

    backends = []

    def make_jobs(node, store):
        js = JobService(node, store, engine=engine)
        be = lm_make(kv=True)
        backends.append(be)
        js.register_lm("LM198M", backend=be.backend, cost=be.cost(),
                       patterns=("*.tokens.txt", "ingress_*.req"))
        return js

    base = free_port_block(INGRESS_NODES + INGRESS_JOIN_SPAN)
    c = LocalCluster(INGRESS_NODES, os.path.join(tmp, "cluster"), base, with_ingress=True,
                     make_jobs=make_jobs,
                     timing=Timing(ping_interval=0.2, ack_timeout=0.3, cleanup_time=1.0,
                                   leader_rpc_timeout=10.0))
    chunks, lock = [0], threading.Lock()
    dispatch = engine._dispatch_chunk

    def counted_dispatch(lm, chunk, *a, **kw):  # the workers' threads call it
        with lock:
            chunks[0] += 1
        return dispatch(lm, chunk, *a, **kw)

    def counter(name):
        return sum(v for _, v in METRICS.counter(name).items())

    try:
        t0 = time.monotonic()
        await c.start()
        await c.wait_for(c.converged, 30.0, "the port cluster's convergence")
        out["converge_s"] = time.monotonic() - t0
        client = c.client()
        rng = np.random.RandomState(18)
        imgs = np.clip(rng.randint(0, 256, (INGRESS_FILES, 256, 256, 3)) // 2
                       + rng.randint(0, 128, (INGRESS_FILES, 1, 1, 3)), 0, 255).astype(np.uint8)
        os.makedirs(os.path.join(tmp, "in"))
        files = write_images(os.path.join(tmp, "in"), imgs, "jpeg")
        for f in files:
            await client.store.put(f, os.path.basename(f))
        # one request before the counted run: the scheduler measures its costs
        warm = await client.ingress.request("ResNet50", store_name=os.path.basename(files[0]),
                                            timeout=120.0)
        check(warm.get("ok"), f"warm-up request: {warm}")
        trace = loadgen.open_loop_trace(18, 2.0 * INGRESS_REQUESTS / INGRESS_QPS, INGRESS_QPS,
                                        model="ResNet50")
        check(len(trace.arrivals) >= INGRESS_REQUESTS, "the trace is short")
        trace.arrivals = trace.arrivals[:INGRESS_REQUESTS]

        async def image_arm(kill_at=None):
            """The pinned image trace; returns (outcomes, wall, terminals,
            request ids per arrival, the crashed leader, where the time
            went)."""
            coord = c.nodes[c.leader_uname()].jobs
            since, wait0 = len(coord.batch_timing), _queue_wait(METRICS)
            recs, killed, n_sub = [None] * len(trace.arrivals), {}, [0]
            index = {id(a): i for i, a in enumerate(trace.arrivals)}

            async def submit(a):
                i = index[id(a)]
                n_sub[0] += 1
                if kill_at is not None and n_sub[0] == kill_at:
                    killed["leader"] = c.leader_uname()
                    killed["task"] = asyncio.ensure_future(c.crash_node(killed["leader"]))
                recs[i] = _OneRequest(client.ingress)
                return await loadgen.drive_one(
                    recs[i], a, store_name=os.path.basename(files[i % len(files)]),
                    submit_timeout=8.0, wait_timeout=90.0)

            outcomes, wall = await loadgen.run_open_loop(submit, trace)
            if "task" in killed:
                await killed["task"]
            return (outcomes, wall, [r.terminal for r in recs], [r.rids for r in recs],
                    killed.get("leader"),
                    _where_time_goes(METRICS, coord, since, "ResNet50", wait0))

        engine._dispatch_chunk = counted_dispatch
        arms, counts = {}, {}
        try:
            torch.cuda.synchronize()
            reset_launch_counts()
            # ---- arm 1: pinned image requests
            ch0 = chunks[0]
            arms["images"] = await image_arm()
            torch.cuda.synchronize()
            counts["images"] = dict(launch_counts(), chunks=chunks[0] - ch0)
            # ---- arm 2: streamed multi-turn LM sessions
            d0, l0 = server_dispatches(), launch_counts()
            hits0 = counter("request_session_affinity_hits_total")
            miss0 = counter("request_session_affinity_misses_total")
            kv0 = [be.kv_cache_stats() for be in backends]
            coord = c.nodes[c.leader_uname()].jobs
            since, wait0 = len(coord.batch_timing), _queue_wait(METRICS)
            strace = loadgen.multi_turn_trace(18, model="LM198M", slo="batch",
                                              vocab=LM_CFG["vocab_size"], **INGRESS_SESSIONS)
            s_out, s_wall, transcripts = await loadgen.run_sessions(
                client.ingress, strace, wait_timeout=120.0)
            torch.cuda.synchronize()
            l1 = launch_counts()
            d = {k: v - d0[k] for k, v in server_dispatches().items()}
            counts["sessions"] = dict({k: l1[k] - l0[k] for k in l1}, dispatches=d)
            kv1 = [be.kv_cache_stats() for be in backends]
            lm_stages = _where_time_goes(METRICS, coord, since, "LM198M", wait0)
            affinity = {"hits": counter("request_session_affinity_hits_total") - hits0,
                        "misses": counter("request_session_affinity_misses_total") - miss0}
            # ---- arm 3: arm 1's trace, the leader crashed at half the submits
            l2, ch2 = launch_counts(), chunks[0]
            arms["failover"] = await image_arm(kill_at=INGRESS_REQUESTS // 2)
            torch.cuda.synchronize()
            l3 = launch_counts()
            counts["failover"] = dict({k: l3[k] - l2[k] for k in l3}, chunks=chunks[0] - ch2)
            total = launch_counts()
        finally:
            engine._dispatch_chunk = dispatch
        conflicts = sum(sn.ingress.terminal_conflicts for sn in c.nodes.values()
                        if sn.ingress is not None)
    finally:
        await c.stop()
        for be in backends:
            be.close()
    # ---- what each arm must show
    for arm in ("images", "failover"):
        outcomes, wall, terms, rids = arms[arm][:4]
        check(len(outcomes) == INGRESS_REQUESTS and all(t is not None for t in terms),
              f"{arm}: {len(outcomes)} terminals for {INGRESS_REQUESTS} requests")
        check(all(o.terminal in ("completed", "shed", "rejected", "lost") for o in outcomes),
              f"{arm}: a terminal of no kind")
        done = [r[-1] for o, r in zip(outcomes, rids) if o.terminal == "completed"]
        check(len(set(done)) == len(done), f"{arm}: a request id completed twice")
        check(all(o.has_result for o in outcomes if o.terminal == "completed"),
              f"{arm}: a completion without its result")
        if arm == "images":
            check(not any(o.terminal == "lost" for o in outcomes), "images: a request was lost")
            check(sum(o.terminal == "completed" for o in outcomes) > 0, "images: none completed")
    check(conflicts == 0, f"{conflicts} terminal conflicts (a request settled twice)")
    check(any(o.terminal == "completed" for o in arms["failover"][0]),
          "failover: no request completed across the leader crash")
    for arm in ("images", "failover"):
        n = counts[arm]
        check(n["chunks"] > 0 and {k: n[k] for k in n if k != "chunks"} == {
            "normalize": n["chunks"], "flash_attention": 0, "flash_bwd": 0, "flash_bwd_delta": 0,
            "decode_attention": 0}, f"{arm}: launched {n} (K1 one a chunk)")
    n = counts["sessions"]
    want = check_server_launches("LM sessions", {k: n[k] for k in n if k != "dispatches"},
                                 n["dispatches"], LM_CFG["n_layers"], LMS_CHUNK)
    check(all(o.terminal == "completed" for o in s_out), "sessions: a turn did not complete")
    tokens = sum(len(t) for tx in transcripts.values() for t in tx)
    by_turn = {}
    for o in s_out:
        by_turn.setdefault(o.turn, []).append(o.ttft_s * 1e3)
    out["images"] = dict(_arm_summary(loadgen, arms["images"][0], arms["images"][1]),
                         stages_ms=arms["images"][5], launches=counts["images"])
    out["sessions"] = dict(
        _arm_summary(loadgen, s_out, s_wall), tokens=tokens, tokens_per_s=tokens / s_wall,
        ttft_ms_by_turn={t: {"p50": _pct(v, 50), "p99": _pct(v, 99)}
                         for t, v in sorted(by_turn.items())},
        session_affinity=affinity, stages_ms=lm_stages,
        kv_cache={k: sum(b[k] - a[k] for a, b in zip(kv0, kv1)) for k in kv1[0]
                  if isinstance(kv1[0][k], (int, float))},
        launches={k: v for k, v in n.items() if k != "dispatches"}, server_dispatches=n["dispatches"],
        formula=want)
    out["failover"] = dict(_arm_summary(loadgen, arms["failover"][0], arms["failover"][1]),
                           crashed_leader=arms["failover"][4], terminal_conflicts=conflicts,
                           stages_ms=arms["failover"][5],
                           launches=counts["failover"])
    out["launches"] = total
    images = {arm: [(files[i % len(files)], t["result"]) for i, (o, t) in
                    enumerate(zip(arms[arm][0], arms[arm][2])) if o.terminal == "completed"]
              for arm in ("images", "failover")}
    return total, images, strace, transcripts


def phase_ingress():
    """The request front door on a port LocalCluster (phase 18): pinned
    ResNet50 requests, streamed sessions of the 198M LM, and a leader crash
    mid-trace; returns the path's launches: K1, K2 and K4."""
    import asyncio

    import torch
    from dml_tpu_torch.inference import InferenceEngine
    from dml_tpu_torch.inference import generate as gen
    from dml_tpu_torch.inference.lm_backend import LMBackend, write_prompt_file
    from dml_tpu_torch.models.lm_params import init_lm_params
    from dml_tpu_torch.models.registry import get_model

    t_phase = time.monotonic()
    eng = InferenceEngine(dtype=torch.bfloat16)  # device None -> cuda
    check(eng.device.type == "cuda", f"engine on {eng.device}")
    eng.load_model("ResNet50", variables=seeded_weights(get_model("ResNet50"), seed=0),
                   batch_size=BATCH)
    cfg = gen.LMConfig(**LM_CFG, dtype=torch.bfloat16)
    params = gen.serving_params(init_lm_params(cfg, seed=0), cfg)

    def lm_make(kv):
        return LMBackend(params, cfg, max_new_tokens=64, max_slots=LMS_SLOTS,
                         max_len=LMS_MAX_LEN, chunk=LMS_CHUNK,
                         kv_cache_bytes=INGRESS_KV_BYTES if kv else 0)

    out = {"nodes": INGRESS_NODES, "files": INGRESS_FILES,
           "engine": f"{eng.device} {eng.dtype} b{BATCH}, one for all nodes",
           "lm": f"198M GQA-4 bf16 on every node: {LMS_SLOTS} slots, chunk {LMS_CHUNK}, "
                 f"KV prefix cache {INGRESS_KV_BYTES >> 20} MiB",
           "arms": {"images": f"{INGRESS_REQUESTS} ResNet50 requests, interactive, "
                              f"open loop at {INGRESS_QPS:g}/s, each pinned to one of "
                              f"{INGRESS_FILES} JPEGs",
                    "sessions": f"multi_turn_trace {INGRESS_SESSIONS}, batch class, streamed",
                    "failover": "the images arm's trace, the leader crashed at half the "
                                "submits"}}
    with tempfile.TemporaryDirectory() as tmp:
        total, images, strace, transcripts = asyncio.run(
            asyncio.wait_for(_run_ingress(tmp, eng, lm_make, out), 600))
        # completed image results against the engine called directly
        direct = {os.path.basename(k): v for k, v in
                  eng.infer_files("ResNet50", sorted({f for rows in images.values()
                                                     for f, _ in rows})).to_json_dict().items()}
        worst = 0.0
        for arm, rows in images.items():
            for f, got in rows:
                want = direct[os.path.basename(f)]
                check([r["wnid"] for r in got] == [r["wnid"] for r in want],
                      f"{arm} {os.path.basename(f)}: top-5 {[r['wnid'] for r in got]} != the "
                      f"engine's {[r['wnid'] for r in want]}")
                worst = max(worst, max(abs(a["score"] - b["score"]) for a, b in zip(got, want)))
        check(worst <= 1e-6, f"request scores differ from the engine's by {worst} (> 1e-6)")
        out["vs_engine_infer_files"] = {"max_abs_score_diff": worst, "bar": 1e-6}
        # each turn against the lone LMBackend serve of the same history
        turns, history = [], {}
        for a in sorted(strace.arrivals, key=lambda x: (x.session, x.turn)):
            got = transcripts[a.session][a.turn - 1]
            prompt = history.get(a.session, []) + list(a.suffix)
            turns.append((np.asarray(prompt, np.int32), int(a.budget), got))
            history[a.session] = prompt + got
        paths = []
        for i, (p, b, _) in enumerate(turns):
            paths.append(os.path.join(tmp, f"turn{i}.tokens.txt"))
            write_prompt_file(paths[-1], p, max_new_tokens=b)
        be = lm_make(kv=False)
        try:
            lone, _, _ = be.serve_files(paths)
        finally:
            be.close()
        equal = ties = 0
        for i, (p, b, got) in enumerate(turns):
            want = lone[paths[i]]["tokens"]
            check(len(got) == b, f"turn {i}: {len(got)} tokens, budget {b}")
            if got == want:
                equal += 1
                continue
            want_t, margins = lone_greedy(gen, params, cfg, p, b)
            held, upto, _, _ = tie_compare(got, want_t, margins)
            check(held, f"turn {i}: the session's tokens differ from the lone run at {upto} "
                        f"with no near-tie before it")
            ties += 1
        out["sessions"]["vs_lone_backend"] = {"turns": len(turns), "equal": equal,
                                              "held_to_a_near_tie": ties,
                                              "tie_margin": TIE_MARGIN}
    del params, eng
    torch.cuda.empty_cache()
    out["phase_s"] = time.monotonic() - t_phase
    emit(phase="ingress", **out)
    return {"normalize": {"ResNet50": total["normalize"]},
            "flash_attention": total["flash_attention"],
            "decode_attention": total["decode_attention"]}


# ---------------------------------------------------------------------------
# phase 19: the other image families
# ---------------------------------------------------------------------------

FAMILY_MODELS = (("MobileNetV2", "tf"), ("EfficientNetB0", "raw"), ("EfficientNetB4", "raw"),
                 ("ViT-B16", "tf"))
FAMILY_TRAIN_BATCH, FAMILY_TRAIN_STEPS = 16, 3
FAMILY_CHECK_IMAGES = 4  # top-1 against the float32 engines
VIT_BLOCKS = 12  # ViT-B16's encoder blocks: one K2 launch (and K3, delta) each


def family_launches(name, mode, chunks=1, train=False):
    """The launches a families path must make per `chunks` engine chunks
    (or train steps): K1 once each in `tf` mode (EfficientNet's `raw` mode
    is a cast), and for ViT-B16 one K2 a block, in training one K3 and one
    delta kernel a block too."""
    vit = VIT_BLOCKS * chunks if name.startswith("ViT") else 0
    return {"normalize": chunks if mode == "tf" else 0, "flash_attention": vit,
            "flash_bwd": vit if train else 0, "flash_bwd_delta": vit if train else 0,
            "decode_attention": 0}


def _f32_probs(name, sd, few):
    """Probabilities of `few` from the port's float32 CPU engine and its
    float32 CUDA engine with TF32 off."""
    import torch
    from dml_tpu_torch.inference import InferenceEngine

    cpu = InferenceEngine(dtype=torch.float32, device="cpu")
    cpu.load_model(name, variables=sd, batch_size=len(few), warmup=False)
    p_cpu = cpu.infer_arrays(name, few)
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        g32 = InferenceEngine(dtype=torch.float32)
        g32.load_model(name, variables=sd, batch_size=len(few), warmup=False)
        p_g32 = g32.infer_arrays(name, few)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    return p_cpu, p_g32


def register_b4_s2d():
    """EfficientNetB4 with the space-to-depth stem, as a model of its own
    (the same weights load into it)."""
    import torch
    from dml_tpu_torch.models.efficientnet import build_variant
    from dml_tpu_torch.models.registry import ModelSpec, get_model, register

    b4 = get_model("EfficientNetB4")

    def build(num_classes=1000, dtype=torch.bfloat16, param_dtype=None):
        return build_variant("b4", num_classes=num_classes, dtype=dtype,
                             param_dtype=param_dtype, s2d_stem=True)

    return register(ModelSpec(name="EfficientNetB4-s2d", builder=build,
                              input_size=b4.input_size, preprocess=b4.preprocess, cost=b4.cost))


def phase_families(timer):
    """MobileNetV2, EfficientNet-B0 and -B4 and ViT-B16 at b32 bf16 served
    through InferenceEngine on cuda and trained through the image Trainer,
    counted. Returns each kernel's launches on the path."""
    import torch
    from dml_tpu_torch.inference import InferenceEngine
    from dml_tpu_torch.models.preprocess import normalize_on_device
    from dml_tpu_torch.models.registry import get_model
    from dml_tpu_torch.parallel.train import Trainer

    t_phase = time.monotonic()
    total = dict.fromkeys(launch_counts(), 0)
    chunks = -(-N_IMAGES // BATCH)
    for name, mode in FAMILY_MODELS:
        t_model = time.monotonic()
        spec = get_model(name)
        check(spec.preprocess == mode, f"{name}: preprocess {spec.preprocess}, want {mode}")
        h, w = spec.input_size
        sd = seeded_weights(spec, seed=0)
        imgs, _ = _seeded_batch(np.random.RandomState(19), N_IMAGES, h, w, 1000)
        eng = InferenceEngine(dtype=torch.bfloat16)  # device None -> cuda
        check(eng.device.type == "cuda", f"engine on {eng.device}")
        t0 = time.monotonic()
        lm = eng.load_model(name, variables=sd, batch_size=BATCH)
        load_s = time.monotonic() - t0

        # ---- the main path, counted: serving ----
        reset_launch_counts()
        probs = eng.infer_arrays(name, imgs)
        torch.cuda.synchronize()
        serve = launch_counts()
        want = family_launches(name, mode, chunks)
        check(serve == want, f"{name}: serving launched {serve}, want {want} for {chunks} chunks")
        _add(total, serve)
        check(probs.shape == (N_IMAGES, 1000) and np.isfinite(probs).all(),
              f"{name}: probs {probs.shape}, finite {np.isfinite(probs).all()}")
        row_err = float(np.abs(probs.sum(-1) - 1.0).max())
        check(row_err <= 1e-2, f"{name}: rows sum to 1 +- {row_err}")
        top1 = probs.argmax(-1)

        # the same module fed by the plain normalize
        with torch.inference_mode():
            plain = []
            for s in range(0, N_IMAGES, BATCH):
                chunk = imgs[s:s + BATCH]
                pad = np.zeros((BATCH - len(chunk), h, w, 3), np.uint8)
                x = torch.from_numpy(np.concatenate([chunk, pad])).cuda()
                plain.append(lm.module(normalize_on_device(x, mode, torch.bfloat16))[:len(chunk)]
                             .float().cpu().numpy())
        plain = np.concatenate(plain)
        check((plain.argmax(-1) == top1).all(), f"{name}: top-1 differs from the plain-normalize run")

        # float32 on the CPU against the card: f32 (TF32 off) exactly in
        # top-1, bf16 wherever the f32 top-1 leads by TIE_MARGIN in log-prob
        few = imgs[:FAMILY_CHECK_IMAGES]
        p_cpu, p_g32 = _f32_probs(name, sd, few)
        cpu_top1 = p_cpu.argmax(-1)
        srt = np.sort(np.log(p_cpu + 1e-30), -1)
        margins = (srt[:, -1] - srt[:, -2]).tolist()
        held = [m >= TIE_MARGIN for m in margins]
        f32_diff = float(np.abs(p_g32 - p_cpu).max())
        check((p_g32.argmax(-1) == cpu_top1).all() and f32_diff <= 1e-4,
              f"{name}: f32 cuda top-1 {p_g32.argmax(-1)} != cpu {cpu_top1} or probabilities "
              f"{f32_diff} apart")
        check(all(t == c for t, c, k in zip(top1, cpu_top1, held) if k),
              f"{name}: bf16 cuda top-1 {top1[:len(few)]} != f32 cpu {cpu_top1} (margins {margins})")

        # device time of one forward (normalize + model), L2 flushed
        xb = torch.from_numpy(imgs[:BATCH]).cuda()
        fwd_ms = timer.ms(lambda: eng._forward(lm, xb), iters=10, warmup=2)
        extra = {}
        if name == "EfficientNetB4":
            # the space-to-depth stem on the same weights, timed in turns
            # with the stock stem (stock, s2d, s2d, stock)
            s2d_name = register_b4_s2d().name
            lm2 = eng.load_model(s2d_name, variables=sd, batch_size=BATCH)
            p2 = eng.infer_arrays(s2d_name, imgs)
            turns = {"stock": [], "s2d": []}
            for key in ("stock", "s2d", "s2d", "stock"):
                turns[key].append(timer.ms(lambda key=key: eng._forward(
                    lm if key == "stock" else lm2, xb), iters=10, warmup=2))
            check(np.isfinite(p2).all(), "s2d stem: non-finite probabilities")
            extra["s2d_stem"] = dict(
                max_abs_diff=float(np.abs(p2 - probs).max()),
                top1_equal=int((p2.argmax(-1) == top1).sum()), images=N_IMAGES,
                forward_ms={k: statistics.mean(v) for k, v in turns.items()}, turns_ms=turns)
            eng.unload_model(s2d_name)
        mem_serve = torch.cuda.max_memory_allocated() / 1e6
        first_query_s = lm.first_query
        del eng, lm
        torch.cuda.empty_cache()

        # ---- the main path, counted: training ----
        x_np, y_np = _seeded_batch(np.random.RandomState(20), FAMILY_TRAIN_BATCH, h, w, 1000)
        x, y = torch.from_numpy(x_np).cuda(), torch.from_numpy(y_np).cuda()
        tr = Trainer(name, batch_size=FAMILY_TRAIN_BATCH, dtype=torch.bfloat16, seed=0)
        check(tr.device.type == "cuda", f"Trainer on {tr.device}")
        warm = tr.step(x, y)
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        per_step = family_launches(name, mode, train=True)
        losses, accs, step_ms = _counted_steps(tr, x, y, FAMILY_TRAIN_STEPS, per_step)
        trained = launch_counts()
        _add(total, trained)
        check(all(np.isfinite(losses)), f"{name}: non-finite loss {losses}")
        check(all(p.dtype == torch.float32 for p in tr.params.values()),
              f"{name}: master weights not float32")
        med = statistics.median(step_ms)
        emit(phase="families", model=name, mode=mode, image=[h, w], dtype="bfloat16",
             batch=BATCH, load_s=load_s, first_query_s=first_query_s,
             serve_launches=serve, chunks=chunks, row_sum_err=row_err,
             plain_normalize_max_abs_diff=float(np.abs(plain - probs).max()),
             top1=top1.tolist(), top1_cpu_f32=cpu_top1.tolist(), cpu_f32_log_margin=margins,
             bf16_held_to_cpu=sum(held),
             cuda_f32_vs_cpu_f32_max_abs=f32_diff,
             forward_device_ms=fwd_ms, images_per_s_forward=BATCH / (fwd_ms / 1e3),
             max_memory_allocated_mb_serve=mem_serve,
             train=dict(batch=FAMILY_TRAIN_BATCH, optimizer="AdamW lr 1e-3 wd 1e-4",
                        warmup_loss=warm["loss"], losses=losses, accuracies=accs,
                        launches=trained, launches_per_step=per_step, step_ms=step_ms,
                        step_ms_median=med, images_per_s=FAMILY_TRAIN_BATCH / (med / 1e3),
                        max_memory_allocated_mb=torch.cuda.max_memory_allocated() / 1e6),
             model_s=time.monotonic() - t_model, **extra)
        del tr, x, y
        torch.cuda.empty_cache()
    emit(phase="families_total", launches=total, phase_s=time.monotonic() - t_phase)
    return total


# ---------------------------------------------------------------------------
# phase 20: the worker groups' sharded backends
# ---------------------------------------------------------------------------

GROUP_NODES, GROUP_FILES, GROUP_QUERIES = 4, 64, 64
GROUP_LM_PROMPTS, GROUP_SLAB_PROMPTS = 8, 4  # phase 12's stream: its first 8, then first 4
GROUP_LM_SPEC = dict(LM_SPEC, name="LM198M")
GROUP_TIMING = dict(ping_interval=0.2, ack_timeout=0.5, cleanup_time=1.5,
                    leader_rpc_timeout=20.0)


async def _group_cluster(tmp, group, make_jobs):
    """A started port LocalCluster of GROUP_NODES nodes with one worker
    group. H1 leads and H2 is the standby, so a group of H3 and H4 is the
    whole pool: every batch runs on its primary's group backend."""
    from dml_tpu_torch.cluster.chaos import LocalCluster
    from dml_tpu_torch.config import Timing

    c = LocalCluster(GROUP_NODES, tmp, free_port_block(GROUP_NODES),
                     timing=Timing(**GROUP_TIMING), worker_groups=[group], make_jobs=make_jobs)
    await c.start()
    await c.wait_for(c.converged, 30.0, "group cluster convergence")
    check(c.leader_uname() == c.spec.node_by_name("H1").unique_name,
          f"leader {c.leader_uname()}, want H1")
    return c


async def _run_group_images(tmp, eng, files, out):
    """img0 = H3 (primary) + H4 at dp 1 x tp 1: every node wired as a
    production node is (`wire_group_backend`), so H3 serves on the lazy
    `group_engine_backend` and the others on the shared engine. The group
    engine takes the engine's weights through the store (H3 publishes
    them and loads them back, which calls its `set_variables`), then a
    ResNet50 job of GROUP_QUERIES queries runs on it. Returns the merged
    output, K1 launches and the group engine's chunks."""
    import threading

    import torch
    from dml_tpu_torch.config import MeshSpec, WorkerGroupSpec
    from dml_tpu_torch.jobs.groups import wire_group_backend
    from dml_tpu_torch.jobs.service import JobService
    from dml_tpu_torch.observability import METRICS
    from dml_tpu_torch.parallel import inference as pinf

    group = WorkerGroupSpec("img0", ("H3", "H4"), MeshSpec(dp=1, tp=1))
    gbs = {}

    def make_jobs(node, store):
        gb = wire_group_backend(node)
        if gb is not None:
            gbs[node.me.name] = gb
        js = JobService(node, store, engine=eng, group_backend=gb)
        js.scheduler.set_batch_size("ResNet50", BATCH)
        return js

    c = await _group_cluster(tmp, group, make_jobs)
    chunks, lock = [0], threading.Lock()
    forward = pinf.ShardedInference._forward

    def counted(self, rows):
        with lock:
            chunks[0] += 1
        return forward(self, rows)

    pinf.ShardedInference._forward = counted
    try:
        check(sorted(gbs) == ["H3"], f"group engines wired on {sorted(gbs)}, want H3 only")
        gb = gbs["H3"]
        primary = c.nodes[c.spec.node_by_name("H3").unique_name].jobs
        await primary.publish_model("ResNet50")
        await primary.load_model_weights("ResNet50")
        client = c.client()
        for f in files:
            await client.store.put(f, os.path.basename(f))
        key = "jobs_group_batches_total{group=img0}"
        batches0 = METRICS.snapshot()["counters"].get(key, 0.0)
        coord = c.nodes[c.leader_uname()].jobs
        timing0 = len(coord.batch_timing)
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.monotonic()
        jid = await client.jobs.submit_job("ResNet50", GROUP_QUERIES)
        done = await client.jobs.wait_job(jid, timeout=300.0)
        wall = time.monotonic() - t0
        torch.cuda.synchronize()
        launches = launch_counts()
        check(done["total_queries"] == GROUP_QUERIES, f"group image job: {done}")
        merged = await client.jobs.get_output(jid, os.path.join(tmp, f"final_{jid}.json"))
        gstats = coord.group_stats()["img0"]
        batches = METRICS.snapshot()["counters"].get(key, 0.0) - batches0
        timing = list(coord.batch_timing)[timing0:]
    finally:
        pinf.ShardedInference._forward = forward
        await c.stop()
    check(gstats["formed"], f"img0 not formed: {gstats}")
    engines = sorted(f"{m} dp{s[0]} tp{s[1]} pp{s[2]}" for m, s in gb.engines)
    check(engines == ["ResNet50 dp1 tp1 pp1"], f"group engines {engines}")
    check(batches == len(timing) and batches >= 1,
          f"{batches} group-served batches for {len(timing)} batches")
    check(launches == {"normalize": chunks[0], "flash_attention": 0, "flash_bwd": 0,
                       "flash_bwd_delta": 0, "decode_attention": 0},
          f"the group image job launched {launches} for {chunks[0]} group-engine chunks")
    per_query = sorted(s["exec"] * 1e3 for s in timing for _ in range(BATCH))
    out["image"] = {
        "group": "img0 = H3 (primary) + H4, dp 1 x tp 1 at world 1, param_gather",
        "job": jid, "queries": GROUP_QUERIES, "wall_s": wall,
        "images_per_s": GROUP_QUERIES / wall, "group_batches": batches,
        "batch_exec_ms": [s["exec"] * 1e3 for s in timing],
        "query_exec_ms_p50": _pct(per_query, 50), "query_exec_ms_p99": _pct(per_query, 99),
        "capacity": gb.capacity, "engines": engines, "chunks": chunks[0],
        "launches": launches}
    return merged, launches


async def _run_group_lm(tmp, eng, single, lm_files, out):
    """tp0 = H3 (decode primary) + H4 (prefill role) at dp 1 x tp 1, every
    node wired by `wire_lm_group`: H3 serves on `DisaggLMBackend` over the
    resident engine, H4 prefills on `LMPrefillBackend`. Three arms through
    H3's backend, with the launch counts of each: (a) a job of the 8
    prompts, the streamed handoff; (b) the 8 prompts with H3's data plane
    failing every pull, the whole-slab form, so each request falls back
    to a local prefill; (c) the first 4 prompts, the whole-slab form.
    Then H4 is crashed and the backend refuses a batch (GroupDegraded)."""
    import torch
    from dml_tpu_torch.cluster.store.data_plane import TunnelFault
    from dml_tpu_torch.config import MeshSpec, WorkerGroupSpec
    from dml_tpu_torch.inference.lm_sharded import DisaggLMBackend, wire_lm_group
    from dml_tpu_torch.jobs.groups import GroupDegraded
    from dml_tpu_torch.jobs.service import JobService

    group = WorkerGroupSpec("tp0", ("H3", "H4"), MeshSpec(dp=1, tp=1),
                            lm_models=(GROUP_LM_SPEC["name"],),
                            roles={"H3": "decode", "H4": "prefill"})
    wired = {}

    def make_jobs(node, store):
        gb, pf = wire_lm_group(node, store, GROUP_LM_SPEC)
        wired[node.me.name] = (gb, pf, store, node)
        js = JobService(node, store, engine=eng)
        js.register_lm(GROUP_LM_SPEC["name"], backend=single.backend, cost=single.cost(),
                       group_backend=gb, prefill=pf)
        return js

    c = await _group_cluster(tmp, group, make_jobs)
    arms = {}
    try:
        roles = {k: (type(v[0]).__name__ if v[0] else None, type(v[1]).__name__ if v[1] else None)
                 for k, v in wired.items()}
        check(roles == {"H1": (None, None), "H2": (None, None),
                        "H3": ("DisaggLMBackend", None), "H4": (None, "LMPrefillBackend")},
              f"wire_lm_group roles {roles}")
        gb, _, store3, node3 = wired["H3"]
        pf = wired["H4"][1]
        check(isinstance(gb, DisaggLMBackend) and gb.handoff == "stream", "H3's backend")
        prefills = [0]
        prefill_one = pf.prefill_one

        def counted_prefill(*a, **kw):
            prefills[0] += 1
            return prefill_one(*a, **kw)

        pf.prefill_one = counted_prefill
        client = c.client(avoid=tuple(c.spec.group_members_unique("tp0")))
        for f in lm_files:
            await client.store.put(f, os.path.basename(f))

        async def arm(name, run):
            torch.cuda.synchronize()
            d0, p0 = server_dispatches(), prefills[0]
            h0, f0, b0 = gb.handoffs, gb.fallbacks, gb.handoff_bytes
            reset_launch_counts()
            t0 = time.monotonic()
            results = await run()
            wall = time.monotonic() - t0
            torch.cuda.synchronize()
            launches = launch_counts()
            d = {k: v - d0[k] for k, v in server_dispatches().items()}
            remote = prefills[0] - p0
            want = {"normalize": 0, "flash_bwd": 0, "flash_bwd_delta": 0,
                    "flash_attention": LM_CFG["n_layers"] * (remote + d["prefill"]),
                    "decode_attention": LM_CFG["n_layers"] * LMS_CHUNK * d["steps"]}
            check(launches == want, f"arm {name}: launched {launches}; {remote} prefill-role "
                                    f"prefills and the decode server's dispatches {d} give {want}")
            tokens = sum(len(v["tokens"]) for v in results.values())
            arms[name] = {"wall_s": wall, "tokens": tokens, "tokens_per_s": tokens / wall,
                          "ttft_s": gb.last_ttft_s, "handoffs": gb.handoffs - h0,
                          "fallbacks": gb.fallbacks - f0, "handoff_bytes": gb.handoff_bytes - b0,
                          "prefill_role_prefills": remote, "decode_server_dispatches": d,
                          "launches": launches}
            return {os.path.basename(k): v["tokens"] for k, v in results.items()}

        async def job():
            jid = await client.jobs.submit_job(GROUP_LM_SPEC["name"], GROUP_LM_PROMPTS)
            done = await client.jobs.wait_job(jid, timeout=300.0)
            check(done["total_queries"] == GROUP_LM_PROMPTS, f"group LM job: {done}")
            return await client.jobs.get_output(jid, os.path.join(tmp, f"final_{jid}.json"))

        async def run_direct(paths):
            return (await gb(GROUP_LM_SPEC["name"], paths))[0]

        got = {"stream": await arm("stream", job)}
        gb.handoff = "slab"
        store3.data_plane.fault = TunnelFault(seed=3, fail_pct=100.0)
        got["fallback"] = await arm("fallback", lambda: run_direct(lm_files))
        store3.data_plane.fault = None
        got["slab"] = await arm("slab", lambda: run_direct(lm_files[:GROUP_SLAB_PROMPTS]))
        h4 = c.spec.node_by_name("H4").unique_name
        await c.crash_node(h4)
        await c.wait_for(lambda: h4 not in {n.unique_name for n in node3.membership.alive_nodes()},
                         30.0, "H4 seen dead by H3")
        degraded = False
        try:
            await gb(GROUP_LM_SPEC["name"], lm_files[:1])
        except GroupDegraded:
            degraded = True
        check(degraded, "H3's backend served a batch with its prefill member dead")
        gb.be.close()
    finally:
        await c.stop()
    check((arms["stream"]["handoffs"], arms["stream"]["fallbacks"]) == (GROUP_LM_PROMPTS, 0),
          f"arm stream: {arms['stream']}")
    check((arms["fallback"]["handoffs"], arms["fallback"]["fallbacks"]) == (0, GROUP_LM_PROMPTS),
          f"arm fallback: {arms['fallback']}")
    check((arms["slab"]["handoffs"], arms["slab"]["fallbacks"]) == (GROUP_SLAB_PROMPTS, 0),
          f"arm slab: {arms['slab']}")
    check(arms["stream"]["handoff_bytes"] > 0 and arms["slab"]["handoff_bytes"] > 0,
          "no slab bytes pulled")
    out["lm"] = {"group": "tp0 = H3 (decode, resident form at dp 1 x tp 1) + H4 (prefill)",
                 "arms": arms, "degraded_after_H4_crashed": degraded,
                 "handoffs": gb.handoffs, "fallbacks": gb.fallbacks,
                 "handoff_bytes": gb.handoff_bytes}
    return got


def phase_groups(timer):
    """The worker groups' sharded backends on port LocalClusters (phase
    20): a ResNet50 job on an image group's lazy group engine, and LM jobs
    through a role-split group's disaggregated decode primary and its
    prefill member; returns the path's launches: K1, K2 and K4."""
    import asyncio

    import torch
    from dml_tpu_torch.inference import InferenceEngine
    from dml_tpu_torch.inference import generate as gen
    from dml_tpu_torch.inference.lm_backend import LMBackend, write_prompt_file
    from dml_tpu_torch.inference.lm_sharded import lm_spec_parts_cached
    from dml_tpu_torch.models.registry import get_model

    t_phase = time.monotonic()
    eng = InferenceEngine(dtype=torch.bfloat16)  # device None -> cuda
    check(eng.device.type == "cuda", f"engine on {eng.device}")
    eng.load_model("ResNet50", variables=seeded_weights(get_model("ResNet50"), seed=0),
                   batch_size=BATCH)
    single = LMBackend.from_spec(GROUP_LM_SPEC)  # the single-device LM backend of every node
    out = {"nodes": GROUP_NODES, "engine": f"{eng.device} {eng.dtype} b{BATCH}, one for all nodes",
           "lm": f"198M GQA-4 bf16: {LMS_SLOTS} slots, chunk {LMS_CHUNK}"}
    with tempfile.TemporaryDirectory() as tmp:
        rng = np.random.RandomState(20)
        imgs = np.clip(rng.randint(0, 256, (GROUP_FILES, 256, 256, 3)) // 2
                       + rng.randint(0, 128, (GROUP_FILES, 1, 1, 3)), 0, 255).astype(np.uint8)
        os.makedirs(os.path.join(tmp, "in"))
        files = write_images(os.path.join(tmp, "in"), imgs, "jpeg")
        lm_files = []
        reqs = mixed_requests(LM_CFG["vocab_size"])[:GROUP_LM_PROMPTS]
        for i, (p, b) in enumerate(reqs):
            lm_files.append(os.path.join(tmp, "in", f"p{i}.tokens.txt"))
            write_prompt_file(lm_files[-1], p, max_new_tokens=b)
        merged, image_launches = asyncio.run(asyncio.wait_for(
            _run_group_images(os.path.join(tmp, "img"), eng, files, out), 300))
        direct = {os.path.basename(k): v for k, v in
                  eng.infer_files("ResNet50", files).to_json_dict().items()}
        check(set(merged) == set(direct), "group job keys != the files")
        worst = 0.0
        for f, rows in merged.items():
            check([r["wnid"] for r in rows] == [r["wnid"] for r in direct[f]],
                  f"group {f}: top-5 {[r['wnid'] for r in rows]} != the engine's "
                  f"{[r['wnid'] for r in direct[f]]}")
            worst = max(worst, max(abs(a["score"] - b["score"]) for a, b in zip(rows, direct[f])))
        check(worst <= 1e-6, f"group scores differ from the engine's by {worst} (> 1e-6)")
        out["image"]["vs_engine_infer_files"] = {"max_abs_score_diff": worst, "bar": 1e-6}

        got = asyncio.run(asyncio.wait_for(
            _run_group_lm(os.path.join(tmp, "lm"), eng, single, lm_files, out), 300))
        lone, _, _ = single.serve_files(lm_files)
        lone = {os.path.basename(k): v["tokens"] for k, v in lone.items()}
        params, cfg = lm_spec_parts_cached(GROUP_LM_SPEC)
        margins_of = {}
        for arm, toks in got.items():
            equal = ties = 0
            for i, (p, b) in enumerate(reqs):
                name = f"p{i}.tokens.txt"
                if name not in toks:
                    continue
                check(len(toks[name]) == b, f"{arm} {name}: {len(toks[name])} tokens, budget {b}")
                if list(toks[name]) == list(lone[name]):
                    equal += 1
                    continue
                if i not in margins_of:
                    margins_of[i] = lone_greedy(gen, params, cfg, p, b)
                held, upto, _, _ = tie_compare(toks[name], *margins_of[i])
                check(held, f"{arm} {name}: tokens differ from the lone serve at {upto} with no "
                            f"near-tie before it")
                ties += 1
            out["lm"]["arms"][arm]["vs_lone_backend"] = {
                "requests": len(toks), "equal": equal, "held_to_a_near_tie": ties,
                "tie_margin": TIE_MARGIN}
    single.close()
    lm = [a["launches"] for a in out["lm"]["arms"].values()]
    total = {"normalize": {"ResNet50": image_launches["normalize"]},
             "flash_attention": sum(x["flash_attention"] for x in lm),
             "decode_attention": sum(x["decode_attention"] for x in lm)}
    del eng, single, params
    torch.cuda.empty_cache()
    out["phase_s"] = time.monotonic() - t_phase
    emit(phase="groups", handoffs=out["lm"]["handoffs"], fallbacks=out["lm"]["fallbacks"],
         handoff_bytes=out["lm"]["handoff_bytes"], launches=total, **out)
    return total


# ---------------------------------------------------------------------------
# phase 21: the operator's entry points, `python -m dml_tpu_torch` as processes
# ---------------------------------------------------------------------------

CLI_NODES, CLI_FILES, CLI_QUERIES = 3, 32, 32
CLI_LM_PROMPTS = 4  # the first 4 requests of phase 12's mixed-budget stream
CLI_LM_SPEC = dict(LM_SPEC, name="LM198M")
# a node's `profile trace start` and `stop` hold its event loop for
# seconds (torch.profiler's start, the trace's export): a peer suspects
# it then, and the cleanup time keeps a suspect from being declared dead
CLI_TIMING = dict(ping_interval=0.2, ack_timeout=1.0, cleanup_time=30.0, leader_rpc_timeout=20.0)
CLI_START_S, CLI_REPLY_S = 180.0, 120.0  # the first reply (a node's start), and each verb's
#: device kernels counted in each node process's torch.profiler trace
CLI_TRACE_KERNELS = {"normalize": "normalize_vec_kernel", "flash_attention": "flash_fwd",
                     "decode_attention": "decode_kernel"}


class ReplPipe:
    """A node process's REPL driven over its stdin: each verb is followed
    by an unknown one, whose `unknown command` reply ends the verb's
    output; a verb with no reply within its time limit fails the phase."""

    def __init__(self, proc, name):
        import queue
        import threading

        self.proc, self.name, self.n = proc, name, 0
        self.lines = queue.Queue()
        threading.Thread(target=self._read, daemon=True).start()

    def _read(self):
        for line in self.proc.stdout:
            self.lines.put(line.rstrip("\n"))
        self.lines.put(None)

    def send(self, cmd):
        """Write `cmd` and its end mark; `reply` reads what it printed."""
        self.n += 1
        self.proc.stdin.write(f"{cmd}\n__end_{self.n}\n")
        self.proc.stdin.flush()
        return cmd

    def reply(self, cmd, timeout=CLI_REPLY_S):
        import queue

        mark = f"__end_{self.n}"
        out, until = [], time.monotonic() + timeout
        while True:
            try:
                line = self.lines.get(timeout=max(0.0, until - time.monotonic()))
            except queue.Empty:
                raise AssertionError(f"{self.name} `{cmd}`: no reply in {timeout} s; "
                                     f"got {out[-20:]}") from None
            check(line is not None, f"{self.name} `{cmd}`: the node exited; got {out[-20:]}")
            if f"unknown command '{mark}'" in line:
                check(not any(ln.startswith("!! ") for ln in out),
                      f"{self.name} `{cmd}` failed: {out[-20:]}")
                return out
            out.append(line)

    def run(self, cmd, timeout=CLI_REPLY_S):
        return self.reply(self.send(cmd), timeout)

    def json(self, cmd, timeout=CLI_REPLY_S):
        return json.loads("\n".join(self.run(cmd, timeout)))


def _tail(path, n=20):
    try:
        with open(path, errors="replace") as f:
            return "".join(f.readlines()[-n:])
    except OSError:
        return ""


def _joined_at(log_path, name):
    """The wall time of the node's first `joined` or `is the leader` log
    line (cli's file log): the first node of a cluster leads without a
    join."""
    import datetime
    import re

    with open(log_path, errors="replace") as f:
        for line in f:
            m = re.match(r"(\S+ \S+) INFO \S+: (\S+) (joined|is the leader)", line)
            if m and m.group(2).startswith(name):
                return datetime.datetime.strptime(m.group(1), "%Y-%m-%d %H:%M:%S,%f").timestamp()
    return None


def _cluster_counters(repl):
    """Counters and histogram counts summed over every node process
    (`profile metrics cluster`: the leader pulls each node's registry)."""
    view = repl.json("profile metrics cluster")
    check(view["merged_from"] == CLI_NODES, f"metrics from {view['nodes_reporting']} only")
    s = view["summary"]
    return {"resnet50_batches": s["counters"].get("worker_batches_total{model=ResNet50}", 0.0),
            "lm_batches": s["counters"].get(f"worker_batches_total{{model={CLI_LM_SPEC['name']}}}",
                                            0.0),
            "prefill": s["histograms"].get("lm_server_prefill_dispatch_seconds",
                                           {}).get("count", 0),
            "steps": s["counters"].get("lm_server_steps_total", 0.0)}


def _trace_kernels(logdir):
    """Device kernels of each name in CLI_TRACE_KERNELS in the Chrome
    traces that `profile trace stop` wrote under `logdir`."""
    import glob

    counts = {k: 0 for k in CLI_TRACE_KERNELS}
    paths = glob.glob(os.path.join(logdir, "*.json"))
    check(paths, f"no trace written under {logdir}")
    for p in paths:
        with open(p) as f:
            events = json.load(f).get("traceEvents", [])
        for e in events:
            if e.get("cat") == "kernel":
                for k, pat in CLI_TRACE_KERNELS.items():
                    counts[k] += pat in e.get("name", "")
    return counts


def _drive_cli(tmp, out):
    """The introducer and CLI_NODES node processes on probed ports, each
    node's REPL over a pipe: H1's drives the verbs, every node traces its
    device from the first job to the last kernel. Returns the merged
    outputs, the files and the launches read from the traces."""
    import re
    import signal

    from dml_tpu_torch import config
    from dml_tpu_torch.inference.lm_backend import write_prompt_file

    base = free_port_block(CLI_NODES)
    spec_path, lm_path = os.path.join(tmp, "spec.json"), os.path.join(tmp, "lm.json")
    subprocess.run([sys.executable, "-m", "dml_tpu_torch", "localspec", "-n", str(CLI_NODES),
                    "--base-port", str(base), "-o", spec_path],
                   cwd=tmp, env=_cli_env(), check=True, timeout=120)
    # the operator's edits: the introducer beside the nodes, the store
    # under tmp, this phase's failure-detector timing
    with open(spec_path) as f:
        raw = json.load(f)
    raw["introducer"]["port"] = base - 1
    raw["store"].update(root=os.path.join(tmp, "roots"), download_dir=os.path.join(tmp, "dl"))
    raw["timing"].update(CLI_TIMING)
    with open(spec_path, "w") as f:
        json.dump(raw, f, indent=2)
    with open(spec_path) as f:
        spec = config.ClusterSpec.from_json(f.read())
    check([n.port for n in spec.nodes] == list(range(base, base + CLI_NODES)),
          f"localspec's ports {[n.port for n in spec.nodes]}, want from {base}")
    with open(lm_path, "w") as f:
        json.dump(CLI_LM_SPEC, f)
    imgs = np.clip(np.random.RandomState(21).randint(0, 256, (CLI_FILES, 256, 256, 3)) // 2
                   + np.random.RandomState(22).randint(0, 128, (CLI_FILES, 1, 1, 3)),
                   0, 255).astype(np.uint8)
    os.makedirs(os.path.join(tmp, "in"))
    files = write_images(os.path.join(tmp, "in"), imgs, "jpeg")
    lm_files = []
    for i, (p, b) in enumerate(mixed_requests(CLI_LM_SPEC["vocab_size"])[:CLI_LM_PROMPTS]):
        lm_files.append(os.path.join(tmp, f"p{i}.tokens.txt"))
        write_prompt_file(lm_files[-1], p, max_new_tokens=b)

    def start(name, *argv, **kw):
        log = os.path.join(tmp, f"{name}.log")
        err = open(os.path.join(tmp, f"{name}.err"), "w")
        kw.setdefault("stdout", err)  # only the REPL node's stdout is read
        procs[name] = (subprocess.Popen(
            [sys.executable, "-u", "-m", "dml_tpu_torch", "--log-file", log, *argv],
            cwd=tmp, env=_cli_env(), stderr=err, text=True, **kw), time.time())
        err.close()

    def fail_info():
        return "\n".join(f"--- {n}: rc {p.poll()}\n{_tail(os.path.join(tmp, n + '.err'))}"
                         f"{_tail(os.path.join(tmp, n + '.log'), 5)}"
                         for n, (p, _) in procs.items())

    procs, repls = {}, {}
    node = ["node", "--spec", spec_path, "--lm-spec", lm_path]
    try:
        start("DNS", "introducer", "--spec", spec_path)
        for n in spec.nodes:
            start(n.name, *node, "--name", n.name, stdin=subprocess.PIPE, stdout=subprocess.PIPE)
            repls[n.name] = ReplPipe(procs[n.name][0], n.name)
        repl = repls["H1"]
        try:
            def on_all(cmd, timeout=CLI_REPLY_S):
                """`cmd(node)` (or `cmd`) on every node at once; each node's
                seconds to reply."""
                t_all, took = time.monotonic(), {}
                cmds = {k: cmd(k) if callable(cmd) else cmd for k in repls}
                for k, r in repls.items():
                    r.send(cmds[k])
                for k, r in repls.items():
                    r.reply(cmds[k], timeout)
                    took[k] = time.monotonic() - t_all
                return took

            def converge():
                t_c = time.monotonic()
                while True:
                    alive = [ln for ln in repl.run("list_mem") if "ALIVE" in ln]
                    if len(alive) == CLI_NODES and any("*leader*" in ln for ln in alive):
                        return alive
                    check(time.monotonic() - t_c < 60,
                          f"the node processes did not converge: {alive}")
                    time.sleep(0.2)

            t0 = time.monotonic()
            on_all("self_id", CLI_START_S)
            alive = converge()
            joined = {n.name: _joined_at(os.path.join(tmp, f"{n.name}.log"), n.name)
                      for n in spec.nodes}
            check(all(joined.values()), f"no `joined` or `is the leader` log line: {joined}")
            out["start_to_joined_s"] = {k: joined[k] - procs[k][1] for k in sorted(joined)}
            leader = [ln for ln in alive if "*leader*" in ln][0]
            check("H1" in leader, f"leader {leader}, want H1 (the REPL node)")

            stages = {"start_to_converged": time.monotonic() - t0}

            def job(model, n, results):
                t_sub = time.monotonic()
                done = repl.run(f"submit-job {model} {n}", 300)
                wall = time.monotonic() - t_sub
                m = re.search(r"job (\d+) DONE: (\d+) queries", "\n".join(done))
                check(m and int(m.group(2)) == n, f"submit-job {model} {n}: {done}")
                jid = int(m.group(1))
                got = repl.run(f"get-output {jid}")
                check(got == [f"ok {results} results -> final_{jid}.json"],
                      f"get-output {jid}: {got}")
                with open(os.path.join(tmp, f"final_{jid}.json")) as f:
                    return jid, wall, json.load(f)

            # ---- images: load-testfiles, then every node process traces
            # its device (torch.profiler) until the last kernel of the
            # phase; the same job twice: the first loads ResNet50 on its
            # worker, the second finds it loaded
            t = time.monotonic()
            put = repl.run(f"load-testfiles {os.path.join(tmp, 'in')} {CLI_FILES}")
            check(put[-1] == f"loaded {CLI_FILES} files", f"load-testfiles: {put[-3:]}")
            logdirs = {k: os.path.join(tmp, f"trace_{k}") for k in repls}
            trace_s = {"start": on_all(lambda k: f"profile trace start {logdirs[k]}")}
            t_c = time.monotonic()
            check("H1" in [ln for ln in converge() if "*leader*" in ln][0], "H1 lost the lead")
            trace_s["reconverged"] = time.monotonic() - t_c
            c0 = _cluster_counters(repl)
            jobs = {k: job("ResNet50", CLI_QUERIES, CLI_FILES) for k in ("cold", "warm")}
            c1 = _cluster_counters(repl)
            # output_<job>_<batch>_<port>.json: the worker processes that ran the batches
            name_of = {str(n.port): n.name for n in spec.nodes}
            hosts = sorted({name_of[ln.split("_", 3)[3].split(".json")[0]]
                            for jid, _, _ in jobs.values()
                            for ln in repl.run(f"ls-all output_{jid}_*") if ln.startswith("output_")})
            c2 = repl.json("C2 ResNet50")
            batches = int(c1["resnet50_batches"] - c0["resnet50_batches"])
            # C2 is the coordinator's per-image time of each batch (exec
            # time / images): a sample a batch, not a tail over queries
            out["image"] = {"jobs": {k: {"job": jid, "queries": CLI_QUERIES, "wall_s": wall,
                                         "images_per_s": CLI_QUERIES / wall}
                                     for k, (jid, wall, _) in jobs.items()},
                            "batches": batches, "worker_processes": hosts,
                            "c2_per_image_ms_over_batches": {
                                "batch_samples": int(c2["count"]),
                                "p50": c2["p50"] * 1e3, "p99": c2["p99"] * 1e3},
                            "c2": c2}
            merged = [m for _, _, m in jobs.values()]
            stages["images"] = time.monotonic() - t

            # ---- the LM: put the prompt files, submit-job, get-output
            t = time.monotonic()
            for p in lm_files:
                got = repl.run(f"put {p} {os.path.basename(p)}")
                check(any(ln.startswith("ok version=") for ln in got), f"put {p}: {got}")
            lm_jid, lm_wall, lm_merged = job(CLI_LM_SPEC["name"], CLI_LM_PROMPTS, CLI_LM_PROMPTS)
            c3 = _cluster_counters(repl)
            d = {"prefill": int(c3["prefill"] - c1["prefill"]),
                 "steps": int(c3["steps"] - c1["steps"])}
            tokens = sum(len(v["tokens"]) for v in lm_merged.values())
            out["lm"] = {"job": lm_jid, "prompts": CLI_LM_PROMPTS, "wall_s": lm_wall,
                         "tokens": tokens, "tokens_per_s": tokens / lm_wall,
                         "batches": int(c3["lm_batches"] - c1["lm_batches"]),
                         "server_dispatches": d}
            stages["lm"] = time.monotonic() - t
            t = time.monotonic()

            # ---- served by the REPL node itself; then every trace stops
            before = repl.run("models")
            local = repl.run(f"predict-locally ResNet50 {files[0]} {files[1]}")
            trace_s["stop"] = on_all("profile trace stop", 300)
            out["trace_s"] = trace_s
            traced = {k: _trace_kernels(logdirs[k]) for k in repls}
            after = repl.run("models")
            c1_lines = repl.run("C1")
            check(repl.json("profile metrics")["counters"], "no counters in the REPL node's registry")
            local_json = json.loads("\n".join(local[:-1]))
            check(local[-1].startswith("exec_time="), f"predict-locally: {local[-3:]}")
            check(any(ln.startswith("ResNet50:") for ln in after), f"models: {after}")
            stages["traced_stop_and_repl_verbs"] = time.monotonic() - t
            t = time.monotonic()
            # H1 quits from its REPL, the rest take SIGTERM (the nodes'
            # stdin closed after it, so their REPL reader threads end)
            procs["H1"][0].stdin.write("quit\n")
            procs["H1"][0].stdin.close()
        except BaseException as e:
            raise AssertionError(f"{e}\n{fail_info()}") from e
        codes = {"H1": procs["H1"][0].wait(timeout=120)}
        for name, (p, _) in procs.items():
            if name != "H1":
                p.send_signal(signal.SIGTERM)
        for name, (p, _) in procs.items():
            if name not in ("H1", "DNS"):
                p.stdin.close()
        for name, (p, _) in procs.items():
            codes[name] = p.wait(timeout=120)
        check(all(c == 0 for c in codes.values()), f"exit codes {codes}\n{fail_info()}")
        out["exit_codes"] = codes
        stages["stop"] = time.monotonic() - t
        out["stages_s"] = stages
    finally:
        for p, _ in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    # the launches are the kernels in the three node processes' traces;
    # the formula holds them: a ResNet50 batch (at most the engine's 32)
    # is one engine chunk, each process that loads ResNet50 warms it up
    # with 2 forwards, predict-locally is one more (after a load, if the
    # REPL node had not served ResNet50); an LM placement prefill is 12
    # K2, a chunk step 12 x chunk K4
    launches = {k: sum(t[k] for t in traced.values()) for k in CLI_TRACE_KERNELS}
    resident = any(ln.startswith("ResNet50:") for ln in before)
    n_layers = CLI_LM_SPEC["n_layers"]
    formula = {"normalize": batches + 2 * len(hosts) + 1 + (0 if resident else 2),
               "flash_attention": n_layers * d["prefill"],
               "decode_attention": n_layers * CLI_LM_SPEC["chunk"] * d["steps"]}
    out["launches"] = {"traced": launches, "by_process": traced, "formula": formula,
                       "repl_node_resnet50_resident_before": resident}
    check(launches == formula, f"the node processes' traces hold {launches} kernels "
                               f"({traced}); the counters give {formula}")
    check(batches >= 1 and d["prefill"] >= 1 and d["steps"] >= 1,
          f"counters moved by {batches} batches, {d}")
    out["c1"] = c1_lines
    return merged, lm_merged, files, lm_files, local_json, launches


def _cli_env():
    """The node processes' environment: this checkout on the path,
    stdout unbuffered (the REPL answers over a pipe)."""
    root = os.path.dirname(os.path.abspath(__file__))
    path = os.environ.get("PYTHONPATH")
    return dict(os.environ, PYTHONUNBUFFERED="1",
                PYTHONPATH=root if not path else f"{root}{os.pathsep}{path}")


def phase_cli():
    """The port started the way an operator starts it (phase 21):
    `python -m dml_tpu_torch` localspec, introducer and three node
    processes on the card, their REPLs driven over stdin; returns the
    path's launches as the processes' traces count them: K1, K2 and K4."""
    import glob

    import torch
    from dml_tpu_torch.inference import InferenceEngine
    from dml_tpu_torch.inference import generate as gen
    from dml_tpu_torch.inference.lm_backend import LMBackend
    from dml_tpu_torch.inference.lm_sharded import lm_spec_parts_cached
    from dml_tpu_torch.ops import _build

    t_phase = time.monotonic()
    def kernel_libraries():  # nvcc's builds (the JPEG loader, built by g++, aside)
        return sorted(p for p in glob.glob(os.path.join(_build.BUILD_DIR, "lib*.so"))
                      if "dmlloader" not in os.path.basename(p))

    built = kernel_libraries()
    out = {"nodes": CLI_NODES, "files": CLI_FILES,
           "lm": f"198M GQA-4 bf16 from --lm-spec: {LMS_SLOTS} slots, chunk {LMS_CHUNK}"}
    with tempfile.TemporaryDirectory() as tmp:
        merged, lm_merged, files, lm_files, local, launches = _drive_cli(tmp, out)
        t = time.monotonic()
        check(kernel_libraries() == built,
              "a node process built a kernel library: the phase's build must serve them all")
        # the outputs against this process's engine on the same files and weights
        eng = InferenceEngine()  # device None -> cuda; seed 0, as every node's
        check(eng.device.type == "cuda", f"engine on {eng.device}")
        eng.load_model("ResNet50")
        direct = {os.path.basename(k): v for k, v in
                  eng.infer_files("ResNet50", files).to_json_dict().items()}
        check(all(set(m) == set(direct) for m in merged), "job keys != the files")
        worst = 0.0
        pairs = [kv for m in merged for kv in m.items()]
        pairs += [(os.path.basename(k), v) for k, v in local.items()]
        for f, rows in pairs:
            check([r["wnid"] for r in rows] == [r["wnid"] for r in direct[f]],
                  f"{f}: top-5 {[r['wnid'] for r in rows]} != the engine's "
                  f"{[r['wnid'] for r in direct[f]]}")
            worst = max(worst, max(abs(a["score"] - b["score"]) for a, b in zip(rows, direct[f])))
        check(worst <= 1e-6, f"scores differ from the engine's by {worst} (> 1e-6)")
        out["image"]["vs_engine_infer_files"] = {
            "max_abs_score_diff": worst, "bar": 1e-6, "checked": len(pairs),
            "distinct_top1": len({rows[0]["wnid"] for rows in merged[0].values()})}
        del eng
        # the LM job against a lone serve of the same prompt files
        be = LMBackend.from_spec(CLI_LM_SPEC)
        try:
            lone, _, _ = be.serve_files(lm_files)
        finally:
            be.close()
        lone = {os.path.basename(k): v["tokens"] for k, v in lone.items()}
        params, cfg = lm_spec_parts_cached(CLI_LM_SPEC)
        equal = ties = 0
        for i, (p, b) in enumerate(mixed_requests(cfg.vocab_size)[:CLI_LM_PROMPTS]):
            name = f"p{i}.tokens.txt"
            got = lm_merged[name]["tokens"]
            check(len(got) == b, f"LM {name}: {len(got)} tokens, budget {b}")
            if list(got) == list(lone[name]):
                equal += 1
                continue
            held, upto, _, _ = tie_compare(got, *lone_greedy(gen, params, cfg, p, b))
            check(held, f"LM {name}: tokens differ from the lone serve at {upto} with no "
                        f"near-tie before it")
            ties += 1
        out["lm"]["vs_lone_backend"] = {"equal": equal, "held_to_a_near_tie": ties,
                                       "tie_margin": TIE_MARGIN}
        out["stages_s"]["references"] = time.monotonic() - t
        del params
    torch.cuda.empty_cache()
    out["phase_s"] = time.monotonic() - t_phase
    emit(phase="cli", **out)
    return {"normalize": {"ResNet50": launches["normalize"]},
            "flash_attention": launches["flash_attention"],
            "decode_attention": launches["decode_attention"]}


# ---------------------------------------------------------------------------
# phase 22: the measuring half (benchmarks, the two tools, the bench arms)
# ---------------------------------------------------------------------------

MEASURE_MATMUL = 8192  # the yardstick's square bf16 product
#: bench.py's b32 chains (bench.py:241-245 for ResNet50; InceptionV3 at b64's)
MEASURE_MODELS = (("ResNet50", (20, 120)), ("InceptionV3", (15, 90)))
MEASURE_REPS = 5  # forward_rate_stats' default
MEASURE_LAT_REPS = 20  # dispatch_latency's default
ROOFLINE_MODELS = ("ResNet50", "InceptionV3", "EfficientNetB4")
#: the JAX bench arms' serving settings (dml_tpu/inference/lm_sharded.py:1993-1997),
#: the 198M LM in float32 so that the arms hold tokens to generate exactly
MEASURE_LM_SPEC = dict(LM_CFG, name="LM198M", dtype="float32", seed=0, max_slots=4,
                       max_len=128, chunk=8)
SPECDEC_NEW, CB_NEW = 32, 16


def _measure_models(smi):
    """(b): the engine's forward (K1, then the model) slope-timed at b32,
    its FLOPs and the card's peak, and the dispatch latency. Returns the
    rows and K1's launches with their formula."""
    import torch
    from dml_tpu_torch.benchmarks import (compiled_flops, dispatch_latency,
                                          forward_rate_stats, peak_flops)
    from dml_tpu_torch.inference import InferenceEngine
    from dml_tpu_torch.models.registry import get_model

    peak = peak_flops()
    eng = InferenceEngine(dtype=torch.bfloat16)
    check(eng.device.type == "cuda", f"engine on {eng.device}")
    rows, k1, k1_want = {}, {}, {}
    for name, chains in MEASURE_MODELS:
        spec = get_model(name)
        lm = eng.load_model(name, variables=seeded_weights(spec, seed=0), batch_size=BATCH)
        x = torch.from_numpy(np.random.RandomState(2).randint(
            0, 256, (BATCH, *spec.input_size, 3)).astype(np.uint8)).cuda()

        def fwd(m, b):
            return eng._forward(m, b)

        reset_launch_counts()
        st = forward_rate_stats(fwd, lm, x, chains=chains, reps=MEASURE_REPS)
        flops = compiled_flops(fwd, lm, x)
        p50, p99 = dispatch_latency(fwd, lm, x, reps=MEASURE_LAT_REPS)
        torch.cuda.synchronize()
        k1[name] = launch_counts()["normalize"]
        k1_want[name] = sum(chains) * (MEASURE_REPS + 1) + 1 + MEASURE_LAT_REPS + 1
        check(launch_counts() == _kernels() | {"normalize": k1_want[name]},
              f"measure {name}: launched {launch_counts()}, K1 wants {k1_want[name]}")
        sec = st["median"]
        check(all(np.isfinite(v) and v > 0 for v in (sec, st["min"], st["max"]))
              and "degenerate_reps" not in st, f"measure {name}: slope {st}")
        busy = SHARED.get(f"busy/{name}")
        rows[name] = {
            "batch": BATCH, "chains": list(chains), "reps": MEASURE_REPS,
            "slope_ms": sec * 1e3, "slope_ms_min": st["min"] * 1e3, "slope_ms_max": st["max"] * 1e3,
            "images_per_s": BATCH / sec, "images_per_s_range": [BATCH / st["max"], BATCH / st["min"]],
            "gflops_per_forward": flops / 1e9, "peak_flops": peak, "mfu": flops / sec / peak,
            "dispatch_latency_ms_p50": p50 * 1e3, "dispatch_latency_ms_p99": p99 * 1e3,
            "busy_from_phase_4_5": busy if busy else "not measured in this call",
            "card": smi}
        eng.unload_model(name)
        del x
    torch.cuda.empty_cache()
    return rows, k1, k1_want


def _measure_arms():
    """(d): the two one-device bench arms on the 198M LM in float32, TF32
    off, with K2 and K4 counted and held to the formula from the arms' own
    dispatches (generate's prefills and decode steps, the server's
    placement prefills (target and draft), chunk steps and draft
    proposals)."""
    import torch
    from dml_tpu_torch.inference import lm_sharded
    from dml_tpu_torch.inference.lm_backend import lm_spec_parts
    from dml_tpu_torch.inference.lm_server import LMServer

    want = {"flash_attention": 0, "decode_attention": 0}
    orig = {"generate": lm_sharded.generate, "_prefill": LMServer._prefill,
            "_chunk_impl": LMServer._chunk_impl, "_propose_impl": LMServer._propose_impl}

    def generate(params, cfg, prompt, n, *a, **kw):
        want["flash_attention"] += cfg.n_layers
        want["decode_attention"] += cfg.n_layers * (n - 1)
        return orig["generate"](params, cfg, prompt, n, *a, **kw)

    def prefill(self, params, cfg, *a, **kw):
        want["flash_attention"] += cfg.n_layers
        return orig["_prefill"](self, params, cfg, *a, **kw)

    def chunk(self, *a, **kw):
        want["decode_attention"] += self.cfg.n_layers * self.chunk
        return orig["_chunk_impl"](self, *a, **kw)

    def propose(self, *a, **kw):
        want["decode_attention"] += self._spec.draft_cfg.n_layers * self._spec.k
        return orig["_propose_impl"](self, *a, **kw)

    with tf32_off():
        params, cfg = lm_spec_parts(MEASURE_LM_SPEC)
        lm_sharded.generate = generate
        LMServer._prefill, LMServer._chunk_impl, LMServer._propose_impl = prefill, chunk, propose
        try:
            reset_launch_counts()
            spec = lm_sharded.bench_specdec_arm(params, cfg, MEASURE_LM_SPEC,
                                                new_tokens=SPECDEC_NEW)
            cb = lm_sharded.bench_cb_arm(params, cfg, MEASURE_LM_SPEC, new_tokens=CB_NEW)
            torch.cuda.synchronize()
            got = launch_counts()
        finally:
            lm_sharded.generate = orig["generate"]
            LMServer._prefill, LMServer._chunk_impl = orig["_prefill"], orig["_chunk_impl"]
            LMServer._propose_impl = orig["_propose_impl"]
    del params
    torch.cuda.empty_cache()
    check(got == _kernels(want["flash_attention"], k4=want["decode_attention"]),
          f"measure arms: launched {got}, the arms' dispatches give {want}")
    check(spec["outputs_equal"], f"specdec arm: tokens differ from generate: {spec}")
    auto = spec["auto_disable"]
    check(auto["disabled"] and auto["reason"] == "acceptance" and auto["outputs_equal"],
          f"specdec arm: the random draft was not auto-disabled with exact tokens: {auto}")
    check(cb["outputs_equal"], f"cb arm: tokens differ from generate: {cb}")
    return spec, cb, got


def _measure_kernel_checks():
    """Not counted: K2 and K4 on float32 inputs at the arms' shapes (a
    placement prefill of 4 rows at the 32-token bucket, GQA-4; a decode
    step over the 4-slot, 128-row cache at mixed positions) against their
    plain versions, within the bars of phases 6-7 (2e-5)."""
    import torch
    from dml_tpu_torch.ops.decode_attention import decode_attention, decode_attention_plain
    from dml_tpu_torch.ops.flash_attention import attention_with_lse, flash_attention_lse

    g = torch.Generator(device="cuda").manual_seed(23)
    slots, t, heads, kv, d = MEASURE_LM_SPEC["max_slots"], MEASURE_LM_SPEC["max_len"], 16, 4, 64
    q = torch.randn(slots, 32, heads, d, generator=g, device="cuda")
    k, v = (torch.randn(slots, 32, kv, d, generator=g, device="cuda") for _ in range(2))
    out, lse = flash_attention_lse(q, k, v, causal=True)
    p_out, p_lse = attention_with_lse(q, k, v, causal=True)
    k2 = max(float((out - p_out).abs().max()), float((lse - p_lse).abs().max()))
    q1 = torch.randn(slots, 1, heads, d, generator=g, device="cuda")
    ck, cv = (torch.randn(slots, kv, t, d, generator=g, device="cuda") for _ in range(2))
    pos = torch.tensor([5, 40, 77, t - 1], dtype=torch.int32, device="cuda")
    k4 = float((decode_attention(q1, ck, cv, pos) - decode_attention_plain(q1, ck, cv, pos))
               .abs().max())
    torch.cuda.synchronize()
    check(k2 <= 2e-5 and k4 <= 2e-5, f"measure: K2 f32 {k2}, K4 f32 {k4} from the plain versions")
    return {"flash_fwd_f32_max_abs_err": k2, "decode_f32_max_abs_err": k4, "bar": 2e-5}


def _measure_footprint():
    """(e): phase 15's recorded sp-2 calls against the footprint tool's
    body at the same point on the same ranks, and the sizes they must
    have: ring sp - 1 shifts of k and v (2 x the activation each),
    Ulysses 2 all-to-alls (q, k, v in; out back: 4 x the activation)."""
    fp = SHARED.get("sp_footprint")
    if fp is None:
        return {"skipped": "phase 15 did not run in this call"}
    act = 1 * (SP_T // 2) * 16 * 64 * 2  # one rank's bf16 [1, T/2, 16, 64]
    want = {"ring": (1, 2 * act), "ulysses": (2, 4 * act)}
    point = fp["point"]
    for form, (count, nbytes) in want.items():
        got, tool = fp["calls"][form], point[form]["recorded"]
        check(got["total_count"] == tool["total_count"] == count
              and got["total_bytes"] == tool["total_bytes"] == nbytes,
              f"footprint {form}: recorded {got}, analyze_point's {tool}, want {count} calls "
              f"of {nbytes} bytes")
    return {"point": point, "recorded_calls": fp["calls"],
            "equal_to_analyze_point": True}


def phase_measure(smi):
    """Phase 22: the port's measuring half on the card. Returns K1's
    launches by model and K2's and K4's on this path."""
    import torch
    from dml_tpu_torch.benchmarks import device_seconds_per_iter, peak_flops, poke
    from dml_tpu_torch.tools import conv_roofline

    t_phase = time.monotonic()
    out = {"card": smi}
    # (a) the timer's yardstick
    n = MEASURE_MATMUL
    g = torch.Generator(device="cuda").manual_seed(22)
    a, b = (torch.randn(n, n, generator=g, device="cuda", dtype=torch.bfloat16) for _ in range(2))

    def mm(i, acc, a, b):
        return (poke(a, acc) @ b)[0, 0].float()

    sec = device_seconds_per_iter(mm, a, b)
    tfs = 2.0 * n ** 3 / sec / 1e12
    share = tfs * 1e12 / peak_flops()
    out["matmul"] = {"shape": [n, n, n], "dtype": "bfloat16", "ms": sec * 1e3,
                     "tflops": tfs, "share_of_989": share}
    check(0.5 <= share <= 1.05, f"matmul yardstick at {tfs:.1f} TF/s, {share:.3f} of the peak")
    del a, b
    # (b) the models
    out["models"], k1, k1_want = _measure_models(smi)
    # (c) the roofline
    out["roofline"] = [conv_roofline.analyze(m, bt) for m in ROOFLINE_MODELS for bt in (32, 128)]
    out["microbench"] = conv_roofline.microbench("EfficientNetB4", 128)
    out["concat_microbench"] = conv_roofline.concat_microbench("InceptionV3", 128)
    torch.cuda.empty_cache()
    # (d) the bench arms, their kernels first held to the plain versions
    out["kernel_checks"] = _measure_kernel_checks()
    spec, cb, arms = _measure_arms()
    out["specdec"], out["cb"] = spec, cb
    # (e) the collective footprint of phase 15's calls
    out["footprint"] = _measure_footprint()
    out["launches"] = {"normalize": k1, "normalize_want": k1_want, "arms": arms}
    out["phase_s"] = time.monotonic() - t_phase
    emit(phase="measure", **out)
    return {"normalize": k1, "flash_attention": arms["flash_attention"],
            "decode_attention": arms["decode_attention"]}


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

    kernel_only = "--kernel-only" in sys.argv[1:]
    build_all(kernel_only)
    timer = Timer()
    if "--measure" in sys.argv[1:]:  # after a measuring edit: build, phase 22 (15 first if asked)
        if "--seq-parallel" in sys.argv[1:]:
            phase_seq_parallel()
        phase_measure(smi)
        print(smi, flush=True)
        return 0
    if "--lm-server" in sys.argv[1:]:  # a short call after a server edit: build, phase 12, stop
        phase_lm_server(timer)
        print(smi, flush=True)
        return 0
    if "--moe" in sys.argv[1:]:  # a short call after an MoE edit: build, phase 13, stop
        phase_moe(timer)
        print(smi, flush=True)
        return 0
    if "--parallel" in sys.argv[1:]:  # a short call after a mesh edit: build, phase 14, stop
        phase_parallel()
        print(smi, flush=True)
        return 0
    if "--seq-parallel" in sys.argv[1:]:  # after a sequence/expert-form edit: build, phase 15
        phase_seq_parallel()
        print(smi, flush=True)
        return 0
    if "--pipeline" in sys.argv[1:]:  # after a pp/tp serving edit: build, phase 16, stop
        phase_pipeline()
        print(smi, flush=True)
        return 0
    if "--cluster" in sys.argv[1:]:  # after a cluster or job-layer edit: build, phase 17, stop
        phase_cluster(timer)
        print(smi, flush=True)
        return 0
    if "--ingress" in sys.argv[1:]:  # after a router or chaos-harness edit: build, phase 18
        phase_ingress()
        print(smi, flush=True)
        return 0
    if "--families" in sys.argv[1:]:  # after an image-family edit: build, phase 19, stop
        phase_families(timer)
        print(smi, flush=True)
        return 0
    if "--groups" in sys.argv[1:]:  # after a worker-group edit: build, phase 20, stop
        phase_groups(timer)
        print(smi, flush=True)
        return 0
    if "--cli" in sys.argv[1:]:  # after a CLI edit: build, phase 21, stop
        phase_cli()
        print(smi, flush=True)
        return 0
    timings = phase_kernel(timer)
    if kernel_only:  # a short call after a K1 edit: build, check, time, stop
        print(smi, flush=True)
        return 0
    launches = {m: phase_model(m, mode, timer) for m, mode in MODELS}
    flash = phase_flash(timer)
    decode = phase_decode(timer)
    lm_launches = phase_lm(timer)
    bwd = phase_flash_bwd(timer)
    train_launches = phase_train()
    image_train_launches = phase_image_train()
    server_launches = phase_lm_server(timer)
    moe_launches = phase_moe(timer)
    parallel_launches = phase_parallel()
    sp_launches = phase_seq_parallel()
    pipe_launches = phase_pipeline()
    cluster_launches = phase_cluster(timer)
    ingress_launches = phase_ingress()
    families_launches = phase_families(timer)
    groups_launches = phase_groups(timer)
    cli_launches = phase_cli()
    measure_launches = phase_measure(smi)

    kernels = []
    for model, mode in MODELS:
        shape = (32, 224, 224, 3) if model == "ResNet50" else (32, 299, 299, 3)
        t = timings[(shape, mode, torch.bfloat16)]
        by_path = {"serve": launches[model], "train": image_train_launches[model]}
        if model == "ResNet50":
            by_path["parallel"] = parallel_launches
            by_path["groups"] = groups_launches["normalize"]["ResNet50"]
            by_path["cli"] = cli_launches["normalize"]["ResNet50"]
        by_path["cluster"] = cluster_launches["normalize"].get(model, 0)
        by_path["ingress"] = ingress_launches["normalize"].get(model, 0)
        by_path["measure"] = measure_launches["normalize"][model]
        kernels.append(dict(
            name=f"normalize_u8[{model} b32 {mode} bf16; 16-pixel vector groups; "
                 f"library call: x.to(bfloat16), the raw mode's call on the same bytes]",
            route="cuda", variant="staged 16-pixel tiles", source="dml_tpu_torch/csrc/normalize.cu",
            replaces="dml_tpu/ops/preprocess.py:30", launches=sum(by_path.values()),
            launches_by_path=by_path, bound_by="bytes", **t))
    t = timings[((32, 224, 224, 3), "tf", torch.bfloat16)]
    kernels.append(dict(
        name="normalize_u8[MobileNetV2 and ViT-B16 b32 224x224 tf bf16; 16-pixel vector groups; "
             "library call: x.to(bfloat16), the raw mode's call on the same bytes]",
        route="cuda", variant="staged 16-pixel tiles", source="dml_tpu_torch/csrc/normalize.cu",
        replaces="dml_tpu/ops/preprocess.py:30", launches=families_launches["normalize"],
        launches_by_path={"families": families_launches["normalize"]}, bound_by="bytes", **t))
    # one kernel timed at several shapes: each row carries every path's launches
    by_path = {kern: {"generate": lm_launches[kern], "train": train_launches[kern],
                      "lm_server": server_launches[kern], "moe": moe_launches[kern],
                      "seq_parallel": sp_launches[kern], "pipeline": pipe_launches[kern],
                      "cluster": cluster_launches[kern], "ingress": ingress_launches[kern],
                      "families": families_launches[kern], "groups": groups_launches[kern],
                      "cli": cli_launches[kern], "measure": measure_launches[kern]}
               for kern in ("flash_attention", "decode_attention")}
    for case, shape in (
            ("prefill_b8", f"prefill b{LM_BATCH} T{PROMPT_LEN} H16 KV4 D64 bf16 causal"),
            ("mha_b1", f"train forward b1 T{TRAIN_T} H16 D64 bf16 causal, k/v repeated"),
            ("vit_b16", f"ViT-B16 b{BATCH} T197 H12 D64 bf16 non-causal, q/k/v strided views "
                        f"of the qkv output")):
        t = dict(flash[case])
        kernels.append(dict(
            name=f"flash_fwd[{shape}; wgmma+TMA]", route="cuda", variant="wgmma+tma",
            source="dml_tpu_torch/csrc/flash_attention.cu",
            replaces="dml_tpu/ops/flash_attention.py:65",
            launches=sum(by_path["flash_attention"].values()),
            launches_by_path=by_path["flash_attention"], **t))
    t = decode["lm_b8"]
    kernels.append(dict(
        name=f"decode_attention[b{LM_BATCH} cache {PROMPT_LEN + NEW_TOKENS} KV4 G4 D64 bf16; "
             f"one launch, bulk async loads, merge folded in]",
        route="cuda", variant="one_launch", source="dml_tpu_torch/csrc/decode_attention.cu",
        replaces="dml_tpu/ops/decode_attention.py:53",
        launches=sum(by_path["decode_attention"].values()),
        launches_by_path=by_path["decode_attention"], **t))
    t = bwd["train"]
    shape = f"train b1 T{TRAIN_T} H16 D64 bf16 causal"
    for part, line in (("dq", 113), ("dkv", 166)):
        kernels.append(dict(
            name=f"flash_bwd_{part}[{shape}; wgmma+TMA; plain and library times are the whole "
                 f"backward's]",
            route="cuda", variant="wgmma+tma", source="dml_tpu_torch/csrc/flash_attention_bwd.cu",
            replaces=f"dml_tpu/ops/flash_attention.py:{line}",
            launches=train_launches["flash_bwd"] + moe_launches["flash_bwd"]
            + sp_launches["flash_bwd"] + families_launches["flash_bwd"],
            launches_by_path={"train": train_launches["flash_bwd"],
                              "moe": moe_launches["flash_bwd"],
                              "seq_parallel": sp_launches["flash_bwd"],
                              "families": families_launches["flash_bwd"]},
            max_abs_err=t["max_abs_err"],
            ms=t["ms"][part], mma_sync_ms=t["ms"][f"{part}_mma_sync"], plain_ms=t["plain_ms"],
            bound_ms=t["bound"][part]["bound_ms"], bound_by=t["bound"][part]["bound_by"],
            library_ms=t["library_ms"]))
    kernels.append(dict(
        name=f"flash_bwd_delta[{shape}; rowsum(dO*O) and padded lse rows]", route="cuda",
        source="dml_tpu_torch/csrc/flash_attention_bwd.cu",
        replaces="dml_tpu/ops/flash_attention.py:311 (a jnp expression beside the Pallas kernels)",
        launches=train_launches["flash_bwd_delta"] + moe_launches["flash_bwd_delta"]
        + sp_launches["flash_bwd_delta"] + families_launches["flash_bwd_delta"],
        launches_by_path={"train": train_launches["flash_bwd_delta"],
                          "moe": moe_launches["flash_bwd_delta"],
                          "seq_parallel": sp_launches["flash_bwd_delta"],
                          "families": families_launches["flash_bwd_delta"]},
        max_abs_err=t["delta_max_abs_err"],
        ms=t["ms"]["delta"], plain_ms=t["delta_plain_ms"], bound_ms=t["bound"]["delta"]["bound_ms"],
        bound_by=t["bound"]["delta"]["bound_by"], library_ms=None))
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

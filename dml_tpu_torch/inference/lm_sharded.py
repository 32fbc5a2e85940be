"""tp- and pp-sharded LM serving, and the KV slab codec of prefill/decode
disaggregation: PyTorch counterpart of the device half of
dml_tpu/inference/lm_sharded.py.

One process per rank (`parallel.mesh`), every rank given the same host
arguments. All forms build on the same deterministic params tree
(`lm_backend.lm_spec_parts`, built on the host; each rank moves only
what it holds to its device).

- **weight-resident tp** (`sharded_lm_backend(form="resident")`): each
  rank holds its piece of every leaf (`shard_lm_params`: the last axis
  of each Flax-layout leaf over tp under JAX's size test,
  `sharding.partition_lm_params`, so the pieces are JAX's device shards).
  The server computes with them in place, as GSPMD partitions a
  column-sharded weight against a replicated input: each linear (qkv,
  proj, up, down, the router, the float32 lm_head) computes its block of
  output columns from the rank's piece and the block is all-gathered over
  tp (`ColumnShard`); the embedding's looked-up rows are all-gathered
  the same way (`RowShard`); the norm scales are gathered at each
  dispatch's entry (d floats each, one collective). The fused qkv
  output is not head-aligned (rank 0 of the 198M LM at tp 2 holds q
  heads 0-11, rank 1 q heads 12-15 and all of k and v), so K2 and K4
  run on the whole q/k/v on every rank: GSPMD cannot partition an opaque
  kernel either.
- **param-gather tp** (`form="gather"`): the pieces are all-gathered
  whole at each dispatch (a placement prefill group, a decode chunk, a
  verify round; one collective per dtype, `sharding.gather_tree`), then
  the one-device program runs: JAX's `_maybe_gather`.
- **pipeline** (`PipelinedLMBackend`): the block stack over pp, JAX's
  tick schedule (`parallel.pipeline`'s), with per-stage KV caches and the
  last stage's token fed back around the ring on an int32 lane.

The logits are all-gathered whole in the tp forms, so every rank reads
back the same tokens and makes the same host decisions (placement,
chunking, speculative auto-disable), hence the same collective calls in
the same order. The dispatch placement is `LMServer(gather_shardings=)`:
JAX passes a tree of shardings (all replicated for the gather form,
None for the resident form, whose partitioning GSPMD derives); the port
passes the callable that makes the tree a dispatch computes with
(`replicated_shardings`, `resident_shardings`).

KV slabs (`kv_slab_to_bytes`, `kv_slab_from_bytes`, the framed stream)
are byte-identical to the JAX package's for the same entries, and each
package reads the other's. Rows are CPU torch tensors here (numpy has no
bfloat16); bfloat16 travels as raw 2-byte words, as the flax-msgpack
codec writes it (`models.params_io`). `LMPrefillBackend` is the prefill
half of disaggregation: one bucket-padded prefill (K2 per layer) per
prompt, its KV rows and first token as a slab.

Metrics, under the JAX package's names: ``lm_sharded_*`` and
``jobs_kv_handoff_*`` (the group backends, which the cluster slice
ports, count batches, tokens and handoffs; `LMPrefillBackend` counts
slabs).

The cluster half: `sharded_lm_group_backend` (a JobService LM group
backend over a mesh-sharded `LMBackend`), `DisaggLMBackend` (the decode
primary of a role-split group: prompts scattered over the live
prefill-role members, their KV slabs streamed back over the data plane
and adopted, per-request fallback to a local prefill) and
`wire_lm_group` (a node's role in a group declaring the model). The
group mesh resolves over the ranks of the process's own world
(`jobs.groups.group_ranks`), where the JAX primary takes the host's
devices; a mesh of more ranks than the world has raises at wiring.

The bench half: `bench_lm_sharded_serving` (the forms through a
5-node cluster, its tp-2 and pp-2 groups over a group world of this
process and one follower rank, `parallel.group_world`), then
`bench_specdec_arm` (speculative decoding against the plain chunk path
at a declared acceptance, and a random draft's auto-disable) and
`bench_cb_arm` (continuous batching's TTFT against batch drain under
staggered waves), one device each, the JAX text but for `device=` (cuda
when None) and tokens read back as Python ints.
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
import logging
import struct
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from ..models.lm_params import _flatten, _nest, resolve_device
from ..models.transformer import rope_tables
from ..observability import METRICS
from ..tracing import TRACER, TraceContext, current_all_ctxs
from ..ops.flash_attention import flash_attention
from ..parallel.group_world import seam
from ..parallel.mesh import all_gather, all_reduce, resolve_mesh, ring_shift
from ..parallel.pipeline import stack_stage_params
from ..parallel.sharding import gather_tree, partition_lm_params, shard, shard_dim
from .generate import LMConfig, _apply_block, _head, generate, init_cache, prefill

log = logging.getLogger(__name__)

_M_SHARDED_BATCHES = METRICS.counter(
    "lm_sharded_batches_total",
    "LM batches served on a group's sharded engine, by serving mode (resident|gather|disagg)")
_M_SHARDED_TOKENS = METRICS.counter(
    "lm_sharded_tokens_total", "generated tokens delivered by group-sharded LM serving")
_M_PREFILL_SLABS = METRICS.counter(
    "lm_sharded_prefill_slabs_total", "KV-cache slabs produced by prefill-role workers")
_M_HANDOFF = METRICS.counter(
    "jobs_kv_handoff_total", "prefill->decode KV slab handoffs by result (ok|fallback)")
_M_HANDOFF_BYTES = METRICS.counter(
    "jobs_kv_handoff_bytes_total", "serialized KV-cache slab bytes pulled over the data plane")
_M_HANDOFF_T = METRICS.histogram(
    "jobs_kv_handoff_seconds", "one batch's prefill RPC + slab pull wall (decode side)")


# ----------------------------------------------------------------------
# parameter placement
# ----------------------------------------------------------------------


def _tree_to(tree: Any, device) -> Any:
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


def shard_lm_params(params: Any, mesh, device=None) -> Any:
    """This rank's pieces of the LM params tree over `mesh`'s tp axis
    (`sharding.partition_lm_params`: JAX's device shards), on `device`
    (the params' own device when None). The weight-resident placement:
    each rank holds 1/tp of every sharded leaf."""
    mesh = resolve_mesh(mesh)
    specs = partition_lm_params(params, mesh or {})
    flat, fspecs = _flatten(params), _flatten(specs)
    pieces = {n: shard(t, fspecs[n], mesh) if mesh is not None else t for n, t in flat.items()}
    tree = _nest(pieces)
    return tree if device is None else _tree_to(tree, device)


class ColumnShard:
    """A kernel [in, out] held as this rank's block of output columns:
    `y @ shard` is `y @ kernel`, the block's product all-gathered over tp
    along the last dim. `kernel_of` casts it (`to`), so the serving
    code's `y @ kernel_of(node, dtype)` runs as it is."""

    __slots__ = ("piece", "mesh")

    def __init__(self, piece: torch.Tensor, mesh):
        self.piece, self.mesh = piece, mesh

    def to(self, dtype: torch.dtype) -> "ColumnShard":
        return ColumnShard(self.piece.to(dtype), self.mesh)

    def __rmatmul__(self, y: torch.Tensor) -> torch.Tensor:
        return all_gather(y @ self.piece, self.mesh, "tp", y.ndim - 1)


class RowShard:
    """The embedding [V, d] held as this rank's block of d: `emb[ids]` is
    the rows' blocks all-gathered over tp along the last dim."""

    __slots__ = ("piece", "mesh")

    def __init__(self, piece: torch.Tensor, mesh):
        self.piece, self.mesh = piece, mesh

    @property
    def device(self) -> torch.device:
        return self.piece.device

    def __getitem__(self, idx) -> torch.Tensor:
        rows = self.piece[idx]
        return all_gather(rows, self.mesh, "tp", rows.ndim - 1)


class TpPlacement:
    """The tree a dispatch computes with, made from this rank's pieces
    (the port's `gather_shardings`): every sharded leaf all-gathered
    (`replicate=True`, the param-gather form), or the sharded kernels
    and the embedding kept as pieces that compute in place
    (`ColumnShard`, `RowShard`) and the other sharded leaves (the norm
    scales) all-gathered (the resident form). The gathers take one
    collective per dtype."""

    def __init__(self, specs: Any, mesh, replicate: bool):
        self.specs, self.mesh, self.replicate = _flatten(specs), mesh, replicate

    def __call__(self, pieces: Dict[str, Any]) -> Dict[str, Any]:
        if self.mesh is None:
            return pieces
        flat = _flatten(pieces)
        kept = set() if self.replicate else {
            n for n in flat if shard_dim(self.specs[n]) is not None
            and (n.endswith("/kernel") or n == "embed/embedding")}
        out = gather_tree({n: t for n, t in flat.items() if n not in kept}, self.specs, self.mesh)
        for n in kept:
            out[n] = (RowShard if n == "embed/embedding" else ColumnShard)(flat[n], self.mesh)
        return _nest(out)


def replicated_shardings(params: Any, mesh) -> TpPlacement:
    """The param-gather form's dispatch placement: every leaf whole
    (replicated) at each dispatch, JAX's all-`P()` tree. `params` is the
    full tree (its shapes fix the specs)."""
    m = resolve_mesh(mesh)
    return TpPlacement(partition_lm_params(params, m or {}), m, replicate=True)


def resident_shardings(params: Any, mesh) -> TpPlacement:
    """The resident form's dispatch placement: kernels and the embedding
    stay tp-sharded and compute in place, the norm scales are gathered."""
    m = resolve_mesh(mesh)
    return TpPlacement(partition_lm_params(params, m or {}), m, replicate=False)


def sharded_lm_backend(
    lm_spec: Dict[str, Any],
    mesh,
    form: str = "resident",
    spec_draft_local: bool = True,
    device=None,
) -> "Any":
    """An `LMBackend` whose server runs over `mesh` (every rank of it
    builds one with the same arguments), on `device` (`cuda` when None;
    it raises where there is none):

    - ``form="resident"``: params tp-sharded, each linear computed from
      the rank's piece and its output gathered;
    - ``form="gather"``: params tp-sharded at rest, all-gathered at every
      dispatch.

    ``lm_spec["spec_k"] > 0`` arms speculative decoding with a replicated
    local draft model (`config.draft_lm_spec`, or ``lm_spec["spec_draft"]``);
    ``spec_draft_local=False`` arms shipped-draft verification only.
    Serial (lock) serving by default; ``{"overlap": true}`` in the spec
    turns on the continuous-batching driver. The mesh's sp, pp and ep
    axes must be 1 (the pipeline form is `PipelinedLMBackend`)."""
    from .lm_backend import LMBackend

    if form not in ("resident", "gather"):
        raise ValueError(f"unknown param form {form!r}")
    shape = dict(getattr(mesh, "shape", mesh) or {})
    for ax in ("sp", "pp", "ep"):
        if shape.get(ax, 1) != 1:
            raise ValueError(f"the tp serving forms shard over tp (and replicate over dp); "
                             f"mesh axis {ax}={shape[ax]} is not one of them")
    dev = resolve_device(device)
    params, cfg = lm_spec_parts_cached(lm_spec, device="cpu")
    pieces = shard_lm_params(params, mesh, device=dev)
    placement = (replicated_shardings if form == "gather" else resident_shardings)(params, mesh)
    max_new = int(lm_spec.get("max_new_tokens", 32))
    be = LMBackend(
        pieces, cfg,
        spec_k=int(lm_spec.get("spec_k", 0) or 0),
        spec_draft=LMBackend._draft_spec_of(lm_spec) if spec_draft_local else None,
        spec_min_accept=lm_spec.get("spec_min_accept"),
        max_new_tokens=max_new,
        max_slots=int(lm_spec.get("max_slots", 4)),
        max_len=int(lm_spec.get("max_len", 1024)),
        chunk=int(lm_spec.get("chunk", max(1, min(max_new, 32)))),
        temperature=float(lm_spec.get("temperature", 0.0)),
        top_k=int(lm_spec["top_k"]) if lm_spec.get("top_k") is not None else None,
        seed=int(lm_spec.get("seed", 0)),
        gather_shardings=placement,
        kv_cache_bytes=int(float(lm_spec.get("kv_cache_mb", 0) or 0) * (1 << 20)),
    )
    be.overlap = bool(lm_spec.get("overlap", False))
    return be


# ----------------------------------------------------------------------
# pipeline-parallel serving (the block stack over the `pp` axis)
# ----------------------------------------------------------------------


def lm_param_bytes(params: Any) -> int:
    """Total bytes of a params tree (memory-budget accounting)."""
    if isinstance(params, dict):
        return sum(lm_param_bytes(v) for v in params.values())
    return int(params.numel() * params.element_size())


def pp_hbm_report(lm_spec: Dict[str, Any], pp: int) -> Dict[str, Any]:
    """Per-member device-memory accounting for a pp group: the block
    stack shards 1/pp per member while embed, ln_out and lm_head
    replicate. Bytes are the serving tree's (`lm_spec_parts`: float32,
    and bf16 block kernels for a bf16 model, where JAX's tree is float32
    throughout; equal to JAX's for a float32 model)."""
    params, _cfg = lm_spec_parts_cached(lm_spec, device="cpu")
    blocks = {k: v for k, v in params.items() if k.startswith("block_")}
    io = {k: v for k, v in params.items() if not k.startswith("block_")}
    block_b, io_b = lm_param_bytes(blocks), lm_param_bytes(io)
    return {
        "full_bytes": lm_param_bytes(params),
        "block_bytes": block_b,
        "io_bytes": io_b,
        "per_member_bytes": io_b + block_b // max(1, int(pp)),
        "pp": int(pp),
    }


_SPEC_CACHE: Dict[str, Tuple[Any, Any]] = {}
#: the spec fields that make the params tree and its LMConfig
_TREE_KEYS = ("vocab_size", "d_model", "n_heads", "n_kv_heads", "n_layers", "d_ff", "dtype",
              "kv_quant", "seed", "weights")


def lm_spec_parts_cached(lm_spec: Dict[str, Any], device=None):
    """`lm_spec_parts` with a process cache keyed on the spec's tree
    fields and the device: the byte accounting and the engines read the
    same tree without building it again (specs that differ only in
    serving settings, such as max_len, share it)."""
    from .lm_backend import lm_spec_parts

    key = json.dumps({"spec": {k: lm_spec.get(k) for k in _TREE_KEYS}, "device": str(device)},
                     sort_keys=True, default=str)
    hit = _SPEC_CACHE.get(key)
    if hit is None:
        hit = lm_spec_parts(lm_spec, device=device)
        _SPEC_CACHE[key] = hit
    return hit


class PipelinedLMBackend:
    """GPipe-style pipeline-parallel LM serving over a mesh's ``pp``
    axis: `parallel.pipeline`'s schedule with what decode needs, per-stage
    KV caches and a ring token feedback (the last stage's greedy token
    rides the same wrap-around hop back to stage 0, where it embeds as
    the next step's input). Each pp rank holds its ``n_layers/pp``
    contiguous blocks (this rank's slice of the stacked block params) and
    the replicated embed/ln_out/lm_head; `pp_hbm_report` is the
    accounting.

    Schedule (JAX's, tick for tick):

    - **prefill**: microbatch m enters stage 0 at tick m; stage s
      applies its blocks with flash attention (K2, on GQA's kv head h //
      G directly) and writes its layers' KV rows; S + M - 1 ticks; the
      last stage reads each row's logits at its true length and takes
      the first token.
    - **decode**: microbatch m's token k occupies stage s at tick
      (k-1)·S + m + s. Attention is the float32 einsum over the cache (as
      JAX's, outside any kernel). Tokens travel on an int32 lane beside
      the hidden state.

    A rank skips the compute of a tick that JAX computes and masks out
    (outside the microbatch window), never the tick's shifts: the hidden
    state, then the token lane. So a `generate_batch` launches K2
    (n_layers / pp) x microbatches times on each rank. The first tokens
    and the decoded tokens are summed over pp as JAX's psum sums them
    (only the last stage's are non-zero).

    Greedy only; bf16/f32 cache layouts only (no kv_quant). JAX keeps at
    most `MAX_COMPILED_SHAPES` compiled programs; eager PyTorch compiles
    nothing, so the port has no such bound, but keeps JAX's shape
    rounding so that tick counts are JAX's."""

    def __init__(self, lm_spec: Dict[str, Any], mesh, microbatches: Optional[int] = None,
                 device=None):
        shape = dict(getattr(mesh, "shape", mesh) or {})
        self.pp = int(shape.get("pp", 1))
        if self.pp < 2:
            raise ValueError(f"pipeline serving needs a pp axis >= 2, mesh has pp={self.pp}")
        for ax in ("dp", "tp", "sp", "ep"):
            if shape.get(ax, 1) != 1:
                raise ValueError(
                    "the pipeline serving form parallelizes over `pp` only; mesh axis "
                    f"{ax}={shape[ax]} would replicate stage compute and misreport capacity")
        params, cfg = lm_spec_parts_cached(lm_spec, device="cpu")
        if cfg.kv_quant:
            raise ValueError("pipeline serving supports bf16/f32 KV cache layouts only "
                             "(no kv_quant)")
        if cfg.n_layers % self.pp:
            raise ValueError(f"n_layers {cfg.n_layers} not divisible by pp {self.pp}")
        self.cfg: LMConfig = cfg
        self.model = str(lm_spec.get("name", "LM"))
        self.max_new_tokens = int(lm_spec.get("max_new_tokens", 32))
        self.max_len = int(lm_spec.get("max_len", 1024))
        self.temperature = float(lm_spec.get("temperature", 0.0))
        if self.temperature != 0.0:
            raise ValueError("pipeline serving is greedy-only")
        self.microbatches = int(microbatches or self.pp)
        if not (1 <= self.microbatches <= self.pp):
            raise ValueError(f"microbatches {self.microbatches} must be in [1, pp={self.pp}] "
                             "(the ring holds at most one in-flight token per stage)")
        self.device = resolve_device(device)
        self.mesh = resolve_mesh(mesh)
        self.stage = self.mesh.coords["pp"]
        self.l_per = cfg.n_layers // self.pp
        # this rank's contiguous slice of the stacked blocks ([l_per, ...]
        # leaves), and the replicated io params; nothing else of the stack
        stacked = stack_stage_params([params[f"block_{i}"] for i in range(cfg.n_layers)])
        lo = self.stage * self.l_per
        self.stacked = {k: {kk: vv[lo:lo + self.l_per].to(self.device) for kk, vv in v.items()}
                        for k, v in stacked.items()}
        del stacked
        self.io = _tree_to({k: v for k, v in params.items() if not k.startswith("block_")},
                           self.device)
        self.hbm = pp_hbm_report(lm_spec, self.pp)
        self._per_query = 0.05
        self.tokens_delivered = 0
        self.batches_served = 0

    def held_bytes(self) -> int:
        """The weight bytes this rank holds (its blocks and the io params)."""
        return lm_param_bytes(self.stacked) + lm_param_bytes(self.io)

    def _block(self, l: int) -> Dict[str, Any]:
        return {k: {kk: vv[l] for kk, vv in v.items()} for k, v in self.stacked.items()}

    # -- the stage programs ---------------------------------------------

    @torch.no_grad()
    def _prefill(self, prompts_m: torch.Tensor, tps_m: torch.Tensor, slots: int, bucket: int):
        """S + M - 1 prefill ticks: (first tokens [M, mb], this stage's cache)."""
        cfg, s, stage, mesh = self.cfg, self.pp, self.stage, self.mesh
        m_count, mb = prompts_m.shape[:2]
        dev = self.device
        cache = init_cache(dataclasses.replace(cfg, n_layers=self.l_per), slots, self.max_len,
                           device=dev)
        firsts = torch.zeros((m_count, mb), dtype=torch.int32, device=dev)
        act = torch.zeros((mb, bucket, cfg.d_model), dtype=cfg.dtype, device=dev)
        tables = rope_tables(torch.arange(bucket, device=dev), cfg.head_dim)
        rows = torch.arange(mb, device=dev)
        for t in range(s + m_count - 1):
            m = t - stage
            if 0 <= m < m_count:
                off = m * mb
                x = (self.io["embed"]["embedding"][prompts_m[m].long()].to(cfg.dtype)
                     if stage == 0 else act)
                for l in range(self.l_per):
                    x, k, v = _apply_block(self._block(l), cfg, x, tables,
                                           lambda q, k, v: flash_attention(q, k, v, causal=True))
                    lay = cache[f"block_{l}"]
                    lay["k"][off:off + mb, :, :bucket] = k.transpose(1, 2)
                    lay["v"][off:off + mb, :, :bucket] = v.transpose(1, 2)
                if stage == s - 1:
                    # each row's logits at its true length: an unpadded prefill's
                    last = (tps_m[m].long() - 1).clamp(0, bucket - 1)
                    firsts[m] = _head(self.io, cfg, x[rows, last][:, None]).argmax(-1).to(
                        torch.int32)
            else:
                x = torch.zeros_like(act)
            act = ring_shift(x, mesh, "pp")
        all_reduce(firsts, mesh, "pp")
        return firsts, cache

    @torch.no_grad()
    def _decode(self, cache, firsts: torch.Tensor, pos0: torch.Tensor, t_new: int):
        """The decode ticks: tokens [t_new, M, mb] (row 0 unused: the
        first tokens are the prefill's)."""
        cfg, s, stage, mesh = self.cfg, self.pp, self.stage, self.mesh
        m_count, mb = firsts.shape
        dev, max_len = self.device, self.max_len
        hd, grp = cfg.head_dim, cfg.n_heads // cfg.kv_heads
        n_ticks = (t_new - 1) * s + m_count - 1 if t_new > 1 else 0
        out = torch.zeros((t_new, m_count, mb), dtype=torch.int32, device=dev)
        act = torch.zeros((mb, cfg.d_model), dtype=cfg.dtype, device=dev)
        ids = torch.zeros((mb,), dtype=torch.int32, device=dev)
        rows = torch.arange(mb, device=dev)
        cols = torch.arange(max_len, device=dev)
        for t in range(n_ticks):
            v_idx = t - stage
            vc = min(max(v_idx, 0), n_ticks)
            m, k = vc % s, vc // s + 1
            tok = None
            if v_idx >= 0 and m < m_count and k < t_new:
                off = m * mb
                if stage == 0:
                    x = self.io["embed"]["embedding"][
                        (firsts[m] if k == 1 else ids).long()].to(cfg.dtype)[:, None, :]
                else:
                    x = act[:, None, :]
                # input token k-1 of each row sits at position tp + k - 1;
                # a write past the cache (budgets rounded up) lands on the
                # last row, never a live position (tp + budget <= max_len)
                pos = pos0[m].long() + (k - 1)
                at = pos.clamp(max=max_len - 1)
                tables = rope_tables(pos[:, None], hd)
                valid = cols[None, :] <= pos[:, None]

                def attn_fn(q, k_new, v_new, l):
                    lay = cache[f"block_{l}"]
                    lay["k"][off + rows, :, at] = k_new[:, 0].to(cfg.dtype)
                    lay["v"][off + rows, :, at] = v_new[:, 0].to(cfg.dtype)
                    ck = lay["k"][off:off + mb].to(torch.float32)
                    cv = lay["v"][off:off + mb].to(torch.float32)
                    qg = q.to(torch.float32).reshape(mb, 1, cfg.kv_heads, grp, hd)
                    sc = torch.einsum("bqkgd,bktd->bkgqt", qg, ck) * (hd ** -0.5)
                    sc = torch.where(valid[:, None, None, None, :], sc,
                                     torch.full_like(sc, -1e30))
                    p = torch.softmax(sc, dim=-1)
                    attn = torch.einsum("bkgqt,bktd->bqkgd", p, cv)
                    return attn.reshape(mb, 1, cfg.n_heads, hd)

                for l in range(self.l_per):
                    x, _, _ = _apply_block(self._block(l), cfg, x, tables,
                                           lambda q, kk, vv, l=l: attn_fn(q, kk, vv, l))
                if stage == s - 1:
                    tok = _head(self.io, cfg, x).argmax(-1).to(torch.int32)
                    out[k, m] = tok
                h = x[:, 0, :]
            else:
                h = torch.zeros_like(act)
            act = ring_shift(h, mesh, "pp")
            ids = ring_shift(tok if tok is not None else ids, mesh, "pp")
        if n_ticks:
            all_reduce(out, mesh, "pp")
        return out

    # -- serving --------------------------------------------------------

    def generate_batch(self, prompts: Sequence[np.ndarray], budgets: Sequence[int]
                       ) -> List[List[int]]:
        """Decode a batch through the pipeline; returns each prompt's
        generated tokens (as many as its budget). The whole batch decodes
        to the largest budget (rounded up to a power of two, as the
        microbatch group count is; padding costs ticks, never answers)
        and each row keeps its own."""
        from .lm_server import _bucket

        if not prompts:
            return []
        prompts = [np.asarray(p, np.int32).reshape(-1) for p in prompts]
        budgets = [int(b) for b in budgets]
        for p, b in zip(prompts, budgets):
            if p.size == 0:
                raise ValueError("empty prompt")
            if b < 1:
                raise ValueError("budget must be >= 1")
            if p.size + b > self.max_len:
                raise ValueError(f"prompt {p.size} + budget {b} exceeds max_len {self.max_len}")
        n = len(prompts)
        t_new = max(budgets)
        if t_new > 1:
            t_new = 1 << (t_new - 1).bit_length()
        t_new = min(t_new, self.max_len - 1)
        bucket = min(_bucket(max(p.size for p in prompts)), self.max_len)
        m_groups = -(-n // self.microbatches)
        m_groups = 1 << (m_groups - 1).bit_length()
        slots = m_groups * self.microbatches
        padded = np.zeros((slots, bucket), np.int32)
        tps = np.ones(slots, np.int32)
        for i in range(slots):
            p = prompts[i if i < n else 0]  # dummy rows repeat row 0
            padded[i, : p.size] = p
            padded[i, p.size:] = p[-1]  # the server's pad policy
            tps[i] = p.size
        firsts_host, rest = self._run_batch(padded, tps, t_new)
        return [[int(firsts_host[i])] + [int(rest[k, i]) for k in range(1, budgets[i])]
                for i in range(n)]

    @seam
    def _run_batch(self, padded: np.ndarray, tps: np.ndarray, t_new: int
                   ) -> Tuple[np.ndarray, np.ndarray]:
        """The batch's device work (its prefill and decode ticks): the
        first tokens [slots] and the decoded ones [t_new, slots], on the
        host. Built through a group primary's world, every stage's rank
        runs it with the primary's arguments."""
        slots, bucket = padded.shape
        mb = slots // self.microbatches
        dev = self.device
        prompts_m = torch.from_numpy(padded).to(dev).reshape(self.microbatches, mb, bucket)
        tps_m = torch.from_numpy(tps).to(dev).reshape(self.microbatches, mb)
        firsts, cache = self._prefill(prompts_m, tps_m, slots, bucket)
        toks = self._decode(cache, firsts, tps_m, t_new)
        del cache
        return firsts.reshape(-1).cpu().numpy(), toks.reshape(t_new, -1).cpu().numpy()

    def serve_files(self, paths: Sequence[str], on_dispatch=None
                    ) -> Tuple[Dict[str, Any], float, Dict[str, float]]:
        """The `LMBackend.serve_files` contract: parse prompt files,
        pipeline-decode, key results by path."""
        from .lm_backend import parse_prompt_file

        parsed = [parse_prompt_file(p, self.cfg.vocab_size) for p in paths]
        prompts = [ids for ids, _ in parsed]
        budgets = [b if b is not None else self.max_new_tokens for _, b in parsed]
        t0 = time.monotonic()
        toks = self.generate_batch(prompts, budgets)
        infer_time = time.monotonic() - t0
        self.tokens_delivered += sum(len(t) for t in toks)
        self.batches_served += 1
        if paths:
            self._per_query = infer_time / len(paths)
        return ({p: {"tokens": list(t)} for p, t in zip(paths, toks)}, infer_time,
                self.cost_constants())

    async def backend(self, model: str, paths: Sequence[str]
                      ) -> Tuple[Dict[str, Any], float, Dict[str, float]]:
        del model
        return await asyncio.to_thread(self.serve_files, paths)

    def decode_tokens_total(self) -> int:
        return int(self.tokens_delivered)

    def cost_constants(self) -> Dict[str, float]:
        return {"load_time": 0.0, "first_query": self._per_query,
                "per_query": self._per_query, "batch_size": max(self.microbatches, 1)}

    def close(self) -> None:  # symmetry with LMBackend
        pass


# ----------------------------------------------------------------------
# KV-cache slab serialization (the prefill->decode handoff payload)
# ----------------------------------------------------------------------

_SLAB_MAGIC = b"KVS1"


def _leaf_bytes(a) -> Tuple[List[int], str, bytes]:
    """(shape, dtype name, C-order bytes) of a CPU or device tensor, or
    a numpy array; bfloat16 as its raw 2-byte words."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().contiguous()
        if a.dtype == torch.bfloat16:
            return list(a.shape), "bfloat16", a.view(torch.int16).numpy().tobytes()
        a = a.numpy()
    a = np.ascontiguousarray(a)
    return [int(s) for s in a.shape], a.dtype.name, a.tobytes()


def kv_slab_to_bytes(entries: Sequence[Dict[str, Any]]) -> bytes:
    """Serialize prefilled-request slabs into one transferable blob.

    Each entry: ``{"prompt_len", "budget", "first_token", "rows"}`` where
    `rows` is the per-layer cache for positions < prompt_len with the
    batch axis stripped: ``{block_i: {k, v: [KV, Tp, D]}}`` or the
    kv_quant layout (int8 values and f32 scales [KV, 1, Tp]). Leaves are
    walked in sorted order, each recording (shape, dtype), so every
    layout round-trips bit-exact; an optional ``draft`` list of tokens
    rides the header. The bytes are the JAX package's for the same
    entries."""
    header_entries = []
    bufs: List[bytes] = []
    for e in entries:
        leaves = []
        for name in sorted(e["rows"]):
            for key in sorted(e["rows"][name]):
                shape, dtype_name, data = _leaf_bytes(e["rows"][name][key])
                leaves.append([name, key, shape, dtype_name])
                bufs.append(data)
        he = {
            "prompt_len": int(e["prompt_len"]),
            "budget": int(e.get("budget", 0)),
            "first_token": int(e["first_token"]),
            "leaves": leaves,
        }
        if e.get("draft") is not None:
            he["draft"] = [int(t) for t in e["draft"]]
        header_entries.append(he)
    header = json.dumps({"entries": header_entries}, separators=(",", ":")).encode()
    return _SLAB_MAGIC + struct.pack("!I", len(header)) + header + b"".join(bufs)


def _leaf_from(data: bytes, off: int, shape, dtype_name: str) -> Tuple[torch.Tensor, int]:
    count = int(np.prod(shape, dtype=np.int64))
    dt = np.dtype(np.int16) if dtype_name == "bfloat16" else np.dtype(dtype_name)
    end = off + count * dt.itemsize
    if end > len(data):
        raise ValueError("truncated KV slab")
    t = torch.from_numpy(np.frombuffer(data, dtype=dt, count=count, offset=off).copy())
    if dtype_name == "bfloat16":
        t = t.view(torch.bfloat16)
    return t.reshape([int(s) for s in shape]), end


def kv_slab_from_bytes(data: bytes) -> List[Dict[str, Any]]:
    """Inverse of `kv_slab_to_bytes` (rows as CPU tensors); raises
    ValueError on a truncated or foreign blob (the decode side then falls
    back to a local prefill)."""
    if data[:4] != _SLAB_MAGIC:
        raise ValueError("not a KV slab (bad magic)")
    if len(data) < 8:
        raise ValueError("truncated KV slab")
    (hlen,) = struct.unpack("!I", data[4:8])
    try:
        header = json.loads(data[8:8 + hlen].decode())
    except (ValueError, UnicodeDecodeError):
        raise ValueError("truncated KV slab header") from None
    off = 8 + hlen
    out: List[Dict[str, Any]] = []
    for e in header["entries"]:
        rows: Dict[str, Dict[str, torch.Tensor]] = {}
        for name, key, shape, dtype_name in e["leaves"]:
            rows.setdefault(name, {})[key], off = _leaf_from(data, off, shape, dtype_name)
        entry = {"prompt_len": int(e["prompt_len"]), "budget": int(e["budget"]),
                 "first_token": int(e["first_token"]), "rows": rows}
        if e.get("draft") is not None:
            entry["draft"] = [int(t) for t in e["draft"]]
        out.append(entry)
    if off != len(data):
        raise ValueError("KV slab size mismatch")
    return out


#: max payload bytes per pushed stream chunk: the decode side adopts
#: early requests while later ones still transfer
SLAB_STREAM_CHUNK = 1 << 18


async def push_slab_entry(feed, idx: int, blob: bytes) -> None:
    """Frame one request's serialized slab onto a live feed: a JSON
    header chunk ``{"i", "size"}``, then the blob in `SLAB_STREAM_CHUNK`
    pieces, each through the feed's backpressured ``put``."""
    await feed.put(json.dumps({"i": int(idx), "size": len(blob)}).encode())
    for off in range(0, len(blob), SLAB_STREAM_CHUNK):
        await feed.put(blob[off:off + SLAB_STREAM_CHUNK])


async def push_slab_error(feed, idx: int, error: str) -> None:
    """Frame a per-request prefill failure: the decode side prefills
    exactly this request locally."""
    await feed.put(json.dumps({"i": int(idx), "error": str(error)[:500]}).encode())


async def iter_slab_stream(chunks):
    """Async generator over a framed slab stream: yields ``(index,
    entry_or_None)`` per request as its chunks complete (None for a
    request the peer reported failed). Raises ValueError on a garbled
    frame, an overrun of the declared size, or a stream that ends
    mid-entry."""
    header: Optional[Dict[str, Any]] = None
    buf: List[bytes] = []
    got = 0
    async for chunk in chunks:
        if header is None:
            try:
                header = json.loads(chunk.decode())
                if not isinstance(header, dict) or "i" not in header:
                    raise ValueError
            except (ValueError, UnicodeDecodeError):
                raise ValueError("garbled slab-stream header frame") from None
            if "error" in header:
                yield int(header["i"]), None
                header = None
                continue
            buf, got = [], 0
            if int(header.get("size", -1)) < 0:
                raise ValueError("slab-stream header without size")
            if header["size"] == 0:
                raise ValueError("zero-size slab entry")
            continue
        buf.append(chunk)
        got += len(chunk)
        if got > int(header["size"]):
            raise ValueError(f"slab stream overran its declared size ({got} > {header['size']})")
        if got == int(header["size"]):
            entries = kv_slab_from_bytes(b"".join(buf))
            if len(entries) != 1:
                raise ValueError(f"slab-stream entry held {len(entries)} slabs")
            yield int(header["i"]), entries[0]
            header = None
    if header is not None:
        raise ValueError("slab stream ended mid-entry")


# ----------------------------------------------------------------------
# prefill-role worker
# ----------------------------------------------------------------------


class LMPrefillBackend:
    """The prefill half of disaggregated serving: one bucket-padded
    prefill per prompt (K2 once per layer), its KV rows for the prompt's
    positions and the first greedy token as a slab. Reading the logits
    at tp - 1 keeps the first token an unpadded forward's, so the decode
    side's adopted continuation is token for token its own local
    prefill's (greedy). Runs where `params` live.

    ``draft=(draft_params, draft_cfg)`` with ``draft_k > 0`` also runs
    the draft model on prompt + first token and ships its k proposals in
    the slab header; a failed draft forfeits the shipment, never the
    slab. ``min_prefill_s`` pads each request to a floor of seconds (0
    in production)."""

    def __init__(self, params: Any, cfg: LMConfig, max_len: int = 1024,
                 min_prefill_s: float = 0.0, draft: Optional[Tuple[Any, Any]] = None,
                 draft_k: int = 0):
        self.params = params
        self.cfg = cfg
        self.max_len = int(max_len)
        self.slabs_built = 0
        self.draft = draft
        self.draft_k = int(draft_k)
        self.drafts_shipped = 0
        self.min_prefill_s = float(min_prefill_s)

    def prefill_one(self, prompt: np.ndarray, budget: int,
                    draft_k: Optional[int] = None) -> Dict[str, Any]:
        from .lm_server import _bucket

        t0 = time.monotonic()
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        tp = int(prompt.size)
        if tp == 0:
            raise ValueError("empty prompt")
        if tp + int(budget) > self.max_len:
            raise ValueError(f"prompt {tp} + budget {budget} exceeds max_len {self.max_len}")
        bucket = min(_bucket(tp), self.max_len)
        padded = np.zeros((1, bucket), np.int32)
        padded[0, :tp] = prompt
        padded[0, tp:] = prompt[-1]  # the server's pad policy
        dev = self.params["embed"]["embedding"].device
        # a cache of `bucket` rows: the slab carries positions < tp only
        logits, pcache = prefill(self.params, self.cfg, torch.from_numpy(padded).to(dev),
                                 bucket, logits_index=tp - 1)
        first = int(logits.argmax(-1)[0])
        rows: Dict[str, Dict[str, torch.Tensor]] = {}
        for name, kv in pcache.items():
            rows[name] = {}
            for key, arr in kv.items():
                t_axis = 2 if key.endswith("_s") else 1
                rows[name][key] = arr[0].narrow(t_axis, 0, tp).contiguous().cpu()
        entry = {"prompt_len": tp, "budget": int(budget), "first_token": first, "rows": rows}
        k = self.draft_k if draft_k is None else min(int(draft_k), self.draft_k)
        if self.draft is not None and k > 0 and int(budget) > 1:
            # the draft's greedy continuation after [prompt, first]: what a
            # decode-side draft would propose from (cur=first, pos=tp)
            try:
                dparams, dcfg = self.draft
                ddev = dparams["embed"]["embedding"].device
                ext = torch.from_numpy(np.concatenate([prompt, np.asarray([first], np.int32)]))
                d = generate(dparams, dcfg, ext[None].to(ddev), int(k))[0]
                entry["draft"] = [int(t) for t in d.cpu().tolist()]
                self.drafts_shipped += 1
            except Exception as e:
                log.warning("draft shipment failed (%r); slab only", e)
        if self.min_prefill_s > 0:
            left = self.min_prefill_s - (time.monotonic() - t0)
            if left > 0:
                time.sleep(left)
        return entry

    def slabs_bytes(self, prompts: Sequence[Sequence[int]], budgets: Sequence[int],
                    draft_k: Optional[int] = None) -> bytes:
        entries = [self.prefill_one(np.asarray(p, np.int32), b, draft_k=draft_k)
                   for p, b in zip(prompts, budgets)]
        self.slabs_built += len(entries)
        _M_PREFILL_SLABS.inc(len(entries))
        return kv_slab_to_bytes(entries)

    async def stream_slabs(self, prompts: Sequence[Sequence[int]], budgets: Sequence[int],
                           feed, draft_k: Optional[int] = None) -> None:
        """Prefill each prompt in turn and push its framed slab the moment
        it is built (transfer overlaps compute); a per-request failure
        frames an error entry. The feed closes at the end either way."""
        try:
            for i, (p, b) in enumerate(zip(prompts, budgets)):
                try:
                    entry = await asyncio.to_thread(self.prefill_one, np.asarray(p, np.int32),
                                                    int(b), draft_k)
                    blob = kv_slab_to_bytes([entry])
                except asyncio.CancelledError:
                    raise
                except Exception as e:
                    await push_slab_error(feed, i, repr(e))
                    continue
                await push_slab_entry(feed, i, blob)
                self.slabs_built += 1
                _M_PREFILL_SLABS.inc()
        finally:
            feed.close()


# ----------------------------------------------------------------------
# group backends (decode side)
# ----------------------------------------------------------------------


def _member_check(
    group_name: Optional[str],
    members: Tuple[str, ...],
    alive_fn: Optional[Callable[[], Set[str]]],
) -> None:
    if members and alive_fn is not None:
        from ..jobs.groups import _check_members

        _check_members(group_name or "?", members, alive_fn)


def sharded_lm_group_backend(
    be,  # LMBackend over the group mesh (sharded_lm_backend)
    *,
    model_name: str,
    group_name: str,
    members: Tuple[str, ...] = (),
    alive_fn: Optional[Callable[[], Set[str]]] = None,
    capacity: Optional[float] = None,
    mode: str = "resident",
):
    """JobService LM GROUP backend over a mesh-sharded `LMBackend`:
    the LM analog of `jobs.groups.sharded_backend`. Serves exactly
    one model (``backend.model``); member liveness is checked around
    the decode so a mid-batch group degradation raises
    `GroupDegraded` (-> TASK_FAIL -> requeue onto the single-chip
    pool) instead of acking tokens a broken mesh could not have
    produced."""
    cap = float(capacity if capacity is not None
                else max(len(members), 1))

    async def backend(model: str, paths: List[str]):
        from ..parallel import group_world

        _member_check(group_name, members, alive_fn)
        group_world.refuse(backend, be)
        try:
            results, infer_time, cost = await asyncio.to_thread(
                be.serve_files, list(paths)
            )
        except Exception as e:
            group_world.refuse(backend, be, e)  # a lost rank: GroupDegraded
            raise
        _member_check(group_name, members, alive_fn)
        _M_SHARDED_BATCHES.inc(group=group_name, mode=mode)
        _M_SHARDED_TOKENS.inc(
            sum(len(v.get("tokens", ())) for v in results.values()),
            group=group_name,
        )
        return results, infer_time, cost

    backend.model = model_name
    backend.group_name = group_name
    backend.capacity = cap
    backend.lm_backend = be
    return backend


class DisaggLMBackend:
    """Decode-role group backend with the prefill offloaded: scatter
    the batch's prompt token ids across EVERY live prefill-role
    member (multi-prefill fan-out), pull each peer's serialized KV
    slabs back over the data plane, adopt them into the
    (weight-resident sharded) decode server, stream tokens through
    the normal completion path.

    Two handoff forms:

    - ``handoff="stream"`` (default): each peer ACKs a live
      data-plane stream token IMMEDIATELY and pushes per-request slab
      chunks as its prefills complete (`LMPrefillBackend.stream_slabs`
      -> `iter_slab_stream`); the decode primary adopts each request
      into a free slot the moment ITS chunks land — transfer overlaps
      prefill compute and the first decoded token leaves before the
      last prefill chunk is even computed.
    - ``handoff="slab"``: the whole-slab pull (one blob per peer
      after its whole share prefilled), kept as the bench's measured
      comparison baseline.

    Fallback discipline is PER REQUEST: a dead/straggling peer, a
    tunnel fault mid-stream, a garbled chunk, a truncated slab, or a
    failed adoption demotes exactly the affected requests to LOCAL
    prefill on the decode engine
    (``jobs_kv_handoff_total{result="fallback"}`` per request; adopted
    requests tick ``result="ok"``). Greedy outputs are identical
    either way, so ANY handoff failure changes throughput
    attribution, never answers."""

    #: shares whose combined token count exceeds this ride the local
    #: path: the UDP control frame caps at ~60 KB and the ids travel
    #: as JSON ints
    MAX_FRAME_TOKENS = 8_000

    def __init__(
        self,
        be,  # LMBackend over the group mesh (decode side)
        *,
        model_name: str,
        group_name: str,
        node,
        store,
        members: Tuple[str, ...] = (),
        alive_fn: Optional[Callable[[], Set[str]]] = None,
        capacity: Optional[float] = None,
        prefill_timeout: float = 30.0,
        handoff: str = "stream",
        fanout: int = 0,
        draft_k: int = 0,
    ):
        if handoff not in ("stream", "slab"):
            raise ValueError(f"unknown handoff form {handoff!r}")
        self.be = be
        self.model = model_name
        self.group_name = group_name
        self.node = node
        self.store = store
        self.members = tuple(members)
        self.alive_fn = alive_fn
        self.capacity = float(
            capacity if capacity is not None else max(len(members), 1)
        )
        self.prefill_timeout = float(prefill_timeout)
        self.handoff = handoff
        #: max prefill peers a batch scatters across; 0 = all alive
        self.fanout = int(fanout)
        self._roles = node.spec.group_roles_unique(group_name)
        self.handoffs = 0  # requests adopted from a peer slab
        self.handoff_bytes = 0
        self.fallbacks = 0  # requests locally prefilled instead
        #: requests kept LOCAL because the decode server's KV prefix
        #: cache already covers their prompt (inference/kv_cache.py) —
        #: a warm start, not a handoff failure
        self.warm_locals = 0
        self.last_ttft_s: Optional[float] = None
        self.lm_backend = be
        #: remote-draft speculation: ask prefill peers to ship this
        #: many draft tokens with each slab (0 = none). Peers without
        #: a draft model simply omit the field; the decode side's
        #: verify round treats an absent shipment as zero acceptance,
        #: so a peer killed mid-verify (chaos) degrades to the plain
        #: per-request local-fallback story with identical outputs.
        self.draft_k = int(draft_k)

    def _prefill_peers(self) -> List[Any]:
        """Alive prefill-role members (not this node), deterministic
        order, capped at `fanout` when set."""
        alive = self.alive_fn() if self.alive_fn is not None else set()
        me = self.node.me.unique_name
        peers = [
            self.node.spec.node_by_unique_name(u)
            for u in sorted(self._roles)
            if self._roles[u] == "prefill" and u != me and u in alive
        ]
        if self.fanout > 0:
            peers = peers[: self.fanout]
        return peers

    async def _prefill_rpc(
        self, peer, model: str, prompts: List[np.ndarray],
        budgets: List[int], stream: bool,
        traces: Optional[List[Dict[str, Any]]] = None,
    ) -> Dict[str, Any]:
        """LM_PREFILL_REQUEST with one retry (at-most-once UDP): a
        single dropped frame costs half the window, not all of it;
        a duplicate just mints another token/stream the TTL reaps.
        ``traces`` ships the share's per-request trace contexts so the
        prefill member's span lands in the stitched cross-node tree."""
        from ..cluster.wire import MsgType

        reply = None
        for _ in range(2):
            try:
                reply = await self.node.request(
                    peer, MsgType.LM_PREFILL_REQUEST,
                    {
                        "model": model,
                        "prompts": [[int(t) for t in p] for p in prompts],
                        "budgets": [int(b) for b in budgets],
                        "stream": bool(stream),
                        **({"draft_k": self.draft_k}
                           if self.draft_k > 0 else {}),
                        **({"traces": traces} if traces else {}),
                    },
                    timeout=self.prefill_timeout / 2,
                )
                break
            except (TimeoutError, asyncio.TimeoutError):
                continue
        if reply is None:
            raise TimeoutError(
                f"prefill peer {peer} never answered "
                f"({self.prefill_timeout:g}s)"
            )
        if not reply.get("ok"):
            raise RuntimeError(f"prefill peer: {reply.get('error')}")
        return reply

    async def _fetch_slabs(
        self, model: str, prompts: List[np.ndarray], budgets: List[int],
        peer=None, traces: Optional[List[Dict[str, Any]]] = None,
    ) -> Optional[List[Dict[str, Any]]]:
        """Whole-slab pull of one peer's share (``handoff="slab"``).
        Returns the share's slab entries, or None when no peer is
        available/eligible."""
        from ..cluster.store_service import data_addr

        if peer is None:
            peers = self._prefill_peers()
            peer = peers[0] if peers else None
        if peer is None:
            return None
        if sum(int(p.size) for p in prompts) > self.MAX_FRAME_TOKENS:
            return None
        t0 = time.monotonic()
        reply = await self._prefill_rpc(
            peer, model, prompts, budgets, stream=False, traces=traces
        )
        data = await self.store.data_plane.fetch_token_bytes(
            data_addr(peer), reply["token"],
            timeout=self.prefill_timeout,
        )
        slabs = kv_slab_from_bytes(data)
        if len(slabs) != len(prompts):
            raise ValueError(
                f"peer returned {len(slabs)} slabs for "
                f"{len(prompts)} prompts"
            )
        _M_HANDOFF_T.observe(time.monotonic() - t0)
        _M_HANDOFF_BYTES.inc(len(data))
        self.handoff_bytes += len(data)
        return slabs

    def _shares(
        self, n: int, n_peers: int
    ) -> List[List[int]]:
        """Contiguous near-equal index shares, one per peer — request
        order within a share is prompt order, so a peer's stream
        adopts in the order the decode grid wants them."""
        if n_peers <= 0:
            return []
        base, extra = divmod(n, n_peers)
        shares: List[List[int]] = []
        start = 0
        for j in range(n_peers):
            size = base + (1 if j < extra else 0)
            shares.append(list(range(start, start + size)))
            start += size
        return shares

    def _share_spans(
        self, ctxs: Optional[List[Optional[TraceContext]]],
        idxs: List[int], delivered: Set[int], peer,
        t0_wall: float, failed: bool,
    ) -> None:
        """One `handoff` span per sampled request of a share; a
        request the share failed to deliver carries the ``fallback``
        event (a tail exemplar, captured regardless of sampling — the
        demotion to local prefill is exactly what explains that
        request's tail latency)."""
        if not ctxs:
            return
        t1_wall = time.time()
        for gi, c in zip(idxs, ctxs):
            if c is None:
                continue
            s = TRACER.start_span(
                "handoff", ctx=c, node=self.node.me.unique_name,
                t0=t0_wall,
                labels={"peer": getattr(peer, "unique_name", str(peer)),
                        "group": self.group_name,
                        "form": self.handoff},
            )
            if failed and gi not in delivered:
                s.event("fallback")
                s.label(result="fallback")
            else:
                s.label(result="ok")
            s.end(t1_wall)

    async def _pull_share_stream(
        self, peer, model: str, idxs: List[int],
        prompts: List[np.ndarray], budgets: List[int], arrivals,
        ctxs: Optional[List[Optional[TraceContext]]] = None,
    ) -> None:
        """One peer's streamed share: RPC for the stream token, then
        reassemble per-request entries as their chunks land, handing
        each to the decode thread's arrival queue. ANY failure demotes
        the share's REMAINING requests to local prefill — requests
        already handed over stay adopted."""
        from ..cluster.store_service import data_addr

        t0 = time.monotonic()
        t0_wall = time.time()
        delivered: Set[int] = set()
        try:
            if sum(int(prompts[i].size) for i in idxs) \
                    > self.MAX_FRAME_TOKENS:
                raise ValueError("share exceeds control-frame budget")
            reply = await self._prefill_rpc(
                peer, model,
                [prompts[i] for i in idxs],
                [budgets[i] for i in idxs],
                stream=True,
                traces=[c.to_wire() for c in (ctxs or []) if c],
            )
            if not reply.get("stream"):
                # old-form peer: its token is a whole-slab file —
                # treat as a one-shot arrival of the whole share
                data = await self.store.data_plane.fetch_token_bytes(
                    data_addr(peer), reply["token"],
                    timeout=self.prefill_timeout,
                )
                slabs = kv_slab_from_bytes(data)
                if len(slabs) != len(idxs):
                    raise ValueError("slab count mismatch")
                _M_HANDOFF_BYTES.inc(len(data))
                self.handoff_bytes += len(data)
                for i, entry in zip(idxs, slabs):
                    arrivals.put_nowait((i, entry))
                    delivered.add(i)
                self._share_spans(ctxs, idxs, delivered, peer,
                                  t0_wall, failed=False)
                return
            chunks = self.store.data_plane.fetch_stream(
                data_addr(peer), reply["token"],
                timeout=self.prefill_timeout,
            )
            async for local_i, entry in iter_slab_stream(
                _counting(chunks, lambda n: _note_bytes(self, n))
            ):
                if not (0 <= local_i < len(idxs)):
                    raise ValueError(
                        f"peer streamed unknown index {local_i}"
                    )
                gi = idxs[local_i]
                arrivals.put_nowait((gi, entry))
                delivered.add(gi)
            if len(delivered) != len(idxs):
                raise ValueError(
                    f"stream ended after {len(delivered)}/{len(idxs)} "
                    "entries"
                )
            _M_HANDOFF_T.observe(time.monotonic() - t0)
            self._share_spans(ctxs, idxs, delivered, peer,
                              t0_wall, failed=False)
        except asyncio.CancelledError:
            raise
        except Exception as e:
            log.warning(
                "%s: streamed KV handoff from %s failed (%r); local "
                "prefill for its %d remaining request(s)",
                self.group_name, peer, e, len(idxs) - len(delivered),
            )
            self._share_spans(ctxs, idxs, delivered, peer,
                              t0_wall, failed=True)
            for i in idxs:
                if i not in delivered:
                    arrivals.put_nowait((i, None))

    async def _pull_share_slab(
        self, peer, model: str, idxs: List[int],
        prompts: List[np.ndarray], budgets: List[int], arrivals,
        ctxs: Optional[List[Optional[TraceContext]]] = None,
    ) -> None:
        """One peer's whole-slab share (the comparison form)."""
        t0_wall = time.time()
        try:
            slabs = await self._fetch_slabs(
                model,
                [prompts[i] for i in idxs],
                [budgets[i] for i in idxs],
                peer=peer,
                traces=[c.to_wire() for c in (ctxs or []) if c],
            )
            if slabs is None:
                raise RuntimeError("no eligible peer/share")
            for i, entry in zip(idxs, slabs):
                arrivals.put_nowait((i, entry))
            self._share_spans(ctxs, idxs, set(idxs), peer,
                              t0_wall, failed=False)
        except asyncio.CancelledError:
            raise
        except Exception as e:
            log.warning(
                "%s: KV handoff from %s failed (%r); local prefill "
                "for its %d request(s)",
                self.group_name, peer, e, len(idxs),
            )
            self._share_spans(ctxs, idxs, set(), peer,
                              t0_wall, failed=True)
            for i in idxs:
                arrivals.put_nowait((i, None))

    async def __call__(
        self, model: str, paths: List[str], on_token=None
    ):
        import queue as _queue

        from ..parallel import group_world
        from .lm_backend import parse_prompt_file

        _member_check(self.group_name, self.members, self.alive_fn)
        group_world.refuse(self, self.be)
        parsed = [
            parse_prompt_file(p, self.be.cfg.vocab_size) for p in paths
        ]
        prompts = [ids for ids, _ in parsed]
        budgets = [
            b if b is not None else self.be.max_new_tokens
            for _, b in parsed
        ]
        # validate against decode capacity BEFORE spending a handoff
        for p, prompt, budget in zip(paths, prompts, budgets):
            if prompt.size + budget > self.be.server.max_len:
                raise ValueError(
                    f"{p}: prompt of {prompt.size} tokens + budget "
                    f"{budget} exceeds the server's max_len "
                    f"{self.be.server.max_len}"
                )
        peers = self._prefill_peers()
        arrivals: "_queue.Queue" = _queue.Queue()
        tasks: List[asyncio.Task] = []
        t_batch0 = time.monotonic()
        # per-request trace contexts, routed by local path (the job
        # service re-keyed them before the backend call): request i's
        # prefill/handoff/decode spans land in ITS cross-node trace.
        # UNFILTERED on purpose: a fallback on an unsampled request
        # still pins its tail exemplar (the span records with the
        # context's own sampled flag; the exemplar pin is always-on),
        # while the decode span below gates on .sampled itself.
        by_path = {c.key: c for c in current_all_ctxs()}
        req_ctxs: List[Optional[TraceContext]] = [
            by_path.get(p) for p in paths
        ]
        # KV-prefix warm hits stay LOCAL: a prompt the decode server's
        # prefix cache already covers would have a peer recompute rows
        # the adopter then throws away — route it down the local-
        # prefill arm instead, where placement warm-starts with a
        # suffix-only prefill (inference/kv_cache.py). Peeked without
        # a pin: an entry evicted before placement just cold-prefills
        # locally, so the routing choice can never change answers.
        warm_idx: Set[int] = set()
        kvc = getattr(self.be.server, "kv_cache", None)
        if kvc is not None and self.be.server.temperature == 0.0:
            for i, p in enumerate(prompts):
                if kvc.match_len(p) > 0:
                    warm_idx.add(i)
                    arrivals.put_nowait((i, None))
        remote = [i for i in range(len(prompts)) if i not in warm_idx]
        if not peers:
            # no live prefill peer at all: every request is a typed
            # local fallback
            for i in remote:
                arrivals.put_nowait((i, None))
                TRACER.note_exemplar(
                    req_ctxs[i], "fallback",
                    node=self.node.me.unique_name,
                    labels={"group": self.group_name,
                            "reason": "no_prefill_peer"},
                )
        else:
            shares = self._shares(len(remote), len(peers))
            pull = (
                self._pull_share_stream if self.handoff == "stream"
                else self._pull_share_slab
            )
            for peer, share in zip(peers, shares):
                idxs = [remote[j] for j in share]
                if not idxs:
                    continue
                tasks.append(asyncio.ensure_future(pull(
                    peer, model, idxs, prompts, budgets, arrivals,
                    ctxs=[req_ctxs[i] for i in idxs],
                )))
        _member_check(self.group_name, self.members, self.alive_fn)
        ttft_box: List[float] = []

        def on_first() -> None:
            ttft_box.append(time.monotonic() - t_batch0)

        decode_wall0 = time.time()
        try:
            toks, infer_time, stats = await asyncio.to_thread(
                self.be.serve_prefilled_stream,
                prompts, budgets, arrivals,
                self.be._token_cbs(paths, on_token),
                on_first,
                max(self.prefill_timeout * 2, 30.0),
            )
        except Exception as e:
            group_world.refuse(self, self.be, e)  # a lost rank: GroupDegraded
            raise
        finally:
            for t in tasks:
                if not t.done():
                    t.cancel()
        decode_wall1 = time.time()
        for c in req_ctxs:
            if c is not None and c.sampled:
                TRACER.start_span(
                    "decode", ctx=c, node=self.node.me.unique_name,
                    t0=decode_wall0,
                    labels={"group": self.group_name,
                            "mode": "disagg",
                            "shared": len(prompts)},
                ).end(decode_wall1)
        self.last_ttft_s = ttft_box[0] if ttft_box else None
        self.handoffs += stats["adopted"]
        # warm-routed requests ride the "local" arm of the decode
        # stream but are cache HITS, not handoff failures — count them
        # apart so the fallback metric keeps meaning "a peer/handoff
        # let us down" (an entry evicted between the routing peek and
        # placement cold-prefills locally yet still counts warm here;
        # a routing-accuracy approximation, never an answer change)
        n_warm = len(warm_idx)
        fallbacks = max(0, stats["local"] - n_warm)
        self.fallbacks += fallbacks
        self.warm_locals += n_warm
        if stats["adopted"]:
            _M_HANDOFF.inc(stats["adopted"], result="ok")
        if fallbacks:
            _M_HANDOFF.inc(fallbacks, result="fallback")
        if n_warm:
            _M_HANDOFF.inc(n_warm, result="local_warm")
        results = {
            p: {"tokens": [int(t) for t in ts]}
            for p, ts in zip(paths, toks)
        }
        cost = self.be.cost_constants()
        _member_check(self.group_name, self.members, self.alive_fn)
        _M_SHARDED_BATCHES.inc(group=self.group_name, mode="disagg")
        _M_SHARDED_TOKENS.inc(
            sum(len(v.get("tokens", ())) for v in results.values()),
            group=self.group_name,
        )
        return results, infer_time, cost


def _counting(chunks, note):
    """Wrap an async chunk iterator, reporting each chunk's size."""
    async def it():
        async for c in chunks:
            note(len(c))
            yield c

    return it()


def _note_bytes(gb: "DisaggLMBackend", n: int) -> None:
    gb.handoff_bytes += n
    _M_HANDOFF_BYTES.inc(n)


# ----------------------------------------------------------------------
# memory budget and the speculative-decoding support table
# ----------------------------------------------------------------------


def check_hbm_budget(g, lm_spec: Dict[str, Any], pp: Optional[int] = None
                     ) -> Optional[Dict[str, Any]]:
    """Hold a `config.WorkerGroupSpec`'s ``hbm_bytes`` to the model's
    weights: a pp group passes when each member's slice
    (`pp_hbm_report`'s ``per_member_bytes``) fits; a non-pp group must
    fit the whole tree per member (the gather form and a fall-back to one
    device both hold it). ``pp`` overrides the spec's axis with the
    resolved mesh size (a spec axis of -1). Returns the report, or None
    when no budget is declared."""
    budget = int(getattr(g, "hbm_bytes", 0) or 0)
    if budget <= 0:
        return None
    if pp is None:
        pp = max(int(g.mesh.pp), 1)
    rep = pp_hbm_report(lm_spec, pp)
    need = rep["per_member_bytes"] if pp > 1 else rep["full_bytes"]
    if need > budget:
        hint = ("" if pp > 1 else " — a model bigger than one member's HBM needs a pp axis "
                "on the group mesh (pipeline-parallel serving)")
        raise RuntimeError(f"group {g.name}: model {lm_spec.get('name')!r} needs {need} bytes "
                           f"per member, hbm_bytes budget is {budget}{hint}")
    return rep


# Which serving forms support speculative decoding, and where the draft
# runs: "local" on the decode mesh, "shipped" by prefill-role peers in
# the slab header, False a typed exclusion (the pp engine's
# batch-granular schedule has no per-slot verify seam).
SPEC_DECODE_SUPPORT: Dict[str, Any] = {
    "resident": "local",
    "gather": "local",
    "disagg": "shipped",
    "pp": False,
}


def wire_lm_group(node, store, lm_spec: Dict[str, Any], device=None):
    """Production wiring for a NodeApp registering `lm_spec`: returns
    ``(group_backend, prefill_backend)`` for this node's role in a
    worker group that declares the model in ``lm_models`` — the LM
    analog of `jobs.groups.wire_group_backend`.

    - group PRIMARY: a sharded decode engine over the group mesh —
      PIPELINE-parallel when the group mesh has a ``pp`` axis > 1
      (each member holds only its layer-stack slice; models deeper
      than one member's HBM), else weight-resident tp-sharded; when
      any OTHER member carries the ``prefill`` role, the
      disaggregated form (multi-peer streamed prefill handoff +
      per-request local fallback; ``lm_spec["kv_handoff"]`` picks
      "stream" (default) or "slab", ``lm_spec["prefill_fanout"]``
      caps the peer fan-out, 0 = all alive);
    - prefill-role members: an `LMPrefillBackend` (serves
      LM_PREFILL_REQUEST, whole-slab and streamed forms);
    - everyone else (lenders without a role, ungrouped nodes):
      ``(None, None)`` — they serve single-chip like before.

    The engines run on `device` (`cuda` when None; it raises where
    there is none). The group mesh resolves over the group world
    (`jobs.groups.group_ranks`: one process per rank, where the JAX
    primary takes the host's devices); with a primary's world open
    (`parallel.group_world`), the mesh and the engine are built through
    it, and its follower ranks run every device call of the engine.

    Raises at startup if the group mesh wants more ranks than this
    process's world has (a group that silently served single-chip
    while the pool weighted it at group capacity would be slower than
    no groups at all — same contract as `group_engine_backend`), or if
    the model's per-member weight bytes exceed a declared
    ``hbm_bytes`` budget (`check_hbm_budget`).

    ``lm_spec["kv_cache_mb"]`` gives the tp/disagg decode primary a
    worker-resident KV prefix cache (inference/kv_cache.py): retired
    requests' slabs warm-start prompts that extend a cached prefix,
    and the disagg form keeps cache-covered prompts local instead of
    shipping them to a prefill peer. The pp>1 engine is excluded —
    its batch-granular stage schedule has no per-request slot
    adoption to warm-start (the tp x pp x cache composition rides
    with ROADMAP item 3's real-ICI remainder)."""
    spec = node.spec
    uname = node.me.unique_name
    g = spec.group_of_unique(uname)
    name = str(lm_spec.get("name", "LM"))
    if g is None or name not in g.lm_models:
        return None, None
    members = spec.group_members_unique(g.name)
    roles = spec.group_roles_unique(g.name)

    def alive() -> Set[str]:
        return {n.unique_name for n in node.membership.alive_nodes()}

    spec_k = int(lm_spec.get("spec_k", 0) or 0)
    prefill = None
    if roles.get(uname) == "prefill":
        if int(g.mesh.pp) == 1:
            # the prefill backend materializes the FULL tree, so the
            # budget gate must hold it to the full-tree bound
            check_hbm_budget(g, lm_spec, pp=1)
            params, cfg = lm_spec_parts_cached(lm_spec, device=device)
            draft = None
            if spec_k > 0:
                # prefill-role members idle during decode-heavy
                # phases; spec_k>0 puts the DRAFT model here so they
                # propose tokens for the decode primary to verify
                # (shipped in the slab header over the PR-8 wire
                # path). Same derivation as the local-draft form so
                # both placements propose identical tokens.
                from .lm_backend import LMBackend, lm_spec_parts

                dspec = LMBackend._draft_spec_of(lm_spec)
                if dspec is not None:
                    draft = lm_spec_parts(dspec, device=device)
            prefill = LMPrefillBackend(
                params, cfg, max_len=int(lm_spec.get("max_len", 1024)),
                draft=draft, draft_k=spec_k,
            )
        else:
            # a pp group's primary never sends LM_PREFILL_REQUEST (the
            # pipelined engine owns its own prefill schedule), so
            # building the full-tree prefill backend here would hold
            # weights the declared budget says don't fit — and never
            # serve a single slab (tp x pp x disagg composition is the
            # real-ICI remainder, ROADMAP item 3)
            log.warning(
                "%s: prefill role on %s ignored — the pp>1 serving "
                "form does not disaggregate", g.name, uname,
            )
    gb = None
    if members and uname == members[0]:
        from ..jobs.groups import group_ranks
        from ..parallel import group_world
        from ..parallel.mesh import make_mesh

        # through the primary's group world when one is open: every rank
        # builds the mesh (collective) and its copy of the engine
        mesh = group_world.build(
            make_mesh, g.mesh, ranks=group_ranks(g.name, g.mesh))
        pp = int(mesh.shape.get("pp", 1))
        # budget-check against the RESOLVED pp: a spec axis of -1
        # (fill remaining) may have resolved to a pipelined layout
        # that fits where the full tree would not
        check_hbm_budget(g, lm_spec, pp=pp)
        disagg = any(
            r == "prefill" for u, r in roles.items() if u != uname
        )
        if pp > 1:
            # pipeline-parallel primary: the layer stack shards over
            # pp; prefill disaggregation composes at the BATCH level
            # only (the pp engine owns its own pipelined prefill), so
            # role-split pp groups serve the pp form directly
            if spec_k > 0:
                # typed exclusion, not a crash: the pp engine's
                # batch-granular stage schedule has no per-slot
                # verify seam (SPEC_DECODE_SUPPORT["pp"] is False);
                # spec decode on pp rides ROADMAP item 4's remainder
                log.warning(
                    "%s: spec_k=%d on %s ignored — the pp>1 serving "
                    "form does not speculative-decode", g.name,
                    spec_k, uname,
                )
            be_pp = group_world.build(
                PipelinedLMBackend, lm_spec, mesh, device=device)
            cap = float(pp * mesh.shape.get("dp", 1))
            gb = sharded_lm_group_backend(
                be_pp, model_name=name, group_name=g.name,
                members=members, alive_fn=alive, capacity=cap,
                mode="pp",
            )
        else:
            # disagg decode primary arms shipped-draft verification
            # only (SPEC_DECODE_SUPPORT["disagg"] = "shipped"): the
            # draft lives on prefill-role peers, so the primary's
            # HBM and step loop carry zero draft cost; resident/
            # gather forms host the draft locally ("local")
            be = group_world.build(
                sharded_lm_backend, lm_spec, mesh, form="resident",
                spec_draft_local=not disagg, device=device,
            )
            cap = float(
                mesh.shape.get("dp", 1) * mesh.shape.get("tp", 1)
            )
            if disagg:
                gb = DisaggLMBackend(
                    be, model_name=name, group_name=g.name, node=node,
                    store=store, members=members, alive_fn=alive,
                    capacity=cap,
                    handoff=str(lm_spec.get("kv_handoff", "stream")),
                    fanout=int(lm_spec.get("prefill_fanout", 0) or 0),
                    draft_k=spec_k,
                )
            else:
                gb = sharded_lm_group_backend(
                    be, model_name=name, group_name=g.name,
                    members=members, alive_fn=alive, capacity=cap,
                )
    return gb, prefill


# ----------------------------------------------------------------------
# bench: the `cluster_lm_sharded` section's body (python -m
# dml_tpu_torch.inference.lm_sharded: this process runs the cluster and
# is rank 0 of the group's world; its follower rank is a `node --follow`
# process)
# ----------------------------------------------------------------------


def bench_lm_sharded_serving(
    n_prompts: int = 16,
    new_tokens: int = 16,
    base_port: int = 28961,
    steady_s: float = 4.0,
    tmp: Optional[str] = None,
    device=None,
    lm_overrides: Optional[Dict[str, Any]] = None,
    stats: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    """Sharded LM serving forms through the FULL cluster pipeline on
    one topology (H3 decode primary, H4+H5 prefill roles):

    - param_gather vs weight-resident tp=2,
    - PIPELINE-parallel pp=2 (layer stack split across members —
      models deeper than one member's HBM; `pp_hbm_report` records
      the budget story),
    - disaggregated prefill/decode with the handoff ladder: whole-
      slab pull vs chunk-STREAMED handoff (time-to-first-token must
      strictly drop — decode adopts request 0 while request N still
      prefills), and 1- vs 2-prefill-peer FAN-OUT on a prefill-heavy
      workload (context-phase throughput must rise),
    - a member-kill-MID-STREAM chaos case: the dying peer's in-flight
      share demotes to typed per-request local-prefill fallbacks,
      the job completes exactly once, tokens unchanged. The peers
      are DRAFT peers too (draft_k > 0, shipped-draft verification
      on the decode primary), so the kill also covers draft-proposal
      loss mid-verify,
    - after the cluster stops: the speculative-decoding A/B
      (`bench_specdec_arm` — speedup at a declared acceptance,
      real-draft auto-disable, token equality) and the
      continuous-batching TTFT A/B (`bench_cb_arm` — step-granular
      adoption vs batch-drain under staggered load).

    5-node topology: leader + standby + the three-member group means
    the formed group is the pool's ONLY slot, so every timed batch
    flows through the group engine and mode rates compare serving
    forms. What transfers is the token-equality contract (every
    mode's merged outputs == isolated generate(), f32 greedy) and the
    handoff/exactly-once machinery.

    The port's tp-2 and pp-2 meshes are a group world
    (`parallel.group_world`) over the same two ranks: this process,
    which runs the cluster, is rank 0, and one follower rank is a `node
    --follow 1` process this bench starts, its rendezvous under `tmp`
    (a fresh directory under the system's temporary root when None).
    The four group backends (resident, gather, the disaggregated
    form's resident backend with `spec_k`, pp) are built through it.
    Engines run on `device` (cuda when None; it raises where there is
    none); two ranks on one card exchange through the host (gloo), so
    the tok/s of the group forms time host staging, not an
    interconnect. `lm_overrides` updates the bench's LM spec (a
    smaller model for a quick run); the isolated `generate` reference
    is the port's own. `stats`, when given, receives the world's
    (`World.stats()`: calls, bytes, host seconds of its broadcasts and
    of the calls they carried)."""
    import contextlib
    import os
    import shutil
    import tempfile

    from ..cluster.chaos import LocalCluster
    from ..config import ClusterSpec, MeshSpec, Timing, WorkerGroupSpec, draft_lm_spec
    from ..jobs.service import JobService
    from ..models.lm_params import resolve_device
    from ..parallel import group_world
    from ..parallel.mesh import make_mesh
    from .lm_backend import LMBackend, lm_spec_parts, write_prompt_file

    dev = resolve_device(device)
    tmp = tmp or os.path.join(tempfile.gettempdir(), "dml_tpu_torch_bench_lm_sharded")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp, exist_ok=True)

    # d_model 384 (the JAX bench's): big enough that the gathered
    # form's 2x per-rank compute outweighs its partitioning overhead
    # (at d 64 the comparison would read backwards); head dim 96, its
    # draft's 48, which K2's float32 route and K4 take. n_layers 4 so
    # the pp=2 pipeline splits the stack evenly (2 blocks per stage).
    lm_spec = {
        "name": "ShardLM", "vocab_size": 128, "d_model": 384,
        "n_heads": 4, "n_kv_heads": 2, "n_layers": 4, "d_ff": 1536,
        "dtype": "float32", "max_new_tokens": new_tokens,
        "max_slots": 4, "max_len": 128, "seed": 0, "chunk": 8,
    }
    lm_spec.update(lm_overrides or {})
    params, cfg = lm_spec_parts(lm_spec, device=dev)
    spec_k_bench = 4
    # per-member HBM story: the pp split is what fits a member whose
    # budget sits between its layer slice and the full tree
    hbm = pp_hbm_report(lm_spec, 2)
    hbm_budget = (hbm["per_member_bytes"] + hbm["full_bytes"]) // 2
    group = WorkerGroupSpec(
        "pd0", ("H3", "H4", "H5"), MeshSpec(dp=1, tp=2),
        lm_models=("ShardLM",),
        roles={"H3": "decode", "H4": "prefill", "H5": "prefill"},
        hbm_bytes=hbm_budget,
    )
    model = "ShardLM"
    # the tp-2 and pp-2 meshes: this process and one follower rank
    worlds = contextlib.ExitStack()
    world = worlds.enter_context(group_world.local_world(
        ClusterSpec.localhost(5, base_port=base_port, worker_groups=[group]), "H3",
        os.path.join(tmp, "world"), device=dev))
    try:
        mesh = group_world.build(make_mesh, MeshSpec(dp=1, tp=2), ranks=range(2))
        mesh_pp = group_world.build(
            make_mesh, MeshSpec(dp=1, tp=1, pp=2), ranks=range(2)
        )
        # the group-engine forms share one deterministic tree; the
        # single-chip reference backend and the prefill workers use the
        # plain (single-device) placement of the SAME tree
        be_resident = group_world.build(
            sharded_lm_backend, lm_spec, mesh, form="resident", device=dev)
        be_gather = group_world.build(
            sharded_lm_backend, lm_spec, mesh, form="gather", device=dev)
        # the disagg decode primary arms SHIPPED-draft verification
        # (SPEC_DECODE_SUPPORT["disagg"]): prefill peers run the derived
        # draft and ship spec_k proposals in each slab header, the
        # primary verifies them on the adoption round — so the kill-H5
        # chaos case below doubles as the draft-peer-death-mid-verify
        # case (typed fallback, exactly-once tokens, equality asserted)
        be_disagg = group_world.build(
            sharded_lm_backend,
            {**lm_spec, "spec_k": spec_k_bench}, mesh, form="resident",
            spec_draft_local=False, device=dev,
        )
        be_pp = group_world.build(PipelinedLMBackend, lm_spec, mesh_pp, device=dev)
        be_single = LMBackend(
            params, cfg, max_new_tokens=new_tokens,
            max_slots=int(lm_spec["max_slots"]),
            max_len=int(lm_spec["max_len"]), chunk=int(lm_spec["chunk"]),
        )
        # one prefill backend PER prefill-role node, so the fan-out phase
        # can assert both peers actually built slabs; both carry the
        # derived draft model (random weights — draft QUALITY is not what
        # the handoff path scores; equality + exactly-once are)
        draft_parts = lm_spec_parts(draft_lm_spec(lm_spec), device=dev)
        prefill_bes = {
            "H4": LMPrefillBackend(
                params, cfg, max_len=lm_spec["max_len"],
                draft=draft_parts, draft_k=spec_k_bench,
            ),
            "H5": LMPrefillBackend(
                params, cfg, max_len=lm_spec["max_len"],
                draft=draft_parts, draft_k=spec_k_bench,
            ),
        }

        async def run() -> Dict[str, Any]:
            root = os.path.join(tmp, "cluster")
            os.makedirs(root, exist_ok=True)
            services: Dict[str, JobService] = {}

            def make_jobs(node, store):
                uname = node.me.unique_name
                alive = lambda: {  # noqa: E731
                    n.unique_name for n in node.membership.alive_nodes()
                }
                js = JobService(node, store)
                members = node.spec.group_members_unique(group.name)
                is_primary = bool(members) and uname == members[0]
                if is_primary:
                    def disagg(handoff, fanout):
                        return DisaggLMBackend(
                            be_disagg, model_name=model,
                            group_name=group.name, node=node, store=store,
                            members=members, alive_fn=alive, capacity=3.0,
                            prefill_timeout=8.0, handoff=handoff,
                            fanout=fanout, draft_k=spec_k_bench,
                        )

                    # mode-swapped during the run via set_mode below
                    js._lm_group_modes = {
                        "resident": sharded_lm_group_backend(
                            be_resident, model_name=model,
                            group_name=group.name, members=members,
                            alive_fn=alive, capacity=3.0, mode="resident",
                        ),
                        "gather": sharded_lm_group_backend(
                            be_gather, model_name=model,
                            group_name=group.name, members=members,
                            alive_fn=alive, capacity=3.0, mode="gather",
                        ),
                        "pp": sharded_lm_group_backend(
                            be_pp, model_name=model,
                            group_name=group.name, members=members,
                            alive_fn=alive, capacity=3.0, mode="pp",
                        ),
                        "disagg": disagg("stream", 0),
                        "disagg_stream_f1": disagg("stream", 1),
                        "disagg_stream_f2": disagg("stream", 2),
                        "disagg_slab_f1": disagg("slab", 1),
                    }
                pf = prefill_bes.get(node.me.name)
                js.register_lm(
                    model, backend=be_single.backend, cost=be_single.cost(),
                    prefill=pf,
                    group_backend=(
                        js._lm_group_modes["resident"] if is_primary
                        else None
                    ),
                )
                services[uname] = js
                return js

            cluster = LocalCluster(
                5, root, base_port,
                timing=Timing(ping_interval=0.2, ack_timeout=0.3,
                              cleanup_time=1.0, leader_rpc_timeout=10.0),
                worker_groups=[group],
                make_jobs=make_jobs,
            )
            try:
                await cluster.start()
                await cluster.wait_for(
                    cluster.converged, 20.0, "lm-sharded bench convergence"
                )
                members = cluster.spec.group_members_unique(group.name)
                # the chaos phase kills a prefill peer: the client driving
                # submit/wait/get-output must be NEITHER group member (a
                # dead client wedges its own wait_job forever) nor the
                # leader (client() excludes it)
                client = cluster.client(avoid=members)
                rng = np.random.RandomState(0)
                reference: Dict[str, List[int]] = {}
                for i in range(8):
                    prompt = rng.randint(0, cfg.vocab_size,
                                         int(rng.randint(6, 24)))
                    fname = f"prompt_{i}.tokens.txt"
                    p = os.path.join(root, fname)
                    write_prompt_file(p, prompt)
                    await client.store.put(p, fname)
                    reference[fname] = _generated(
                        params, cfg, np.asarray(prompt, np.int32), new_tokens)
                # prefill-heavy files for the handoff-comparison phase:
                # long prompts, tiny budgets — the wall IS context phase.
                # LOCAL files only (never store-put): the steady-mode jobs
                # wrap-sample every matching store object, and mixing
                # budget-4 files into them would corrupt the tok/s
                # accounting above
                ctx_budget = 4
                ctx_files = []
                ctx_prompt_toks = 0
                for i in range(6):
                    prompt = rng.randint(0, cfg.vocab_size,
                                         int(rng.randint(48, 64)))
                    fname = f"ctx_{i}.tokens.txt"
                    p = os.path.join(root, fname)
                    write_prompt_file(p, prompt, max_new_tokens=ctx_budget)
                    ctx_files.append(fname)
                    ctx_prompt_toks += int(prompt.size)
                    reference[fname] = _generated(
                        params, cfg, np.asarray(prompt, np.int32), ctx_budget)

                primary_js = services[members[0]]

                def set_mode(mode: str) -> Any:
                    gb = primary_js._lm_group_modes[mode]
                    pf = prefill_bes.get(
                        cluster.spec.node_by_unique_name(members[0]).name
                    )
                    primary_js.register_lm(
                        model, backend=be_single.backend,
                        cost=be_single.cost(), prefill=pf,
                        group_backend=gb,
                    )
                    return gb

                async def timed_job(n=None) -> Tuple[float, Dict[str, Any]]:
                    n = n if n is not None else n_prompts
                    t0 = time.monotonic()
                    job_id = await client.jobs.submit_job(model, n)
                    done = await client.jobs.wait_job(job_id, timeout=600.0)
                    wall = time.monotonic() - t0
                    assert done["total_queries"] == n, done
                    merged = await client.jobs.get_output(
                        job_id, os.path.join(root, f"out_{job_id}.json")
                    )
                    return wall, merged

                def check_equal(merged: Dict[str, Any]) -> bool:
                    return bool(merged) and all(
                        merged[f]["tokens"] == reference[f]
                        for f in merged
                    )

                modes_out: Dict[str, Any] = {}
                all_equal = True
                for mode in ("gather", "resident", "pp", "disagg"):
                    gb = set_mode(mode)
                    # warm the compiles outside the timed window
                    _, merged = await timed_job()
                    all_equal = all_equal and check_equal(merged)
                    t0 = time.monotonic()
                    tokens = 0
                    jobs = 0
                    while (
                        time.monotonic() - t0 < steady_s or jobs < 2
                    ):
                        _, merged = await timed_job()
                        all_equal = all_equal and check_equal(merged)
                        # n_prompts queries per job, each decoding the
                        # shared default budget (the ctx_* files carry
                        # directives but this phase samples prompt_*)
                        tokens += n_prompts * new_tokens
                        jobs += 1
                    wall = time.monotonic() - t0
                    entry = {
                        "tok_s": round(tokens / wall, 1),
                        "jobs": jobs,
                        "wall_s": round(wall, 2),
                        "outputs_equal": check_equal(merged),
                    }
                    if mode == "disagg":
                        entry["handoffs"] = gb.handoffs
                        entry["fallbacks"] = gb.fallbacks
                        entry["handoff_bytes"] = gb.handoff_bytes
                    modes_out[mode] = entry

                # ---- handoff ladder: whole-slab vs chunk-streamed, and
                # 1- vs 2-peer fan-out, on the prefill-heavy files. The
                # scheduler wrap-samples the WHOLE store set, so these
                # jobs submit exactly len(ctx_files) queries after
                # clearing the prompt_* files from sampling via explicit
                # n = multiple of the file count — instead we drive the
                # group backend DIRECTLY with the ctx paths: same engine,
                # no sampling ambiguity, per-job ttft from the backend.
                ctx_paths = [os.path.join(root, f) for f in ctx_files]

                async def handoff_trial(mode: str) -> Dict[str, Any]:
                    gb = set_mode(mode)
                    pf_counts0 = {
                        n: pf.slabs_built for n, pf in prefill_bes.items()
                    }
                    results, _, _ = await gb(model, ctx_paths)  # warm
                    assert all(
                        results[p]["tokens"]
                        == reference[os.path.basename(p)]
                        for p in ctx_paths
                    )
                    walls, ttfts = [], []
                    for _ in range(3):
                        t0 = time.monotonic()
                        results, _, _ = await gb(model, ctx_paths)
                        walls.append(time.monotonic() - t0)
                        if gb.last_ttft_s is not None:
                            ttfts.append(gb.last_ttft_s)
                        ok = all(
                            results[p]["tokens"]
                            == reference[os.path.basename(p)]
                            for p in ctx_paths
                        )
                        if not ok:
                            return {"error": "outputs diverged"}
                    med_wall = sorted(walls)[len(walls) // 2]
                    med_ttft = (
                        sorted(ttfts)[len(ttfts) // 2] if ttfts else None
                    )
                    return {
                        "wall_s": round(med_wall, 3),
                        "ttft_ms": (
                            round(med_ttft * 1000, 1)
                            if med_ttft is not None else None
                        ),
                        "ctx_tok_s": round(ctx_prompt_toks / med_wall, 1),
                        "handoffs": gb.handoffs,
                        "fallbacks": gb.fallbacks,
                        "peer_slabs": {
                            n: pf.slabs_built - pf_counts0[n]
                            for n, pf in prefill_bes.items()
                        },
                    }

                # declared per-request prefill device floor for the
                # ladder (and the chaos case below): the in-process sim
                # shares 2 host cores between every "peer", so raw peer
                # COMPUTE cannot scale with fan-out here no matter what
                # the orchestration does — the floor (same declared-stub
                # discipline as the chaos/request stub backends) makes
                # the ladder measure what the handoff machinery actually
                # controls: per-request overlap of transfer, adoption,
                # and peer device time. Token equality still runs the
                # real engine end-to-end.
                prefill_floor_s = 0.12
                for pf in prefill_bes.values():
                    pf.min_prefill_s = prefill_floor_s
                handoff = {
                    "prompt_tokens_per_job": ctx_prompt_toks,
                    "budget_per_prompt": ctx_budget,
                    "simulated_prefill_floor_s": prefill_floor_s,
                    "slab_f1": await handoff_trial("disagg_slab_f1"),
                    "stream_f1": await handoff_trial("disagg_stream_f1"),
                    "stream_f2": await handoff_trial("disagg_stream_f2"),
                }
                s1, s2 = handoff["stream_f1"], handoff["stream_f2"]
                sl = handoff["slab_f1"]
                if sl.get("ttft_ms") and s1.get("ttft_ms"):
                    handoff["ttft_stream_ms"] = s1["ttft_ms"]
                    handoff["ttft_slab_ms"] = sl["ttft_ms"]
                    handoff["stream_vs_slab_ttft"] = round(
                        sl["ttft_ms"] / max(s1["ttft_ms"], 1e-9), 2
                    )
                    handoff["stream_vs_slab_wall"] = round(
                        sl["wall_s"] / max(s1["wall_s"], 1e-9), 2
                    )
                if s1.get("ctx_tok_s") and s2.get("ctx_tok_s"):
                    handoff["fanout_ctx_speedup"] = round(
                        s2["ctx_tok_s"] / max(s1["ctx_tok_s"], 1e-9), 2
                    )

                # single-chip comparison rate on the SAME topology:
                # grouping disabled, the members serve as individual
                # chips (context for the mode rates; also re-checks
                # equality through the ungrouped path)
                set_mode("resident")
                for js in services.values():
                    js.groups.enabled = False
                _, merged = await timed_job()  # warm the ungrouped route
                all_equal = all_equal and check_equal(merged)
                t0 = time.monotonic()
                sc_tokens = sc_jobs = 0
                while time.monotonic() - t0 < steady_s or sc_jobs < 2:
                    _, merged = await timed_job()
                    all_equal = all_equal and check_equal(merged)
                    sc_tokens += n_prompts * new_tokens
                    sc_jobs += 1
                tok_s_single = round(sc_tokens / (time.monotonic() - t0), 1)
                for js in services.values():
                    js.groups.enabled = True

                # ---- member-kill-MID-STREAM chaos: a prefill peer dies
                # while its streamed share is in flight. The affected
                # requests demote to typed local-prefill fallbacks
                # (jobs_kv_handoff_total{result=fallback}), the group
                # degrades on SWIM detection, the job completes exactly
                # once with tokens unchanged, and the group re-forms when
                # the peer returns.
                gb_chaos = set_mode("disagg_stream_f2")
                leader_js = services[cluster.leader_uname()]
                fallbacks_before = gb_chaos.fallbacks
                bytes_before = gb_chaos.handoff_bytes
                victim = cluster.resolve_target("H5")
                chaos_n = 4 * n_prompts
                job_id = await client.jobs.submit_job(model, chaos_n)
                # kill while slab bytes are actively flowing (mid-stream,
                # not between batches)
                for _ in range(400):
                    if gb_chaos.handoff_bytes > bytes_before:
                        break
                    await asyncio.sleep(0.02)
                await cluster.crash_node(victim)
                # the degradation edge arrives with SWIM detection (~1-2s
                # at this timing); wait for it so "degrades" is an
                # observed fact, not a race against a fast job
                try:
                    await cluster.wait_for(
                        lambda: leader_js.groups.degradations.get(
                            group.name, 0) >= 1,
                        20.0, "group degradation edge",
                    )
                except AssertionError:  # wait_for timeout
                    pass  # recorded as degraded=False below
                done = await client.jobs.wait_job(job_id, timeout=600.0)
                merged = await client.jobs.get_output(
                    job_id, os.path.join(root, "chaos_out.json")
                )
                chaos_equal = check_equal(merged)
                gstats = leader_js.group_stats().get(group.name, {})
                degraded = gstats.get("degradations", 0) >= 1
                fallback_ticks = gb_chaos.fallbacks - fallbacks_before
                await cluster.restart_node(victim)

                def reformed() -> bool:
                    st = leader_js.group_stats().get(group.name, {})
                    return bool(st.get("formed"))

                try:
                    await cluster.wait_for(reformed, 30.0, "group reform")
                    did_reform = True
                except Exception:
                    did_reform = False
                chaos = {
                    "member_killed": "H5 (prefill role, mid-stream)",
                    "completed": done["total_queries"] == chaos_n,
                    "exactly_once_tokens": chaos_equal,
                    # shipped-draft evidence: the dead peer was a DRAFT
                    # peer too (draft_k > 0), so this kill also covers
                    # draft-proposal loss mid-verify — acceptance may
                    # drop to the local-fallback path, tokens may not
                    "draft_k": spec_k_bench,
                    "drafts_shipped": sum(
                        pf.drafts_shipped for pf in prefill_bes.values()
                    ),
                    "typed_fallbacks": fallback_ticks,
                    "degraded": degraded,
                    "reformed": did_reform,
                    # green = completed exactly once with unchanged
                    # tokens AND the kill was actually felt (per-request
                    # fallback or a degradation edge — whichever side of
                    # the SWIM race the kill landed on)
                    "verdict_green": bool(
                        done["total_queries"] == chaos_n and chaos_equal
                        and (fallback_ticks > 0 or degraded)
                    ),
                }

                return {
                    "nodes": 5,
                    "prompts_per_job": n_prompts,
                    "new_tokens_per_prompt": new_tokens,
                    "model_cfg": {
                        k: lm_spec[k]
                        for k in ("d_model", "n_heads", "n_kv_heads",
                                  "n_layers", "dtype", "max_slots")
                    },
                    "groups": {
                        group.name: {
                            "members": list(
                                cluster.spec.group_members_unique(group.name)
                            ),
                            "mesh": {"dp": 1, "tp": 2},
                            "pp_mesh": {"dp": 1, "tp": 1, "pp": 2},
                            "lm_models": list(group.lm_models),
                            "roles": dict(group.roles),
                        }
                    },
                    "hbm": {
                        **hbm,
                        "budget_bytes": hbm_budget,
                        # the acceptance story: the full tree does NOT
                        # fit the configured member budget; the pp slice
                        # does — only the pipelined layout serves
                        "fits_only_pipelined": bool(
                            hbm["per_member_bytes"] <= hbm_budget
                            < hbm["full_bytes"]
                        ),
                    },
                    "modes": modes_out,
                    "handoff": handoff,
                    "tok_s_param_gather": modes_out["gather"]["tok_s"],
                    "tok_s_resident": modes_out["resident"]["tok_s"],
                    "tok_s_pp": modes_out["pp"]["tok_s"],
                    "tok_s_disagg": modes_out["disagg"]["tok_s"],
                    "tok_s_single_chip": tok_s_single,
                    "resident_vs_gather": round(
                        modes_out["resident"]["tok_s"]
                        / max(modes_out["gather"]["tok_s"], 1e-9), 2
                    ),
                    "tokens_equal_single_chip": bool(all_equal and chaos_equal),
                    "kv_handoff_bytes": modes_out["disagg"]["handoff_bytes"],
                    "ttft_stream_ms": handoff.get("ttft_stream_ms"),
                    "stream_vs_slab_ttft": handoff.get("stream_vs_slab_ttft"),
                    "fanout_ctx_speedup": handoff.get("fanout_ctx_speedup"),
                    "chaos": chaos,
                    "note": "a group world of two ranks on one host: "
                            "the equality flag (every mode's merged "
                            "outputs == isolated generate() per prompt, "
                            "f32 greedy) and the handoff/exactly-once "
                            "machinery are the product claims; the group "
                            "forms' tok/s time the world's host-staged "
                            "gloo exchange, not an interconnect",
                }
            finally:
                await cluster.stop()
                be_single.close()

        result = asyncio.run(run())
        if stats is not None:
            stats.update(world.stats(), device=str(dev))
    finally:
        worlds.close()
    if result.get("error"):
        return result
    # the world is closed: these arms run on this process's device alone
    # ---- raw-decode arms, AFTER the cluster is down so heartbeat/
    # gossip threads don't pollute the single-device A/B walls:
    # speculative decoding (oracle proposer at a declared acceptance
    # + real-draft auto-disable) and step-granular continuous
    # batching (overlap-adoption vs batch-drain TTFT under staggered
    # load). Top-level mirrors feed the bench summary + claim gates.
    result["specdec"] = bench_specdec_arm(
        params, cfg, lm_spec, new_tokens=max(new_tokens, 32), device=dev
    )
    result["cb"] = bench_cb_arm(
        params, cfg, lm_spec, new_tokens=new_tokens, device=dev
    )
    result["lm_specdec_speedup"] = result["specdec"].get("speedup")
    result["lm_specdec_accept"] = result["specdec"].get("accept_rate")
    result["lm_cb_ttft_ms"] = result["cb"].get("ttft_p99_overlap_ms")
    return result


def _pctl(vals: List[float], p: float) -> Optional[float]:
    """Linear-interpolation percentile (loadgen's definition) over a
    small sample — the CB arm's TTFT tail with a handful of waves."""
    vs = sorted(vals)
    if not vs:
        return None
    if len(vs) == 1:
        return float(vs[0])
    rank = (p / 100.0) * (len(vs) - 1)
    lo = int(rank)
    hi = min(lo + 1, len(vs) - 1)
    frac = rank - lo
    return float(vs[lo] * (1.0 - frac) + vs[hi] * frac)


def _generated(params, cfg, prompt: np.ndarray, new_tokens: int) -> List[int]:
    """The isolated `generate` continuation of one prompt, as Python ints."""
    return [int(t) for t in generate(params, cfg, prompt[None], new_tokens)[0].tolist()]


def bench_specdec_arm(
    params,
    cfg,
    lm_spec: Dict[str, Any],
    n_prompts: int = 8,
    new_tokens: int = 32,
    k: int = 4,
    declared_accept: float = 0.8,
    device=None,
) -> Dict[str, Any]:
    """Raw-decode A/B on one device: plain chunked decode vs
    speculative propose+verify over the SAME weights, prompts, and
    seed (steady tok/s, full batch in flight). `params` live on
    `device` (cuda when None; it raises where there is none), where the
    draft of the third run is built.

    The spec arm runs an ORACLE proposer pinned near a DECLARED
    acceptance rate: proposals come from the precomputed
    isolated-generate continuations with every 8th token position
    corrupted, so the measured rate sits near `declared_accept`
    instead of the perfect oracle's ~1.0. A real draft's acceptance is
    a model-quality property this synthetic family can't exhibit (any
    same-family small draft either nails the target's argmax or whiffs
    completely), so the arm declares the operating point and scores
    what the serving stack owns — the propose/verify/commit machinery
    at that acceptance. Token equality vs isolated generate() is
    asserted for BOTH arms (proposal-independence: a corrupted proposal
    shortens acceptance, never changes output).

    A third run arms a REAL derived draft (config.draft_lm_spec,
    fresh random weights — acceptance ~0 against this target) with a
    break-even floor: the server must AUTO-DISABLE speculation
    (reason="acceptance") and still emit exact tokens."""
    from ..config import draft_lm_spec
    from ..models.lm_params import resolve_device
    from .lm_backend import lm_spec_parts
    from .lm_server import LMServer

    dev = resolve_device(device)
    rng = np.random.RandomState(11)
    prompts = [
        np.asarray(
            rng.randint(0, cfg.vocab_size, int(rng.randint(6, 20))),
            np.int32,
        )
        for _ in range(n_prompts)
    ]
    refs = [_generated(params, cfg, p, new_tokens) for p in prompts]

    def make_server() -> "Any":
        return LMServer(
            params, cfg,
            max_slots=int(lm_spec.get("max_slots", 4)),
            max_len=int(lm_spec["max_len"]),
            chunk=int(lm_spec["chunk"]),
        )

    ref_of: Dict[int, List[int]] = {}

    def oracle(reqs, kk: int) -> np.ndarray:
        rows = np.zeros((len(reqs), kk), np.int32)
        for i, r in enumerate(reqs):
            ref = ref_of[r.rid]
            for j in range(kk):
                e = r.emitted + j
                tok = ref[e] if e < len(ref) else 0
                if e % 8 == 7:
                    # deliberate miss: pins measured acceptance near
                    # the declared rate (~0.8 at k=4 / period 8)
                    tok = (tok + 1) % cfg.vocab_size
                rows[i, j] = tok
        return rows

    def drain(srv) -> Tuple[float, List[List[int]]]:
        t0 = time.monotonic()
        rids = srv.submit_many(prompts, new_tokens)
        for rid, ref in zip(rids, refs):
            ref_of[rid] = ref
        done = srv.run(rids)
        wall = time.monotonic() - t0
        return wall, [[int(t) for t in done[rid]] for rid in rids]

    total = n_prompts * new_tokens
    srv_a = make_server()
    drain(srv_a)  # warm: prefill buckets, cuDNN/cuBLAS choices
    wall_plain, outs_plain = drain(srv_a)
    srv_b = make_server()
    srv_b.enable_spec_decode(k, proposer=oracle, min_accept=0.0)
    drain(srv_b)  # warm: prefill buckets + the verify shapes
    wall_spec, outs_spec = drain(srv_b)
    stats = srv_b.spec_stats() or {}
    accept = stats.get("accept_rate")

    # auto-disable: real derived draft, random weights, break-even
    # floor — speculation must disarm itself, outputs must not move
    dparams, dcfg = lm_spec_parts(draft_lm_spec(lm_spec), device=dev)
    srv_c = make_server()
    srv_c.enable_spec_decode(
        k, draft_params=dparams, draft_cfg=dcfg,
        min_accept=0.3, min_samples=16,
    )
    _, outs_auto = drain(srv_c)
    st_auto = srv_c.spec_stats() or {}
    auto_ok = bool(
        not st_auto.get("enabled", True)
        and st_auto.get("disabled_reason") == "acceptance"
        and outs_auto == refs
    )

    eq = bool(outs_plain == refs and outs_spec == refs)
    tok_s_plain = total / max(wall_plain, 1e-9)
    tok_s_spec = total / max(wall_spec, 1e-9)
    speedup = round(tok_s_spec / max(tok_s_plain, 1e-9), 2)
    return {
        "k": k,
        "prompts": n_prompts,
        "new_tokens_per_prompt": new_tokens,
        "declared_accept": declared_accept,
        "accept_rate": accept,
        "spec_rounds": stats.get("rounds"),
        "tok_s_plain": round(tok_s_plain, 1),
        "tok_s_spec": round(tok_s_spec, 1),
        "speedup": speedup,
        "outputs_equal": eq,
        "auto_disable": {
            "draft_layers": int(dcfg.n_layers),
            "disabled": not st_auto.get("enabled", True),
            "reason": st_auto.get("disabled_reason"),
            "accept_rate": st_auto.get("accept_rate"),
            "outputs_equal": bool(outs_auto == refs),
        },
        "verdict_green": bool(speedup > 1.0 and eq and auto_ok),
    }


def bench_cb_arm(
    params,
    cfg,
    lm_spec: Dict[str, Any],
    n_waves: int = 6,
    wave_size: int = 2,
    new_tokens: int = 16,
    stagger_s: float = 0.05,
    device=None,
) -> Dict[str, Any]:
    """Step-granular continuous batching TTFT A/B under sustained
    staggered load, same seed both arms: `n_waves` request waves land
    `stagger_s` apart while earlier waves are still decoding. `params`
    live on `device` (cuda when None; it raises where there is none).

    - OVERLAP arm: every wave enters ONE LMDriver — a late wave's
      prompts adopt free/retired slots at the next step boundary
      mid-flight, so its first token never waits for the running
      batch to drain.
    - DRAIN arm: the pre-driver serial discipline (one lock around
      submit+run), i.e. wave N+1's prefill cannot start until wave N
      fully drains — the batch-drain latency continuous batching
      removes.

    p99 TTFT (client-observed first token per wave) must be strictly
    lower on the overlap arm; outputs must equal isolated generate() on
    both (the LMServer batching-exactness contract, no matter how
    tickets interleave)."""
    import threading

    from ..models.lm_params import resolve_device
    from .lm_server import LMDriver, LMServer

    resolve_device(device)
    rng = np.random.RandomState(13)
    waves = [
        [
            np.asarray(
                rng.randint(0, cfg.vocab_size, int(rng.randint(6, 16))),
                np.int32,
            )
            for _ in range(wave_size)
        ]
        for _ in range(n_waves)
    ]
    refs = [[_generated(params, cfg, p, new_tokens) for p in w] for w in waves]

    def make_server():
        return LMServer(
            params, cfg,
            max_slots=int(lm_spec.get("max_slots", 4)),
            max_len=int(lm_spec["max_len"]),
            chunk=int(lm_spec["chunk"]),
        )

    def run_arm(overlap: bool) -> Tuple[List[float], List[Any], Any]:
        srv = make_server()
        driver = LMDriver(srv) if overlap else None
        lock = threading.Lock()
        # warm the prefill buckets and the chunk outside the timed window
        # so neither arm pays first-call costs in its TTFT
        if overlap:
            driver.serve(waves[0], new_tokens)
        else:
            rids = srv.submit_many(waves[0], new_tokens)
            srv.run(rids)
        ttfts: List[Optional[float]] = [None] * n_waves
        outs: List[Any] = [None] * n_waves
        t0 = time.monotonic()

        def one_wave(i: int) -> None:
            t_due = t0 + i * stagger_s
            delay = t_due - time.monotonic()
            if delay > 0:
                time.sleep(delay)
            t_sub = time.monotonic()
            first = [False]

            def stamp(_tok: int) -> None:
                if not first[0]:
                    first[0] = True
                    ttfts[i] = time.monotonic() - t_sub
            cbs = [stamp] + [None] * (wave_size - 1)
            if overlap:
                toks = driver.serve(waves[i], new_tokens, on_token=cbs)
                outs[i] = [[int(t) for t in seq] for seq in toks]
            else:
                with lock:
                    rids = srv.submit_many(
                        waves[i], new_tokens, on_token=cbs
                    )
                    done = srv.run(rids)
                outs[i] = [
                    [int(t) for t in done[rid]] for rid in rids
                ]

        threads = [
            threading.Thread(target=one_wave, args=(i,), daemon=True)
            for i in range(n_waves)
        ]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300.0)
        if driver is not None:
            driver.stop()
        return [t for t in ttfts if t is not None], outs, srv

    ttft_ov, outs_ov, _ = run_arm(overlap=True)
    ttft_dr, outs_dr, _ = run_arm(overlap=False)
    eq = bool(outs_ov == refs and outs_dr == refs)
    p99_ov = _pctl(ttft_ov, 99)
    p99_dr = _pctl(ttft_dr, 99)
    return {
        "waves": n_waves,
        "wave_size": wave_size,
        "stagger_ms": round(stagger_s * 1e3, 1),
        "new_tokens_per_prompt": new_tokens,
        "ttft_p50_overlap_ms": round(_pctl(ttft_ov, 50) * 1e3, 1),
        "ttft_p99_overlap_ms": round(p99_ov * 1e3, 1),
        "ttft_p50_drain_ms": round(_pctl(ttft_dr, 50) * 1e3, 1),
        "ttft_p99_drain_ms": round(p99_dr * 1e3, 1),
        "drain_vs_overlap_p99": round(p99_dr / max(p99_ov, 1e-9), 2),
        "outputs_equal": eq,
        "verdict_green": bool(eq and p99_ov < p99_dr),
    }


def _value_of(counter_name: str) -> float:
    """Sum of one counter across all label children (bench helper)."""
    try:
        snap = METRICS.snapshot()
        return sum(
            float(v) for k, v in snap.get("counters", {}).items()
            if k == counter_name or k.startswith(counter_name + "{")
        )
    except Exception:
        return 0.0


def _main(argv: Optional[List[str]] = None) -> None:  # pragma: no cover - bench entry
    """`python -m dml_tpu_torch.inference.lm_sharded [options]`: one JSON
    line, `bench_lm_sharded_serving` at JAX's defaults unless the options
    say otherwise (cuda unless --device cpu; --lm-spec-json updates the
    bench's LM spec)."""
    import argparse

    p = argparse.ArgumentParser(prog="python -m dml_tpu_torch.inference.lm_sharded")
    p.add_argument("--n-prompts", type=int, default=16)
    p.add_argument("--new-tokens", type=int, default=16)
    p.add_argument("--base-port", type=int, default=28961)
    p.add_argument("--steady-s", type=float, default=4.0)
    p.add_argument("--tmp", default=None)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--lm-spec-json", default=None, metavar="JSON")
    p.add_argument("--world-stats", default=None, metavar="PATH",
                   help="write the group world's stats there (JSON)")
    a = p.parse_args(argv)
    stats: Dict[str, Any] = {}
    # the package's module, not __main__: a group world builds objects by
    # their module's name on every rank
    from . import lm_sharded

    print(json.dumps(lm_sharded.bench_lm_sharded_serving(
        n_prompts=a.n_prompts, new_tokens=a.new_tokens, base_port=a.base_port,
        steady_s=a.steady_s, tmp=a.tmp, device=a.device,
        lm_overrides=json.loads(a.lm_spec_json) if a.lm_spec_json else None, stats=stats),
        default=str), flush=True)
    if a.world_stats:
        with open(a.world_stats, "w") as f:
            json.dump(stats, f)


if __name__ == "__main__":  # pragma: no cover
    _main()

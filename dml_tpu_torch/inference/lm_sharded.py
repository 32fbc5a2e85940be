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

Not here yet: the bench entry points (ROADMAP A8).
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
        mb = slots // self.microbatches
        dev = self.device
        prompts_m = torch.from_numpy(padded).to(dev).reshape(self.microbatches, mb, bucket)
        tps_m = torch.from_numpy(tps).to(dev).reshape(self.microbatches, mb)
        firsts, cache = self._prefill(prompts_m, tps_m, slots, bucket)
        toks = self._decode(cache, firsts, tps_m, t_new)
        del cache
        firsts_host = firsts.reshape(-1).cpu().numpy()
        rest = toks.reshape(t_new, -1).cpu().numpy()  # [t_new, slots]
        return [[int(firsts_host[i])] + [int(rest[k, i]) for k in range(1, budgets[i])]
                for i in range(n)]

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
        _member_check(group_name, members, alive_fn)
        results, infer_time, cost = await asyncio.to_thread(
            be.serve_files, list(paths)
        )
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

        from .lm_backend import parse_prompt_file

        _member_check(self.group_name, self.members, self.alive_fn)
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
    there is none). The group mesh resolves over this process's
    world (`jobs.groups.group_ranks`: one process per rank, where the
    JAX primary takes the host's devices).

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
        from ..parallel.mesh import make_mesh

        mesh = make_mesh(g.mesh, ranks=group_ranks(g.name, g.mesh))
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
            be_pp = PipelinedLMBackend(lm_spec, mesh, device=device)
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
            be = sharded_lm_backend(
                lm_spec, mesh, form="resident",
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

"""Continuous-batching LM server: PyTorch counterpart of
dml_tpu/inference/lm_server.py. Requests join and leave a running decode
batch.

- A fixed slot grid: a per-layer KV cache [slots, KV, max_len, D]
  (`init_cache`'s head-major layout; only the slot axis 0 is indexed
  here) and per-slot position and current-token vectors on the device.
- Placement prefills queued prompts in groups, one `prefill` (the flash
  kernel K2, once per layer) per prompt bucket, with prompt lengths
  bucketed to powers of two from 16 and the group padded to a
  power-of-two row count (`max_slots` rows up to 256-token buckets),
  and copies each row into its free slot. Placement makes no host round
  trip: the first sampled token's value rides the next step's readback.
- `step()` advances every slot `chunk` tokens: a Python loop of
  `batched_decode_step` calls (the decode kernel K4, once per layer per
  token) with per-slot positions. The packed readback of its tokens is
  the step's one blocking device-to-host copy.
- Finished slots free at once and the next queued request takes the
  slot at the same step boundary.

Correctness contract (tests/test_torch_lm_server.py): greedy outputs
equal `generate` run on each request alone, and the JAX server's.
Sampling (temperature > 0) is reproducible per request: the token at
position p of request rid is `generate.sample_per_request`'s, a pure
function of (seed, rid, p) and the logits, so a request's sampled
output does not depend on what else shares the grid. The noise is not
JAX's threefry stream, so sampled tokens differ from the JAX server's.

Differences from the JAX package, by design:
- What JAX jits is eager here. The cache is updated in place (JAX
  donates it): `_insert_impl` copies a prefilled row into the slot's
  whole row, `_chunk_impl` loops `chunk` decode steps, `_merge_vec` is
  a `torch.where` on device vectors.
- Host arrays reach the card by non-blocking copies from pinned memory,
  so the readback stays each step's only synchronizing call.
- `gather_shardings` (the tp serving forms, `inference.lm_sharded`) is
  a callable, not JAX's tree of shardings: at each dispatch (a placement
  prefill group, a warm start, a decode chunk, a verify round) the
  server passes it the params it holds (this rank's tp pieces) and runs
  the one-device program on what it returns, as JAX's `_maybe_gather`
  constrains the tree at each dispatch's entry.

The device work of each dispatch is one `_dev_*` method (a placement
group, an adopted or warm-started slab, a chunk, a speculative round, a
retired request's capture), marked `@seam`: built through a group
primary's world (`parallel.group_world`, the tp forms of
`inference.lm_sharded`), the primary broadcasts each with its host
arguments and the follower ranks run it on their copies of the server,
while the host logic (queue, slots, readbacks, callbacks) runs on the
primary alone. Its arguments are checked before it is called.

The server clamps every position it hands a step to the cache
(`_chunk_impl`, `_propose_impl`, `_verify_impl`): the port's decode step
index-writes the cache at that position, so an unclamped freed slot,
whose position grows by `chunk` every step, would write out of range.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..observability import METRICS
from ..parallel.group_world import seam
from .generate import (
    LMConfig,
    _device_of,
    batched_decode_step,
    batched_verify_step,
    init_cache,
    prefill,
    sample_per_request,
)

log = logging.getLogger(__name__)

# Serve-loop instrumentation, under the JAX package's names. Host-side
# O(1) updates per dispatch (a step covers chunk x slots tokens).
_M_REQS = METRICS.counter("lm_server_requests_total", "requests submitted to the slot grid")
_M_REQS_DONE = METRICS.counter("lm_server_requests_completed_total", "requests fully decoded")
_M_TOKENS = METRICS.counter("lm_server_decode_tokens_total",
                            "generated tokens delivered to request outputs")
_M_STEPS = METRICS.counter("lm_server_steps_total", "chunked decode dispatches")
_M_COMPILES = METRICS.counter(
    "lm_server_compile_events_total",
    "first-seen dispatch shapes per server (each a new set of kernel shapes)")
_M_QUEUE_WAIT = METRICS.histogram("lm_server_queue_wait_seconds", "submit -> slot placement wait")
_M_PREFILL = METRICS.histogram(
    "lm_server_prefill_dispatch_seconds",
    "host wall of one placement group's prefill + insert + merge dispatch chain "
    "(async dispatch; device time shows up in step)")
_M_STEP = METRICS.histogram("lm_server_step_seconds",
                            "one chunked decode step incl. its packed readback")
_M_READBACK = METRICS.histogram("lm_server_readback_seconds",
                                "blocking device->host readbacks (the serve loop's only stalls)")
_M_SLOTS = METRICS.gauge("lm_server_slots_active", "occupied decode slots")
_M_SLOTS_TOTAL = METRICS.gauge("lm_server_slots_total", "slot grid capacity")
_M_OCCUPANCY = METRICS.histogram(
    "lm_server_slot_occupancy", "occupied slots per decode dispatch (grid utilization)")
_M_SPEC_PROPOSED = METRICS.counter("lm_specdec_proposed_total",
                                   "draft tokens proposed to the verify program")
_M_SPEC_ACCEPTED = METRICS.counter("lm_specdec_accepted_total",
                                   "proposed draft tokens accepted by target-greedy verification")
_M_SPEC_DISABLED = METRICS.counter(
    "lm_specdec_disabled_total",
    "speculative-decode disable events by reason (acceptance = measured rate fell below "
    "break-even)")


def _bucket(n: int, lo: int = 16) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


@dataclasses.dataclass
class _Request:
    rid: int
    prompt: np.ndarray  # [Tp] int32
    max_new_tokens: int
    # `emitted` counts tokens generated on the device, `out` the values
    # read back; they differ while a placement's first token waits for
    # the next packed readback. Retirement keys on emitted, results on out.
    out: List[int] = dataclasses.field(default_factory=list)
    emitted: int = 0
    slot: Optional[int] = None
    t_submit: float = 0.0  # monotonic submit time (queue-wait metric)
    # fired with each token value as it is read back (token streaming)
    on_token: Optional[Callable[[int], None]] = None
    # draft tokens shipped with an adopted slab: consumed by one verify
    # round; a bad or absent shipment only shortens the accepted run
    shipped_draft: Optional[np.ndarray] = None
    spec_rounds: int = 0
    spec_accepted: int = 0

    def deliver(self, toks) -> None:
        """Append read-back token values to `out`, firing `on_token` per
        token: the one append point, so a stream sees exactly the tokens
        the result carries."""
        cb = self.on_token
        for t in toks:
            t = int(t)
            self.out.append(t)
            if cb is not None:
                try:
                    cb(t)
                except Exception as e:
                    # a streaming hint, never a decode error
                    log.debug("on_token callback failed: %r", e)

    @property
    def done(self) -> bool:
        return self.emitted >= self.max_new_tokens


@dataclasses.dataclass
class _SpecState:
    """Speculative-decoding state of one LMServer: one proposal source
    (a draft model on the device, a host proposer, or shipped drafts
    only), and the windowed acceptance counters behind auto-disable."""

    k: int
    draft_params: Any = None
    draft_cfg: Optional[LMConfig] = None
    draft_cache: Any = None
    proposer: Optional[Callable[[Sequence["_Request"], int], Any]] = None
    min_accept: float = 0.0
    min_samples: int = 64
    enabled: bool = True
    disabled_reason: Optional[str] = None
    proposed_total: int = 0
    accepted_total: int = 0
    win_proposed: int = 0
    win_accepted: int = 0
    rounds: int = 0


def _slots_in_use(slot_req) -> int:
    return sum(1 for r in slot_req if r is not None)


class LMServer:
    """Slot-based continuous batching over `batched_decode_step`.

    >>> srv = LMServer(params, cfg, max_slots=4, max_len=512)
    >>> a = srv.submit(prompt_a, max_new_tokens=64)
    >>> b = srv.submit(prompt_b, max_new_tokens=32)
    >>> results = srv.run()          # {rid: np.ndarray of new tokens}

    The grid lives where `params` live (`cuda`, or the CPU in tests).
    """

    def __init__(
        self,
        params: Any,
        cfg: LMConfig,
        max_slots: int = 4,
        max_len: int = 1024,
        chunk: int = 16,
        temperature: float = 0.0,
        top_k: Optional[int] = None,
        seed: int = 0,
        gather_shardings: Any = None,
    ):
        if chunk < 1:
            raise ValueError("chunk must be >= 1")
        if max_slots < 1:
            raise ValueError("max_slots must be >= 1")
        self.params = params
        self._gather_shardings = gather_shardings
        self.cfg = cfg
        self.device = _device_of(params)
        self.max_slots = max_slots
        self.max_len = max_len
        self.chunk = chunk
        self.temperature = temperature
        self.top_k = top_k
        self.seed = int(seed)
        self.cache = init_cache(cfg, max_slots, max_len, device=self.device)
        # decode state lives on the device: the next input token and the
        # next write position per slot, and the request id each slot
        # samples for. Placement merges into them; the host never reads
        # them back (a slot's position is req.prompt.size + req.emitted).
        self._cur_dev = torch.zeros(max_slots, dtype=torch.int32, device=self.device)
        self._pos_dev = torch.zeros(max_slots, dtype=torch.int32, device=self.device)
        self._rid_dev = torch.zeros(max_slots, dtype=torch.int32, device=self.device)
        self.rid_vec = np.zeros(max_slots, np.int32)  # slot -> request id
        self._slot_req: List[Optional[_Request]] = [None] * max_slots
        # this server's delivered-token count (the registry's is process-wide)
        self.tokens_delivered = 0
        # placement groups whose first tokens are not read back yet:
        # (requests in row order, device [group rows] tokens)
        self._pending_first: List[Tuple[List[_Request], torch.Tensor]] = []
        self._queue: List[_Request] = []
        self._done: Dict[int, _Request] = {}
        self._rid = 0
        self._seen_shapes: set = set()
        # KV prefix cache (enable_kv_cache); None keeps the cold path
        self.kv_cache = None
        self._warm = None
        # speculative decoding (enable_spec_decode); None = the chunk path
        self._spec: Optional[_SpecState] = None
        _M_SLOTS_TOTAL.set(max_slots)

    # -- device pieces (JAX jits these) ---------------------------------

    def _maybe_gather(self, params):
        """The tree a dispatch computes with: `params`, or under a tp
        form what `gather_shardings` makes of them (the pieces
        all-gathered, or kept sharded with the norm scales gathered)."""
        return params if self._gather_shardings is None else self._gather_shardings(params)

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        """A host array on the grid's device. To a GPU it goes from
        pinned memory without blocking: the caching host allocator keeps
        the buffer until the copy is done."""
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.clone()

    def _prefill(self, params, cfg, prompts: np.ndarray, tps: np.ndarray):
        """One bucketed group prefill, each row's logits at its last
        prompt position."""
        return prefill(params, cfg, self._upload(prompts), self.max_len,
                       logits_index=self._upload(tps - 1))

    @staticmethod
    def _insert_impl(cache, pcache, slot: int, row: int):
        """Copy row `row` of a (group-batched) prefilled cache into
        `slot`, in place, whole rows: stale tail positions past the
        prompt are behind the per-slot validity mask.

        INVARIANT (with `_chunk_impl`): an empty slot's position is
        clamped to max_len - 1, so between retire and reuse its steps
        only rewrite the last cache row, and this whole-row overwrite
        erases that too. A partial-row insert or an unclamped write
        would break the pairing; keep both sides together."""
        for name, kv in cache.items():
            for key, dst in kv.items():
                dst[slot].copy_(pcache[name][key][row])
        return cache

    @staticmethod
    def _check_rows(rows, tp: int) -> None:
        """A slab's rows must hold exactly the prompt's tp positions."""
        for name, kv in rows.items():
            for key, arr in kv.items():
                t_axis = 2 if key.endswith("_s") else 1
                if arr.shape[t_axis] != tp:
                    raise ValueError(f"slab {name}/{key}: T={arr.shape[t_axis]} != prompt {tp}")

    def _insert_rows(self, cache, slot: int, rows, tp: int):
        """`_insert_impl` for a slab of positions < tp (values [KV, tp,
        D], kv_quant scales [KV, 1, tp]; `_check_rows` first): the slab,
        then zeros to max_len, as JAX's padded whole-row insert writes."""
        for name, kv in rows.items():
            for key, arr in kv.items():
                src = torch.as_tensor(arr)
                t_axis = 2 if key.endswith("_s") else 1
                dst = cache[name][key][slot]
                dst.narrow(t_axis, 0, tp).copy_(src, non_blocking=src.is_pinned())
                dst.narrow(t_axis, tp, self.max_len - tp).zero_()
        return cache

    @staticmethod
    def _merge_vec(vec, vals, slot_map):
        """slot_map[s] = the row of `vals` slot s takes, or -1 to keep
        vec[s]. All on the device."""
        return torch.where(slot_map >= 0, vals[slot_map.clamp(min=0).long()], vec)

    def _sample_slots(self, logits, rid, write_pos):
        """The token that occupies position write_pos[b] of request
        rid[b]: argmax, or `sample_per_request`'s draw."""
        return sample_per_request(logits, self.seed, rid, write_pos, self.temperature, self.top_k)

    def _chunk_impl(self, params, cache, cur, pos, rid):
        """`chunk` batched decode steps. Each position is clamped to the
        last cache row, and the clamped position is what is carried:
        the identity for a live request (prompt + budget fits max_len,
        checked at submit), while a freed slot pins at max_len instead
        of growing by `chunk` every step."""
        last = self.max_len - 1
        toks = []
        for _ in range(self.chunk):
            pos_c = pos.clamp(max=last)
            logits, cache = batched_decode_step(params, self.cfg, cache, cur, pos_c)
            pos = pos_c + 1
            cur = self._sample_slots(logits, rid, pos)
            toks.append(cur)
        return cache, cur, pos, torch.stack(toks)  # toks: [chunk, slots]

    def _propose_impl(self, draft_params, draft_cache, cur, pos):
        """k greedy draft steps from every slot's (cur, pos), clamped as
        in `_chunk_impl`: returns (draft cache, proposals [slots, k]).
        The draft's cache rows < pos hold exactly the committed tokens'
        K/V (the verify round's cap keeps this so)."""
        last = self.max_len - 1
        cfg = self._spec.draft_cfg
        d = []
        for _ in range(self._spec.k):
            pc = pos.clamp(max=last)
            logits, draft_cache = batched_decode_step(draft_params, cfg, draft_cache, cur, pc)
            cur = logits.argmax(dim=-1).to(torch.int32)
            pos = pc + 1
            d.append(cur)
        return draft_cache, torch.stack(d, dim=1)

    def _verify_impl(self, params, cache, cur, pos, d_toks):
        """One verify + acceptance round: the target consumes [cur, d_1
        .. d_k] per slot in one multi-token forward, takes its greedy
        tokens g_1..g_{k+1} and commits c = min(a + 1, k) of them, a =
        the leading draft/target matches. Returns (cache, cur', pos',
        committed tokens [slots, k], accept lengths a [slots]).

        Committing at most k keeps both caches consistent: target rows
        pos..pos+c-1 hold [cur, d_1..d_{c-1}], which the draft cache's
        rows hold too. Rows written past the commit point are stale and
        unread: the next dispatch writes its own rows there first. The
        start is clamped to max_len - (k + 1), so a freed slot's writes
        stay in range. g_i follows the same prefix a plain greedy decode
        would have, so the committed tokens are the plain decode's for
        any d_toks whatsoever."""
        k = self._spec.k
        start = pos.clamp(max=self.max_len - (k + 1))
        inputs = torch.cat([cur[:, None], d_toks], dim=1)
        logits, cache = batched_verify_step(params, self.cfg, cache, inputs, start)
        g = logits.argmax(dim=-1).to(torch.int32)  # [B, k+1]
        match = (d_toks == g[:, :k]).to(torch.int32)
        a = torch.cumprod(match, dim=1).sum(dim=1).to(torch.int32)  # [B] 0..k
        c = torch.clamp(a + 1, max=k)
        cur2 = torch.gather(g, 1, (c - 1).long()[:, None])[:, 0]
        return cache, cur2, (start + c).to(torch.int32), g[:, :k], a

    # -- configuration --------------------------------------------------

    def enable_spec_decode(
        self,
        k: int,
        *,
        draft_params: Any = None,
        draft_cfg: Optional[LMConfig] = None,
        proposer: Optional[Callable] = None,
        min_accept: float = 0.0,
        min_samples: int = 64,
    ) -> None:
        """Turn on speculative decoding: each dispatch becomes one
        propose (k draft tokens per slot) and one verify (the target
        consumes all k in one `batched_verify_step`), committing 1..k
        target-greedy tokens per slot. Outputs equal the plain chunk
        path's: proposals change how many tokens commit, never which.

        Proposal source, one of: `draft_params` + `draft_cfg` (a draft
        model on the device, same vocab, with its own cache shadowing
        the grid); `proposer(requests, k) -> [len(requests), k]` (a host
        callable); neither (verify only for drafts shipped with adopted
        slabs). `min_accept` > 0 arms auto-disable: once `min_samples`
        proposals are measured, a windowed acceptance rate below it
        reverts the server to the chunk path for good. Greedy only;
        enable before submitting work."""
        if self.temperature != 0.0:
            raise ValueError("speculative decoding requires temperature == 0 "
                             "(greedy acceptance compares draft tokens against target argmaxes)")
        if k < 1:
            raise ValueError("spec k must be >= 1")
        if k + 1 >= self.max_len:
            raise ValueError(f"spec k {k} leaves no room in max_len {self.max_len}")
        if (draft_params is None) != (draft_cfg is None):
            raise ValueError("draft_params and draft_cfg come together")
        if draft_params is not None and proposer is not None:
            raise ValueError("pick ONE of draft model / proposer")
        if draft_cfg is not None and draft_cfg.vocab_size != self.cfg.vocab_size:
            raise ValueError(f"draft vocab {draft_cfg.vocab_size} != target vocab "
                             f"{self.cfg.vocab_size}")
        if self.has_work():
            raise RuntimeError("enable_spec_decode on a busy server: active slots have no "
                               "draft cache rows to verify against")
        self._spec = _SpecState(k=int(k), draft_params=draft_params, draft_cfg=draft_cfg,
                                proposer=proposer, min_accept=float(min_accept),
                                min_samples=int(min_samples))
        if draft_params is not None:
            self._spec.draft_cache = init_cache(draft_cfg, self.max_slots, self.max_len,
                                                device=self.device)

    def disable_spec_decode(self, reason: str = "manual") -> None:
        """Revert to the plain chunk path (idempotent). The spec state
        stays for `spec_stats()`."""
        sp = self._spec
        if sp is None or not sp.enabled:
            return
        sp.enabled = False
        sp.disabled_reason = reason
        _M_SPEC_DISABLED.inc(reason=reason)
        log.warning("speculative decoding disabled (%s): accepted %d / proposed %d over %d "
                    "rounds", reason, sp.accepted_total, sp.proposed_total, sp.rounds)

    def spec_stats(self) -> Optional[Dict[str, Any]]:
        """Acceptance accounting (None when spec was never enabled)."""
        sp = self._spec
        if sp is None:
            return None
        return {
            "enabled": sp.enabled,
            "k": sp.k,
            "rounds": sp.rounds,
            "proposed": sp.proposed_total,
            "accepted": sp.accepted_total,
            "accept_rate": sp.accepted_total / sp.proposed_total if sp.proposed_total else None,
            "disabled_reason": sp.disabled_reason,
        }

    def enable_kv_cache(self, cache) -> None:
        """Attach a `KVPrefixCache`: retiring requests donate their KV
        rows and token ids, and queued greedy requests whose prompt
        extends a cached prefix warm-start with only the suffix
        prefilled. None detaches it (the cold path)."""
        from .kv_cache import WarmStart

        self.kv_cache = cache
        self._warm = WarmStart(cache, self.cfg, self.max_len) if cache is not None else None

    # -- public API -----------------------------------------------------

    def submit(self, prompt: np.ndarray, max_new_tokens: int) -> int:
        """Queue a request; returns its request id. Placement happens at
        once if a slot is free, else at the next step()."""
        return self.submit_many([prompt], max_new_tokens)[0]

    def _validate(self, prompt: np.ndarray, max_new_tokens: int) -> np.ndarray:
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size == 0:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            # generate() returns [B, 0] for a zero budget; a server
            # request always produces tokens, so reject it
            raise ValueError("max_new_tokens must be >= 1")
        if prompt.size + max_new_tokens > self.max_len:
            raise ValueError(f"prompt {prompt.size} + budget {max_new_tokens} exceeds max_len "
                             f"{self.max_len}")
        return prompt

    def submit_many(
        self,
        prompts: Sequence[np.ndarray],
        max_new_tokens,
        on_token: Optional[Sequence[Optional[Callable[[int], None]]]] = None,
    ) -> List[int]:
        """Queue a burst of requests and place them in one round.
        `max_new_tokens` is an int for the burst or one per prompt.
        Validates every prompt before queueing any (atomic), in
        sequential submit()'s rid order. `on_token` is an optional
        per-prompt sequence of callbacks fired with each token value as
        it is read back."""
        if isinstance(max_new_tokens, (int, np.integer)):
            budgets = [int(max_new_tokens)] * len(prompts)
        else:
            budgets = [int(b) for b in max_new_tokens]
            if len(budgets) != len(prompts):
                raise ValueError(f"{len(budgets)} budgets for {len(prompts)} prompts")
        if on_token is not None and len(on_token) != len(prompts):
            raise ValueError(f"{len(on_token)} on_token callbacks for {len(prompts)} prompts")
        validated = [self._validate(p, b) for p, b in zip(prompts, budgets)]
        reqs = []
        now = time.monotonic()
        for i, (prompt, b) in enumerate(zip(validated, budgets)):
            self._rid += 1
            reqs.append(_Request(self._rid, prompt, b, t_submit=now,
                                 on_token=on_token[i] if on_token is not None else None))
        _M_REQS.inc(len(reqs))
        self._queue.extend(reqs)
        self._place_waiting()
        return [r.rid for r in reqs]

    def free_slot_count(self) -> int:
        """Currently unoccupied decode slots."""
        return sum(1 for r in self._slot_req if r is None)

    def submit_prefilled(
        self,
        prompt: np.ndarray,
        max_new_tokens: int,
        rows: Dict[str, Dict[str, Any]],
        first_token: int,
        on_token: Optional[Callable[[int], None]] = None,
        draft_tokens: Optional[Sequence[int]] = None,
    ) -> int:
        """Adopt a request prefilled elsewhere: place its KV slab (`rows`:
        per layer, positions < len(prompt), batch axis stripped: values
        [KV, Tp, D], kv_quant scales [KV, 1, Tp]; CPU or device tensors,
        or numpy arrays of a numpy dtype) into a free slot and decode
        from `first_token`, the token the prefill sampled at the last
        prompt position. Its value is host-side, so it lands in the
        output at once. Requires a free slot. Greedy continuations equal
        a local submit()'s. `draft_tokens` (at most spec k) seed the
        request's first verify round when spec decoding runs with no
        local draft, and are dropped otherwise."""
        prompt = self._validate(prompt, max_new_tokens)
        slot = next((s for s in range(self.max_slots) if self._slot_req[s] is None), None)
        if slot is None:
            raise RuntimeError("no free slot for prefilled request")
        self._rid += 1
        req = _Request(self._rid, prompt, int(max_new_tokens), t_submit=time.monotonic(),
                       on_token=on_token)
        if (draft_tokens is not None and self._spec is not None and self._spec.enabled
                and self._spec.draft_params is None):
            req.shipped_draft = np.asarray(draft_tokens, np.int32).reshape(-1)[: self._spec.k]
        _M_REQS.inc()
        self._place_prefilled(slot, req, rows, int(first_token))
        _M_SLOTS.set(_slots_in_use(self._slot_req))
        return req.rid

    def _spec_draft_on(self) -> bool:
        """Whether a device draft model shadows the grid."""
        return (self._spec is not None and self._spec.enabled
                and self._spec.draft_params is not None)

    def _place_prefilled(self, slot: int, req: _Request, rows, first_token: int) -> None:
        """Place an already-prefilled request into `slot` (the core of
        `submit_prefilled`): the rows on the device, then the request's
        bookkeeping."""
        self._check_rows(rows, req.prompt.size)
        # the slab carried target rows only: the draft cache needs its own
        # rows for positions < Tp before it can propose
        draft = self._spec_draft_on() and req.max_new_tokens > 1
        self._dev_place_rows(slot, rows, req.prompt.size, int(first_token), req.rid,
                             req.prompt if draft else None)
        self._adopt(slot, req, int(first_token))

    @seam
    def _dev_place_rows(self, slot: int, rows, tp: int, first_token: int, rid: int,
                        draft_prompt: Optional[np.ndarray]) -> None:
        """A prefilled slab into `slot`, the slot's cur/pos/rid merged;
        with `draft_prompt`, the draft cache's rows for it too."""
        self.cache = self._insert_rows(self.cache, slot, rows, tp)
        slot_map = np.full(self.max_slots, -1, np.int32)
        slot_map[slot] = 0
        sm = self._upload(slot_map)
        self._cur_dev = self._merge_vec(self._cur_dev, self._upload(np.asarray([first_token], np.int32)), sm)
        self._pos_dev = self._merge_vec(self._pos_dev, self._upload(np.asarray([tp], np.int32)), sm)
        self._rid_dev = self._merge_vec(self._rid_dev, self._upload(np.asarray([rid], np.int32)), sm)
        if draft_prompt is not None:
            self._spec_draft_prefill_one(slot, draft_prompt)

    def _adopt(self, slot: int, req: _Request, first_token: int) -> None:
        """The host half of placing a prefilled request: its first token
        (a host value) delivered, the slot taken."""
        req.deliver([first_token])
        req.emitted = 1
        req.slot = slot
        self._slot_req[slot] = req
        self.rid_vec[slot] = req.rid
        self.tokens_delivered += 1
        _M_TOKENS.inc()
        if req.done:  # max_new_tokens == 1: the slab's token was all
            self._retire(slot)

    def _spec_draft_prefill_one(self, slot: int, prompt: np.ndarray) -> None:
        """The draft cache's rows for one slot from a host-known prompt
        (adopted and warm placements), bucketed as a group prefill."""
        tp = prompt.size
        bucket = min(_bucket(tp), self.max_len)
        padded = np.full((1, bucket), prompt[-1], np.int32)
        padded[0, :tp] = prompt
        _, pcache = self._prefill(self._spec.draft_params, self._spec.draft_cfg, padded,
                                  np.asarray([tp], np.int32))
        self._spec.draft_cache = self._insert_impl(self._spec.draft_cache, pcache, slot, 0)
        shape = ("draft_prefill", bucket, 1)
        if shape not in self._seen_shapes:
            self._seen_shapes.add(shape)
            _M_COMPILES.inc()

    def _place_waiting(self) -> None:
        # Placement is asynchronous and group-batched: free slots take
        # queued requests bucket by bucket, one batched prefill per
        # bucket group, one whole-row insert per request, one batched
        # first-token sample and masked merges into the device cur/pos.
        # Nothing here waits on the device; the first tokens' values
        # ride the next step's packed readback (or _flush_firsts).
        pairs = []
        for slot in range(self.max_slots):
            if self._slot_req[slot] is None and self._queue:
                pairs.append((slot, self._queue.pop(0)))
        if not pairs:
            return
        if self._warm is not None and self.temperature == 0.0:
            # warm starts intercept placement request by request: a
            # prompt extending a cached prefix adopts the cached rows
            # plus a suffix-only prefill; the rest fall through to the
            # cold group prefill. Greedy only (sampled firsts are
            # rid-keyed).
            cold: List[Tuple[int, _Request]] = []
            draft = self._spec_draft_on()
            hits = self._dev_warm_place([(slot, req.prompt, req.rid,
                                          draft and req.max_new_tokens > 1)
                                         for slot, req in pairs])
            for (slot, req), hit in zip(pairs, hits):
                if hit is None:
                    cold.append((slot, req))
                    continue
                first, saved = hit
                _M_QUEUE_WAIT.observe(time.monotonic() - req.t_submit)
                self._adopt(slot, req, first)
                self.kv_cache.note_adopted(saved)
            pairs = cold
            if not pairs:
                _M_SLOTS.set(_slots_in_use(self._slot_req))
                return
        groups: Dict[int, List[Tuple[int, _Request]]] = {}
        for slot, req in pairs:
            groups.setdefault(min(_bucket(req.prompt.size), self.max_len), []).append((slot, req))
        spec_draft = self._spec_draft_on()
        for bucket, grp in groups.items():
            t_grp0 = time.monotonic()
            k = len(grp)
            # short buckets pad straight to max_slots rows (one shape per
            # bucket); long ones to a power of two (an 8-row 4k-token
            # prefill's transient cache is real memory)
            kp = self.max_slots if bucket <= 256 else min(_bucket(k, lo=1), self.max_slots)
            padded = np.zeros((kp, bucket), np.int32)
            tps = np.ones(kp, np.int32)
            rids = np.zeros(kp, np.int32)
            slot_map = np.full(self.max_slots, -1, np.int32)
            for row, (slot, req) in enumerate(grp):
                tp = req.prompt.size
                padded[row, :tp] = req.prompt
                # pad with the last token: positions >= tp are behind the
                # validity mask, but rope and the cache write them
                padded[row, tp:] = req.prompt[-1]
                tps[row] = tp
                rids[row] = req.rid
                slot_map[slot] = row
            for row in range(k, kp):  # dummy rows repeat row 0
                padded[row] = padded[0]
                tps[row] = tps[0]
            firsts = self._dev_place_group(padded, tps, rids, slot_map,
                                           [slot for slot, _ in grp], spec_draft)
            if spec_draft:
                dshape = ("draft_prefill", bucket, kp)
                if dshape not in self._seen_shapes:
                    self._seen_shapes.add(dshape)
                    _M_COMPILES.inc()
            self._pending_first.append(([req for _, req in grp], firsts))
            now = time.monotonic()
            shape = ("prefill", bucket, kp)
            if shape not in self._seen_shapes:
                self._seen_shapes.add(shape)
                _M_COMPILES.inc()
            _M_PREFILL.observe(now - t_grp0)
            for slot, req in grp:
                _M_QUEUE_WAIT.observe(now - req.t_submit)
                req.emitted = 1
                req.slot = slot
                self._slot_req[slot] = req
                self.rid_vec[slot] = req.rid
                if req.done:  # max_new_tokens == 1
                    self._retire(slot)
        _M_SLOTS.set(_slots_in_use(self._slot_req))

    @seam
    def _dev_place_group(self, padded: np.ndarray, tps: np.ndarray, rids: np.ndarray,
                         slot_map: np.ndarray, slots: List[int], draft: bool) -> torch.Tensor:
        """One bucket group's placement: a batched prefill (logits_index
        = tp - 1 per row: causal masking makes each row's logits there
        those of an unpadded prefill), row `i` into `slots[i]`, the first
        tokens sampled and merged into cur/pos/rid; with `draft`, the
        draft cache's rows too. Returns the first tokens (device)."""
        logits, pcache = self._prefill(self._maybe_gather(self.params), self.cfg, padded, tps)
        for row, slot in enumerate(slots):
            self.cache = self._insert_impl(self.cache, pcache, slot, row)
        del pcache
        if draft:
            # the draft cache shadows the grid: a second prefill of the
            # same padded batch with the draft's params; its logits are
            # unused (the first token is the target's)
            _, dpcache = self._prefill(self._spec.draft_params, self._spec.draft_cfg,
                                       padded, tps)
            for row, slot in enumerate(slots):
                self._spec.draft_cache = self._insert_impl(self._spec.draft_cache, dpcache,
                                                           slot, row)
            del dpcache
        rids_dev = self._upload(rids)
        tps_dev = self._upload(tps)
        # first tokens occupy position tp: the streams the chunk sampler
        # continues
        firsts = self._sample_slots(logits, rids_dev, tps_dev)
        sm = self._upload(slot_map)
        self._cur_dev = self._merge_vec(self._cur_dev, firsts, sm)
        self._pos_dev = self._merge_vec(self._pos_dev, tps_dev, sm)
        self._rid_dev = self._merge_vec(self._rid_dev, rids_dev, sm)
        return firsts

    @seam
    def _dev_warm_place(self, picks) -> List[Optional[Tuple[int, int]]]:
        """Warm starts, in order: each `(slot, prompt, rid, draft)` whose
        prompt extends a cached prefix adopts the cached rows plus a
        suffix-only prefill (`_dev_place_rows`); returns per pick None (a
        miss, for the cold group prefill) or (first token, saved
        tokens)."""
        params = self._maybe_gather(self.params)
        out: List[Optional[Tuple[int, int]]] = []
        for slot, prompt, rid, draft in picks:
            warm = self._warm.rows_for(params, prompt)
            if warm is None:
                out.append(None)
                continue
            rows, first, saved = warm
            self._dev_place_rows(slot, rows, prompt.size, int(first), rid,
                                 prompt if draft else None)
            out.append((int(first), int(saved)))
        return out

    @seam
    def _dev_capture(self, slot: int, tokens: np.ndarray) -> None:
        """A retiring slot's rows for `tokens` into the prefix cache. A
        failure only forfeits the entry."""
        from .kv_cache import capture_slot_rows

        try:
            self.kv_cache.offer(tokens, capture_slot_rows(self.cache, slot, int(tokens.size)))
        except Exception as e:
            log.warning("kv-cache capture failed at retire: %r", e)

    @seam
    def _dev_chunk(self) -> torch.Tensor:
        """The chunk dispatch's device work: `chunk` decode steps of
        every slot; returns the tokens [chunk, slots] (device)."""
        self.cache, self._cur_dev, self._pos_dev, toks = self._chunk_impl(
            self._maybe_gather(self.params), self.cache, self._cur_dev, self._pos_dev,
            self._rid_dev)
        return toks

    @seam
    def _dev_spec_round(self, d: Optional[np.ndarray]):
        """A speculative round's device work: the draft model's
        proposals (`d` None) or the host's `d` [slots, k], verified in one
        target forward; returns (committed tokens, accept lengths)."""
        sp = self._spec
        if d is None:
            sp.draft_cache, d_toks = self._propose_impl(sp.draft_params, sp.draft_cache,
                                                        self._cur_dev, self._pos_dev)
        else:
            d_toks = self._upload(d)
        self.cache, self._cur_dev, self._pos_dev, toks, acc = self._verify_impl(
            self._maybe_gather(self.params), self.cache, self._cur_dev, self._pos_dev, d_toks)
        return toks, acc

    def _retire(self, slot: int) -> None:
        req = self._slot_req[slot]
        assert req is not None
        # greedy only, like the warm side: a sampled server never adopts
        if self.kv_cache is not None and self.temperature == 0.0:
            self._capture_retired(slot, req)
        self._done[req.rid] = req
        req.slot = None
        self._slot_req[slot] = None
        self.rid_vec[slot] = 0
        _M_REQS_DONE.inc()

    def _capture_retired(self, slot: int, req: _Request) -> None:
        """Donate a retiring request's KV rows to the prefix cache. Valid
        positions are [0, Tp + emitted - 1): the last sampled token was
        never fed back, so its row is unwritten. `capture_slot_rows`
        copies the rows out on the device before the slot can be reused;
        `KVPrefixCache.offer` moves them to the host, once per retired
        request (`_dev_capture`). A failure only forfeits the entry."""
        need = req.emitted - 1  # generated tokens with rows
        if len(req.out) < need:
            return
        self._dev_capture(slot, np.concatenate([req.prompt,
                                                np.asarray(req.out[:need], np.int32)]))

    @staticmethod
    def _distribute_firsts(entries, vals, off) -> int:
        """Append each pending group's first tokens to its requests'
        outputs from the packed buffer `vals` at `off`; rows past a
        group's requests are padding. Shared by step()'s readback and
        _flush_firsts, so the offset walk stays one."""
        for reqs, v in entries:
            for i, req in enumerate(reqs):
                req.deliver([int(vals[off + i])])
            off += int(v.shape[0])
        return off

    def _readback(self, parts: List[torch.Tensor]) -> np.ndarray:
        """The one blocking device-to-host copy: every part flattened,
        concatenated and copied in one call."""
        t0 = time.monotonic()
        packed = torch.cat([p.reshape(-1) for p in parts]).cpu().numpy()
        _M_READBACK.observe(time.monotonic() - t0)
        return packed

    def _flush_firsts(self) -> None:
        """Read back placement first tokens that have not ridden a
        step's readback (a budget-1 request that retired at placement
        with no step after it)."""
        if not self._pending_first:
            return
        entries = self._pending_first
        self._pending_first = []
        vals = self._readback([v for _, v in entries])
        self._distribute_firsts(entries, vals, 0)
        flushed = sum(len(reqs) for reqs, _ in entries)
        self.tokens_delivered += flushed
        _M_TOKENS.inc(flushed)

    def step(self) -> None:
        """One decode dispatch: every active slot advances, through the
        chunk loop or, when enabled and eligible (`_use_spec`), one
        propose + verify round. Finished slots free and queued requests
        take them at this step's end (`_place_waiting`), mid-flight."""
        if not any(r is not None for r in self._slot_req):
            self._place_waiting()
            if not any(r is not None for r in self._slot_req):
                return
        _M_OCCUPANCY.observe(_slots_in_use(self._slot_req))
        if self._use_spec():
            self._spec_step()
        else:
            self._chunk_step()

    def _use_spec(self) -> bool:
        """Whether this dispatch is a speculative round. Not when there
        is no proposal source this round, nor when any active slot is
        within k + 1 positions of max_len (the verify forward writes
        rows pos..pos+k, and a clamped start would move live rows)."""
        sp = self._spec
        if sp is None or not sp.enabled:
            return False
        if sp.draft_params is None and sp.proposer is None and not any(
                r is not None and r.shipped_draft is not None for r in self._slot_req):
            return False
        lim = self.max_len - (sp.k + 1)
        return not any(r is not None and r.prompt.size + r.emitted > lim for r in self._slot_req)

    def _spec_step(self) -> None:
        """One speculative round: propose k tokens per slot, verify them
        in one target forward, commit 1..k per slot. Committed tokens,
        accept lengths and pending firsts ride one packed readback."""
        t_step0 = time.monotonic()
        sp = self._spec
        k = sp.k
        b = self.max_slots
        firsts = self._pending_first
        self._pending_first = []
        real = [False] * b  # slots whose proposals count toward the rate
        if sp.draft_params is not None:
            # device draft: proposals never leave the card; a shipped
            # draft is redundant here and consumed
            for r in self._slot_req:
                if r is not None:
                    r.shipped_draft = None
                    real[r.slot] = True
            if "spec_propose" not in self._seen_shapes:
                self._seen_shapes.add("spec_propose")
                _M_COMPILES.inc()
            d = None
        else:
            # host proposals: shipped drafts first (consumed once), then
            # the proposer; slots with neither get zero rows (they still
            # commit >= 1 correct token) and do not count toward the rate
            d = np.zeros((b, k), np.int32)
            need: List[_Request] = []
            for slot, r in enumerate(self._slot_req):
                if r is None:
                    continue
                if r.shipped_draft is not None:
                    sd = r.shipped_draft[:k]
                    r.shipped_draft = None
                    d[slot, : sd.size] = sd
                    real[slot] = True
                elif sp.proposer is not None:
                    need.append(r)
            if need:
                rows = np.asarray(sp.proposer(need, k), np.int32).reshape(len(need), k)
                for r, row in zip(need, rows):
                    d[r.slot] = row
                    real[r.slot] = True
        if "spec_verify" not in self._seen_shapes:
            self._seen_shapes.add("spec_verify")
            _M_COMPILES.inc()
        toks, acc = self._dev_spec_round(d)
        packed = self._readback([toks, acc] + [v for _, v in firsts])
        n = b * k
        tokm = packed[:n].reshape(b, k)
        accs = packed[n: n + b]
        # occupancy snapshot before any callback: an on_token adoption
        # mid-delivery decodes from the next dispatch, not this round's
        # stale column
        live = list(enumerate(self._slot_req))
        self._distribute_firsts(firsts, packed, n + b)
        delivered = sum(len(reqs) for reqs, _ in firsts)
        prop_n = acc_n = 0
        for slot, req in live:
            if req is None:
                continue
            a = int(accs[slot])
            c = min(a + 1, k)
            take = min(c, req.max_new_tokens - req.emitted)
            req.deliver(tokm[slot, :take])
            req.emitted += take
            delivered += take
            if real[slot]:
                prop_n += k
                acc_n += a
                req.spec_rounds += 1
                req.spec_accepted += a
            # take < c retires; the slot's device cur/pos ran past its
            # budget, which the next insert's whole-row overwrite erases
            if req.done:
                self._retire(slot)
        sp.rounds += 1
        if prop_n:
            _M_SPEC_PROPOSED.inc(prop_n)
            _M_SPEC_ACCEPTED.inc(acc_n)
            sp.proposed_total += prop_n
            sp.accepted_total += acc_n
            sp.win_proposed += prop_n
            sp.win_accepted += acc_n
            if (sp.min_accept > 0.0 and (sp.draft_params is not None or sp.proposer is not None)
                    and sp.win_proposed >= sp.min_samples):
                if sp.win_accepted / sp.win_proposed < sp.min_accept:
                    self.disable_spec_decode(reason="acceptance")
                elif sp.win_proposed >= 2 * sp.min_samples:
                    # slide the window: track the current workload
                    sp.win_proposed //= 2
                    sp.win_accepted //= 2
        self._place_waiting()
        self.tokens_delivered += delivered
        _M_TOKENS.inc(delivered)
        _M_STEPS.inc()
        _M_SLOTS.set(_slots_in_use(self._slot_req))
        _M_STEP.observe(time.monotonic() - t_step0)

    def _chunk_step(self) -> None:
        """The plain chunk dispatch."""
        t_step0 = time.monotonic()
        firsts = self._pending_first
        self._pending_first = []
        if "chunk" not in self._seen_shapes:
            self._seen_shapes.add("chunk")
            _M_COMPILES.inc()
        toks = self._dev_chunk()
        # one packed readback per step: the chunk's tokens and any
        # placement first tokens deferred since the last one
        packed = self._readback([toks] + [v for _, v in firsts])
        n = self.chunk * self.max_slots
        toks = packed[:n].reshape(self.chunk, self.max_slots)
        # occupancy snapshot before deliver() fires callbacks: an
        # adoption into a slot this step freed must not take this
        # dispatch's stale column
        live = list(enumerate(self._slot_req))
        self._distribute_firsts(firsts, packed, n)
        delivered = sum(len(reqs) for reqs, _ in firsts)
        for slot, req in live:
            if req is None:
                continue
            take = min(self.chunk, req.max_new_tokens - req.emitted)
            req.deliver(toks[:take, slot])
            req.emitted += take
            delivered += take
            # take < chunk retires here; the slot's device cur/pos ran
            # past its budget, which the next insert erases
            if req.done:
                self._retire(slot)
        self._place_waiting()
        self.tokens_delivered += delivered
        _M_TOKENS.inc(delivered)
        _M_STEPS.inc()
        _M_SLOTS.set(_slots_in_use(self._slot_req))
        _M_STEP.observe(time.monotonic() - t_step0)

    def has_work(self) -> bool:
        """True while any request is queued or occupying a slot."""
        return bool(self._queue) or any(r is not None for r in self._slot_req)

    def take_done(self) -> Dict[int, np.ndarray]:
        """Drain finished requests: {rid: generated tokens}. Deferred
        first tokens are flushed only when a pending request has retired
        (a budget-1 request can retire at placement with its one token
        still on the device)."""
        if any(r.done for reqs, _ in self._pending_first for r in reqs):
            self._flush_firsts()
        out = {rid: np.asarray(r.out, np.int32) for rid, r in self._done.items()}
        self._done.clear()
        return out

    def run(self, rids: Optional[Sequence[int]] = None) -> Dict[int, np.ndarray]:
        """Drive until every submitted request finishes; returns {rid:
        generated tokens}. With `rids`, drive until those finish and
        return (and remove) only them, leaving other results for their
        owner (a caller sharing the server with an LMDriver)."""
        if rids is None:
            while self.has_work():
                self.step()
            return self.take_done()
        want = set(rids)
        while (want - set(self._done)) and self.has_work():
            self.step()
        self._flush_firsts()  # a wanted budget-1 rid may have no step
        out = {}
        for rid in want:
            r = self._done.pop(rid, None)
            if r is not None:
                out[rid] = np.asarray(r.out, np.int32)
        return out


@dataclasses.dataclass
class _Ticket:
    """One caller's batch of prompts inside the driver. `event` fires
    when every request in the ticket has finished (or on error)."""

    prompts: List[np.ndarray]
    max_new_tokens: Any  # int, or per-prompt sequence of ints
    event: threading.Event
    on_dispatch: Optional[Callable[[], None]] = None
    on_token: Optional[Sequence[Optional[Callable[[int], None]]]] = None
    rids: Optional[List[int]] = None
    remaining: int = 0
    results: Optional[Dict[int, np.ndarray]] = None
    error: Optional[BaseException] = None


class LMDriver:
    """Thread-safe continuous-batching front door for one `LMServer`.

    One background thread owns the server (its device work and the
    kernels' launch counts run there); any number of callers call
    `serve()` at once, and their prompts merge into the same slot grid:
    a new batch's prefills enter freed slots while earlier batches are
    still decoding, and each caller gets its results the moment its own
    requests retire. Outputs equal isolated `generate` calls however the
    tickets interleave. A death of the thread fails every ticket in
    flight instead of leaving its caller waiting."""

    def __init__(self, server: LMServer, server_lock: Optional[threading.Lock] = None):
        self.server = server
        # guards the raw server against a caller that also drives it
        # directly (LMBackend's serial mode holds it for a whole run())
        self._server_lock = server_lock or threading.Lock()
        self._cv = threading.Condition()
        self._incoming: List[_Ticket] = []
        self._owner: Dict[int, _Ticket] = {}  # rid -> ticket
        self._stop = False
        self._thread: Optional[threading.Thread] = None
        self.steps = 0
        self.tickets_served = 0

    # -- caller side ----------------------------------------------------

    def serve(
        self,
        prompts: Sequence[np.ndarray],
        max_new_tokens,
        on_dispatch: Optional[Callable[[], None]] = None,
        on_token: Optional[Sequence[Optional[Callable[[int], None]]]] = None,
    ) -> List[np.ndarray]:
        """Blocking: decode `prompts`, return their completions in order.
        Safe from any thread. `on_dispatch` fires (on the driver thread)
        once the ticket's prompts are submitted; `on_token` (per-prompt
        callbacks, on the driver thread) streams each delivered token."""
        t = _Ticket(prompts=[np.asarray(p, np.int32).reshape(-1) for p in prompts],
                    max_new_tokens=max_new_tokens, event=threading.Event(),
                    on_dispatch=on_dispatch, on_token=on_token)
        with self._cv:
            if self._stop:
                raise RuntimeError("LMDriver is stopped")
            self._ensure_thread()
            self._incoming.append(t)
            self._cv.notify_all()
        t.event.wait()
        if t.error is not None:
            raise t.error
        assert t.results is not None and t.rids is not None
        return [t.results[rid] for rid in t.rids]

    def stop(self) -> None:
        """Stop the driver thread (idempotent). In-flight tickets finish
        first; new serve() calls are rejected. If the join times out the
        handle is kept (that thread still owns the grid) and a later
        stop() retries."""
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        t = self._thread
        if t is not None:
            t.join(timeout=60.0)
            if t.is_alive():
                log.error("LMDriver thread %s did not stop within 60s; keeping the handle "
                          "(it still owns the LMServer slot grid)", t.name)
                return
            self._thread = None

    # -- driver thread --------------------------------------------------

    def _ensure_thread(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(target=self._loop, name="lm-driver", daemon=True)
            self._thread.start()

    def _loop(self) -> None:
        try:
            self._loop_inner()
        except BaseException as e:
            # fail every in-flight and queued ticket loudly, then stop
            # accepting work: silence would block their callers forever
            with self._cv:
                self._stop = True
                pending = list(self._incoming)
                self._incoming = []
            owned = {id(t): t for t in self._owner.values()}
            self._owner.clear()
            for t in list(owned.values()) + pending:
                if t.error is None:
                    t.error = RuntimeError(f"LMDriver thread died: {e!r}")
                t.event.set()
            raise

    def _loop_inner(self) -> None:
        srv = self.server
        while True:
            with self._cv:
                while not self._incoming and not srv.has_work() and not self._stop:
                    self._cv.wait()
                if self._stop and not self._incoming and not srv.has_work():
                    return
                new = self._incoming
                self._incoming = []
            with self._server_lock:
                for t in new:
                    try:
                        # submit_many is atomic: a bad prompt rejects the
                        # whole ticket before any of it queues
                        t.rids = srv.submit_many(t.prompts, t.max_new_tokens,
                                                 on_token=t.on_token)
                        t.remaining = len(t.rids)
                        t.results = {}
                        for rid in t.rids:
                            self._owner[rid] = t
                        if t.remaining == 0:
                            t.event.set()
                    except Exception as e:
                        t.error = e
                        t.event.set()
                        continue
                    if t.on_dispatch is not None:
                        try:
                            t.on_dispatch()
                        except Exception as e:
                            log.warning("on_dispatch hook failed: %r", e)
                if srv.has_work():
                    srv.step()
                    with self._cv:
                        self.steps += 1
                done = srv.take_done()
            for rid, toks in done.items():
                t = self._owner.pop(rid, None)
                if t is None:
                    continue  # submitted through the raw server API
                t.results[rid] = toks
                t.remaining -= 1
                if t.remaining == 0:
                    self.tickets_served += 1
                    t.event.set()

"""LM serving backend: PyTorch counterpart of
dml_tpu/inference/lm_backend.py.

Prompts are token files; each batch of files decodes through one
continuous-batching `LMServer`, shared by every caller through an
`LMDriver` (overlap mode) or driven under a lock (serial mode).

Prompt file contract (no tokenizer in the core): a text file of
whitespace- or comma-separated integer token ids, e.g. ``12 7 998 4``,
optionally with a ``# max_new_tokens: N`` directive line. Output per
file: ``{"tokens": [...]}``, the greedy completion, equal to an
isolated `generate(prompt, max_new_tokens)` call for that prompt
whatever else shared the batch.

Weights come from `init_lm_params(cfg, seed)` (the port's seeded init;
not JAX's bits) or from a weights file in the JAX package's flax-msgpack
format (`params_io.variables_from_bytes`, then `lm_params_from_flax`).
The job-service wiring (`cost()`'s `ModelCost`, `register_lm`) waits for
the port's jobs layer.
"""

from __future__ import annotations

import asyncio
import logging
import queue as _queue
import re
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .generate import LMConfig, serving_params
from .lm_server import LMDriver, LMServer

log = logging.getLogger(__name__)

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def parse_prompt_file(path: str, vocab_size: int) -> Tuple[np.ndarray, Optional[int]]:
    """(token ids, per-request budget or None) from a prompt file; raises
    with the offending path on malformed content.

    A line starting with ``#`` is a directive; ``# max_new_tokens: N``
    sets this request's budget (else the backend's default). A comment
    that starts with the directive's name but does not parse fails
    loudly; other comments are ignored."""
    budget: Optional[int] = None
    body: List[str] = []
    with open(path) as f:
        for line in f:
            s = line.strip()
            if s.startswith("#"):
                m = s[1:].split(":", 1)
                if len(m) == 2 and m[0].strip() == "max_new_tokens":
                    try:
                        budget = int(m[1])
                    except ValueError:
                        raise ValueError(f"{path}: bad max_new_tokens directive {s!r}") from None
                    if budget < 1:
                        raise ValueError(f"{path}: max_new_tokens must be >= 1")
                elif re.match(r"^#\s*max_new_tokens\b", s):
                    raise ValueError(f"{path}: unparseable max_new_tokens directive {s!r} "
                                     f"(expected '# max_new_tokens: N')")
                continue
            body.append(line)
    toks = [t for t in " ".join(body).replace(",", " ").split() if t]
    if not toks:
        raise ValueError(f"{path}: empty prompt file")
    try:
        ids = np.array([int(t) for t in toks], np.int32)
    except ValueError as e:
        raise ValueError(f"{path}: non-integer token ({e})") from None
    if (ids < 0).any() or (ids >= vocab_size).any():
        raise ValueError(f"{path}: token id out of range [0, {vocab_size})")
    return ids, budget


def write_prompt_file(path: str, tokens: Sequence[int], max_new_tokens: Optional[int] = None) -> None:
    """Inverse of parse_prompt_file; `max_new_tokens` writes the budget
    directive."""
    if max_new_tokens is not None and int(max_new_tokens) < 1:
        raise ValueError("max_new_tokens must be >= 1")
    with open(path, "w") as f:
        if max_new_tokens is not None:
            f.write(f"# max_new_tokens: {int(max_new_tokens)}\n")
        f.write(" ".join(str(int(t)) for t in tokens))


def lm_spec_parts(spec: Dict[str, Any], device=None):
    """(serving params, LMConfig) from a JSON-able LM spec, on `device`
    (`cuda` when None; it raises where there is none). Weights are
    `init_lm_params(cfg, seed)` (the same tree on every process that
    loads the spec) unless `weights` names a flax-msgpack file, which
    must hold {"params": the JAX package's LM tree}."""
    from ..models.lm_params import init_lm_params, lm_params_from_flax

    d_model = int(spec["d_model"])
    cfg = LMConfig(
        vocab_size=int(spec["vocab_size"]),
        d_model=d_model,
        n_heads=int(spec.get("n_heads", 8)),
        n_layers=int(spec.get("n_layers", 2)),
        d_ff=int(spec.get("d_ff", 4 * d_model)),
        dtype=_DTYPES[spec.get("dtype", "bfloat16")],
        n_kv_heads=int(spec["n_kv_heads"]) if spec.get("n_kv_heads") is not None else None,
        kv_quant=bool(spec.get("kv_quant", False)),
    )
    if spec.get("weights"):
        from ..models.params_io import variables_from_bytes

        with open(spec["weights"], "rb") as f:
            data = f.read()
        params = lm_params_from_flax(variables_from_bytes(data)["params"], device, cfg=cfg)
    else:
        params = init_lm_params(cfg, int(spec.get("seed", 0)), device=device)
    return serving_params(params, cfg), cfg


class LMBackend:
    """A worker-side LM serving backend: one `LMServer` (slot grid and
    KV cache allocated once); each batch of prompt files submits its
    prompts and collects their completions. Greedy by default;
    temperature > 0 stays reproducible per request through the
    server's per-request sampler.

    >>> be = LMBackend(params, cfg, max_new_tokens=32)
    >>> results, seconds, cost = be.serve_files(["a.tokens.txt"])
    """

    def __init__(
        self,
        params: Any,
        cfg: LMConfig,
        max_new_tokens: int = 32,
        max_slots: int = 8,
        max_len: int = 1024,
        chunk: int = 16,
        temperature: float = 0.0,
        top_k: Optional[int] = None,
        seed: int = 0,
        gather_shardings: Any = None,
        kv_cache_bytes: int = 0,
        spec_k: int = 0,
        spec_draft: Optional[Dict[str, Any]] = None,
        spec_min_accept: Optional[float] = None,
    ):
        self.cfg = cfg
        self.max_new_tokens = max_new_tokens
        self.server = LMServer(params, cfg, max_slots=max_slots, max_len=max_len, chunk=chunk,
                               temperature=temperature, top_k=top_k, seed=seed,
                               gather_shardings=gather_shardings)
        # speculative decoding (spec_k > 0): a draft model from
        # `spec_draft` (a model spec, normally config.draft_lm_spec of the
        # target's), on the params' device; spec_k > 0 without a draft
        # spec verifies shipped drafts only
        self.spec_k = int(spec_k)
        if self.spec_k > 0:
            from ..config import SPEC_MIN_ACCEPT_DEFAULT, SPEC_MIN_SAMPLES_DEFAULT

            dp = dcfg = None
            if spec_draft is not None:
                dp, dcfg = lm_spec_parts(spec_draft, device=self.server.device)
            self.server.enable_spec_decode(
                self.spec_k, draft_params=dp, draft_cfg=dcfg,
                min_accept=(SPEC_MIN_ACCEPT_DEFAULT if spec_min_accept is None
                            else float(spec_min_accept)),
                min_samples=SPEC_MIN_SAMPLES_DEFAULT)
        # KV prefix cache under a host-bytes budget; 0 = disabled
        self.kv_cache = None
        if int(kv_cache_bytes) > 0:
            from .kv_cache import KVPrefixCache

            self.kv_cache = KVPrefixCache(int(kv_cache_bytes))
            self.server.enable_kv_cache(self.kv_cache)
        self._per_query = 0.05
        # overlap=True: every caller feeds one LMDriver, so batch N+1
        # prefills into freed slots while batch N decodes; overlap=False:
        # the lock-serialized path. The driver takes the same lock the
        # serial mode holds across a whole run().
        self.overlap = True
        self._serve_lock = threading.Lock()
        self.driver = LMDriver(self.server, server_lock=self._serve_lock)

    @staticmethod
    def _token_cbs(paths: Sequence[str], on_token) -> Optional[list]:
        """Per-prompt delivery callbacks from ``on_token(local_path,
        text)``: each delivered token streams as its decimal text and a
        space, so the stream concatenates to the result's token list."""
        if on_token is None:
            return None
        return [(lambda t, p=p: on_token(p, f"{int(t)} ")) for p in paths]

    def serve_files(self, paths: Sequence[str], on_dispatch=None, on_token=None
                    ) -> Tuple[Dict[str, Any], float, Dict[str, float]]:
        """Decode every prompt file; returns (results keyed by path,
        decode seconds, cost constants). `on_dispatch` (overlap mode)
        fires once the prompts are in the driver's grid; `on_token(path,
        text)` fires per delivered token."""
        parsed = [parse_prompt_file(p, self.cfg.vocab_size) for p in paths]
        prompts = [ids for ids, _ in parsed]
        budgets = [b if b is not None else self.max_new_tokens for _, b in parsed]
        # every prompt checked against the server before any is
        # submitted, with the file's path in the error
        for p, prompt, budget in zip(paths, prompts, budgets):
            if prompt.size + budget > self.server.max_len:
                raise ValueError(f"{p}: prompt of {prompt.size} tokens + budget {budget} exceeds "
                                 f"the server's max_len {self.server.max_len}")
        cbs = self._token_cbs(paths, on_token)
        if self.overlap:
            t0 = time.monotonic()
            toks = self.driver.serve(prompts, budgets, on_dispatch=on_dispatch, on_token=cbs)
            infer_time = time.monotonic() - t0
            results = {p: {"tokens": [int(t) for t in ts]} for p, ts in zip(paths, toks)}
        else:
            with self._serve_lock:
                # the clock starts inside the lock: waiting out another
                # caller's decode is queueing, not this batch's cost
                t0 = time.monotonic()
                rids = self.server.submit_many(prompts, budgets, on_token=cbs)
                # run(rids): only our requests, never a driver ticket's
                done = self.server.run(rids)
                infer_time = time.monotonic() - t0
            results = {p: {"tokens": [int(t) for t in done[rid]]} for p, rid in zip(paths, rids)}
        if paths:
            self._per_query = infer_time / len(paths)
        return results, infer_time, self.cost_constants()

    async def backend(self, model: str, paths: Sequence[str], on_dispatch=None, on_token=None
                      ) -> Tuple[Dict[str, Any], float, Dict[str, float]]:
        """The coroutine form of `serve_files` (the job service's backend
        contract); the blocking decode runs in a thread."""
        del model
        return await asyncio.to_thread(self.serve_files, paths, on_dispatch, on_token)

    def close(self) -> None:
        """Stop the driver thread (idempotent); in-flight work finishes
        first."""
        self.driver.stop()
        if self.kv_cache is not None:
            self.kv_cache.close()

    def set_kv_cache_enabled(self, enabled: bool) -> None:
        """Attach or detach the prefix cache without dropping its
        contents (no-op without a cache budget)."""
        if self.kv_cache is None:
            return
        self.server.enable_kv_cache(self.kv_cache if enabled else None)

    def kv_cache_stats(self) -> Optional[Dict[str, int]]:
        """Prefix-cache counters (None when disabled)."""
        return None if self.kv_cache is None else self.kv_cache.stats()

    def spec_stats(self) -> Optional[Dict[str, Any]]:
        """Speculative-decoding acceptance accounting (None when spec was
        never enabled)."""
        return self.server.spec_stats()

    def decode_tokens_total(self) -> int:
        """Tokens delivered by this backend's server."""
        return int(self.server.tokens_delivered)

    def cost_constants(self) -> Dict[str, float]:
        return {
            "load_time": 0.0,
            "first_query": self._per_query,
            "per_query": self._per_query,
            "batch_size": self.server.max_slots,
        }

    def cost(self):
        """The scheduler's `ModelCost` lives in the job layer, which the
        port does not have yet."""
        raise NotImplementedError(
            "LMBackend.cost() returns a jobs.cost_model.ModelCost; the port's jobs layer "
            "is ROADMAP A6 (use cost_constants())")

    def serve_prefilled(self, prompts: Sequence[np.ndarray], budgets: Sequence[int],
                        slabs: Sequence[Dict[str, Any]], on_token=None
                        ) -> Tuple[List[np.ndarray], float]:
        """Decode a batch prefilled elsewhere: each slab ({"rows": the
        per-layer KV for positions < len(prompt), "first_token": the
        token the prefill sampled}) adopts a slot through
        `LMServer.submit_prefilled`. Returns (tokens per prompt in order,
        decode seconds). A slab that cannot be adopted falls back to a
        local prefill of its prompt."""
        if len(prompts) != len(slabs) or len(prompts) != len(budgets):
            raise ValueError("prompts/budgets/slabs length mismatch")
        arrivals: "_queue.Queue" = _queue.Queue()
        for i, slab in enumerate(slabs):
            arrivals.put((i, slab))
        toks, infer_time, _ = self.serve_prefilled_stream(prompts, budgets, arrivals,
                                                          on_token=on_token)
        return toks, infer_time

    def serve_prefilled_stream(self, prompts: Sequence[np.ndarray], budgets: Sequence[int],
                               arrivals, on_token=None, on_first_token=None,
                               arrival_timeout: float = 120.0
                               ) -> Tuple[List[np.ndarray], float, Dict[str, int]]:
        """Decode a batch whose KV slabs arrive one by one: `arrivals` is
        a thread-safe queue yielding one ``(index, entry)`` per prompt,
        `entry` a slab dict or None (prefill that request here). Requests
        adopt slots as their slabs land, so decode overlaps the wait.
        A failed adoption demotes that one request to a local prefill.
        Returns (tokens per prompt in order, decode seconds, {"adopted":
        n, "local": n}). `on_first_token` fires once, at the batch's
        first delivered token. Drives the raw server under the serve
        lock; greedy only."""
        if len(prompts) != len(budgets):
            raise ValueError("prompts/budgets length mismatch")
        if self.server.temperature != 0.0:
            raise ValueError("disaggregated decode requires temperature == 0")
        n = len(prompts)
        first_fired = [False]

        def _cb(i: int):
            inner = on_token[i] if on_token is not None else None

            def fire(t: int) -> None:
                if not first_fired[0]:
                    first_fired[0] = True
                    if on_first_token is not None:
                        try:
                            on_first_token()
                        except Exception as e:
                            log.warning("on_first_token hook failed: %r", e)
                if inner is not None:
                    inner(t)

            return fire

        srv = self.server
        stats = {"adopted": 0, "local": 0}
        with self._serve_lock:
            t0 = time.monotonic()
            received = 0
            to_adopt: List[Tuple[int, Dict[str, Any]]] = []
            rids: List[Optional[int]] = [None] * n
            done: Dict[int, np.ndarray] = {}

            def submit_local(idx: int) -> None:
                rids[idx] = srv.submit_many([prompts[idx]], [budgets[idx]],
                                            on_token=[_cb(idx)])[0]
                stats["local"] += 1

            try:
                while True:
                    # 1) drain arrivals; block only when the grid is idle
                    block = received < n and not to_adopt and not srv.has_work()
                    while received < n:
                        try:
                            idx, entry = (arrivals.get(block=True, timeout=arrival_timeout)
                                          if block else arrivals.get_nowait())
                        except _queue.Empty:
                            if block:
                                raise TimeoutError(f"KV slab arrivals stalled ({received}/{n} "
                                                   f"after {arrival_timeout:g}s idle)")
                            break
                        block = False
                        received += 1
                        if entry is None:
                            submit_local(idx)
                        else:
                            to_adopt.append((idx, entry))
                    # 2) adopt landed slabs into free slots
                    while to_adopt and srv.free_slot_count() > 0:
                        idx, entry = to_adopt.pop(0)
                        try:
                            rids[idx] = srv.submit_prefilled(
                                prompts[idx], budgets[idx], entry["rows"], entry["first_token"],
                                on_token=_cb(idx), draft_tokens=entry.get("draft"))
                            stats["adopted"] += 1
                        except Exception as e:
                            log.warning("slab adoption failed for request %d (%r); local "
                                        "prefill", idx, e)
                            submit_local(idx)
                    # 3) advance the grid
                    if srv.has_work():
                        srv.step()
                    done.update(srv.take_done())
                    if (received >= n and not to_adopt and all(r is not None for r in rids)
                            and all(r in done for r in rids)):
                        break
            except Exception:
                # drain what was placed, so a fallback starts clean
                live = [r for r in rids if r is not None and r not in done]
                if live:
                    srv.run(live)
                raise
            infer_time = time.monotonic() - t0
        if n:
            self._per_query = infer_time / n
        return [done[rid] for rid in rids], infer_time, stats

    @staticmethod
    def _draft_spec_of(spec: Dict[str, Any]) -> Optional[Dict[str, Any]]:
        """The draft-model spec a serving spec implies: absent + spec_k >
        0 derives one (`config.draft_lm_spec`); a dict overrides the
        derived spec (or replaces it when it has its own vocab_size and
        d_model); False opts out of a local draft."""
        if int(spec.get("spec_k", 0) or 0) <= 0:
            return None
        sd = spec.get("spec_draft")
        if sd is False:
            return None
        from ..config import draft_lm_spec

        if sd is None:
            return draft_lm_spec(spec)
        if not isinstance(sd, dict):
            raise ValueError(f"spec_draft must be a dict or false, got {sd!r}")
        if "vocab_size" in sd and "d_model" in sd:
            return dict(sd)
        return draft_lm_spec(spec, **sd)

    @classmethod
    def from_spec(cls, spec: Dict[str, Any], device=None) -> "LMBackend":
        """Build from a JSON-able spec, on `device` (`cuda` when None;
        it raises where there is none):

            {"name": "LM", "vocab_size": 256, "d_model": 64,
             "n_heads": 4, "n_kv_heads": 2, "n_layers": 2,
             "max_new_tokens": 32, "max_slots": 4, "max_len": 1024,
             "weights": null}

        Weights are deterministic from `seed` unless `weights` names a
        file written by `params_io.variables_to_bytes({"params": ...})`
        (either package's). `kv_cache_mb` turns on the prefix cache,
        `spec_k` speculative decoding (`spec_draft` as in
        `_draft_spec_of`), `overlap` picks the serving mode."""
        params, cfg = lm_spec_parts(spec, device)
        max_new = int(spec.get("max_new_tokens", 32))
        # default chunk ~ the budget (capped): each step's readback is a
        # host round trip, so fewer, longer steps for short budgets
        chunk_default = max(1, min(max_new, 32))
        be = cls(
            params, cfg,
            max_new_tokens=max_new,
            max_slots=int(spec.get("max_slots", 4)),
            max_len=int(spec.get("max_len", 1024)),
            chunk=int(spec.get("chunk", chunk_default)),
            temperature=float(spec.get("temperature", 0.0)),
            top_k=int(spec["top_k"]) if spec.get("top_k") is not None else None,
            seed=int(spec.get("seed", 0)),
            kv_cache_bytes=int(float(spec.get("kv_cache_mb", 0) or 0) * (1 << 20)),
            spec_k=int(spec.get("spec_k", 0) or 0),
            spec_draft=LMBackend._draft_spec_of(spec),
            spec_min_accept=spec.get("spec_min_accept"),
        )
        if spec.get("overlap") is not None:
            be.overlap = bool(spec["overlap"])
        return be

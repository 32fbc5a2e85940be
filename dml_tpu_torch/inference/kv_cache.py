"""KV prefix cache: PyTorch counterpart of dml_tpu/inference/kv_cache.py.
Warm-start decode from retired requests' KV slabs, prefilling only the
new suffix.

- Capture: when a request retires from the `LMServer` grid, its KV rows
  (prompt and generated positions) and their token ids are kept on the
  host, keyed by token prefix in a trie, so multi-turn sessions (turn
  N+1 extends turn N's prompt and completion) and shared system prompts
  hit.
- Warm start: a new request whose prompt extends a cached prefix adopts
  the cached rows and prefills only the suffix (`SuffixPrefiller`: one
  forward over the new tokens attending the cached prefix), then enters
  a slot through the server's prefilled placement. Greedy outputs equal
  the cold path's; sampled serving never warm-starts.
- Budget: entries are ref-counted (an entry pinned by an adopter is
  never evicted) under a host-bytes budget with LRU eviction; an entry
  whose tokens are a strict prefix of a newly inserted one is dropped
  at once.

Host slabs are CPU torch tensors (numpy has no bfloat16), pinned when
they come from a CUDA cache: `capture_slot_rows` copies a slot's rows
out on the device before the slot can be reused, and `offer` moves
them to the host once per retiring request, never per decode step.
With no cache attached (`LMServer.kv_cache is None`, the default) the
serve path does none of this.

Slab leaf layout (the `LMServer.submit_prefilled` contract), batch axis
stripped: values [KV, T, D], kv_quant scales [KV, 1, T].

Metrics, under the JAX package's names: `lm_kv_cache_*` hit, miss,
eviction and saved-token counters, resident-bytes and entry gauges.
"""

from __future__ import annotations

import logging
import threading
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..observability import METRICS

log = logging.getLogger(__name__)

_M_HITS = METRICS.counter("lm_kv_cache_hits_total",
                          "prefix-cache warm starts (requests adopted from a cached slab)")
_M_MISSES = METRICS.counter("lm_kv_cache_misses_total",
                            "prefix-cache lookups with no usable cached prefix")
_M_EVICT = METRICS.counter("lm_kv_cache_evictions_total",
                           "prefix-cache entries evicted (budget LRU + dominated prefixes)")
_M_SAVED = METRICS.counter("lm_kv_cache_tokens_saved_total",
                           "prompt tokens NOT re-prefilled thanks to warm starts")
_M_BYTES = METRICS.gauge("lm_kv_cache_bytes", "resident host bytes across prefix caches")
_M_ENTRIES = METRICS.gauge("lm_kv_cache_entries", "live prefix-cache entries across caches")

# process-wide totals behind the gauges: several caches may live in one
# process, and a per-instance set() would make them fight over a gauge
_TOTALS_LOCK = threading.Lock()
_TOTAL_BYTES = 0
_TOTAL_ENTRIES = 0


def _totals_add(d_bytes: int, d_entries: int) -> None:
    global _TOTAL_BYTES, _TOTAL_ENTRIES
    with _TOTALS_LOCK:
        _TOTAL_BYTES += d_bytes
        _TOTAL_ENTRIES += d_entries
        _M_BYTES.set(_TOTAL_BYTES)
        _M_ENTRIES.set(_TOTAL_ENTRIES)


def _t_axis(key: str) -> int:
    """The position axis of a slab leaf: scales carry it on axis 2."""
    return 2 if key.endswith("_s") else 1


def _host(a) -> torch.Tensor:
    """A slab leaf as a CPU tensor: a device tensor is copied into
    pinned memory (a blocking copy), a CPU tensor kept, numpy wrapped."""
    if isinstance(a, torch.Tensor):
        if a.device.type == "cpu":
            return a.detach()
        out = torch.empty(a.shape, dtype=a.dtype, pin_memory=True)
        return out.copy_(a)
    return torch.from_numpy(np.ascontiguousarray(a))


def rows_nbytes(rows: Dict[str, Dict[str, torch.Tensor]]) -> int:
    return sum(int(a.numel() * a.element_size()) for kv in rows.values() for a in kv.values())


def slice_rows(rows: Dict[str, Dict[str, torch.Tensor]], n: int) -> Dict[str, Dict[str, torch.Tensor]]:
    """The first `n` positions of a slab tree (views)."""
    return {name: {key: a.narrow(_t_axis(key), 0, n) for key, a in kv.items()}
            for name, kv in rows.items()}


def concat_rows(prefix: Dict[str, Dict[str, torch.Tensor]],
                suffix: Dict[str, Dict[str, torch.Tensor]]) -> Dict[str, Dict[str, torch.Tensor]]:
    """Prefix slab ++ suffix slab along the position axis (a copy)."""
    return {name: {key: torch.cat([a, suffix[name][key]], dim=_t_axis(key))
                   for key, a in kv.items()}
            for name, kv in prefix.items()}


def capture_slot_rows(cache: Dict[str, Any], slot: int, n: int) -> Dict[str, Dict[str, torch.Tensor]]:
    """One slot's first `n` cache positions in slab layout (values [KV,
    n, D], kv_quant scales [KV, 1, n]), copied on the cache's device:
    the cache is updated in place, so a view would change under the next
    occupant of the slot."""
    return {name: {key: arr[slot].narrow(_t_axis(key), 0, n).clone(
                       memory_format=torch.contiguous_format)
                   for key, arr in kv.items()}
            for name, kv in cache.items()}


class _TrieNode:
    __slots__ = ("children", "owners", "terminals")

    def __init__(self):
        self.children: Dict[int, "_TrieNode"] = {}
        self.owners: set = set()      # every entry passing through
        self.terminals: set = set()   # entries ending exactly here


class _Entry:
    __slots__ = ("eid", "tokens", "rows", "nbytes", "refs")

    def __init__(self, eid: int, tokens: np.ndarray, rows: Dict[str, Dict[str, torch.Tensor]],
                 nbytes: int):
        self.eid = eid
        self.tokens = tokens  # token ids at positions [0, len(rows' T))
        self.rows = rows
        self.nbytes = nbytes
        self.refs = 0


class Lease:
    """A pinned match: the entry cannot be evicted while the adopter
    holds the lease. `m` is the usable prefix length for the prompt the
    lease was taken for (always < len(prompt): one suffix token remains
    to give the next-token logits)."""

    def __init__(self, cache: "KVPrefixCache", entry: _Entry, m: int):
        self._cache = cache
        self._entry = entry
        self.m = int(m)
        self._released = False

    def prefix_rows(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """The entry's first `m` positions (host views into the cached
        slab, valid while the lease is held; `concat_rows` copies)."""
        return slice_rows(self._entry.rows, self.m)

    def release(self) -> None:
        if self._released:
            return
        self._released = True
        self._cache._unpin(self._entry)


class KVPrefixCache:
    """Token-prefix-keyed cache of retired requests' KV slabs.

    Thread-safe: one lock guards the trie, the LRU order and the byte
    budget. `min_match` is the shortest cached prefix worth a warm
    start."""

    def __init__(self, max_bytes: int, min_match: int = 1):
        if max_bytes <= 0:
            raise ValueError("max_bytes must be positive")
        self.max_bytes = int(max_bytes)
        self.min_match = max(1, int(min_match))
        self._closed = False
        self._lock = threading.Lock()
        self._root = _TrieNode()
        #: eid -> entry in LRU order (oldest first)
        self._entries: "OrderedDict[int, _Entry]" = OrderedDict()
        self._next_id = 0
        self.bytes = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.tokens_saved = 0
        self.inserts = 0

    # ---- write side ---------------------------------------------------

    def offer(self, tokens: np.ndarray, rows: Dict[str, Dict[str, Any]]) -> bool:
        """Keep a retired request's slab: `tokens[i]` is the token at
        position i, `rows` the per-layer KV for exactly those positions
        (device or host tensors, or numpy; moved to the host here).
        Returns False when the slab was not kept (already covered,
        bigger than the whole budget, or every evictable entry pinned)."""
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        n = int(tokens.size)
        if n < 1:
            return False
        host = {name: {k: _host(a) for k, a in kv.items()} for name, kv in rows.items()}
        nbytes = rows_nbytes(host)
        with self._lock:
            if self._closed:
                return False  # a retire racing close() must not resurrect bytes
            covered, _ = self._walk(tokens)
            if covered >= n:
                return False
            if nbytes > self.max_bytes:
                return False
            if not self._make_room(nbytes):
                return False
            self._next_id += 1
            e = _Entry(self._next_id, tokens, host, nbytes)
            node = self._root
            for d in range(n):
                node = node.children.setdefault(int(tokens[d]), _TrieNode())
                node.owners.add(e.eid)
                # an entry ending strictly inside the new path is
                # dominated: drop it now unless an adopter pins it
                if d + 1 < n and node.terminals:
                    for teid in list(node.terminals):
                        te = self._entries.get(teid)
                        if te is not None and te.refs == 0:
                            self._evict(te)
            node.terminals.add(e.eid)
            self._entries[e.eid] = e
            self.bytes += nbytes
            self.inserts += 1
            _totals_add(nbytes, 1)
            return True

    def _make_room(self, need: int) -> bool:
        while self.bytes + need > self.max_bytes:
            victim = next((e for e in self._entries.values() if e.refs == 0), None)
            if victim is None:
                return False
            self._evict(victim)
        return True

    def _evict(self, e: _Entry) -> None:
        node = self._root
        stack: List[Tuple[_TrieNode, int]] = []
        for t in e.tokens:
            child = node.children.get(int(t))
            if child is None:
                break
            stack.append((node, int(t)))
            child.owners.discard(e.eid)
            child.terminals.discard(e.eid)
            node = child
        for parent, tok in reversed(stack):
            child = parent.children[tok]
            if child.owners or child.children:
                break
            del parent.children[tok]
        self._entries.pop(e.eid, None)
        self.bytes -= e.nbytes
        self.evictions += 1
        _M_EVICT.inc()
        _totals_add(-e.nbytes, -1)

    # ---- read side ----------------------------------------------------

    def _walk(self, prompt: np.ndarray) -> Tuple[int, Optional[int]]:
        """Deepest trie depth along `prompt` with a live owner, and the
        newest owning entry id there (None when nothing matches)."""
        node = self._root
        best_d, best_eid = 0, None
        for d in range(int(prompt.size)):
            node = node.children.get(int(prompt[d]))
            if node is None:
                break
            if node.owners:
                best_d, best_eid = d + 1, max(node.owners)
        return best_d, best_eid

    def _usable(self, prompt: np.ndarray) -> Tuple[int, Optional[int]]:
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        d, eid = self._walk(prompt)
        m = min(d, int(prompt.size) - 1)
        if m < self.min_match or eid is None:
            return 0, None
        return m, eid

    def match_len(self, prompt: np.ndarray) -> int:
        """The usable cached-prefix length for `prompt` (0 = miss): a
        peek, with no pin and no hit/miss accounting."""
        with self._lock:
            m, eid = self._usable(prompt)
            return m if eid is not None else 0

    def acquire(self, prompt: np.ndarray) -> Optional[Lease]:
        """Pin the longest usable cached prefix of `prompt`; counts a
        miss (and returns None) when nothing usable is cached. The
        caller must release the lease (try/finally)."""
        with self._lock:
            m, eid = self._usable(prompt)
            if eid is None:
                self.misses += 1
                _M_MISSES.inc()
                return None
            e = self._entries[eid]
            e.refs += 1
            self._entries.move_to_end(eid)  # LRU touch
            return Lease(self, e, m)

    def _unpin(self, e: _Entry) -> None:
        with self._lock:
            e.refs = max(0, e.refs - 1)
            # a close() that skipped this pinned entry finishes here
            if self._closed and e.refs == 0 and e.eid in self._entries:
                self._evict(e)

    def note_adopted(self, saved_tokens: int) -> None:
        """A warm start was placed: count the hit and the prompt tokens
        whose prefill it skipped."""
        with self._lock:
            self.hits += 1
            self.tokens_saved += int(saved_tokens)
        _M_HITS.inc()
        _M_SAVED.inc(int(saved_tokens))

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "entries": len(self._entries),
                "bytes": self.bytes,
                "max_bytes": self.max_bytes,
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "tokens_saved": self.tokens_saved,
                "inserts": self.inserts,
            }

    def close(self) -> None:
        """Drop every unpinned entry and refuse new inserts; pinned
        entries drop at their lease's release."""
        with self._lock:
            self._closed = True
            for e in list(self._entries.values()):
                if e.refs == 0:
                    self._evict(e)


# ----------------------------------------------------------------------
# suffix-only prefill: one forward over the new tokens, attending over
# the cached prefix KV and causally within the suffix
# ----------------------------------------------------------------------


class SuffixPrefiller:
    """Suffix prefill over a cached prefix.

    KV at position i depends only on tokens <= i, so attending the
    suffix's queries over the cached prefix rows plus the suffix's own
    causal keys computes what a full prefill of the whole prompt does;
    the first token is the argmax at the last prompt position.
    Attention is float32 einsum over the (dequantized, under kv_quant)
    prefix, as in the JAX package (`kv_cache.py:482-556`): no kernel.
    Eager torch needs no shape buckets, so neither side is padded (JAX
    pads both to powers of two behind validity masks)."""

    def __init__(self, cfg, max_len: int):
        self.cfg = cfg
        self.max_len = int(max_len)

    @torch.no_grad()
    def __call__(self, params: Any, prefix_rows: Dict[str, Dict[str, Any]], m: int,
                 suffix: np.ndarray) -> Tuple[int, Dict[str, Dict[str, torch.Tensor]]]:
        """(first_token, suffix slab for positions [m, m + len(suffix)))
        on the host. The slab concatenates onto the prefix slab to form
        the whole `submit_prefilled` payload."""
        from .generate import _device_of

        suffix = np.asarray(suffix, np.int32).reshape(-1)
        if suffix.size < 1:
            raise ValueError("empty suffix")
        if m + suffix.size > self.max_len:
            raise ValueError(f"prefix {m} + suffix {suffix.size} exceeds max_len {self.max_len}")
        dev = _device_of(params)
        prefix = {name: {k: torch.as_tensor(a).to(dev) for k, a in kv.items()}
                  for name, kv in prefix_rows.items()}
        first, rows = suffix_prefill(params, self.cfg, prefix, m,
                                     torch.from_numpy(suffix).to(dev))
        return int(first), {name: {k: _host(a) for k, a in kv.items()} for name, kv in rows.items()}


def suffix_prefill(params, cfg, prefix, plen: int, suffix_tok: torch.Tensor):
    """Suffix tokens [Ts] at positions plen + arange(Ts) over a prefix
    slab of `plen` positions (on the params' device). Returns (argmax
    token at the last suffix position, a 0-d int32 tensor; the suffix
    positions' slab in cache leaf layout)."""
    from ..models.transformer import rope_tables
    from .generate import _apply_block, _head, _kv_dequant, _kv_quantize

    ts = int(suffix_tok.shape[0])
    hd = cfg.head_dim
    grp = cfg.n_heads // cfg.kv_heads
    dev = suffix_tok.device
    x = params["embed"]["embedding"][suffix_tok.long()].to(cfg.dtype)[None]
    tables = rope_tables(plen + torch.arange(ts, device=dev), hd)
    causal = torch.arange(ts, device=dev)[:, None] >= torch.arange(ts, device=dev)[None, :]
    out_rows: Dict[str, Dict[str, torch.Tensor]] = {}
    for i in range(cfg.n_layers):
        name = f"block_{i}"
        pfx = prefix[name]
        if cfg.kv_quant:
            pk = _kv_dequant(pfx["k_q"], pfx["k_s"].transpose(1, 2))
            pv = _kv_dequant(pfx["v_q"], pfx["v_s"].transpose(1, 2))
        else:
            pk, pv = pfx["k"].to(torch.float32), pfx["v"].to(torch.float32)

        def attn_fn(q, k, v, pk=pk, pv=pv):
            # q [1, Ts, H, hd]; k/v [1, Ts, KV, hd]: float32 attention over
            # the prefix ++ the causal suffix
            qg = q.to(torch.float32).reshape(1, ts, cfg.kv_heads, grp, hd) * (hd ** -0.5)
            sp = torch.einsum("btkgd,kpd->bkgtp", qg, pk)
            ss = torch.einsum("btkgd,bskd->bkgts", qg, k.to(torch.float32))
            ss = torch.where(causal, ss, torch.full_like(ss, -1e30))
            p = torch.softmax(torch.cat([sp, ss], dim=-1), dim=-1)
            pc = pk.shape[1]
            ctx = torch.einsum("bkgtp,kpd->btkgd", p[..., :pc], pv)
            ctx = ctx + torch.einsum("bkgts,bskd->btkgd", p[..., pc:], v.to(torch.float32))
            return ctx.reshape(1, ts, cfg.n_heads, hd)

        x, k, v = _apply_block(params[name], cfg, x, tables, attn_fn)
        kh, vh = k.transpose(1, 2)[0], v.transpose(1, 2)[0]  # [KV, Ts, hd]: cache layout
        if cfg.kv_quant:
            kq, ks = _kv_quantize(kh)
            vq, vs = _kv_quantize(vh)
            out_rows[name] = {"k_q": kq, "k_s": ks.transpose(1, 2).contiguous(),
                              "v_q": vq, "v_s": vs.transpose(1, 2).contiguous()}
        else:
            out_rows[name] = {"k": kh.to(cfg.dtype).contiguous(), "v": vh.to(cfg.dtype).contiguous()}
    logits = _head(params, cfg, x[:, ts - 1:ts])  # [1, V]
    return logits.argmax(dim=-1).to(torch.int32)[0], out_rows


class WarmStart:
    """The LMServer's warm-placement half: cache plus suffix prefiller.
    `rows_for` turns a queued prompt into a whole `submit_prefilled`
    payload, or None on a miss (the caller falls back to the cold group
    prefill)."""

    def __init__(self, cache: KVPrefixCache, cfg, max_len: int):
        self.cache = cache
        self.prefiller = SuffixPrefiller(cfg, max_len)

    def rows_for(self, params: Any, prompt: np.ndarray
                 ) -> Optional[Tuple[Dict[str, Dict[str, torch.Tensor]], int, int]]:
        """(rows for positions < len(prompt), first_token, saved_tokens)
        or None. Any failure demotes to the cold path: a stale or
        undersized cached slab must never fail the request."""
        lease = self.cache.acquire(prompt)
        if lease is None:
            return None
        try:
            m = lease.m
            first, suffix_rows = self.prefiller(params, lease.prefix_rows(), m,
                                                np.asarray(prompt, np.int32).reshape(-1)[m:])
            rows = concat_rows(lease.prefix_rows(), suffix_rows)
        except Exception as e:
            log.warning("kv-cache warm start failed (%r); cold prefill", e)
            return None
        finally:
            lease.release()
        return rows, first, m

"""End-to-end distributed request tracing: spans, context propagation,
per-node flight recorder, cluster collection, tail attribution.

The metrics registry (observability.py) answers "how is the cluster
doing" in aggregate — exactly the coordinator console the reference
paper ships. What it cannot answer is "where did THIS request's time
go": a p99 outlier or a deadline miss crosses the front door, the
coordinator's batch former, the scheduler, a worker's fetch/infer/put
pipeline, and (for disaggregated LM serving) a prefill peer and a KV
handoff — four or more processes, none of which holds the whole story.
This module is the per-request causality layer:

- **Span** — one named, wall-clocked interval on one node, belonging
  to a trace (``trace_id``) under a parent span. Span NAMES are a
  closed registry (``SPAN_NAMES``): the stage names the attribution
  table reports are the same constants the instrumentation emits, and
  tools/dmllint.py (rule ``drift-span-names``) fails the build when a
  ``start_span("...")`` call site uses a name this registry doesn't
  declare — stage names cannot silently drift.
- **TraceContext** — the (trace_id, parent span, sampled) triple that
  rides the wire next to ``slo_class``: REQUEST_SUBMIT mints it at
  admission (seeded head-sampling decision), the formed batch carries
  one context per request through ``ingress_submit`` → scheduler →
  WORKER_TASK_REQUEST → LM_PREFILL_REQUEST → back out via
  REQUEST_DONE, so one trace stitches the full cross-node span tree.
- **Flight recorder** (``Tracer``) — a bounded ring buffer of finished
  spans per process, plus ALWAYS-ON capture (regardless of the head
  sampling decision) of the slowest-K request roots and of every span
  carrying a tail-exemplar event (``deadline_miss`` / ``shed`` /
  ``requeue`` / ``fallback``): the exemplars that explain the tail are
  never sampled away.
- **TRACE_PULL** (cluster/node.py) — leader aggregation of every
  node's recorder with the same tier-by-tier datagram degradation as
  METRICS_PULL; ``assemble_traces`` stitches the pulled spans into
  per-trace trees and ``chrome_trace`` exports them for
  ``chrome://tracing`` / Perfetto. CLI: ``trace [dump|pull|chrome]``.
- **Attribution** — ``stage_breakdown`` folds one trace's spans into
  per-stage seconds; ``ingress/loadgen.summarize`` joins completions
  against these to report where the p99 cohort's time went
  (queue-wait vs formation vs dispatch vs prefill vs handoff vs
  decode vs result-return), and the ``request_serving`` bench section
  embeds the result as its ``tracing`` block.

Overhead discipline: every recorder update is a host-side O(1) dict /
deque operation outside any device step (same contract as the
metrics registry), sampling is decided ONCE at admission, and an
unsampled request's spans are recorded only if they end up tail
exemplars — the bench measures a sampling=0 rerun against the traced
run and records both.

In-process simulations run many nodes in ONE process sharing this
module-global ``TRACER`` (like ``observability.METRICS``); spans carry
the recording node's name and collection dedupes by span id, so the
sim's cluster trace equals the shared recorder instead of multiplying
by the node count.
"""

from __future__ import annotations

import contextvars
import hashlib
import itertools
import secrets
import threading
import time
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

from .observability import METRICS

# ----------------------------------------------------------------------
# span-name registry (lint-enforced: dmllint rule drift-span-names)
# ----------------------------------------------------------------------

#: the root span of a request's trace: admission -> terminal
SPAN_ROOT = "request"

#: Every name ``start_span(...)`` may emit, and therefore every stage
#: the attribution table can report. tools/dmllint.py cross-checks all
#: ``start_span("<literal>", ...)`` call sites in the tree against
#: this tuple — add the name HERE first, or the build fails. Keep the
#: comment on each line: it is the one place the stage vocabulary is
#: documented.
# plain assignment (no annotation): dmllint's _module_const_strs reads
# top-level Assign nodes, and this tuple IS its machine contract
SPAN_NAMES = (
    "request",     # root: admission -> terminal on the router
    "admission",   # REQUEST_SUBMIT handling (sampling, SLO, shed check)
    "formation",   # admission -> batch dispatch (the queue wait)
    "dispatch",    # ingress_submit -> WORKER_TASK_REQUEST send
    "fetch",       # worker: store replica fetch + host decode
    "infer",       # worker: backend infer call (device forward)
    "prefill",     # prefill-role member: chunked prompt prefill
    "handoff",     # decode primary: prefill RPC + KV slab pull
    "decode",      # decode side of a disaggregated LM batch
    "put",         # worker: output write + replicated store PUT
    "store_put",   # replicated store PUT under a request's trace
    "store_get",   # replicated store GET under a request's trace
    "result",      # job completion -> REQUEST_DONE push
    "marker",      # zero-duration exemplar marker (note_exemplar)
)

#: span events that force always-on exemplar capture: any span ending
#: with one of these pins its whole trace in the recorder regardless
#: of the head sampling decision — these are the requests that explain
#: the tail, and a tail you sampled away cannot be attributed
EXEMPLAR_EVENTS: Tuple[str, ...] = (
    "deadline_miss", "shed", "requeue", "fallback",
)

_M_SPANS = METRICS.counter(
    "tracing_spans_total",
    "finished spans observed by the flight recorder, by sampled=")
_M_DROPPED = METRICS.counter(
    "tracing_spans_dropped_total",
    "sampled spans evicted from the flight-recorder ring")
_M_EXEMPLARS = METRICS.counter(
    "tracing_exemplars_total",
    "tail-exemplar span captures, by kind= (deadline_miss|shed|...)")


# ----------------------------------------------------------------------
# context + span
# ----------------------------------------------------------------------


@dataclass(frozen=True)
class TraceContext:
    """What propagates across a hop: which trace, under which parent
    span, and whether the head decision sampled it. The wire form is
    a three-key dict (``t``/``p``/``s``) small enough to ride every
    batch and prefill frame next to ``slo_class``; ``key`` optionally
    binds the context to its request's input file (``f``) so batch-
    level code can route per-request contexts without a side table."""

    trace_id: str
    span_id: str = ""
    sampled: bool = True
    key: str = ""

    def to_wire(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {"t": self.trace_id, "p": self.span_id,
                             "s": 1 if self.sampled else 0}
        if self.key:
            d["f"] = self.key
        return d

    @staticmethod
    def from_wire(d: Any) -> Optional["TraceContext"]:
        """Tolerant decode: byzantine/garbled context degrades to 'no
        trace', never to a handler exception."""
        if not isinstance(d, dict) or not isinstance(d.get("t"), str):
            return None
        return TraceContext(
            trace_id=d["t"],
            span_id=str(d.get("p", "")),
            sampled=bool(d.get("s", 1)),
            key=str(d.get("f", "")),
        )


class Span:
    """One live span; finished (and recorded) exactly once via
    ``end()`` or the context-manager exit."""

    __slots__ = (
        "trace_id", "span_id", "parent_id", "name", "node", "sampled",
        "t0", "t1", "labels", "events", "_tracer",
    )

    def __init__(
        self, tracer: "Tracer", name: str, trace_id: str,
        parent_id: str, node: str, sampled: bool,
        t0: Optional[float] = None,
        labels: Optional[Dict[str, Any]] = None,
        span_id: Optional[str] = None,
    ):
        self._tracer = tracer
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id or tracer._new_span_id()
        self.parent_id = parent_id
        self.node = node
        self.sampled = sampled
        self.t0 = time.time() if t0 is None else float(t0)
        self.t1: Optional[float] = None
        self.labels = dict(labels) if labels else {}
        self.events: List[List[Any]] = []

    def ctx(self) -> TraceContext:
        """Context for children of THIS span."""
        return TraceContext(self.trace_id, self.span_id, self.sampled)

    def event(self, name: str, ts: Optional[float] = None) -> None:
        self.events.append([name, round(time.time() if ts is None
                                        else ts, 6)])

    def label(self, **labels: Any) -> None:
        self.labels.update(labels)

    def end(self, t1: Optional[float] = None) -> None:
        if self.t1 is not None:
            return  # idempotent: error paths may double-close
        self.t1 = time.time() if t1 is None else float(t1)
        self._tracer._record(self)

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, *exc) -> None:
        self.end()

    @property
    def duration(self) -> float:
        return (self.t1 or time.time()) - self.t0

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {
            "tid": self.trace_id, "sid": self.span_id,
            "par": self.parent_id, "name": self.name, "node": self.node,
            "t0": round(self.t0, 6),
            "t1": round(self.t1 if self.t1 is not None else self.t0, 6),
        }
        if self.labels:
            d["lb"] = {k: v for k, v in self.labels.items()}
        if self.events:
            d["ev"] = [list(e) for e in self.events]
        return d


#: batch-scoped contexts for code that cannot thread them through its
#: call signature (store put/get under a worker's fetch, the LM group
#: backends' prefill/handoff/decode internals): the service sets this
#: around a batch's backend call; asyncio tasks and to_thread hops
#: inherit it via contextvars copy semantics
CURRENT_CTXS: "contextvars.ContextVar[Tuple[TraceContext, ...]]" = (
    contextvars.ContextVar("dml_tpu_torch_trace_ctxs", default=())
)


def current_ctxs() -> Tuple[TraceContext, ...]:
    """The batch's propagated trace contexts, sampled ones only (the
    common gate ordinary span-recording sites want)."""
    return tuple(c for c in CURRENT_CTXS.get() if c.sampled)


def current_all_ctxs() -> Tuple[TraceContext, ...]:
    """Every propagated context, sampled or not — for the ALWAYS-ON
    exemplar paths (a handoff fallback on an unsampled request must
    still be captured; that is the whole point of exemplars)."""
    return tuple(CURRENT_CTXS.get())


# ----------------------------------------------------------------------
# the flight recorder
# ----------------------------------------------------------------------


class Tracer:
    """Process-wide span recorder: seeded head sampling, a bounded
    ring of finished sampled spans, and always-on slowest-K + tail
    exemplar capture. Thread-safe (backends finish spans on decode
    threads)."""

    def __init__(
        self,
        sample_rate: float = 0.1,
        seed: int = 0,
        span_budget: int = 4096,
        slow_k: int = 32,
        exemplar_traces: int = 256,
    ):
        self._lock = threading.Lock()
        self._salt = secrets.token_hex(3)
        self._span_counter = itertools.count(1)
        self._trace_counter = itertools.count(1)
        self.configure(
            sample_rate=sample_rate, seed=seed, span_budget=span_budget,
            slow_k=slow_k, exemplar_traces=exemplar_traces,
        )

    def configure(
        self,
        sample_rate: Optional[float] = None,
        seed: Optional[int] = None,
        span_budget: Optional[int] = None,
        slow_k: Optional[int] = None,
        exemplar_traces: Optional[int] = None,
    ) -> None:
        """(Re)configure knobs; omitted arguments keep their value.
        Changing ``span_budget`` re-bounds the ring, carrying over the
        newest spans that still fit."""
        with self._lock:
            if sample_rate is not None:
                self.sample_rate = min(1.0, max(0.0, float(sample_rate)))
            if seed is not None:
                self.seed = int(seed)
            if span_budget is not None:
                self.span_budget = max(16, int(span_budget))
                old = list(getattr(self, "_ring", ()))
                self._ring: "deque[Dict[str, Any]]" = deque(
                    old[-self.span_budget:], maxlen=self.span_budget
                )
            if slow_k is not None:
                self.slow_k = max(1, int(slow_k))
                self._slow: List[Tuple[float, Dict[str, Any]]] = list(
                    getattr(self, "_slow", ())
                )[: self.slow_k]
            if exemplar_traces is not None:
                self.max_exemplar_traces = max(4, int(exemplar_traces))
                self._exemplars: "OrderedDict[str, List[Dict[str, Any]]]" \
                    = OrderedDict(getattr(self, "_exemplars", ()))
            if not hasattr(self, "dropped"):
                self.dropped = 0
                self.peak_spans = 0
                self.recorded = 0

    # -- identity + sampling ------------------------------------------

    def _new_span_id(self) -> str:
        return f"s{self._salt}{next(self._span_counter):x}"

    def new_trace_id(self) -> str:
        return f"t{self._salt}{next(self._trace_counter):x}"

    def head_sample(self, trace_id: str) -> bool:
        """Deterministic seeded head decision: the same (seed,
        trace_id) pair samples identically on every node and every
        run — the property the bench's replayed traces rely on."""
        if self.sample_rate >= 1.0:
            return True
        if self.sample_rate <= 0.0:
            return False
        h = hashlib.blake2b(
            f"{self.seed}:{trace_id}".encode(), digest_size=8
        ).digest()
        return int.from_bytes(h, "big") < self.sample_rate * 2.0 ** 64

    # -- span lifecycle -----------------------------------------------

    def start_span(
        self,
        name: str,
        ctx: Optional[TraceContext] = None,
        *,
        trace_id: Optional[str] = None,
        parent_id: str = "",
        node: str = "",
        sampled: Optional[bool] = None,
        t0: Optional[float] = None,
        labels: Optional[Dict[str, Any]] = None,
        span_id: Optional[str] = None,
    ) -> Span:
        """Open a span. ``ctx`` supplies trace/parent/sampled in one
        argument (the propagated-hop form); the keyword triple is the
        root-creation form. ``span_id`` pins the id explicitly — the
        promoted router reconstructs an adopted request's ROOT under
        its relayed original id, so spans the dead leader recorded
        against it still resolve their parent (no orphans across a
        failover). Names MUST come from ``SPAN_NAMES`` — dmllint
        cross-checks every literal call site."""
        if ctx is not None:
            trace_id = ctx.trace_id
            parent_id = ctx.span_id
            if sampled is None:
                sampled = ctx.sampled
        if trace_id is None:
            trace_id = self.new_trace_id()
        return Span(
            self, name, trace_id, parent_id, node,
            self.head_sample(trace_id) if sampled is None else sampled,
            t0=t0, labels=labels, span_id=span_id,
        )

    def _record(self, span: Span) -> None:
        d = span.to_dict()
        exemplar_kinds = [
            e[0] for e in span.events if e[0] in EXEMPLAR_EVENTS
        ]
        with self._lock:
            self.recorded += 1
            _M_SPANS.inc(sampled="yes" if span.sampled else "no")
            if span.sampled:
                if len(self._ring) == self.span_budget:
                    self.dropped += 1
                    _M_DROPPED.inc()
                self._ring.append(d)
                self.peak_spans = max(self.peak_spans, len(self._ring))
            # always-on slowest-K request roots (head sampling must
            # not be able to hide the slowest requests in the fleet)
            if span.name == SPAN_ROOT:
                dur = d["t1"] - d["t0"]
                self._slow.append((dur, d))
                self._slow.sort(key=lambda x: -x[0])
                del self._slow[self.slow_k:]
            for kind in exemplar_kinds:
                _M_EXEMPLARS.inc(kind=kind)
            if exemplar_kinds:
                self._pin_trace_locked(span.trace_id, d)

    def _pin_trace_locked(self, trace_id: str, d: Dict[str, Any]) -> None:
        spans = self._exemplars.get(trace_id)
        if spans is None:
            spans = self._exemplars[trace_id] = []
            # retroactively pin what the ring already holds for this
            # trace: an exemplar's earlier spans must survive eviction
            spans.extend(
                s for s in self._ring if s["tid"] == trace_id
            )
            while len(self._exemplars) > self.max_exemplar_traces:
                self._exemplars.popitem(last=False)
        if all(s["sid"] != d["sid"] for s in spans):
            spans.append(d)

    def note_exemplar(self, ctx: Optional[TraceContext], kind: str,
                      node: str = "", labels: Optional[Dict[str, Any]]
                      = None) -> None:
        """Record a zero-duration exemplar marker for ``ctx``'s trace
        (kind must be in ``EXEMPLAR_EVENTS``): the requeue/shed call
        sites have no surrounding interval worth a timed span, but the
        trace must still be pinned and the event must still show in
        the tree."""
        if ctx is None:
            return
        t = time.time()
        s = Span(self, "marker", ctx.trace_id, ctx.span_id, node, True,
                 t0=t, labels=labels)
        s.event(kind, t)
        s.end(t)

    # -- collection ----------------------------------------------------

    def dump(
        self,
        trace_ids: Optional[Iterable[str]] = None,
        max_spans: Optional[int] = None,
        strip: bool = False,
    ) -> List[Dict[str, Any]]:
        """Finished spans this node holds: the ring, the slowest-K
        roots, and every pinned exemplar trace, deduped by span id,
        newest-last. ``trace_ids`` filters; ``max_spans`` keeps the
        NEWEST — except exemplar-trace spans, which survive the cut
        first (the recorder pinned them against ring eviction; a
        collection cap must not un-pin them, or a deadline miss early
        in a long run loses exactly the trace that explains it).
        ``strip`` drops labels/events (the datagram-degraded form)."""
        want = set(trace_ids) if trace_ids is not None else None
        with self._lock:
            rows = list(self._ring)
            rows.extend(d for _, d in self._slow)
            for spans in self._exemplars.values():
                rows.extend(spans)
            pinned_tids = set(self._exemplars)
        seen: set = set()
        out: List[Dict[str, Any]] = []
        for d in rows:
            if d["sid"] in seen:
                continue
            if want is not None and d["tid"] not in want:
                continue
            seen.add(d["sid"])
            out.append(d)
        out.sort(key=lambda d: (d["t0"], d["sid"]))
        if max_spans is not None and len(out) > max_spans:
            ex = [d for d in out if d["tid"] in pinned_tids]
            if len(ex) >= max_spans:
                out = ex[-max_spans:]
            else:
                rest = [d for d in out if d["tid"] not in pinned_tids]
                out = rest[-(max_spans - len(ex)):] + ex
                out.sort(key=lambda d: (d["t0"], d["sid"]))
        if strip:
            out = [
                {k: v for k, v in d.items() if k not in ("lb", "ev")}
                for d in out
            ]
        return out

    def exemplar_trace_ids(self, kind: Optional[str] = None) -> List[str]:
        """Pinned exemplar traces, oldest first. ``kind`` filters to
        traces holding at least one span with that event (the signal
        plane attaches the freshest ``deadline_miss`` exemplar to a
        deadline-burn alert, not merely a recent shed)."""
        with self._lock:
            if kind is None:
                return list(self._exemplars)
            return [
                tid for tid, spans in self._exemplars.items()
                if any(
                    e[0] == kind
                    for s in spans for e in s.get("ev", ())
                )
            ]

    def stats(self) -> Dict[str, Any]:
        """Flight-recorder accounting (the bench's budget verdict):
        the ring NEVER exceeds ``span_budget`` by construction;
        ``peak_spans`` records the high-water mark so the artifact can
        prove it."""
        with self._lock:
            return {
                "span_budget": self.span_budget,
                "spans": len(self._ring),
                "peak_spans": self.peak_spans,
                "dropped": self.dropped,
                "recorded": self.recorded,
                "slow_k": self.slow_k,
                "slow_held": len(self._slow),
                "exemplar_traces": len(self._exemplars),
                "sample_rate": self.sample_rate,
                "within_budget": self.peak_spans <= self.span_budget,
            }

    def reset(self) -> None:
        """Drop every recorded span + counters (tests/bench phases);
        configuration survives."""
        with self._lock:
            self._ring.clear()
            self._slow = []
            self._exemplars = OrderedDict()
            self.dropped = 0
            self.peak_spans = 0
            self.recorded = 0


#: the process-wide recorder every subsystem writes into
TRACER = Tracer()


# ----------------------------------------------------------------------
# assembly + attribution + export
# ----------------------------------------------------------------------


def merge_span_dumps(
    dumps: Sequence[Sequence[Dict[str, Any]]],
) -> List[Dict[str, Any]]:
    """Fold per-node dumps into one deduped span list (in-process sims
    share one recorder, so every node returns the same spans — span
    ids make the dedupe exact; real deployments dedupe nothing)."""
    seen: set = set()
    out: List[Dict[str, Any]] = []
    for dump in dumps:
        for d in dump:
            sid = d.get("sid")
            if not isinstance(sid, str) or sid in seen:
                continue
            seen.add(sid)
            out.append(d)
    out.sort(key=lambda d: (d.get("t0", 0.0), d.get("sid", "")))
    return out


def assemble_traces(
    spans: Sequence[Dict[str, Any]],
) -> Dict[str, List[Dict[str, Any]]]:
    """Group a span list by trace id, each trace's spans in start
    order (the stitched cross-node tree; parents sort before their
    children because a child starts after its parent)."""
    out: Dict[str, List[Dict[str, Any]]] = {}
    for d in spans:
        tid = d.get("tid")
        if isinstance(tid, str):
            out.setdefault(tid, []).append(d)
    for rows in out.values():
        rows.sort(key=lambda d: (d.get("t0", 0.0), d.get("sid", "")))
    return out


def trace_covers(spans: Sequence[Dict[str, Any]],
                 stages: Sequence[str]) -> bool:
    """Whether one trace's spans include every named stage (the
    acceptance contract for the stitched disaggregated-path trace)."""
    have = {d.get("name") for d in spans}
    return all(s in have for s in stages)


def stage_breakdown(spans: Sequence[Dict[str, Any]]) -> Dict[str, float]:
    """Per-stage seconds for ONE trace: wall duration summed by span
    name, root span excluded (it IS the e2e). Batch-shared spans (a
    worker's fetch covers every request in the batch) count their full
    duration — the request waited that long regardless of who shared
    the ride — and nested detail spans (store_put under fetch) are
    reported under their own name, so stages are not disjoint by
    construction; the attribution table reads the top-level stage
    names."""
    out: Dict[str, float] = {}
    for d in spans:
        name = d.get("name")
        if name == SPAN_ROOT or not isinstance(name, str):
            continue
        dur = max(0.0, float(d.get("t1", 0.0)) - float(d.get("t0", 0.0)))
        out[name] = out.get(name, 0.0) + dur
    return out


def trace_e2e(spans: Sequence[Dict[str, Any]]) -> Optional[float]:
    """Root-span duration of one trace, if the root was recorded."""
    for d in spans:
        if d.get("name") == SPAN_ROOT:
            return max(0.0, float(d.get("t1", 0.0)) - float(d.get("t0", 0.0)))
    return None


def chrome_trace(spans: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    """Chrome ``chrome://tracing`` / Perfetto JSON: one complete
    ('X') event per span — pid = recording node, tid = trace — plus an
    instant ('i') event per span event. Times in microseconds as the
    format demands."""
    nodes = sorted({str(d.get("node", "")) for d in spans})
    pid_of = {n: i + 1 for i, n in enumerate(nodes)}
    tids = sorted({str(d.get("tid", "")) for d in spans})
    tid_of = {t: i + 1 for i, t in enumerate(tids)}
    events: List[Dict[str, Any]] = []
    for n, pid in pid_of.items():
        events.append({
            "ph": "M", "pid": pid, "name": "process_name",
            "args": {"name": n or "?"},
        })
    for d in spans:
        pid = pid_of[str(d.get("node", ""))]
        tid = tid_of[str(d.get("tid", ""))]
        t0 = float(d.get("t0", 0.0))
        t1 = float(d.get("t1", t0))
        args: Dict[str, Any] = {
            "trace_id": d.get("tid"), "span_id": d.get("sid"),
            "parent": d.get("par"),
        }
        args.update(d.get("lb") or {})
        events.append({
            "ph": "X", "name": str(d.get("name", "?")), "cat": "dml",
            "pid": pid, "tid": tid,
            "ts": round(t0 * 1e6, 1),
            "dur": round(max(0.0, t1 - t0) * 1e6, 1),
            "args": args,
        })
        for ev in d.get("ev") or ():
            try:
                ev_name, ev_ts = str(ev[0]), float(ev[1])
            except (TypeError, ValueError, IndexError):
                continue
            events.append({
                "ph": "i", "name": ev_name, "cat": "dml", "s": "t",
                "pid": pid, "tid": tid, "ts": round(ev_ts * 1e6, 1),
            })
    events.sort(key=lambda e: e.get("ts", 0.0))
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def cohort_attribution(
    breakdowns: Sequence[Dict[str, float]],
    e2es: Sequence[float],
) -> Dict[str, Any]:
    """Mean per-stage seconds over a cohort of traces (the p99 cohort
    in the bench), plus how much of the cohort's mean e2e the named
    stages explain (``attributed_fraction`` — the >= 0.9 claim gate).
    Overlapping stages (store detail under fetch; pipelined decode
    under handoff) are EXCLUDED from the coverage sum via their known
    parents, so the fraction cannot exceed honesty by double
    counting."""
    if not breakdowns or not e2es:
        return {"n": 0}
    stages: Dict[str, float] = {}
    for b in breakdowns:
        for k, v in b.items():
            stages[k] = stages.get(k, 0.0) + v
    n = len(breakdowns)
    mean_stages = {k: v / n for k, v in sorted(stages.items())}
    mean_e2e = sum(e2es) / len(e2es)
    # top-level stages only: detail spans nest under (or run
    # concurrently with) these and would double-count the same wall
    # time — admission sits inside formation, store_* inside
    # fetch/put, and the disagg prefill/handoff/decode trio runs
    # INSIDE the primary's infer span (that is the point of the
    # disaggregation: it all overlaps the batch's device window)
    detail = {"store_put", "store_get", "admission", "decode",
              "prefill", "handoff", "marker"}
    covered = sum(v for k, v in mean_stages.items() if k not in detail)
    return {
        "n": n,
        "mean_e2e_ms": round(mean_e2e * 1e3, 2),
        "stage_ms": {k: round(v * 1e3, 2) for k, v in mean_stages.items()},
        "attributed_ms": round(covered * 1e3, 2),
        "attributed_fraction": (
            round(covered / mean_e2e, 4) if mean_e2e > 0 else None
        ),
    }

"""SLO-aware request front door: per-request ingress for the cluster.

Everything before this entered the cluster as an operator-submitted
batch job (``submit-job <model> <N>`` through the CLI). The north
star is per-request traffic — millions of users each sending ONE
image or ONE prompt with a latency expectation — which is a different
regime: requests arrive open-loop, deadlines differ by class, and the
batch shape the device wants has to be FORMED from whatever is queued
rather than handed down by an operator.

``RequestRouter`` sits in front of JobService on the leader (every
node constructs one; the router role activates with leadership, the
client verbs work anywhere — the same role pattern as JobService):

- **admission** (ingress/slo.py): each request carries an SLO class;
  a request the cluster already knows it cannot serve inside its
  deadline — or whose class queue is at its backpressure limit — is
  SHED with an immediate typed rejection, never a timeout.
- **continuous batch formation**: admitted requests pool in forming
  batches keyed (model, class, session-affinity target). A batch
  dispatches into the ordinary job pipeline when it FILLS, when the
  pipeline is HUNGRY (free slot + empty queue — light load serves at
  single-request latency after a tiny coalescing linger), or when its
  oldest request's deadline-derived slack EXPIRES. One mechanism
  spans the load range: light load gets low latency, heavy load gets
  full device batches. ``formation="fixed"`` pins the naive
  fill-only baseline the bench compares against.
- **dispatch rides the existing pipeline**: a formed batch becomes a
  one-batch job (JobService.ingress_submit) and inherits everything
  the job path already guarantees — fair-share scheduling against
  operator jobs, standby relays, exactly-once completion dedup,
  requeue on worker death, failover.
- **session affinity**: multi-turn LM requests carrying a session id
  are routed toward the worker that served the session's previous
  turn (the node holding its KV state); best-effort — a dead or busy
  node never strands a request.
- **token streaming**: streaming LM requests get their tokens over
  the worker's TCP data plane as they decode (ingress/streaming.py).
- **terminal exactly once**: every admitted request ends in exactly
  one of {completed, rejected(typed)} — pushed (REQUEST_DONE) and
  recoverable by poll (REQUEST_STATUS, the same dropped-push
  discipline as wait_job). After a leader failover, dispatched
  requests complete through the relayed ingress table; requests the
  dead leader never dispatched are answered "unknown" and the client
  converts that into a typed LOST rejection instead of hanging.
"""

from __future__ import annotations

import asyncio
import logging
import secrets
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..cluster.util import BoundedDict, leader_retry, reap_task
from ..cluster.wire import Message, MsgType
from ..observability import METRICS
from ..tracing import CURRENT_CTXS, TRACER, TraceContext
from .slo import DEFAULT_CLASSES, SLOClass, resolve_class, shed_reason

log = logging.getLogger(__name__)

# request_* metrics family (observability docstring map): the
# per-request analog of the jobs_* C1/C2 counters — admission and
# terminal counters per class, queue-wait and end-to-end latency
# histograms (the bench's p50/p95/p99 source), in-flight gauge, and
# batch-formation quality (fill fraction + formation wall).
_M_ADMITTED = METRICS.counter(
    "request_admitted_total", "requests admitted at the front door, per class")
_M_SHED = METRICS.counter(
    "request_shed_total",
    "requests shed at admission with a typed rejection, per class+reason")
_M_REJECTED = METRICS.counter(
    "request_rejected_total",
    "admitted requests terminally rejected (job failure etc.), per class")
_M_COMPLETED = METRICS.counter(
    "request_completed_total", "requests completed, per class")
_M_DEADLINE_MISS = METRICS.counter(
    "request_deadline_miss_total",
    "completions that landed past their SLO deadline, per class")
_M_QWAIT = METRICS.histogram(
    "request_queue_wait_seconds",
    "admission -> batch dispatch wait, per class")
_M_E2E = METRICS.histogram(
    "request_e2e_latency_seconds",
    "admission -> completion end-to-end latency, per class")
_M_INFLIGHT = METRICS.gauge(
    "request_in_flight", "admitted, not yet terminal, per class")
_M_FILL = METRICS.histogram(
    "request_batch_fill_fraction",
    "formed-batch fill at dispatch (1.0 = full device batch)")
_M_FORMATION = METRICS.histogram(
    "request_batch_formation_seconds",
    "first-enqueue -> dispatch wall per formed batch")
# session-affinity observability: the router's session map is a REAL
# locality signal once the worker-resident KV prefix cache exists
# (inference/kv_cache.py) — a routed-to-holder turn warm-starts, a
# miss re-prefills the whole history. Hits/misses make the signal's
# quality visible; the eviction counter makes `_session_node` bound
# pressure visible (a silently evicted session is a guaranteed cache
# miss on its next turn).
_M_AFF_HITS = METRICS.counter(
    "request_session_affinity_hits_total",
    "session requests routed to their previous turn's live worker")
_M_AFF_MISSES = METRICS.counter(
    "request_session_affinity_misses_total",
    "session requests with no live affinity target (first turn, dead "
    "or demoted holder, or an evicted session row)")
_M_AFF_EVICT = METRICS.counter(
    "request_session_affinity_evictions_total",
    "session->worker rows evicted, per reason= (bound pressure, or a "
    "purge when the holder leaves gracefully / fails)")


def _terminal_kind(terminal: Any) -> str:
    """Classify a settled terminal into its kind (``completed`` /
    ``shed`` / ``rejected`` / ``lost``). Accepts both the full terminal
    dict every settle path carries and the bare ``"lost"`` marker
    ``wait()`` plants when its caller times out unresolved."""
    if isinstance(terminal, str):
        return terminal
    kind = terminal.get("terminal")
    if kind:
        return str(kind)
    return "completed" if terminal.get("ok") else "rejected"


class RequestRejected(RuntimeError):
    """Typed front-door rejection. ``shed=True`` means admission
    control refused it (queue_full / deadline_unmeetable); False means
    a validation or execution failure."""

    def __init__(self, reason: str, slo: str = "", shed: bool = False):
        super().__init__(f"request rejected ({reason})")
        self.reason = reason
        self.slo = slo
        self.shed = shed


@dataclass
class PendingRequest:
    """One admitted request while it lives on the router."""

    id: str
    client: str          # unique_name to push terminals to
    model: str
    slo: SLOClass
    file: str            # store input name (payload's or sampled)
    payload: Optional[bytes]  # inline payload to PUT at dispatch
    session: Optional[str]
    stream: bool
    arrival: float       # monotonic admission time
    deadline: float      # arrival + slo.deadline_s
    #: wall-clock admission time (spans are wall-clocked so cross-node
    #: trees align) and the request's trace context (children of the
    #: root span parent here); ctx is None only for reconstructed
    #: requests whose relay predates tracing
    arrival_wall: float = 0.0
    ctx: Optional[TraceContext] = None


@dataclass
class FormingBatch:
    """Requests coalescing toward one dispatch."""

    model: str
    slo: SLOClass
    affinity: Optional[str]
    opened_at: float
    reqs: List[PendingRequest] = field(default_factory=list)


class BatchFormer:
    """Pure continuous-batch-formation state (deterministic under an
    injected clock; the router drives it from its tick loop).

    ``mode="continuous"`` dispatches a batch when any of:
      - it is FULL (``batch_size_of(model)`` requests),
      - the pipeline is HUNGRY for its model (caller-observed: a free
        slot and no queued batches) and the batch has lingered at
        least ``slo.linger_s * linger_scale`` (the light-load
        coalescing window; scale < 1 when backends adopt mid-flight),
      - its SLACK expired: the oldest request's deadline minus the
        batch's estimated exec (with 50% headroom + 50 ms dispatch
        margin) is now — waiting any longer manufactures SLO misses.

    ``mode="fixed"`` is the naive baseline: dispatch only when full
    (or when the oldest request's deadline has already passed — late,
    but bounded; this is exactly why fixed-size batching loses the
    light-load tail in the bench comparison)."""

    def __init__(
        self,
        batch_size_of: Callable[[str], int],
        est_exec_s: Callable[[str, int], float],
        mode: str = "continuous",
        now: Callable[[], float] = time.monotonic,
        linger_scale: float = 1.0,
    ):
        if mode not in ("continuous", "fixed"):
            raise ValueError(f"unknown formation mode {mode!r}")
        if not (0.0 <= float(linger_scale) <= 1.0):
            raise ValueError(
                f"linger_scale must be in [0, 1], got {linger_scale!r}"
            )
        self.batch_size_of = batch_size_of
        self.est_exec_s = est_exec_s
        self.mode = mode
        self.now = now
        #: scales every class's linger window at the hungry-dispatch
        #: check. The linger exists to amortize batch formation over
        #: co-batchable arrivals — worth real TTFT when the backend
        #: drains each batch before starting the next. When the
        #: serving backends adopt requests into RUNNING batches at
        #: step granularity (LMServer continuous batching), a late
        #: arrival merges into the in-flight grid anyway, so holding
        #: the door open buys nothing: routers fronting adopting
        #: backends shrink it (0 = dispatch the moment the pipeline
        #: is hungry).
        self.linger_scale = float(linger_scale)
        self.forming: Dict[Tuple[str, str, str], FormingBatch] = {}

    def add(self, req: PendingRequest, affinity: Optional[str]) -> None:
        key = (req.model, req.slo.name, affinity or "")
        fb = self.forming.get(key)
        if fb is None:
            fb = FormingBatch(
                model=req.model, slo=req.slo, affinity=affinity,
                opened_at=self.now(),
            )
            self.forming[key] = fb
        fb.reqs.append(req)

    def pending(self) -> int:
        return sum(len(fb.reqs) for fb in self.forming.values())

    def _dispatch_by(self, fb: FormingBatch) -> float:
        est = self.est_exec_s(fb.model, len(fb.reqs))
        oldest = min(r.deadline for r in fb.reqs)
        if self.mode == "fixed":
            return oldest  # the baseline waits for full until too late
        return oldest - 1.5 * est - 0.05

    def due(self, hungry_models: Optional[set] = None) -> List[FormingBatch]:
        """Pop and return every batch that should dispatch now."""
        t = self.now()
        hungry = hungry_models or set()
        out: List[FormingBatch] = []
        for key, fb in list(self.forming.items()):
            size = max(1, self.batch_size_of(fb.model))
            # FULL dispatches in device-batch-sized slices: a burst
            # landing within one tick must not pin a single job's
            # batch_size above the model's configured width (an
            # unconfigured shape — a fresh compile per odd burst size
            # on compiled-shape backends). FIFO order preserved; any
            # remainder keeps forming under the usual rules.
            while len(fb.reqs) >= size:
                out.append(FormingBatch(
                    model=fb.model, slo=fb.slo, affinity=fb.affinity,
                    opened_at=fb.opened_at, reqs=fb.reqs[:size],
                ))
                fb.reqs = fb.reqs[size:]
            if not fb.reqs:
                del self.forming[key]
                continue
            slack_out = t >= self._dispatch_by(fb)
            feed = (
                self.mode == "continuous"
                and fb.model in hungry
                and t - fb.opened_at >= fb.slo.linger_s * self.linger_scale
            )
            if slack_out or feed:
                del self.forming[key]
                out.append(fb)
        return out


@dataclass
class _RequestState:
    req: PendingRequest
    state: str = "forming"  # forming | dispatched
    job_id: Optional[int] = None
    #: the live root span (admission -> terminal); ended exactly once
    #: by whichever terminal path settles the request
    root: Optional[Any] = None
    #: wall clock of the batch dispatch (closes the formation stage in
    #: the terminal's per-stage breakdown)
    dispatched_wall: Optional[float] = None


class RequestRouter:
    """One per node (like JobService): router role while leader,
    client verbs anywhere."""

    def __init__(
        self,
        jobs,
        classes: Optional[Dict[str, SLOClass]] = None,
        formation: str = "continuous",
        tick_s: float = 0.02,
        linger_scale: float = 1.0,
    ):
        self.jobs = jobs
        self.node = jobs.node
        self.store = jobs.store
        self.classes = dict(classes or DEFAULT_CLASSES)
        self.tick_s = tick_s
        # linger_scale < 1 is the knob for deployments whose serving
        # backends adopt requests mid-flight (LM continuous batching,
        # {"overlap": true} specs): the coalescing window shrinks
        # because late arrivals merge into running batches at the
        # next step boundary instead of waiting out a drain
        self.former = BatchFormer(
            batch_size_of=self._batch_size_of,
            est_exec_s=self._est_exec_s,
            mode=formation,
            linger_scale=linger_scale,
        )
        # --- router (leader) state ---
        self._active: Dict[str, _RequestState] = {}
        self._pending_by_class: Dict[str, int] = {}
        self._by_job: Dict[int, List[str]] = {}
        #: terminal records for status re-polls + submit dedup
        self._done: BoundedDict = BoundedDict(5000)
        #: session -> worker that served its last turn (KV locality);
        #: bound-forced evictions are counted (each one guarantees a
        #: prefix-cache miss on that session's next turn)
        self._session_node: BoundedDict = BoundedDict(
            2000, on_evict=lambda _k: _M_AFF_EVICT.inc(reason="bound")
        )
        #: sessions whose binding changed since the last standby relay
        #: (failover-safe affinity: the rows piggyback on INGRESS_RELAY
        #: so a promoted router keeps routing turn N+1 to the worker
        #: holding the session's cached KV)
        self._session_dirty: set = set()
        self._session_flush_t = 0.0
        #: standby: job_id -> relayed request dicts (promotion adopts)
        self._relayed: BoundedDict = BoundedDict(500)
        #: model -> (stamp, sampled input files): pattern matching is
        #: O(store files) and must not run per request at open-loop
        #: rates; sampled inputs are immutable store objects, so a
        #: short TTL is safe
        self._sample_cache: Dict[str, Tuple[float, List[str]]] = {}
        # --- client state ---
        #: request-id salt (see submit): ids must not repeat across a
        #: same-identity restart of this node
        self._rid_salt = secrets.token_hex(4)
        #: bounded: submit()-without-wait() (the documented streaming
        #: flow) leaks one future per request whenever the single
        #: unacked REQUEST_DONE push is dropped — a long-lived node
        #: under loss must not grow this without bound
        self._futs: BoundedDict = BoundedDict(5000)
        self._client_terminal: BoundedDict = BoundedDict(5000)
        #: late COMPLETED terminals for requests already settled as
        #: lost/rejected: work executed and delivered after the
        #: cluster declared it dead — the real exactly-once violation
        #: the failover bench asserts stays zero. (The opposite
        #: direction — a late rejection after a completed settle — is
        #: the promoted router honestly re-terminating relayed
        #: requests whose result bytes died with the old leader; the
        #: first-terminal-wins guard dedups it for clients that got
        #: the original push.)
        self.terminal_conflicts = 0
        #: bounded like every other client-side map: an abandoned
        #: streaming request (caller never drains stream_text) must
        #: not leak its queue for the life of the node
        self._streams: BoundedDict = BoundedDict(1000)
        #: request ids with an ACTIVE data-plane pull: their EOF comes
        #: from the pull task, not the terminal settle — the terminal
        #: can land while the last token chunks are still in flight
        self._stream_pulls: set = set()
        self._form_task: Optional[asyncio.Task] = None
        self._bg: set = set()
        self.shed_count = 0
        self.admit_count = 0
        self._register()
        jobs.on_job_done_cbs.append(self._on_job_done)
        self.node.on_became_leader_cbs.append(self._on_promoted)
        # stale-affinity purge: a departed worker's session rows must
        # go, or turn N+1 chases a ghost instead of cold-routing. The
        # hook fires on EVERY node (router and standby relay copies
        # alike), and the departure kind is read off the universe
        # table: a graceful LEAVE removed the entry before callbacks
        # fire, a crash leaves it in place.
        self.node.on_node_failed_cbs.append(self._purge_sessions_for)

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------

    async def start(self) -> None:
        self._form_task = asyncio.create_task(
            self._formation_loop(), name=f"{self._me}-ingress-form"
        )

    async def stop(self) -> None:
        # snapshot-before-await (dmllint race-yield-hazard): a start()
        # racing this stop must not have its fresh formation task
        # nulled out after the reap yields
        form, self._form_task = self._form_task, None
        if form is not None:
            await reap_task(form, self._me, "ingress formation")
        for t in list(self._bg):
            t.cancel()

    @property
    def _me(self) -> str:
        return self.node.me.unique_name

    def _register(self) -> None:
        n = self.node
        n.register(MsgType.REQUEST_SUBMIT, self._h_submit)
        n.register(MsgType.REQUEST_STATUS, self._h_status)
        n.register(MsgType.REQUEST_DONE, self._h_done)
        n.register(MsgType.REQUEST_STREAM_READY, self._h_stream_ready)
        n.register(MsgType.INGRESS_RELAY, self._h_ingress_relay)

    def _spawn(self, coro, what: str) -> asyncio.Task:
        t = asyncio.create_task(coro)
        self._bg.add(t)

        def _fin(task: asyncio.Task) -> None:
            self._bg.discard(task)
            if not task.cancelled() and task.exception() is not None:
                log.error("%s: ingress %s failed: %r",
                          self._me, what, task.exception())

        t.add_done_callback(_fin)
        return t

    # ------------------------------------------------------------------
    # cost / shape inputs
    # ------------------------------------------------------------------

    def _batch_size_of(self, model: str) -> int:
        return max(1, self.jobs.scheduler.batch_size_of(model))

    #: slack-shed needs this many measured batches first: the FIRST
    #: batch of a model carries its cold compile (seconds where steady
    #: state is milliseconds), and with sheds blocking new traffic a
    #: one-sample estimate can never heal itself
    MIN_EXEC_SAMPLES = 3

    def _measured_exec_s(self, model: str, n: int) -> Optional[float]:
        """MEASURED per-batch exec from the trailing batch-ACK samples
        (the same stream C2 reads), or None until the model has
        ``MIN_EXEC_SAMPLES`` measured batches on this coordinator.
        Admission slack uses only measured values: trusting the
        registry's reference CPU prior (~50x a real serving batch)
        would shed every interactive request behind any backlog at
        all — and a freshly promoted coordinator starts sample-less,
        where erring permissive beats rejecting live traffic on a
        stale prior. MEDIAN of the trailing window, not mean: the
        cold-compile first batch is a many-second outlier that a mean
        would let poison admission for the next 32 batches."""
        import statistics

        samples = self.jobs.scheduler.latency_samples.get(model)
        if not samples or len(samples) < self.MIN_EXEC_SAMPLES:
            return None
        recent = list(samples)[-32:]
        per_query = statistics.median(
            et / max(1, k) for (_, et, k) in recent
        )
        return max(1e-4, per_query) * max(1, n)

    def _est_exec_s(self, model: str, n: int) -> float:
        """Formation's dispatch-by estimate: measured when available,
        cost-table prior otherwise (an inflated prior only dispatches
        partial batches EARLIER, which is harmless)."""
        measured = self._measured_exec_s(model, n)
        if measured is not None:
            return measured
        cost = self.jobs.scheduler.costs.get(model)
        if cost is None or cost.per_query <= 0:
            return 0.1
        return cost.per_query * max(1, n)

    # ------------------------------------------------------------------
    # router role: admission
    # ------------------------------------------------------------------

    async def _h_submit(self, msg: Message, addr) -> None:
        if not self.node.is_leader:
            return
        d = msg.data
        rid = d.get("rid")
        req_id = str(d.get("id", ""))

        def ack(payload: Dict[str, Any]) -> None:
            self.node.send_unique(
                msg.sender, MsgType.REQUEST_SUBMIT_ACK,
                {"rid": rid, "id": req_id, **payload},
            )

        if not req_id:
            ack({"accepted": False, "reason": "missing_request_id"})
            return
        # idempotent retries: an id we already know keeps its original
        # outcome (re-ACK; a terminal replays its acceptance — the
        # status/push path carries the result)
        if req_id in self._active:
            ack({"accepted": True})
            return
        prior = self._done.get(req_id)
        if prior is not None:
            if prior.get("terminal") == "shed":
                ack({"accepted": False, "reason": prior.get("reason"),
                     "shed": True})
            else:
                ack({"accepted": True})
            return
        slo_name = str(d.get("slo", "interactive"))
        try:
            slo = resolve_class(slo_name, self.classes)
        except KeyError as e:
            ack({"accepted": False, "reason": f"unknown_slo: {e}"})
            return
        try:
            model = self.jobs._canon(str(d.get("model", "")))
        except KeyError:
            ack({"accepted": False, "reason": "unknown_model"})
            return
        payload: Optional[bytes] = None
        stream = bool(d.get("stream"))
        store_name = d.get("store_name")
        if d.get("payload") is not None:
            payload = str(d["payload"]).encode("utf-8")
            file = f"ingress_{req_id}.req"
        elif store_name:
            if not self.store.metadata.replicas_of(str(store_name)):
                ack({"accepted": False, "reason": "unknown_input"})
                return
            file = str(store_name)
        else:
            # no payload: sample a store input the model's patterns
            # match, like the batch-job intake does (shared immutable
            # inputs are the cheap path — no per-request PUT). Cached
            # briefly: fnmatch over the whole store per request would
            # melt at open-loop rates.
            now0 = time.monotonic()
            cached = self._sample_cache.get(model)
            if cached is not None and now0 - cached[0] < 1.0:
                files = cached[1]
            else:
                patterns = self.jobs.model_patterns.get(
                    model, self.jobs.image_patterns
                )
                files = sorted({
                    f for p in patterns
                    for f in self.store.metadata.matching(p)
                })
                # only non-empty listings are cached: negative-caching
                # an empty match would shed 'no_inputs' for the whole
                # TTL after the model's first input lands in the store
                if files:
                    self._sample_cache[model] = (now0, files)
            if not files:
                ack({"accepted": False, "reason": "no_inputs"})
                return
            # streaming requests share sampled inputs like everything
            # else: batch.streams carries a LIST of targets per file,
            # so several streaming requests decoding one input each
            # get their own feed + READY push
            file = files[hash(req_id) % len(files)]
        now = time.monotonic()
        now_wall = time.time()
        # trace head decision at admission (dml_tpu_torch/tracing.py): one
        # seeded-samplable choice per request; the context propagates
        # through every hop the request takes whether sampled or not
        # (unsampled spans surface only as tail exemplars)
        tid = TRACER.new_trace_id()
        trace_sampled = TRACER.head_sample(tid)
        root = TRACER.start_span(
            "request", trace_id=tid, node=self._me,
            sampled=trace_sampled, t0=now_wall,
            labels={"slo": slo.name, "model": model, "id": req_id},
        )
        adm = TRACER.start_span(
            "admission", ctx=root.ctx(), node=self._me, t0=now_wall,
        )
        reason = shed_reason(
            now=now,
            deadline=now + slo.deadline_s,
            pending_in_class=self._pending_by_class.get(slo.name, 0),
            queue_limit=slo.queue_limit,
            backlog_batches=sum(
                len(q) for q in self.jobs.scheduler.queues.values()
            ),
            slots=len(self.jobs.worker_pool()),
            est_batch_exec_s=self._measured_exec_s(
                model, self._batch_size_of(model)
            ),
        )
        if reason is not None:
            self.shed_count += 1
            _M_SHED.inc(slo=slo.name, reason=reason)
            # shed requests observe their (zero) queue wait too: the
            # histogram must describe every request the door saw, not
            # only the ones that dispatched (the overload regime is
            # exactly when the difference matters)
            _M_QWAIT.observe(0.0, slo=slo.name)
            self._done[req_id] = {
                "terminal": "shed", "reason": reason, "slo": slo.name,
                "trace_id": tid,
            }
            adm.end()
            root.label(terminal="shed", reason=reason)
            root.event("shed")  # tail exemplar: captured regardless
            root.end()          # of the sampling decision
            # signal plane: remember this trace as the freshest shed
            # exemplar for the class, so a shed-ratio burn alert can
            # attach the trace that EXPLAINS it
            self.jobs.signal.note_bad_request("shed", slo.name, tid)
            ack({"accepted": False, "reason": reason, "shed": True})
            return
        adm.end()
        req = PendingRequest(
            id=req_id, client=msg.sender, model=model, slo=slo,
            file=file, payload=payload,
            session=d.get("session"), stream=stream,
            arrival=now, deadline=now + slo.deadline_s,
            arrival_wall=now_wall,
            ctx=TraceContext(tid, root.span_id, trace_sampled, key=file),
        )
        affinity = None
        if req.session:
            aff = self._session_node.get(req.session)
            # only a node still in the schedulable pool counts: a dead
            # or demoted holder must not pin the batch to a ghost
            if aff and aff in self.jobs.worker_pool():
                affinity = aff
                _M_AFF_HITS.inc()
            else:
                _M_AFF_MISSES.inc()
        self._active[req_id] = _RequestState(req=req, root=root)
        self._pending_by_class[slo.name] = (
            self._pending_by_class.get(slo.name, 0) + 1
        )
        self.admit_count += 1
        _M_ADMITTED.inc(slo=slo.name)
        _M_INFLIGHT.set(
            self._pending_by_class.get(slo.name, 0), slo=slo.name
        )
        self.former.add(req, affinity)
        ack({"accepted": True})

    # ------------------------------------------------------------------
    # router role: formation + dispatch
    # ------------------------------------------------------------------

    async def _formation_loop(self) -> None:
        while True:
            await asyncio.sleep(self.tick_s)
            if not self.node.is_leader:
                if self.former.forming:
                    # demoted WITHOUT crashing (leave/rejoin, lost an
                    # election): requests still forming here were never
                    # dispatched, so no other node can ever complete
                    # them — typed rejection now beats a client-side
                    # lost-conversion later
                    for fb in list(self.former.forming.values()):
                        for r in fb.reqs:
                            self._terminal_reject(r, "leadership_lost")
                    self.former.forming.clear()
                if self._active:
                    # DISPATCHED requests belong to the new leader now
                    # (standby relay / client re-poll complete them) —
                    # no terminal from here, just drop the ledger:
                    # stale _active residue would otherwise inflate
                    # _pending_by_class forever and make a later
                    # re-promotion shed live traffic as queue_full
                    # against phantom in-flight counts
                    self._active.clear()
                    self._by_job.clear()
                    for slo_name in list(self._pending_by_class):
                        self._pending_by_class[slo_name] = 0
                        _M_INFLIGHT.set(0, slo=slo_name)
                continue
            try:
                for fb in self.former.due(self._hungry_models()):
                    self._spawn(
                        self._dispatch_batch(fb),
                        f"dispatch {fb.model}/{fb.slo.name} "
                        f"x{len(fb.reqs)}",
                    )
                now = time.monotonic()
                if (
                    self._session_dirty
                    and now - self._session_flush_t >= self._SESSION_FLUSH_S
                ):
                    self._session_flush_t = now
                    self._flush_sessions()
            except Exception:
                log.exception("%s: ingress formation tick failed", self._me)

    def _hungry_models(self) -> set:
        """Models whose pipeline would idle if we kept lingering: at
        least one free slot and nothing of that model queued."""
        if not self.former.forming:
            return set()
        sched = self.jobs.scheduler
        pool = self.jobs.worker_pool()
        free = any(
            w not in sched.in_progress and w not in sched.prefetch
            for w in pool
        )
        if not free:
            return set()
        return {
            fb.model for fb in self.former.forming.values()
            if not sched.queues.get(fb.model)
        }

    async def _traced_put(self, r: PendingRequest):
        """One request's inline-payload PUT under its trace context
        (gather wraps this into a Task, so the contextvar set is
        task-local and the store's store_put span lands in the right
        trace)."""
        tok = CURRENT_CTXS.set((r.ctx,) if r.ctx is not None else ())
        try:
            return await self.store.put_bytes(
                r.file, r.payload, timeout=15.0
            )
        finally:
            CURRENT_CTXS.reset(tok)

    async def _dispatch_batch(self, fb: FormingBatch) -> None:
        now = time.monotonic()
        reqs = list(fb.reqs)
        # inline payloads land in the replicated store first — workers
        # fetch batch inputs over the ordinary replica path
        puts = [r for r in reqs if r.payload is not None]
        if puts:
            results = await asyncio.gather(
                *(self._traced_put(r) for r in puts),
                return_exceptions=True,
            )
            failed = {
                r.id for r, res in zip(puts, results)
                if isinstance(res, BaseException)
            }
            if failed:
                for r in [r for r in reqs if r.id in failed]:
                    self._terminal_reject(r, "input_store_failed")
                reqs = [r for r in reqs if r.id not in failed]
        if not reqs:
            return
        # file -> [[client, id], ...]: a LIST of targets per input, so
        # two streaming requests naming the same store input in one
        # formed batch each get their own feed + READY push (both the
        # sampling and the store_name paths legitimately share files)
        streams: Dict[str, List[List[Any]]] = {}
        for r in reqs:
            if r.stream:
                streams.setdefault(r.file, []).append([r.client, r.id])
        job_id = self.jobs.scheduler.next_job_id()
        # unique inputs only: two requests naming the same store file
        # must decode ONCE (results and token streams fan back out
        # per-request at completion; a duplicated path would double-
        # feed every stream of that input)
        files = list(dict.fromkeys(r.file for r in reqs))
        # one trace-context wire entry per request rides the batch
        # (next to slo_class): `q` stamps the dispatch wall so the
        # coordinator's first WORKER_TASK_REQUEST send can close the
        # scheduler-side `dispatch` span
        now_wall = time.time()
        traces = [
            {**r.ctx.to_wire(), "q": round(now_wall, 6)}
            for r in reqs if r.ctx is not None
        ]
        try:
            self.jobs.ingress_submit(
                job_id, fb.model, files,
                requester=self._me, affinity=fb.affinity,
                streams=streams or None,
                slo_class=fb.slo.name,
                traces=traces or None,
            )
        except Exception as e:
            log.exception("%s: ingress dispatch of %d reqs failed",
                          self._me, len(reqs))
            for r in reqs:
                self._terminal_reject(r, f"dispatch_failed: {e}")
            return
        ids = []
        for r in reqs:
            st = self._active.get(r.id)
            if st is not None:
                st.state = "dispatched"
                st.job_id = job_id
                st.dispatched_wall = now_wall
            ids.append(r.id)
            _M_QWAIT.observe(now - r.arrival, slo=r.slo.name)
            if r.ctx is not None:
                # formation span: admission -> this dispatch (the
                # front-door queue wait, wall-clocked)
                TRACER.start_span(
                    "formation", ctx=r.ctx, node=self._me,
                    t0=r.arrival_wall,
                    labels={"job": job_id, "slo": r.slo.name},
                ).end(now_wall)
        self._by_job[job_id] = ids
        _M_FILL.observe(len(reqs) / self._batch_size_of(fb.model))
        _M_FORMATION.observe(now - fb.opened_at)
        # standby relay: a promoted router must be able to fan the
        # job's completion back out to the clients (remaining_s keeps
        # deadlines meaningful across the hop)
        sb = self.store.standby_node()
        if sb is not None and sb.unique_name != self._me:
            try:
                self.node.send(
                    sb, MsgType.INGRESS_RELAY,
                    {"job": job_id, "reqs": [
                        [r.id, r.client, r.slo.name, r.file,
                         round(r.deadline - now, 3), r.session or "",
                         int(r.stream),
                         # trace continuity across failover: the
                         # promoted router re-roots the adopted
                         # request under the ORIGINAL trace + root
                         # span id, so its completion carries the same
                         # trace_id and earlier spans keep a parent
                         r.ctx.trace_id if r.ctx else "",
                         r.ctx.span_id if r.ctx else "",
                         int(bool(r.ctx and r.ctx.sampled))]
                        for r in reqs
                    ],
                    # session->worker rows dirtied since the last
                    # relay piggyback here (failover-safe affinity:
                    # turn N+1 after a promotion still routes to the
                    # worker holding the session's cached KV)
                    "sessions": self._take_session_rows()},
                )
            except Exception:
                log.exception("%s: ingress relay of job %d failed",
                              self._me, job_id)

    #: max session rows per relay datagram (UDP control-frame budget)
    _SESSION_RELAY_MAX = 100
    #: standalone session-row flush cadence while dirty rows wait and
    #: no dispatch relay happens to carry them
    _SESSION_FLUSH_S = 0.25

    def _take_session_rows(self) -> List[List[str]]:
        """Pop up to ``_SESSION_RELAY_MAX`` dirtied session->worker
        bindings for a relay payload. Best-effort at-most-once UDP
        like the job relay itself: a dropped row costs the promoted
        router one affinity miss, never correctness."""
        rows: List[List[str]] = []
        while self._session_dirty and len(rows) < self._SESSION_RELAY_MAX:
            s = self._session_dirty.pop()
            w = self._session_node.get(s)
            if w:
                rows.append([s, w])
        return rows

    def _purge_sessions_for(self, uname: str) -> None:
        """Drop every session->worker row pointing at a departed node
        (on_node_failed hook; fires on router and standby copies
        alike). Without this, a graceful scale-in of a worker holding
        KV-prefix sessions leaves ghost rows: turn N+1 would "hit"
        affinity for a node that no longer exists instead of cold-
        routing to a live one. Purged rows leave `_session_dirty` too,
        so a pending relay can't resurrect the binding on the standby."""
        stale = [
            s for s, w in list(self._session_node.items()) if w == uname
        ]
        if not stale:
            return
        # a LEAVE removed the node from the universe table before the
        # callbacks fired; a crash leaves the table entry in place
        reason = (
            "leave"
            if self.node.spec.node_by_unique_name(uname) is None
            else "failure"
        )
        for s in stale:
            self._session_node.pop(s, None)
            self._session_dirty.discard(s)
            _M_AFF_EVICT.inc(reason=reason)
        log.info(
            "%s: purged %d session-affinity rows for departed %s (%s)",
            self._me, len(stale), uname, reason,
        )

    def _flush_sessions(self) -> None:
        """Standalone INGRESS_RELAY carrying only session rows: a
        binding established by the LAST completion before a quiet
        spell (or a leader kill) must not wait for the next dispatch
        to reach the standby."""
        sb = self.store.standby_node()
        if sb is None or sb.unique_name == self._me:
            return
        rows = self._take_session_rows()
        if not rows:
            return
        try:
            self.node.send(sb, MsgType.INGRESS_RELAY, {"sessions": rows})
        except Exception:
            log.exception("%s: ingress session-row flush failed", self._me)

    # ------------------------------------------------------------------
    # router role: completion fan-out
    # ------------------------------------------------------------------

    def _on_job_done(self, st, worker: Optional[str]) -> None:
        ids = self._by_job.pop(st.job_id, None)
        if not ids:
            return
        self._spawn(
            self._complete_job(st, ids, worker),
            f"complete job {st.job_id}",
        )

    async def _complete_job(self, st, ids: List[str], worker) -> None:
        # fast path: inline-results batches carried the results in the
        # completing ACK (no store round trip per job — see
        # Batch.inline_results). The store fallback covers oversized
        # results, which DID take the PUT path. A job completed on a
        # promoted coordinator whose inline copy died with the old
        # leader has neither — its requests get a TYPED rejection
        # below (result_unavailable), never a hollow ok=True with a
        # null result.
        merged: Dict[str, Any] = dict(
            getattr(st, "inline_results", None) or {}
        )
        if not merged and not st.error:
            try:
                listing = await self.store.ls_all(
                    f"output_{st.job_id}_*.json"
                )
                import json as _json

                for name in sorted(listing):
                    part = _json.loads(
                        await self.store.get_bytes(name)
                    )
                    for k, v in part.items():
                        merged.setdefault(k, v)
            except Exception:
                # tolerated like get_output: the worker's PUT may have
                # failed mid-failover; completion still terminates the
                # request (result absent), never hangs it
                log.exception("%s: ingress output fetch for job %d "
                              "failed", self._me, st.job_id)
        now = time.monotonic()
        now_wall = time.time()
        for req_id in ids:
            state = self._active.pop(req_id, None)
            if state is None:
                continue
            r = state.req
            stages = self._request_stages(state, st, now_wall)
            trace_extra = (
                {"trace_id": r.ctx.trace_id, "stages": stages}
                if r.ctx is not None else {}
            )
            self._dec_pending(r.slo.name)
            if st.error:
                self._done[req_id] = {
                    "terminal": "rejected",
                    "reason": f"job_failed: {st.error}", "slo": r.slo.name,
                    **trace_extra,
                }
                _M_REJECTED.inc(slo=r.slo.name, reason="job_failed")
                self._end_root(state, "rejected", now_wall,
                               reason="job_failed")
                try:
                    self.node.send_unique(
                        r.client, MsgType.REQUEST_DONE,
                        {"id": req_id, "ok": False,
                         "reason": f"job_failed: {st.error}",
                         **trace_extra},
                    )
                except Exception:
                    log.exception("%s: ingress job-failed push for %s "
                                  "failed", self._me, req_id)
                continue
            if merged.get(r.file) is None:
                # the job finished but this request's result bytes are
                # gone (inline copy died with the old leader across a
                # failover, or the worker's fallback PUT failed): an
                # explicit typed rejection the client can retry on —
                # completing "ok" with a null result would silently
                # lose the answer
                self._done[req_id] = {
                    "terminal": "rejected",
                    "reason": "result_unavailable", "slo": r.slo.name,
                    **trace_extra,
                }
                _M_REJECTED.inc(slo=r.slo.name,
                                reason="result_unavailable")
                self._end_root(state, "rejected", now_wall,
                               reason="result_unavailable")
                try:
                    self.node.send_unique(
                        r.client, MsgType.REQUEST_DONE,
                        {"id": req_id, "ok": False,
                         "reason": "result_unavailable", **trace_extra},
                    )
                except Exception:
                    log.exception("%s: ingress unavailable push for %s "
                                  "failed", self._me, req_id)
                continue
            e2e = now - r.arrival
            met = now <= r.deadline
            if r.session and worker:
                if self._session_node.get(r.session) != worker:
                    self._session_dirty.add(r.session)
                self._session_node[r.session] = worker
            terminal = {
                "terminal": "completed", "slo": r.slo.name,
                "result": merged.get(r.file),
                "worker": worker, "e2e_ms": round(e2e * 1e3, 2),
                "deadline_met": met,
                **trace_extra,
            }
            try:
                self.node.send_unique(
                    r.client, MsgType.REQUEST_DONE,
                    {"id": req_id, "ok": True, **terminal},
                )
            except Exception:
                # a result too big for one datagram (Message.pack
                # frame cap) must not strand THIS request — the same
                # oversized record in _done would also make every
                # status-ACK unsendable, killing the re-poll recovery
                # path — nor abort the loop and strand the REST of the
                # batch. Degrade to a small typed rejection the client
                # can act on.
                log.exception("%s: ingress completed push for %s "
                              "unsendable; rejecting typed", self._me,
                              req_id)
                self._done[req_id] = {
                    "terminal": "rejected",
                    "reason": "result_too_large", "slo": r.slo.name,
                    **trace_extra,
                }
                _M_REJECTED.inc(slo=r.slo.name,
                                reason="result_too_large")
                self._end_root(state, "rejected", now_wall,
                               reason="result_too_large")
                try:
                    self.node.send_unique(
                        r.client, MsgType.REQUEST_DONE,
                        {"id": req_id, "ok": False,
                         "reason": "result_too_large", **trace_extra},
                    )
                except Exception:
                    log.exception("%s: ingress rejection push for %s "
                                  "failed too", self._me, req_id)
                continue
            _M_COMPLETED.inc(slo=r.slo.name)
            _M_E2E.observe(e2e, slo=r.slo.name)
            if r.ctx is not None:
                # result-return stage: job completion -> DONE push
                TRACER.start_span(
                    "result", ctx=r.ctx, node=self._me, t0=now_wall,
                ).end(time.time())
            if not met:
                # deadline-miss attribution: the counter family's
                # stage= label carries the miss's DOMINANT stage (the
                # one that ate the most wall time), so the metric
                # alone says WHERE the tail is being lost; the miss
                # exemplar trace carries the full breakdown
                dominant = (
                    max(stages, key=lambda k: stages[k])
                    if stages else "unattributed"
                )
                _M_DEADLINE_MISS.inc(slo=r.slo.name, stage=dominant)
                if state.root is not None:
                    state.root.event("deadline_miss")
                    state.root.label(miss_stage=dominant)
                self.jobs.signal.note_bad_request(
                    "deadline_miss", r.slo.name,
                    r.ctx.trace_id if r.ctx is not None else None,
                )
            self._end_root(state, "completed", now_wall,
                           deadline_met=met)
            self._done[req_id] = terminal

    def _request_stages(
        self, state: _RequestState, st, now_wall: float
    ) -> Dict[str, float]:
        """Per-stage seconds for one request's terminal, from what the
        coordinator knows synchronously: the router's own admission/
        dispatch walls plus the batch ACK's carried stage timings
        (``JobState.stage_timing``) — available on a real multi-
        process cluster too, where the worker's spans live on the
        worker. ``dispatch`` is the residual between dispatch and
        completion not explained by the worker's measured exec
        (scheduler queue + wire + ACK latency), floored at zero."""
        r = state.req
        stages: Dict[str, float] = {}
        if state.dispatched_wall and r.arrival_wall:
            stages["formation"] = max(
                0.0, state.dispatched_wall - r.arrival_wall
            )
        timing = getattr(st, "stage_timing", None) or {}
        fetch = float(timing.get("fetch", 0.0))
        backend = float(timing.get("backend", 0.0))
        infer = float(timing.get("infer", 0.0))
        put = float(timing.get("put", 0.0))
        exec_ = float(timing.get("exec", 0.0))
        if timing:
            stages["fetch"] = fetch + max(0.0, backend - infer)
            stages["infer"] = infer
            stages["put"] = put
        if state.dispatched_wall:
            stages["dispatch"] = max(
                0.0, (now_wall - state.dispatched_wall) - max(
                    exec_, fetch + backend + put
                )
            )
        return {k: round(v, 6) for k, v in stages.items()}

    def _end_root(
        self, state: _RequestState, terminal: str, now_wall: float,
        reason: Optional[str] = None, deadline_met: Optional[bool] = None,
    ) -> None:
        """Close a request's root span exactly once with its terminal
        labels (idempotent via Span.end)."""
        root = state.root
        if root is None:
            return
        root.label(terminal=terminal)
        if reason is not None:
            root.label(reason=reason)
        if deadline_met is not None:
            root.label(deadline_met=deadline_met)
        root.end()

    def _terminal_reject(self, r: PendingRequest, reason: str) -> None:
        state = self._active.pop(r.id, None)
        self._dec_pending(r.slo.name)
        # never-dispatched terminals record the queue wait they DID
        # experience: only-completions-observe left the histogram
        # blind to exactly the requests that waited longest and died
        # waiting (optimistic bias under overload)
        _M_QWAIT.observe(
            max(0.0, time.monotonic() - r.arrival), slo=r.slo.name
        )
        self._done[r.id] = {
            "terminal": "rejected", "reason": reason, "slo": r.slo.name,
            **({"trace_id": r.ctx.trace_id} if r.ctx else {}),
        }
        _M_REJECTED.inc(slo=r.slo.name, reason=reason.split(":")[0])
        if state is not None:
            self._end_root(
                state, "rejected", time.time(),
                reason=reason.split(":")[0],
            )
        self.node.send_unique(
            r.client, MsgType.REQUEST_DONE,
            {"id": r.id, "ok": False, "reason": reason,
             **({"trace_id": r.ctx.trace_id} if r.ctx else {})},
        )

    def _dec_pending(self, slo_name: str) -> None:
        n = max(0, self._pending_by_class.get(slo_name, 0) - 1)
        self._pending_by_class[slo_name] = n
        _M_INFLIGHT.set(n, slo=slo_name)

    # ------------------------------------------------------------------
    # router role: status + standby/promotion
    # ------------------------------------------------------------------

    async def _h_status(self, msg: Message, addr) -> None:
        if not self.node.is_leader:
            return
        req_id = str(msg.data.get("id", ""))
        state = self._active.get(req_id)
        done = self._done.get(req_id)
        reply: Dict[str, Any] = {
            "rid": msg.data.get("rid"), "id": req_id,
        }
        if state is not None:
            reply.update({"known": True, "done": False,
                          "state": state.state})
        elif done is not None:
            reply.update({"known": True, "done": True, **done})
        else:
            reply.update({"known": False, "done": False})
        self.node.send_unique(msg.sender, MsgType.REQUEST_STATUS_ACK, reply)

    async def _h_ingress_relay(self, msg: Message, addr) -> None:
        """Standby side: remember which requests ride which job so a
        promotion can fan their completions out, and adopt relayed
        session->worker rows so affinity survives the failover (a
        promoted router otherwise routes every session's next turn to
        a cold peer, turning KV locality into guaranteed misses)."""
        if msg.sender != self.node.leader_unique or self.node.is_leader:
            return
        for row in msg.data.get("sessions") or []:
            if isinstance(row, (list, tuple)) and len(row) >= 2:
                self._session_node[str(row[0])] = str(row[1])
        job = msg.data.get("job")
        if job is None:
            return  # session-row-only flush
        self._relayed[int(job)] = {
            "at": time.monotonic(),
            "reqs": list(msg.data.get("reqs") or []),
        }

    def _on_promoted(self) -> None:
        """Adopt relayed dispatched requests: the promoted coordinator
        finishes their jobs through its shadow queues, and this router
        must complete them — in-flight traffic either completes or is
        explicitly rejected across a failover, never silently lost."""
        if not self._relayed:
            return
        now = time.monotonic()
        adopted = 0
        for job_id, entry in list(self._relayed.items()):
            if job_id in self._by_job:
                continue
            ids = []
            for row in entry["reqs"]:
                (rid_, client, slo_name, file, remaining, session,
                 stream) = row[:7]
                tid, root_sid, tr_sampled = (
                    list(row[7:10]) + ["", "", 0]
                )[:3]
                if rid_ in self._active:
                    continue
                try:
                    slo = resolve_class(slo_name, self.classes)
                except KeyError:
                    slo = SLOClass(slo_name, deadline_s=30.0)
                elapsed = now - entry["at"]
                arrival = (
                    now - max(0.0, slo.deadline_s - float(remaining))
                    - elapsed
                )
                root = None
                ctx = None
                if tid:
                    # re-root the adopted request under the ORIGINAL
                    # trace + root span id: the completion's trace_id
                    # survives the failover, and spans the dead leader
                    # already recorded keep a resolvable parent
                    root = TRACER.start_span(
                        "request", trace_id=str(tid), node=self._me,
                        sampled=bool(tr_sampled),
                        t0=time.time() - max(0.0, now - arrival),
                        labels={"slo": slo.name, "id": rid_,
                                "adopted": 1},
                        span_id=str(root_sid) or None,
                    )
                    ctx = TraceContext(
                        str(tid), root.span_id, bool(tr_sampled),
                        key=file,
                    )
                r = PendingRequest(
                    id=rid_, client=client, model="", slo=slo,
                    file=file, payload=None,
                    session=session or None, stream=bool(stream),
                    arrival=arrival,
                    deadline=now + float(remaining) - elapsed,
                    arrival_wall=time.time() - max(0.0, now - arrival),
                    ctx=ctx,
                )
                self._active[rid_] = _RequestState(
                    req=r, state="dispatched", job_id=job_id, root=root,
                )
                self._pending_by_class[slo.name] = (
                    self._pending_by_class.get(slo.name, 0) + 1
                )
                # the gauge tracks the counter on every path — the
                # failover window is exactly when it must not lie
                _M_INFLIGHT.set(
                    self._pending_by_class[slo.name], slo=slo.name
                )
                ids.append(rid_)
            if ids:
                self._by_job[job_id] = ids
                adopted += len(ids)
                # the job may have already finished on the shadow
                # (retired via ack relays) — complete immediately
                st = self.jobs.scheduler.done_jobs.get(job_id)
                if st is not None:
                    self._on_job_done(st, None)
        self._relayed.clear()
        if adopted:
            log.info("%s: ingress adopted %d in-flight requests across "
                     "failover", self._me, adopted)

    def stats(self) -> Dict[str, Any]:
        """CLI surface: live front-door state."""
        return {
            "mode": self.former.mode,
            "classes": {
                n: {"deadline_s": c.deadline_s,
                    "queue_limit": c.queue_limit}
                for n, c in sorted(self.classes.items())
            },
            "admitted": self.admit_count,
            "shed": self.shed_count,
            "forming": {
                "/".join(k for k in key if k): len(fb.reqs)
                for key, fb in self.former.forming.items()
            },
            "in_flight": dict(self._pending_by_class),
            "sessions_tracked": len(self._session_node),
            "terminal_conflicts": self.terminal_conflicts,
        }

    # ------------------------------------------------------------------
    # client verbs (any node)
    # ------------------------------------------------------------------

    async def submit(
        self,
        model: str,
        slo: str = "interactive",
        payload: Optional[str] = None,
        store_name: Optional[str] = None,
        session: Optional[str] = None,
        stream: bool = False,
        timeout: float = 10.0,
        retries: int = 3,
    ) -> str:
        """Submit one request; returns its id once ADMITTED. A shed or
        invalid request raises ``RequestRejected`` immediately — the
        typed-rejection contract. Retries are idempotent by id."""
        # salted with a per-construction nonce: node.new_rid() counts
        # from 1 per process, so a same-identity client restart (chaos
        # restart_node) would re-mint its predecessor's ids and the
        # leader's _done dedup would hand the NEW request the OLD
        # incarnation's terminal — a stale result served as an answer
        req_id = f"{self.node.new_rid()}~{self._rid_salt}"
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._futs[req_id] = fut
        if stream:
            self._streams[req_id] = asyncio.Queue()
        data = {
            "id": req_id, "model": model, "slo": slo,
            "session": session, "stream": stream,
        }
        if payload is not None:
            data["payload"] = payload
        if store_name is not None:
            data["store_name"] = store_name
        # the finally owns the cleanup (dmllint race-yield-hazard): a
        # CANCELLED submit — wait_for timeout around submit(), client
        # teardown — skips `except Exception`, and the future + stream
        # queue registered above would leak in _futs/_streams forever
        admitted = rejected = False
        try:
            reply = await leader_retry(
                self.node, MsgType.REQUEST_SUBMIT, data,
                timeout=timeout, retries=retries,
            )
            if not reply.get("accepted"):
                rejected = True  # typed shed: settled, never completes
                raise RequestRejected(
                    str(reply.get("reason", "rejected")), slo=slo,
                    shed=bool(reply.get("shed")),
                )
            admitted = True
            return req_id
        finally:
            if not admitted:
                self._futs.pop(req_id, None)
                self._streams.pop(req_id, None)
                if not rejected and req_id not in self._client_terminal:
                    # the submit may have been ADMITTED with only its
                    # ACK lost — on ANY non-rejection exit (timeout,
                    # no-leader, CANCELLATION — which `except
                    # Exception` never sees) record the client's lost
                    # classification so a later completed push
                    # registers as a terminal conflict (work delivered
                    # after the client declared the request dead)
                    # instead of silently evading the exactly-once
                    # verdict
                    self._client_terminal[req_id] = "lost"

    async def wait(
        self, req_id: str, timeout: Optional[float] = None
    ) -> Dict[str, Any]:
        """Wait for the request's terminal. Primary signal is the
        REQUEST_DONE push; a 1 s status re-poll covers a dropped push
        or a failover (same discipline as JobService.wait_job). A
        coordinator that answers "unknown" five polls in a row lost
        the request to a failover before dispatch — that becomes a
        typed LOST rejection, never a hang."""
        settled = self._client_terminal.get(req_id)
        if settled is not None:
            # already terminal (push landed while the caller was still
            # streaming tokens, or a prior wait classified it) — no
            # future to race, just read the record back
            if isinstance(settled, dict):
                return dict(settled)
            return {"id": req_id, "ok": False,
                    "reason": "lost_failover", "terminal": str(settled)}
        fut = self._futs.setdefault(
            req_id, asyncio.get_running_loop().create_future()
        )

        async def waiter() -> Dict[str, Any]:
            unknown = 0
            while not fut.done():
                try:
                    return await asyncio.wait_for(asyncio.shield(fut), 1.0)
                except asyncio.TimeoutError:
                    try:
                        reply = await self.node.leader_request(
                            MsgType.REQUEST_STATUS, {"id": req_id},
                            timeout=2.0,
                        )
                    except Exception:
                        continue  # no leader reachable; keep waiting
                    if reply.get("done"):
                        self._settle(req_id, {
                            "id": req_id,
                            "ok": reply.get("terminal") == "completed",
                            **{k: v for k, v in reply.items()
                               if k not in ("rid", "known", "done")},
                        })
                    elif not reply.get("known"):
                        unknown += 1
                        if unknown >= 5:
                            self._settle(req_id, {
                                "id": req_id, "ok": False,
                                "reason": "lost_failover",
                                "terminal": "lost",
                            })
                    else:
                        unknown = 0
            return fut.result()

        try:
            return await asyncio.wait_for(waiter(), timeout)
        except asyncio.TimeoutError:
            # the caller is about to classify this request LOST —
            # record it, so a late completed push counts as a terminal
            # conflict rather than settling into an empty record
            if req_id not in self._client_terminal:
                self._client_terminal[req_id] = "lost"
            raise
        finally:
            # unconditional: a wait that timed out unresolved must not
            # leak its future forever. A terminal arriving later still
            # lands in _client_terminal via _settle (bounded), it just
            # no longer has a future to resolve.
            self._futs.pop(req_id, None)

    async def request(
        self,
        model: str,
        slo: str = "interactive",
        timeout: float = 30.0,
        **kw: Any,
    ) -> Dict[str, Any]:
        """submit + wait in one call (CLI / loadgen convenience)."""
        req_id = await self.submit(model, slo=slo, **kw)
        return await self.wait(req_id, timeout=timeout)

    def _settle(self, req_id: str, terminal: Dict[str, Any]) -> None:
        """First terminal wins — exactly once, no matter how many of
        push / poll / lost-detection race to deliver it. A late
        duplicate or downgrade (push + re-poll racing; a promoted
        router re-rejecting a request the old leader completed) is
        benign under this guard; a late COMPLETED for a request
        already settled dead means the cluster executed work after
        declaring it lost — counted, so exactly-once is asserted on
        observations rather than holding by construction here.
        Resolving POPS the future (submit-without-wait — the
        documented streaming flow — must not leak one per request);
        the settled terminal stays readable through wait() via
        ``_client_terminal``."""
        kind = _terminal_kind(terminal)
        prior = self._client_terminal.get(req_id)
        if prior is not None:
            if kind == "completed" and _terminal_kind(prior) != kind:
                self.terminal_conflicts += 1
                log.warning(
                    "%s: conflicting terminal for request %s: settled "
                    "%s, late %s", self._me, req_id,
                    _terminal_kind(prior), kind,
                )
            return
        self._client_terminal[req_id] = dict(terminal)
        fut = self._futs.pop(req_id, None)
        if fut is not None and not fut.done():
            fut.set_result(terminal)
        q = self._streams.get(req_id)
        if q is not None and req_id not in self._stream_pulls:
            # no data-plane pull ever started (non-streaming backend,
            # lost READY push): EOF the listener here so it never
            # hangs. An active pull owns the EOF instead — the
            # terminal can arrive while tokens are still in flight.
            q.put_nowait(None)

    async def _h_done(self, msg: Message, addr) -> None:
        self._settle(str(msg.data.get("id", "")), dict(msg.data))

    async def _h_stream_ready(self, msg: Message, addr) -> None:
        """A worker exposed this request's token stream: pull it over
        the TCP data plane into the local queue as chunks arrive."""
        req_id = str(msg.data.get("id", ""))
        q = self._streams.get(req_id)
        if q is None:
            return  # not a stream request we own (or already settled)
        if req_id in self._stream_pulls:
            return  # duplicate READY (resent task) — one pull at a time
        addr_ = (str(msg.data.get("host")), int(msg.data.get("port", 0)))
        token = str(msg.data.get("token", ""))
        self._stream_pulls.add(req_id)

        async def pull() -> None:
            try:
                async for chunk in self.store.data_plane.fetch_stream(
                    addr_, token
                ):
                    q.put_nowait(chunk.decode("utf-8", errors="replace"))
            except Exception as e:
                log.info("%s: token stream pull for %s ended early: %r",
                         self._me, req_id, e)
            finally:
                self._stream_pulls.discard(req_id)
                q.put_nowait(None)

        self._spawn(pull(), f"stream pull {req_id}")

    async def stream_text(
        self, req_id: str, timeout: float = 30.0,
        on_first: Optional[Callable[[], None]] = None,
        on_chunk: Optional[Callable[[str], None]] = None,
    ) -> List[str]:
        """Collect a streaming request's token chunks until EOF.
        ``on_first`` fires at the first chunk — the client-side TTFT
        probe the multi-turn loadgen phase reads. ``on_chunk`` fires
        per collected chunk (first included) — the loadgen stamps
        these to build per-request TPOT; residue chunks drained at
        EOF fire too, so the stamps reflect when the CLIENT observed
        each token, which is the only TPOT a client can honestly
        claim."""

        def _note(c: str) -> None:
            if on_chunk is not None:
                try:
                    on_chunk(c)
                except Exception as e:
                    log.warning("stream on_chunk hook failed: %r", e)

        q = self._streams.get(req_id)
        if q is None:
            raise KeyError(f"{req_id} is not a streaming request")
        chunks: List[str] = []
        deadline = time.monotonic() + timeout
        try:
            while True:
                item = await asyncio.wait_for(
                    q.get(), max(0.01, deadline - time.monotonic())
                )
                if item is not None and not chunks and on_first is not None:
                    try:
                        on_first()
                    except Exception as e:
                        log.warning("stream on_first hook failed: %r", e)
                if item is None:
                    # terminal settle also EOFs; drain any residue
                    # pushed by a racing pull task
                    while not q.empty():
                        extra = q.get_nowait()
                        if extra is not None:
                            chunks.append(extra)
                            _note(extra)
                    return chunks
                chunks.append(item)
                _note(item)
        finally:
            # the stream is consumed (or abandoned on timeout): drop
            # the queue so drained requests don't occupy the bound
            self._streams.pop(req_id, None)

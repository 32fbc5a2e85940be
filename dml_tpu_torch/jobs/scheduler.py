"""Pure-logic coordinator state machine: intake, batching, fair-share
assignment, preemption, failure requeue, metrics.

This is the reference's scheduling core (worker.py:176-495 intake +
schedule_job; worker.py:989-1026 ACK bookkeeping; worker.py:1279-1306
failure requeue) extracted into a deterministic, I/O-free class so the
edge cases (preempt/requeue/failover) are unit-testable — SURVEY §7
"hard parts" #3 calls this out as the reason the reference's state
machine was only ever hand-tested.

The service layer (service.py) owns all sockets and devices; it feeds
events in and performs the returned `Assignment`s.

Semantics preserved from the reference:
- wrap-around sampling: a job of N queries cycles the image list until
  N inputs are scheduled (preprocess_job_request, worker.py:188-245)
- one outstanding batch per worker (workers_tasks_dict, worker.py:54)
- single active model -> every free worker takes from its queue
  (worker.py:257-300)
- two active models -> fair split by predicted query rate, growing
  each side to its share and preempting the other's workers; preempted
  batches return to the FRONT of their queue (worker.py:303-480)
- worker death -> its in-flight batch returns to queue front
  (worker.py:1279-1306)
- job completion when every batch has been ACKed (worker.py:1018-1019)

Deliberate non-copies (intent over accident, SURVEY §7):
- batches are padded/short-tail tolerant: the tail batch keeps its
  natural length and the engine pads to the compiled shape, so no
  recompile (the reference emits ragged tails, worker.py:229-237)
- job ids are a monotonic counter from 1, not seeded at 30
  (worker.py:47)
"""

from __future__ import annotations

import statistics
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Deque, Dict, List, Optional, Sequence, Tuple

from ..observability import METRICS
from ..tracing import TRACER, TraceContext
from .cost_model import (
    ModelCost,
    class_split,
    fair_split_weighted_directed,
    query_rate,
)

# Coordinator metrics: the registry form of the reference's C1/C2
# console (see observability.py's C1-C5 map). The exact-sample
# c1_stats/c2_stats read-outs below stay for reference parity; these
# are the mergeable cluster-wide equivalents METRICS_PULL aggregates.
_M_QUERIES = METRICS.counter(
    "jobs_queries_total", "queries completed, per model (C1 count)")
_M_RATE = METRICS.gauge(
    "jobs_query_rate_per_s",
    "trailing 10s per-model query rate, refreshed per batch ACK (C1)")
_M_QUERY_LAT = METRICS.histogram(
    "jobs_query_latency_seconds",
    "per-query processing time, per model (C2: mean + percentiles)")
_M_BATCH_EXEC = METRICS.histogram(
    "jobs_batch_exec_seconds", "per-batch worker exec wall, per model")
_M_QUEUE_DEPTH = METRICS.gauge(
    "jobs_queue_depth", "queued batches, per model")
_M_WORKERS_BUSY = METRICS.gauge(
    "jobs_workers_busy", "workers with a batch in flight (C5 size)")
_M_PREEMPTIONS = METRICS.counter(
    "jobs_preemptions_total",
    "batches displaced by the dual-model fair split")
_M_REQUEUES = METRICS.counter(
    "jobs_requeues_total",
    "batches returned to a queue front (worker death + live failure)")
_M_JOBS_DONE = METRICS.counter(
    "jobs_completed_total", "jobs fully completed, per model")
_M_JOBS_FAILED = METRICS.counter(
    "jobs_failed_total", "jobs retired with an error, per model")
_M_DEPTH = METRICS.gauge(
    "jobs_pipeline_depth",
    "worker-pipelining depth currently in force on the coordinator")
_M_PROBE_QPS = METRICS.histogram(
    "jobs_depth_probe_qps",
    "measured ACK throughput of each depth-probe phase, by depth")
_M_PROBES = METRICS.counter(
    "jobs_depth_probes_total",
    "depth probe cycles committed, by trigger (warmup|drift|ttl|pool)")
_M_PROBE_ABORTS = METRICS.counter(
    "jobs_depth_probe_aborts_total",
    "probe cycles abandoned (work drained / phase timed out)")


class DepthController:
    """Probe-and-commit controller for ``Scheduler.pipeline_depth``.

    Static depth-2 pipelining wins on a congested device link and
    loses on a fast one — like the sync-vs-pipelined dispatch choice,
    the winner is decided by link weather, not by the code. This applies the same cure the engine's
    ``choose_dispatch_mode`` proved on the C4 path: measure both modes
    on real work, commit to the winner, and re-measure when conditions
    drift (Orca/vLLM's measured-not-assumed scheduling discipline).

    Pure logic, deterministic under an injected clock: the service
    feeds it the coordinator's batch-ACK stream and applies the depth
    it returns. Until a probe commits, the depth is 1 — the
    reference-faithful cheap sync path (the mode that never loses to
    overlap overhead) — so short jobs that don't accumulate enough
    backlog to probe serve safely rather than inheriting overlap on
    faith. One probe cycle runs two phases — ``probe_batches``
    counted ACKs at depth 1, then at depth 2 — and each phase
    discards the FIRST ACK from every worker it hears (that worker's
    in-flight batch may have executed under the previous depth; one
    global transition discard is not enough on a multi-worker pool),
    with the phase clock starting at the last discard before counting
    begins. Commit prefers depth 1 unless depth 2's measured rate
    wins by more than ``noise_margin`` (overlap must pay for its
    state machine).

    After commit the controller watches the trailing per-stage walls
    (fetch / infer / put — the same ACK-carried timings
    ``breakdown_stats`` aggregates) against the probe-time signature;
    a stage mean drifting past ``drift_ratio`` in either direction
    re-arms the probe, so congested links regain overlap and healed
    links fall back to the cheap path automatically. ``reprobe_ttl_s``
    re-arms on age alone (link weather drifts without a stage-wall
    signature move when it shifts all stages together).
    """

    PHASES = (1, 2)

    def __init__(
        self,
        probe_batches: int = 5,
        noise_margin: float = 0.05,
        drift_ratio: float = 1.75,
        min_probe_backlog: Optional[int] = None,
        reprobe_ttl_s: float = 600.0,
        probe_phase_timeout_s: float = 60.0,
        initial_depth: int = 1,
        now: Callable[[], float] = time.time,
    ):
        self.probe_batches = max(2, int(probe_batches))
        self.noise_margin = float(noise_margin)
        self.drift_ratio = float(drift_ratio)
        # a probe needs enough queued work to feed BOTH phases plus
        # their transition batches, or phase rates measure starvation
        self.min_probe_backlog = (
            int(min_probe_backlog) if min_probe_backlog is not None
            else 2 * (self.probe_batches + 1)
        )
        self.reprobe_ttl_s = float(reprobe_ttl_s)
        self.probe_phase_timeout_s = float(probe_phase_timeout_s)
        self.now = now
        self.depth = int(initial_depth)
        # warmup: waiting for enough backlog to probe; probing: a
        # phase is collecting ACKs; settled: committed, watching drift
        self.state = "warmup"
        self.probes = 0
        self.reprobes = 0
        self.aborted_probes = 0
        self.committed_at: Optional[float] = None
        self.signature: Optional[Dict[str, float]] = None
        self.last_probe: Optional[Dict[str, Any]] = None
        self._trigger = "warmup"
        self._phase = 0
        self._phase_t0: Optional[float] = None
        # wall time the phase BEGAN (not its first ACK): the phase
        # timeout must fire even when zero ACKs ever arrive (workers
        # died right after the probe started), or the controller
        # wedges in 'probing' forever — TTL only covers 'settled'
        self._phase_wall0: float = 0.0
        # last probing ACK seen (counted OR discarded): the timeout
        # means "ACKs stopped", so it measures from the last sign of
        # life — a slow-but-flowing congested phase (exactly where
        # depth 2 wins) must not abort mid-measurement
        self._phase_last_ack: float = 0.0
        # abort cooldown: an aborted probe must NOT restart in the
        # same tick (a stalled pool with standing backlog would cycle
        # probe/abort forever, flapping the depth each timeout)
        self._no_probe_before: float = 0.0
        # worker -> first-ACK-of-this-phase discard pending (their
        # in-flight batch may predate the depth switch)
        self._phase_skip_seen: Dict[str, bool] = {}
        # pool size the committed depth was measured against (None
        # until first observed): elastic membership can grow or shrink
        # the slot count mid-job, which changes the overlap economics
        # as surely as link weather does — a size change re-arms the
        # probe (trigger "pool") so the committed depth is re-validated
        # against the pool that actually exists now
        self._pool_size: Optional[int] = None
        self._phase_images = 0
        self._phase_acks = 0
        self._phase_rates: Dict[int, float] = {}
        self._probe_stage_sum = {"fetch": 0.0, "infer": 0.0, "put": 0.0}
        self._probe_stage_n = 0
        self._trail: Deque[Tuple[float, float, float]] = deque(
            maxlen=2 * self.probe_batches
        )
        _M_DEPTH.set(self.depth)

    # -- scheduling-round hook ----------------------------------------

    def tick(self, queued_batches: int) -> int:
        """Called once per scheduling round with the current backlog;
        returns the depth the scheduler should run this round."""
        t = self.now()
        if (
            self.state == "settled"
            and self.reprobe_ttl_s > 0
            and self.committed_at is not None
            and t - self.committed_at >= self.reprobe_ttl_s
        ):
            self._rearm("ttl")
        if self.state == "probing":
            # a phase whose ACK stream STOPPED — including one that
            # never received any (workers died right after the probe
            # started) — must not pin a half-measured depth forever:
            # abandon, keep the last commit's winner. Measured from
            # the last ACK, not the first: a slow-but-flowing
            # congested phase is a measurement, not a stall.
            ref = max(self._phase_wall0, self._phase_last_ack)
            if t - ref > self.probe_phase_timeout_s:
                self._abort_probe()
        if (
            self.state == "warmup"
            and queued_batches >= self.min_probe_backlog
            and t >= self._no_probe_before
        ):
            self._begin_probe()
        return self.depth

    # -- pool-size hook (elastic membership) --------------------------

    def on_pool_size(self, n_slots: int) -> None:
        """Called per scheduling round with the slot count. A change
        counts as DRIFT: a settled commit re-arms (a join/leave that
        changed the pool mid-job invalidates the probe's premise —
        more slots deepen the fetch/put overlap window, fewer starve
        it), and an in-flight probe aborts (its two phases would be
        measuring different pools). The first observation only
        records the size — bring-up is not drift."""
        if self._pool_size is None:
            self._pool_size = int(n_slots)
            return
        if int(n_slots) == self._pool_size:
            return
        self._pool_size = int(n_slots)
        if self.state == "settled":
            self.reprobes += 1
            self._rearm("pool")
        elif self.state == "probing":
            self._abort_probe()

    # -- ACK hook -----------------------------------------------------

    def on_ack(
        self,
        n_images: int,
        fetch: float = 0.0,
        infer: float = 0.0,
        put: float = 0.0,
        worker: str = "",
    ) -> int:
        """Fold one worker batch-ACK into the controller; returns the
        depth to apply from here on. `worker` identifies the ACK's
        sender so each phase can discard every worker's transition
        batch (one global discard under-counts on a multi-worker
        pool: W in-flight batches may predate the depth switch)."""
        t = self.now()
        if self.state == "probing":
            self._phase_last_ack = t
            if not self._phase_skip_seen.get(worker):
                # this worker's first ACK of the phase: its batch may
                # have executed under the previous depth — discard.
                # The phase clock starts at the LAST discard before
                # counting begins (clean work starts after the
                # stragglers drain)
                self._phase_skip_seen[worker] = True
                if self._phase_acks == 0:
                    self._phase_t0 = t
                return self.depth
            if self._phase_t0 is None:  # defensive; discards above
                self._phase_t0 = t      # always set it first
                return self.depth
            self._phase_acks += 1
            self._phase_images += int(n_images)
            self._probe_stage_sum["fetch"] += fetch
            self._probe_stage_sum["infer"] += infer
            self._probe_stage_sum["put"] += put
            self._probe_stage_n += 1
            if self._phase_acks >= self.probe_batches:
                wall = max(t - self._phase_t0, 1e-9)
                rate = self._phase_images / wall
                self._phase_rates[self.depth] = rate
                _M_PROBE_QPS.observe(rate, depth=str(self.depth))
                if self._phase + 1 < len(self.PHASES):
                    self._phase += 1
                    self.depth = self.PHASES[self._phase]
                    self._phase_t0 = None
                    self._phase_wall0 = t
                    self._phase_skip_seen = {}
                    self._phase_images = 0
                    self._phase_acks = 0
                    _M_DEPTH.set(self.depth)
                else:
                    self._commit(t)
        elif self.state == "settled" and self.signature is not None:
            self._trail.append((fetch, infer, put))
            if len(self._trail) == self._trail.maxlen and self._drifted():
                self.reprobes += 1
                self._rearm("drift")
        return self.depth

    # -- internals ----------------------------------------------------

    def _rearm(self, trigger: str) -> None:
        self.state = "warmup"
        self._trigger = trigger
        self._trail.clear()

    def _begin_probe(self) -> None:
        self.state = "probing"
        self._phase = 0
        self.depth = self.PHASES[0]
        self._phase_t0 = None
        self._phase_wall0 = self.now()
        self._phase_last_ack = 0.0
        self._phase_skip_seen = {}
        self._phase_images = 0
        self._phase_acks = 0
        self._phase_rates = {}
        self._probe_stage_sum = {"fetch": 0.0, "infer": 0.0, "put": 0.0}
        self._probe_stage_n = 0
        _M_DEPTH.set(self.depth)

    def _abort_probe(self) -> None:
        self.aborted_probes += 1
        _M_PROBE_ABORTS.inc()
        # fall back to what the last commit decided (or the cheap
        # serial path when nothing ever committed) and re-arm — but
        # with a cooldown: without it a stalled pool with standing
        # backlog re-begins the probe in the SAME tick and cycles
        # probe/abort (depth flapping) every timeout period
        win = self.last_probe["winner"] if self.last_probe else 1
        self.depth = win
        self._no_probe_before = self.now() + self.probe_phase_timeout_s
        self._rearm(self._trigger)
        _M_DEPTH.set(self.depth)

    def _commit(self, t: float) -> None:
        r1 = self._phase_rates.get(1, 0.0)
        r2 = self._phase_rates.get(2, 0.0)
        ratio = (r2 / r1) if r1 > 0 else float("inf")
        win = 2 if ratio > 1.0 + self.noise_margin else 1
        self.depth = win
        self.state = "settled"
        self.committed_at = t
        n = max(self._probe_stage_n, 1)
        self.signature = {
            k: v / n for k, v in self._probe_stage_sum.items()
        }
        self._trail.clear()
        self.probes += 1
        if win == 2:
            reason = (
                f"depth-2 overlap won the probe ({ratio:.2f}x > "
                f"1+{self.noise_margin:g} noise margin)"
            )
        else:
            reason = (
                f"depth-1: overlap did not pay ({ratio:.2f}x <= "
                f"1+{self.noise_margin:g} noise margin) — cheap sync "
                "path wins on this link"
            )
        self.last_probe = {
            "qps_depth1": round(r1, 2),
            "qps_depth2": round(r2, 2),
            "ratio_d2_vs_d1": round(ratio, 3) if r1 > 0 else None,
            "winner": win,
            "trigger": self._trigger,
            "reason": reason,
        }
        _M_PROBES.inc(trigger=self._trigger)
        _M_DEPTH.set(win)

    def _drifted(self) -> bool:
        """Trailing stage-wall means vs the probe-time signature; sub-
        millisecond walls are floored so idle-stage jitter (a 0.1 ms
        put doubling to 0.2 ms) can't thrash the probe."""
        assert self.signature is not None
        n = len(self._trail)
        floor = 1e-3
        for i, k in enumerate(("fetch", "infer", "put")):
            cur = max(sum(s[i] for s in self._trail) / n, floor)
            ref = max(self.signature.get(k, 0.0), floor)
            r = cur / ref
            if r > self.drift_ratio or r < 1.0 / self.drift_ratio:
                return True
        return False

    def explain(self) -> Dict[str, Any]:
        """Operator surface (CLI `breakdown`): the committed depth AND
        why — probe rates, trigger, drift signature."""
        trail = None
        if self._trail:
            n = len(self._trail)
            trail = {
                k: round(sum(s[i] for s in self._trail) / n, 6)
                for i, k in enumerate(("fetch", "infer", "put"))
            }
        return {
            "state": self.state,
            "depth": self.depth,
            "probes": self.probes,
            "reprobes": self.reprobes,
            "aborted_probes": self.aborted_probes,
            "probe_batches": self.probe_batches,
            "min_probe_backlog": self.min_probe_backlog,
            "noise_margin": self.noise_margin,
            "drift_ratio": self.drift_ratio,
            "last_probe": self.last_probe,
            "pool_size": self._pool_size,
            "signature_s": (
                {k: round(v, 6) for k, v in self.signature.items()}
                if self.signature else None
            ),
            "trailing_s": trail,
        }


@dataclass
class Batch:
    """One unit of schedulable work (reference: a batch entry in the
    model's pending queue, worker.py:229-245)."""

    job_id: int
    batch_id: int
    model: str
    files: List[str]
    # file -> replica unique_names holding it (resolved at intake,
    # reference worker.py:290-297)
    replicas: Dict[str, List[str]] = field(default_factory=dict)
    # file -> version pinned at assignment time, so a re-PUT during the
    # job can't make workers serve mixed generations of an input
    versions: Dict[str, int] = field(default_factory=dict)
    # times a live worker reported failure for this batch (deterministic
    # failures must eventually fail the JOB, not requeue forever)
    failures: int = 0
    # session-affinity target (request front door, dml_tpu/ingress/):
    # the worker that holds this batch's sessions' KV state from their
    # previous turns. BEST-EFFORT — the single-model assignment pass
    # gives the batch to this worker when it is free, and any free
    # worker otherwise; a dead or busy target never strands the batch.
    affinity: Optional[str] = None
    # token-streaming routing for ingress LM batches: input file ->
    # LIST of [client unique_name, request id] targets (several
    # requests may share one input). The executing worker exposes one
    # stream PER REQUEST on its data plane and notifies each client
    # (REQUEST_STREAM_READY) before decode begins.
    streams: Dict[str, List[Any]] = field(default_factory=dict)
    # ingress batches carry results INLINE in the batch ACK (when they
    # fit a datagram) instead of a replicated-store PUT + GET round
    # trip per batch: per-request serving cannot afford 3x-replicated
    # store objects per formed batch, and nothing ever get-output's an
    # ingress job. Oversized results fall back to the store path.
    inline_results: bool = False
    # SLO class of the requests this batch formed from (ingress;
    # formed batches are single-class by construction). None =
    # operator-submitted work. Classes sharing one model queue get
    # WEIGHTED fair shares of its free workers (`class_weights` /
    # `_take_batches`) instead of one FIFO.
    slo_class: Optional[str] = None
    # per-request trace contexts (dml_tpu/tracing.py wire dicts, one
    # per request, keyed to its input file via "f"): ride next to
    # slo_class through intake -> relay -> WORKER_TASK_REQUEST so the
    # executing worker's fetch/infer/put spans land in each request's
    # cross-node trace. Empty for operator jobs.
    traces: List[Dict[str, Any]] = field(default_factory=list)

    @property
    def key(self) -> Tuple[int, int]:
        return (self.job_id, self.batch_id)

    def trace_ctxs(self) -> List[TraceContext]:
        """Decoded SAMPLED contexts (the gate every instrumentation
        site wants); garbled entries drop silently."""
        out = []
        for e in self.traces:
            c = TraceContext.from_wire(e)
            if c is not None and c.sampled:
                out.append(c)
        return out


@dataclass
class JobState:
    """Coordinator-side bookkeeping for one submitted job (reference
    job_reqester_dict, worker.py:242-245)."""

    job_id: int
    model: str
    requester: str
    total_queries: int
    pending_batches: int
    done: bool = False
    error: Optional[str] = None  # set when the job FAILED (batch cap)
    # batch ids already counted done — guards double-decrement when a
    # falsely-suspected worker's ACK races the reassigned copy's ACK
    completed_batches: set = field(default_factory=set)
    # ACK-carried results of inline-results (ingress) batches, merged
    # across the job's batches; transient — NOT snapshotted (a
    # restored job's batches re-execute and re-deliver)
    inline_results: Optional[Dict[str, Any]] = None
    # last batch ACK's carried stage walls (fetch/backend/infer/put/
    # exec seconds): the router's per-request terminal attribution
    # source. Transient like inline_results.
    stage_timing: Optional[Dict[str, float]] = None


@dataclass
class Assignment:
    """An action for the service to perform: send this batch to this
    worker. `preempted` carries the batch that was displaced (already
    requeued at the front of its model's queue)."""

    worker: str
    batch: Batch
    preempted: Optional[Batch] = None
    # staged=True: a PIPELINE assignment — the worker should fetch and
    # decode this batch now but dispatch it only after its current
    # batch's inference completes (depth-2 worker pipelining)
    staged: bool = False


class Scheduler:
    """Deterministic scheduler state. All methods are synchronous and
    side-effect-free beyond their own state; time is injectable."""

    def __init__(
        self,
        costs: Optional[Dict[str, ModelCost]] = None,
        now: Callable[[], float] = time.time,
    ):
        self.costs: Dict[str, ModelCost] = dict(costs or {})
        self.now = now
        self.queues: Dict[str, Deque[Batch]] = {}
        self.in_progress: Dict[str, Batch] = {}  # worker -> batch
        # Worker pipelining (depth 2): with pipeline_depth > 1 the
        # single-model scheduler STAGES one extra batch per busy worker
        # so the worker overlaps batch N+1's store-fetch + host JPEG
        # decode + device dispatch with batch N's in-flight inference.
        # Default 1 preserves the reference's one-outstanding-batch-
        # per-worker rule (workers_tasks_dict, worker.py:54) exactly;
        # the service turns it up for serving. Dual-model rounds never
        # stage (fair-share preemption and staging interact badly:
        # a staged batch would instantly widen the preempting model's
        # footprint beyond its computed share).
        self.pipeline_depth = 1
        # per-slot capacity from the last schedule() call (worker ->
        # weight; absent = 1.0). Group primaries carry their group's
        # aggregate capacity here (jobs/groups.py).
        self.worker_weights: Dict[str, float] = {}
        self.prefetch: Dict[str, Batch] = {}  # worker -> staged batch
        self._revoked_stages: List[Tuple[str, Tuple[int, int]]] = []
        self.jobs: Dict[int, JobState] = {}  # in-flight only
        # finished jobs, bounded: serves late status queries + duplicate
        # ACKs without growing with coordinator lifetime
        self.done_jobs: Dict[int, JobState] = {}
        self.max_done_jobs = 1000
        # a batch failing this many times on LIVE workers fails its job
        # loudly instead of front-requeuing forever
        self.max_batch_failures = 5
        self._newly_failed: List[JobState] = []
        self._job_counter = 0
        # requeues observed (worker death + live-worker batch failure)
        # — the recovery evidence the failure-injection bench records
        self.requeue_count = 0
        # Per-class WEIGHTED fair share inside each model queue: when
        # batches of different SLO classes share a queue, free workers
        # split between the classes in weight proportion (class_split,
        # built on the dual-model fair_split_weighted enumeration)
        # instead of strict FIFO — sustained batch-class load can no
        # longer queue interactive requests behind its whole backlog.
        # Unknown/None classes weigh 1.0; set to {} to restore FIFO.
        self.class_weights: Dict[str, float] = {
            "interactive": 3.0, "batch": 1.0, "train": 0.5,
        }
        # model -> class -> batches granted (the cross-round deficit
        # memory that keeps single-slot rounds from starving the
        # light-weight class); reset when the model's queue drains
        self._class_served: Dict[str, Dict[Optional[str], int]] = {}
        # metrics (reference worker.py:485-495, 1000-1001); bounded
        # deques so a long-lived coordinator doesn't grow forever
        self.max_samples = 10_000
        self.query_counts: Dict[str, int] = {}
        # per model: (timestamp, exec_time_s, image_count)
        self.latency_samples: Dict[str, Deque[Tuple[float, float, int]]] = {}
        # per model: (timestamp, predicted_rate) per scheduling round
        self.rate_samples: Dict[str, Deque[Tuple[float, float]]] = {}
        # read-time C1 rate refresh: without this the gauge freezes at
        # its last batch-ACK value, so an idle coordinator would show
        # phantom traffic in every scrape/METRICS_PULL forever. Held
        # weakly by the registry — dies with this scheduler.
        METRICS.add_collector(self._refresh_rate_gauges)

    def reweight_classes(
        self, weights: Dict[str, float]
    ) -> Dict[str, float]:
        """Replace the per-class fair-share split — the autoscaler's
        capacity-reallocation actuation point. Weights must be positive
        and finite (a zero or NaN weight would silently starve a class
        forever, which is an outage, not a reallocation). The cross-
        round deficit memory resets so the new split takes effect from
        a clean slate instead of paying down debts accrued under the
        old one. Returns the previous map."""
        for k, v in weights.items():
            w = float(v)
            if not (w > 0.0) or w != w or w == float("inf"):
                raise ValueError(f"bad class weight {k}={v!r}")
        prev = dict(self.class_weights)
        self.class_weights = {k: float(v) for k, v in weights.items()}
        self._class_served.clear()
        return prev

    # ------------------------------------------------------------------
    # model config
    # ------------------------------------------------------------------

    def _refresh_gauges(self) -> None:
        """Queue-depth and busy-worker gauges (C5-size view); called
        wherever queues or in_progress change. O(active models)."""
        for m, q in self.queues.items():
            _M_QUEUE_DEPTH.set(len(q), model=m)
        _M_WORKERS_BUSY.set(len(self.in_progress))

    def _refresh_rate_gauges(self) -> None:
        """Trailing-10s C1 rate gauge, recomputed from the sample
        window NOW — runs on every batch ACK and (as a registry
        collector) before every exposition, so the gauge decays to
        zero on an idle coordinator exactly like the read-time
        c1_stats it mirrors. Bounded walk: newest-first, stops at the
        window edge."""
        t = self.now()
        for model, samples in self.latency_samples.items():
            recent = 0
            for ts, _, n in reversed(samples):
                if ts < t - 10.0:
                    break
                recent += n
            _M_RATE.set(recent / 10.0, model=model)

    def set_cost(self, model: str, cost: ModelCost) -> None:
        self.costs[model] = cost

    def set_batch_size(self, model: str, batch_size: int) -> None:
        """C3 verb (reference SET_BATCH_SIZE, worker.py:1028-1037):
        future jobs batch at the new size; queued batches are unchanged
        (matching the reference, which re-slices only new jobs)."""
        if batch_size <= 0:
            raise ValueError(f"batch_size must be positive, got {batch_size}")
        cost = self.costs.get(model)
        if cost is None:
            raise KeyError(f"unknown model {model!r}")
        self.costs[model] = cost.with_measurements(batch_size=batch_size)

    def _queue(self, model: str) -> Deque[Batch]:
        return self.queues.setdefault(model, deque())

    # ------------------------------------------------------------------
    # intake (reference handle_job_request + preprocess_job_request,
    # worker.py:176-245)
    # ------------------------------------------------------------------

    def next_job_id(self) -> int:
        self._job_counter += 1
        return self._job_counter

    def observe_job_id(self, job_id: int) -> None:
        """Keep the counter ahead of ids minted elsewhere (standby
        replaying the primary's relays)."""
        self._job_counter = max(self._job_counter, job_id)

    def submit_job(
        self,
        job_id: int,
        model: str,
        files: Sequence[str],
        n_queries: int,
        requester: str,
        replicas: Optional[Dict[str, List[str]]] = None,
        batch_size: Optional[int] = None,
        affinity: Optional[str] = None,
        streams: Optional[Dict[str, List[Any]]] = None,
        inline_results: bool = False,
        slo_class: Optional[str] = None,
        traces: Optional[List[Dict[str, Any]]] = None,
    ) -> JobState:
        """Wrap-around sample `n_queries` inputs from `files`, slice
        into batches of the model's current batch size, queue them.

        `batch_size` pins the slicing explicitly — the standby replays
        the primary's relayed value so shadow batch ids always match
        even if a C3 fanout datagram was lost. `affinity`/`streams`/
        `traces` are ingress metadata (see Batch) carried on every
        batch; trace entries follow their request's input file into
        its slice."""
        if not files:
            raise ValueError("no input files to sample from")
        if n_queries <= 0:
            raise ValueError("n_queries must be positive")
        if batch_size is not None:
            bs = batch_size
        else:
            cost = self.costs.get(model)
            bs = cost.batch_size if cost else 32
        if bs <= 0:
            raise ValueError(f"batch_size must be positive, got {bs}")
        inputs = [files[i % len(files)] for i in range(n_queries)]
        batches: List[Batch] = []
        for b, start in enumerate(range(0, n_queries, bs)):
            chunk = inputs[start : start + bs]
            chunk_set = set(chunk)
            batches.append(
                Batch(
                    job_id=job_id,
                    batch_id=b,
                    model=model,
                    files=chunk,
                    replicas={
                        f: (replicas or {}).get(f, []) for f in chunk
                    },
                    affinity=affinity,
                    streams={
                        f: list(v) for f, v in (streams or {}).items()
                        if f in chunk
                    },
                    inline_results=inline_results,
                    slo_class=slo_class,
                    traces=[
                        dict(e) for e in (traces or [])
                        if isinstance(e, dict)
                        and e.get("f") in chunk_set
                    ],
                )
            )
        q = self._queue(model)
        q.extend(batches)
        st = JobState(
            job_id=job_id,
            model=model,
            requester=requester,
            total_queries=n_queries,
            pending_batches=len(batches),
        )
        self.jobs[job_id] = st
        self.observe_job_id(job_id)
        self._refresh_gauges()
        return st

    # ------------------------------------------------------------------
    # scheduling (reference schedule_job, worker.py:255-495)
    # ------------------------------------------------------------------

    def active_models(self) -> List[str]:
        """Models with queued work, in deterministic order."""
        return sorted(m for m, q in self.queues.items() if q)

    def schedule(
        self,
        workers: Sequence[str],
        weights: Optional[Dict[str, float]] = None,
    ) -> List[Assignment]:
        """Compute assignments for this round.

        `workers` is the current live worker pool (coordinator and
        standby excluded by the caller, mirroring the reference's
        H3..H10 set, worker.py:52). Returns the assignments to send;
        in-progress state is updated as if they were delivered.

        `weights` carries per-slot capacity for pool entries that are
        not single chips — a formed tensor-parallel worker group
        (jobs/groups.py) occupies one slot under its primary's name
        with weight = aggregate capacity. Omitted entries weigh 1.0.
        The fair split and the predicted-rate samples use the weights;
        assignment mechanics (one outstanding batch per slot, staging,
        preemption, requeue) are unchanged — a group is exactly one
        worker to them.
        """
        self.worker_weights = dict(weights or {})
        # staged (pipeline) batches drain their model's queue ahead of
        # execution; if a SECOND model's work shows up, un-stage them
        # so the fair split sees the full picture — otherwise the new
        # model waits behind work that hasn't even dispatched
        staged_models = {b.model for b in self.prefetch.values()}
        queued_models = {m for m, q in self.queues.items() if q}
        if self.prefetch and len(staged_models | queued_models) > 1:
            self._unstage_all()
        active = self.active_models()
        # drained models drop their class-deficit memory: a later mix
        # starts fresh instead of replaying an old imbalance as a burst
        for m in list(self._class_served):
            if m not in active:
                del self._class_served[m]
        if not active or not workers:
            return []
        workers = list(workers)
        if len(active) == 1:
            out = self._assign_free(active[0], workers)
        else:
            out = self._schedule_two(active[0], active[1], workers)
        self._record_rates(workers)
        self._refresh_gauges()
        return out

    def _unstage_all(self) -> None:
        """Return every staged batch to its queue front and record the
        revocation so the service can tell the workers (a worker whose
        stage survives here would dispatch it anyway; completion dedup
        makes that merely wasteful, not wrong)."""
        for w, b in list(self.prefetch.items()):
            self._queue(b.model).appendleft(b)
            self._revoked_stages.append((w, b.key))
        self.prefetch.clear()

    def pop_revoked_stages(self) -> List[Tuple[str, Tuple[int, int]]]:
        """(worker, batch key) stage revocations since the last call."""
        out, self._revoked_stages = self._revoked_stages, []
        return out

    def _free_workers(self, workers: Sequence[str]) -> List[str]:
        return [w for w in workers if w not in self.in_progress]

    def _take_batches(self, model: str, k: int) -> List[Batch]:
        """Pop up to `k` batches of `model` for this round — FIFO when
        the queue is single-class (or `class_weights` is empty),
        otherwise a WEIGHTED split of the k slots between the queued
        SLO classes:

        - two classes (the DEFAULT_CLASSES shape): `class_split`, the
          dual-model fair_split_weighted enumeration with each class
          presenting the model's cost scaled by its weight — slots
          land in weight proportion;
        - more: proportional stride over cumulative weighted grants.

        Slots a class cannot fill redistribute; a cross-round deficit
        memory (`_class_served`, reset when the queue drains) hands a
        zero-slot class its overdue slot, so k=1 rounds cannot starve
        the light class. FIFO order is preserved WITHIN each class —
        the split changes who goes next, never reorders a class's own
        work."""
        q = self._queue(model)
        n = min(k, len(q))
        if n <= 0:
            return []
        order: List[Optional[str]] = []
        per_class: Dict[Optional[str], int] = {}
        for b in q:
            if b.slo_class not in per_class:
                order.append(b.slo_class)
            per_class[b.slo_class] = per_class.get(b.slo_class, 0) + 1
        if not self.class_weights or len(order) == 1:
            return [q.popleft() for _ in range(n)]
        order.sort(key=str)  # deterministic, not arrival-dependent
        w = {
            c: max(float(self.class_weights.get(c or "", 1.0)), 1e-9)
            for c in order
        }
        served = self._class_served.setdefault(model, {})
        counts: Dict[Optional[str], int]
        if len(order) == 2:
            cost = self.costs.get(model, ModelCost(0, 0, 0.001))
            c1, c2 = order
            n1, n2 = class_split(n, cost, w[c1], w[c2])
            counts = {c1: n1, c2: n2}
        else:
            counts = {c: 0 for c in order}
            for _ in range(n):
                pick = min(order, key=lambda c: (
                    (served.get(c, 0) + counts[c]) / w[c], str(c)
                ))
                counts[pick] += 1
        # cap by availability, redistribute the leftovers
        spare = 0
        for c in order:
            if counts[c] > per_class[c]:
                spare += counts[c] - per_class[c]
                counts[c] = per_class[c]
        while spare > 0:
            grantable = [c for c in order if counts[c] < per_class[c]]
            if not grantable:
                break
            pick = min(grantable, key=lambda c: (
                (served.get(c, 0) + counts[c]) / w[c], str(c)
            ))
            counts[pick] += 1
            spare -= 1
        # deficit correction: a class with work but zero slots takes
        # one from the most-ahead donor once its weighted grant count
        # trails by a full slot (otherwise k=1 rounds always go to the
        # heavy class and the light one starves forever)
        for c in order:
            if counts[c] == 0 and per_class[c] > 0:
                donors = [d for d in order if counts[d] > 0]
                if not donors:
                    continue
                d = max(donors, key=lambda d: (
                    (served.get(d, 0) + counts[d] - 1) / w[d], str(d)
                ))
                if (served.get(c, 0) + 1) / w[c] <= (
                    served.get(d, 0) + counts[d] - 1
                ) / w[d] + 1e-9:
                    counts[d] -= 1
                    counts[c] += 1
        # single O(n) pass: partition the queue into granted batches
        # (per-class quota, FIFO within class) and the rebuilt
        # remainder — deque.remove per grant would rescan the whole
        # queue per slot, quadratic in exactly the deep-backlog
        # regime the class weighting exists for
        out: List[Batch] = []
        rest: List[Batch] = []
        taken = {c: 0 for c in order}
        want = sum(counts.values())
        for b in q:
            if (len(out) < want
                    and taken.get(b.slo_class, 0)
                    < counts.get(b.slo_class, 0)):
                out.append(b)
                taken[b.slo_class] = taken.get(b.slo_class, 0) + 1
            else:
                rest.append(b)
        q.clear()
        q.extend(rest)
        for b in out:
            served[b.slo_class] = served.get(b.slo_class, 0) + 1
        return out

    def _assign_free(self, model: str, workers: Sequence[str]) -> List[Assignment]:
        """Single-model case (worker.py:257-300): pour the queue onto
        every free worker. Batches carrying a session-affinity target
        (ingress) get a preference pass first: a batch whose affinity
        worker is FREE this round lands there (the node holding its
        sessions' KV state); everything else — including affinity
        batches whose target is busy or gone — pours in reference
        FIFO order. Affinity is a placement preference, never a
        gate: no batch waits for its target."""
        q = self._queue(model)
        out: List[Assignment] = []
        free = self._free_workers(workers)
        if any(b.affinity for b in q):
            free_set = set(free)
            # membership tested INSIDE the loop: two queued batches
            # sharing an affinity target must not both land on it —
            # the second assignment would silently overwrite the
            # first in in_progress and orphan that batch forever
            for batch in list(q):
                if batch.affinity and batch.affinity in free_set:
                    q.remove(batch)
                    self.in_progress[batch.affinity] = batch
                    out.append(
                        Assignment(worker=batch.affinity, batch=batch)
                    )
                    free_set.discard(batch.affinity)
            free = [w for w in free if w in free_set]
        for w, batch in zip(free, self._take_batches(model, len(free))):
            self.in_progress[w] = batch
            out.append(Assignment(worker=w, batch=batch))
        if self.pipeline_depth > 1:
            stageable = [
                w for w in workers
                if w in self.in_progress and w not in self.prefetch
            ]
            for w, batch in zip(
                stageable, self._take_batches(model, len(stageable))
            ):
                self.prefetch[w] = batch
                out.append(Assignment(worker=w, batch=batch, staged=True))
        return out

    def _schedule_two(
        self, model_a: str, model_b: str, workers: Sequence[str]
    ) -> List[Assignment]:
        """Dual-model case (worker.py:303-480): fair split of the pool
        by predicted rate, then grow each model to its share, preempting
        the other model's workers when the split demands it."""
        cost_a = self.costs.get(model_a, ModelCost(0, 0, 0.001))
        cost_b = self.costs.get(model_b, ModelCost(0, 0, 0.001))
        weights = [self.worker_weights.get(w, 1.0) for w in workers]
        want_a, want_b, a_heavy = fair_split_weighted_directed(
            weights, cost_a, cost_b
        )
        # honor the split's placement direction: the model whose count
        # refers to the HEAVIEST slots must grow heaviest-first, the
        # other lightest-first, or a count like "1 = the weight-2
        # group" lands on an arbitrary single chip and the realized
        # split is worse than the unweighted reference's. With a
        # uniform pool the order stays untouched (reference behavior,
        # including which worker takes which batch).
        if any(x != 1.0 for x in weights):
            desc = sorted(
                workers,
                key=lambda w: (-self.worker_weights.get(w, 1.0), w),
            )
            asc = list(reversed(desc))
            workers_a = desc if a_heavy else asc
            workers_b = asc if a_heavy else desc
        else:
            workers_a = workers_b = list(workers)
        # cap wants by actual queue depth + what's already running
        running_a = [w for w, b in self.in_progress.items() if b.model == model_a and w in workers]
        running_b = [w for w, b in self.in_progress.items() if b.model == model_b and w in workers]
        want_a = min(want_a, len(self._queue(model_a)) + len(running_a))
        want_b = min(want_b, len(self._queue(model_b)) + len(running_b))
        out: List[Assignment] = []
        out += self._grow_to(model_a, want_a, model_b, workers_a)
        out += self._grow_to(model_b, want_b, model_a, workers_b)
        return out

    def _grow_to(
        self, model: str, want: int, victim_model: str, workers: Sequence[str]
    ) -> List[Assignment]:
        """Assign queued batches of `model` until it occupies `want`
        workers: free workers first, then preempt `victim_model`'s
        workers beyond *their* fair share (preempted batch returns to
        the front of its queue — reference worker.py:389-408)."""
        q = self._queue(model)
        out: List[Assignment] = []
        have = sum(
            1 for w, b in self.in_progress.items() if b.model == model and w in workers
        )
        # free workers first. The draw goes through _take_batches so
        # the per-class weighted split applies in dual-model rounds
        # too (an unclassed/single-class queue reduces to the exact
        # popleft order) — one model's queue being all batch-class
        # must not starve the other class just because a second model
        # is active.
        free = self._free_workers(workers)
        take = min(len(free), max(0, want - have), len(q))
        for w, batch in zip(free, self._take_batches(model, take)):
            self.in_progress[w] = batch
            out.append(Assignment(worker=w, batch=batch))
            have += 1
        # then preempt the other model's surplus workers
        if have < want and q:
            victims = [
                w
                for w, b in self.in_progress.items()
                if b.model == victim_model and w in workers
            ]
            n_victims = len(victims)
            surplus = victims[: max(0, n_victims - (len(workers) - want))]
            take = min(len(surplus), max(0, want - have), len(q))
            for w, batch in zip(surplus, self._take_batches(model, take)):
                # (no stage handling here: schedule() un-stages every
                # prefetch batch before a dual-model round can run)
                displaced = self.in_progress[w]
                self._queue(displaced.model).appendleft(displaced)
                _M_PREEMPTIONS.inc()
                self.in_progress[w] = batch
                out.append(Assignment(worker=w, batch=batch, preempted=displaced))
                have += 1
        return out

    def _record_rates(self, workers: Sequence[str]) -> None:
        """Per-round predicted-rate sample (reference worker.py:485-495)."""
        t = self.now()
        for model in self.active_models():
            cost = self.costs.get(model)
            if cost is None:
                continue
            n = sum(
                self.worker_weights.get(w, 1.0)
                for w, b in self.in_progress.items()
                if b.model == model and w in workers
            )
            self.rate_samples.setdefault(
                model, deque(maxlen=self.max_samples)
            ).append((t, query_rate(cost, n)))

    # ------------------------------------------------------------------
    # completion + failure (reference worker.py:989-1026, 1279-1306)
    # ------------------------------------------------------------------

    def on_batch_done(
        self, worker: str, job_id: int, batch_id: int, exec_time: float, n_images: int
    ) -> Optional[JobState]:
        """A worker ACKed a batch. Frees the worker, updates metrics;
        returns the JobState iff the whole job just completed."""
        cur = self.in_progress.get(worker)
        if cur is not None and cur.key == (job_id, batch_id):
            del self.in_progress[worker]
            # promote the staged batch: the worker moved on to it the
            # moment its previous inference finished
            nxt = self.prefetch.pop(worker, None)
            if nxt is not None:
                self.in_progress[worker] = nxt
        elif self.prefetch.get(worker) is not None and self.prefetch[
            worker
        ].key == (job_id, batch_id):
            # out-of-order ACK (the staged batch drained first): clear
            # the stage; the primary is still in flight on this worker
            del self.prefetch[worker]
        st = self.jobs.get(job_id)
        if st is None or batch_id in st.completed_batches:
            return None  # unknown job, already-finished job, or dup ACK
        st.completed_batches.add(batch_id)
        # the duplicate copy may still be queued (requeued after a
        # false suspicion) — drop it so no worker re-runs it
        q = self._queue(st.model)
        for b in list(q):
            if b.key == (job_id, batch_id):
                q.remove(b)
                break
        model = st.model
        self.query_counts[model] = self.query_counts.get(model, 0) + n_images
        t = self.now()
        samples = self.latency_samples.setdefault(
            model, deque(maxlen=self.max_samples)
        )
        samples.append((t, exec_time, n_images))
        # registry mirror of the C1/C2 console: counters + histograms
        # METRICS_PULL can merge cluster-wide. Only the LIVE
        # coordinator counts (shadow_prune deliberately does not, or a
        # standby's shadow would double every query in the aggregate)
        _M_QUERIES.inc(n_images, model=model)
        _M_BATCH_EXEC.observe(exec_time, model=model)
        if n_images > 0:
            _M_QUERY_LAT.observe(exec_time / n_images, model=model)
        self._refresh_rate_gauges()
        self._refresh_gauges()
        st.pending_batches -= 1
        if st.pending_batches <= 0 and not st.done:
            st.done = True
            _M_JOBS_DONE.inc(model=model)
            self._retire_job(job_id)
            return st
        return None

    def _retire_job(self, job_id: int) -> None:
        st = self.jobs.pop(job_id, None)
        if st is not None:
            self.done_jobs[job_id] = st
        while len(self.done_jobs) > self.max_done_jobs:
            del self.done_jobs[next(iter(self.done_jobs))]

    def job_state(self, job_id: int) -> Optional[JobState]:
        """In-flight or recently-finished job state (status endpoint)."""
        return self.jobs.get(job_id) or self.done_jobs.get(job_id)

    def on_batch_failed(self, worker: str, job_id: int, batch_id: int) -> Optional[Batch]:
        """A live worker reported it could not run its batch (e.g. no
        replica served an input): requeue at the front and free the
        worker, exactly like a worker death but scoped to the matching
        batch key."""
        cur = self.in_progress.get(worker)
        if cur is None or cur.key != (job_id, batch_id):
            staged = self.prefetch.get(worker)
            if staged is None or staged.key != (job_id, batch_id):
                return None
            # the STAGED batch failed (e.g. its prepare found no live
            # replica): clear the stage; the primary keeps running
            del self.prefetch[worker]
            cur = staged
        else:
            del self.in_progress[worker]
            nxt = self.prefetch.pop(worker, None)
            if nxt is not None:
                # worker proceeds to its staged batch after the failure
                self.in_progress[worker] = nxt
        st = self.jobs.get(job_id)
        if st is None or batch_id in st.completed_batches:
            # unknown/retired job or already done elsewhere: free the
            # worker but never requeue (a deterministically-failing
            # orphan batch would loop forever)
            return None
        self._note_requeue(cur, worker)
        cur.failures += 1
        if cur.failures >= self.max_batch_failures:
            # deterministic failure: fail the JOB loudly; an infinite
            # fail/requeue loop would pin a worker forever while the
            # client waits
            self.fail_job(
                job_id,
                f"batch {batch_id} failed {cur.failures} times on live "
                "workers",
            )
            return None
        self._queue(cur.model).appendleft(cur)
        self.requeue_count += 1
        _M_REQUEUES.inc()
        self._refresh_gauges()
        return cur

    def fail_job(self, job_id: int, error: str) -> Optional[JobState]:
        """Retire a job as FAILED: record the error, purge its queued
        batches, notify path via pop_failed_jobs. Used by the
        coordinator (batch cap) and by the standby applying a
        JOB_FAILED_RELAY so failover can't resurrect the job."""
        st = self.jobs.get(job_id)
        if st is None:
            return None
        st.error = error
        st.done = True
        _M_JOBS_FAILED.inc(model=st.model)
        q = self._queue(st.model)
        for b in [b for b in q if b.job_id == job_id]:
            q.remove(b)
        self._retire_job(job_id)
        self._newly_failed.append(st)
        self._refresh_gauges()
        return st

    def pop_failed_jobs(self) -> List[JobState]:
        """Jobs failed since the last call (service notifies clients)."""
        out, self._newly_failed = self._newly_failed, []
        return out

    def on_worker_failed(self, worker: str) -> Optional[Batch]:
        """Worker died: requeue its in-flight batch at the FRONT
        (reference handle_failures_if_pending_status,
        worker.py:1279-1306). Returns the requeued batch, if any."""
        staged = self.prefetch.pop(worker, None)
        if staged is not None:
            self._queue(staged.model).appendleft(staged)
            self.requeue_count += 1
            _M_REQUEUES.inc()
            self._note_requeue(staged, worker)
        batch = self.in_progress.pop(worker, None)
        if batch is not None:
            # primary requeued after the staged batch so it lands at
            # the very front (it was assigned first)
            self._queue(batch.model).appendleft(batch)
            self.requeue_count += 1
            _M_REQUEUES.inc()
            self._note_requeue(batch, worker)
        self._refresh_gauges()
        return batch

    @staticmethod
    def _note_requeue(batch: Batch, worker: str) -> None:
        """Tail-exemplar marker per affected request trace: a requeue
        is exactly the event that explains a later deadline miss, so
        it is captured regardless of the head sampling decision."""
        for e in batch.traces:
            TRACER.note_exemplar(
                TraceContext.from_wire(e), "requeue",
                labels={"worker": worker, "job": batch.job_id,
                        "batch": batch.batch_id},
            )

    def drop_worker(self, worker: str) -> None:
        """Forget a worker without requeueing (voluntary leave after
        its batch was handled)."""
        self.in_progress.pop(worker, None)
        self.prefetch.pop(worker, None)

    # ------------------------------------------------------------------
    # standby shadow maintenance (reference worker.py:887-897, 965-986)
    # ------------------------------------------------------------------

    def shadow_prune(self, job_id: int, batch_id: int, n_images: int) -> None:
        """Standby side: the primary reported this batch complete —
        remove it wherever it is (queued here since the standby never
        assigns) and update the job count (reference worker.py:965-986)."""
        st = self.jobs.get(job_id)
        if st is None or batch_id in st.completed_batches:
            return
        st.completed_batches.add(batch_id)
        q = self._queue(st.model)
        for b in list(q):
            if b.key == (job_id, batch_id):
                q.remove(b)
                break
        self.query_counts[st.model] = self.query_counts.get(st.model, 0) + n_images
        st.pending_batches -= 1
        if st.pending_batches <= 0:
            st.done = True
            self._retire_job(job_id)

    # ------------------------------------------------------------------
    # metrics read-outs (C1/C2/C5; reference worker.py:1394-1428,
    # 1744-1808)
    # ------------------------------------------------------------------

    def c1_stats(self, window: float = 10.0) -> Dict[str, Dict[str, float]]:
        """Per-model query count + rate over the trailing window
        (reference C1, worker.py:1744-1787)."""
        t = self.now()
        out: Dict[str, Dict[str, float]] = {}
        for model in sorted(set(self.query_counts) | set(self.latency_samples)):
            recent = [
                n
                for (ts, _, n) in self.latency_samples.get(model, [])
                if ts >= t - window
            ]
            out[model] = {
                "total_queries": float(self.query_counts.get(model, 0)),
                "rate_per_sec": sum(recent) / window if window > 0 else 0.0,
            }
        return out

    def c2_stats(self, model: str) -> Dict[str, float]:
        """Mean/stdev/percentiles of per-image processing time
        (reference calculate_c2_command_params, worker.py:1394-1428)."""
        samples = self.latency_samples.get(model, [])
        per_image = [et / max(n, 1) for (_, et, n) in samples if n > 0]
        if not per_image:
            return {"count": 0.0}
        per_image.sort()

        def pct(p: float) -> float:
            i = min(len(per_image) - 1, max(0, int(round(p * (len(per_image) - 1)))))
            return per_image[i]

        return {
            "count": float(len(per_image)),
            "mean": statistics.fmean(per_image),
            "stdev": statistics.stdev(per_image) if len(per_image) > 1 else 0.0,
            "p25": pct(0.25),
            "p50": pct(0.50),
            "p75": pct(0.75),
            "p90": pct(0.90),
            "p99": pct(0.99),
        }

    def c5_assignments(self) -> Dict[str, Any]:
        """Current worker -> batch map (reference C5, worker.py:1807-1808)."""
        out = {
            w: {"job": b.job_id, "batch": b.batch_id, "model": b.model, "images": len(b.files)}
            for w, b in sorted(self.in_progress.items())
        }
        for w, b in sorted(self.prefetch.items()):
            out[f"{w} (staged)"] = {
                "job": b.job_id, "batch": b.batch_id, "model": b.model,
                "images": len(b.files), "staged": True,
            }
        return out

    def queue_depths(self) -> Dict[str, int]:
        return {m: len(q) for m, q in self.queues.items() if q}

    def batch_size_of(self, model: str) -> int:
        cost = self.costs.get(model)
        return cost.batch_size if cost else 32

    def all_queued_batches(self) -> List[Batch]:
        return [b for q in self.queues.values() for b in q]

    # ------------------------------------------------------------------
    # snapshot / restore (net-new vs the reference, whose scheduler
    # state survives only leader failover via the hot-standby relays —
    # SURVEY §5 "Checkpoint/resume: ... not via disk". This makes the
    # job pipeline survive a FULL cluster restart: the coordinator
    # snapshots to the replicated store and a fresh leader restores.)
    # ------------------------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        """JSON-able dump of all scheduling state. In-flight batches
        are folded back into their queue fronts (their workers won't
        exist after a restart — same semantics as worker failure)."""
        def batch_dict(b: Batch) -> Dict[str, Any]:
            return {
                "job_id": b.job_id, "batch_id": b.batch_id,
                "model": b.model, "files": list(b.files),
                "replicas": {f: list(r) for f, r in b.replicas.items()},
                "versions": dict(b.versions),
                "failures": b.failures,
                "affinity": b.affinity,
                "streams": {f: list(v) for f, v in b.streams.items()},
                "slo_class": b.slo_class,
                "traces": [dict(e) for e in b.traces],
            }

        queues: Dict[str, List[Dict[str, Any]]] = {
            m: [batch_dict(b) for b in q] for m, q in self.queues.items() if q
        }
        # staged batches fold in first so the in-progress primaries end
        # up ahead of them at the queue front
        for worker, b in self.prefetch.items():
            queues.setdefault(b.model, []).insert(0, batch_dict(b))
        for worker, b in self.in_progress.items():
            queues.setdefault(b.model, []).insert(0, batch_dict(b))
        return {
            "job_counter": self._job_counter,
            "queues": queues,
            "jobs": {
                str(j.job_id): {
                    "job_id": j.job_id, "model": j.model,
                    "requester": j.requester,
                    "total_queries": j.total_queries,
                    "pending_batches": j.pending_batches,
                    "done": j.done,
                    "error": j.error,
                    "completed_batches": sorted(j.completed_batches),
                }
                for j in self.jobs.values()
            },
            "query_counts": dict(self.query_counts),
            "costs": {
                m: {
                    "load_time": c.load_time, "first_query": c.first_query,
                    "per_query": c.per_query,
                    "download_time": c.download_time,
                    "batch_size": c.batch_size, "resident": c.resident,
                }
                for m, c in self.costs.items()
            },
        }

    def restore(self, snap: Dict[str, Any]) -> None:
        """Load a snapshot(). Replaces queues/jobs/counters; metrics
        samples start fresh (rates are meaningless across a restart)."""
        self._job_counter = max(self._job_counter, int(snap["job_counter"]))
        for m, c in snap.get("costs", {}).items():
            self.costs[m] = ModelCost(**c)
        self.queues = {
            m: deque(Batch(**b) for b in batches)
            for m, batches in snap.get("queues", {}).items()
        }
        self.in_progress = {}
        self.prefetch = {}
        self.jobs = {}
        for j in snap.get("jobs", {}).values():
            completed = set(j.pop("completed_batches", []))
            state = JobState(**j)
            state.completed_batches = completed
            self.jobs[state.job_id] = state
        self.query_counts = dict(snap.get("query_counts", {}))

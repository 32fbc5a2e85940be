"""Typed cluster metrics, tracing, profiling, and structured logging.

The reference system's defining operator surface is the coordinator's
live console: C1 prints the 10-second query rate and total query count
per model, C2 the per-query latency mean/percentiles/std per model, C3
confirms batch-size changes, C5 the current worker->batch assignments
(reference worker.py:1394-1428, 1744-1808). This module is the
generalization of that console: a typed, process-wide
metrics registry every subsystem writes into, plus the exposition
surfaces (Prometheus text, JSON dumps, leader-aggregated METRICS_PULL,
bench-artifact blocks) that make the numbers reachable.

Metric model
------------

- ``Counter`` — monotonically increasing totals (queries served,
  tokens decoded, datagrams sent). Merge across nodes by summing.
- ``Gauge`` — instantaneous values (active slots, queue depth,
  trailing query rate). Merge by summing (cluster capacity view).
- ``Histogram`` — streaming distributions over FIXED LOG-SPACED
  buckets; p50/p95/p99 are computed from the bucket counts with
  geometric interpolation, so percentiles need O(buckets) memory, are
  mergeable across nodes, and never require keeping raw samples.

All three take labels (``model=``, ``role=``, ``peer=``, ``type=``);
one metric object fans out into per-label-set children. Updates are
host-side, O(1), lock-protected dict writes — they live OUTSIDE any
device step, so instrumentation cannot perturb a compiled
program (the continuous-batching decode path updates a handful of
counters per CHUNK dispatch, not per token).

Reference C1–C5 -> registry map
-------------------------------

- **C1** (per-model query count + 10 s rate): ``jobs_queries_total``
  counter + ``jobs_query_rate_per_s`` gauge (scheduler refreshes the
  trailing-window rate on every batch ACK).
- **C2** (per-query processing-time mean/std/percentiles):
  ``jobs_query_latency_seconds`` histogram per model — mean from
  sum/count, p50/p95/p99 from the log buckets. The exact-sample C2
  console (``Scheduler.c2_stats``) remains for parity with the
  reference; the histogram is the mergeable cluster-wide form.
- **C3** (batch size): ``jobs_batch_exec_seconds`` per model shows the
  effect; the authoritative setting stays in the scheduler cost model.
- **C5** (worker->batch assignments): ``jobs_workers_busy`` gauge +
  ``Scheduler.c5_assignments()`` for the exact map.

Beyond the reference (net-new subsystems get the same treatment):
``lm_server_*`` (queue wait, prefill dispatch, per-step decode tokens,
slot occupancy, compile events, readback stalls), ``worker_*``
(fetch/infer/put stage timings, decode-cache hits),
``jobs_pipeline_depth`` / ``jobs_depth_*`` (the probe-adaptive
worker-pipelining controller: depth in force, per-phase probe-rate
histogram by depth, probe-cycle counters by trigger and aborts),
``jobs_group_*`` (tensor-parallel worker groups, jobs/groups.py:
``jobs_group_formed`` gauge — 1 while every member is alive and
schedulable, ``jobs_group_members_alive`` gauge,
``jobs_group_degradations_total`` / ``jobs_group_reforms_total``
edge counters, ``jobs_group_batches_total`` batches served on a
group's sharded engine, ``jobs_group_requeues_total`` primary
in-flight batches requeued by a degradation — all labeled
``group=``),
``lm_sharded_*`` (sharded LM serving, inference/lm_sharded.py:
``lm_sharded_batches_total`` LM batches served on a group engine
labeled ``group=``/``mode=`` (resident|gather|disagg),
``lm_sharded_tokens_total`` generated tokens delivered by
group-sharded serving, ``lm_sharded_prefill_slabs_total`` KV-cache
slabs built by prefill-role workers),
``jobs_kv_handoff_*`` (the disaggregated prefill->decode handoff:
``jobs_kv_handoff_total`` labeled ``result=`` ok|fallback — a
fallback means the decode primary prefilled locally after a failed
handoff, a throughput event never a correctness one —
``jobs_kv_handoff_bytes_total`` serialized slab bytes pulled over
the data plane, ``jobs_kv_handoff_seconds`` per-batch prefill RPC +
slab pull wall),
``request_*`` (the SLO-aware request front door, dml_tpu/ingress/:
``request_admitted_total`` / ``request_completed_total`` per SLO
class, ``request_shed_total`` admission sheds labeled
``slo=``/``reason=`` (queue_full | deadline_unmeetable),
``request_rejected_total`` post-admission typed rejections,
``request_deadline_miss_total`` completions past their deadline —
labeled ``stage=`` with the miss's DOMINANT stage from its trace
attribution (formation | dispatch | fetch | infer | put |
unattributed), so the counter alone says WHERE the tail is lost,
``request_queue_wait_seconds`` admission->dispatch wait and
``request_e2e_latency_seconds`` admission->completion latency
histograms per class — the p50/p95/p99 source of the
``request_serving`` bench section — ``request_in_flight`` gauge,
``request_batch_fill_fraction`` / ``request_batch_formation_seconds``
continuous-batch-formation quality, and
``request_stream_tokens_total`` LM tokens pushed into per-request
data-plane token streams on workers),
``cluster_*`` (SWIM suspicion/failure/false-positive events,
alive-node gauge), ``membership_gossip_*`` (the bounded delta-gossip
piggyback: payloads built and member entries carried, labeled
``mode=`` delta|full — the O(K)-vs-O(N) per-datagram story the
``control_plane_scale`` bench scores), ``metrics_relay_*`` (two-level
METRICS_PULL aggregation: relay-shard pulls by ``role=`` leader|relay,
per-shard wall, and shards that fell back to direct pulls),
``store_report_delta_*`` (the replica inventory re-report fan-in:
reports and entries by ``kind=`` delta|full plus unchanged ticks that
sent nothing), ``transport_*`` (datagram + byte counters by
message type), and ``store_*`` (put/get/replication timing and
counts).

Exposition
----------

- ``METRICS.snapshot()`` — JSON-able dump (sparse buckets) used by the
  ``METRICS_PULL`` wire message: the leader pulls every node's
  snapshot and ``merge_snapshots`` folds them into one cluster view
  (``Node.pull_cluster_metrics``), the analog of the
  reference coordinator's console.
- ``to_prometheus_text()`` — Prometheus exposition format (CLI
  ``profile metrics prom``), scrape-ready.
- ``bench_metrics_block()`` — the ``metrics`` block a bench artifact
  embeds so it carries per-stage breakdowns.

In-process simulations (tests) run many nodes in ONE process sharing
this module-global registry; snapshots carry the pid and
``merge_snapshots`` counts each process once, so the sim's cluster
totals equal the (shared) registry instead of multiplying by the node
count, while real one-process-per-node deployments sum normally.

Also here: ``profile()`` (a torch.profiler trace into a
directory), ``span()`` (wall-clock spans), ``jsonl_logging()``.

Metric map (lint-enforced)
--------------------------

The complete registry, one metric per 4-space-indented line. This map
is MACHINE-READ: ``tools/dmllint.py`` (rule drift-metrics-map, run by
tier-1 via tests/test_dmllint.py) fails when a metric is registered in
``dml_tpu/`` but missing here, or listed here but registered nowhere —
the map cannot silently desynchronize from the code again. Add the
line when you add the metric.

    alert_fired_total                alert firing transitions by name= severity=
    alert_firing                     currently-firing alerts by name=
    alert_relays_total               ledger transitions relayed to standby
    alert_resolved_total             alert resolved transitions by name=
    autoscale_decisions_total        decision-ledger transitions by kind= event=
    autoscale_pool_size              worker-pool size the autoscaler last observed
    autoscale_relays_total           decision events relayed to standby
    autoscale_suppressed_total       decisions withheld by reason= (liar/floor/...)
    cluster_alive_nodes              SWIM live-member gauge
    cluster_failover_recovery_seconds  chaos: leader-kill -> converged wall
    cluster_false_positives_total    SWIM suspicions that proved alive
    cluster_node_failures_total      SWIM members declared failed
    cluster_suspicions_total         SWIM suspicion events
    coordinator_batch_acks_total     batch ACKs seen by the coordinator
    jobs_batch_exec_seconds          per-model batch execution wall
    jobs_completed_total             jobs reaching terminal success
    jobs_depth_probe_aborts_total    depth probes aborted (stall/timeout)
    jobs_depth_probe_qps             probe-phase throughput by depth
    jobs_depth_probes_total          depth probe cycles by trigger
    jobs_failed_total                jobs retired at the failure cap
    jobs_group_batches_total         batches served on a group engine
    jobs_group_degradations_total    group formed -> degraded edges
    jobs_group_formed                1 while a group is schedulable
    jobs_group_members_alive         live members per group
    jobs_group_reforms_total         group degraded -> formed edges
    jobs_group_requeues_total        primary in-flight batches requeued
    jobs_group_reshape_chips         chips in the mesh in force per group
    jobs_group_reshapes_total        collapsed-shape changes (reform ladder)
    jobs_kv_handoff_bytes_total      serialized KV slab bytes pulled
    jobs_kv_handoff_seconds          prefill RPC + slab pull wall
    jobs_kv_handoff_total            disagg handoffs by result ok|fallback
    jobs_pipeline_depth              worker-pipelining depth in force
    jobs_preemptions_total           running batches preempted
    jobs_queries_total               C1 per-model query counter
    jobs_query_latency_seconds       C2 per-query latency histogram
    jobs_query_rate_per_s            C1 trailing 10 s query rate
    jobs_queue_depth                 schedulable batches per model
    jobs_requeues_total              batches requeued after worker loss
    jobs_workers_busy                C5 workers-with-assignments gauge
    lm_kv_cache_bytes                prefix-cache resident host bytes
    lm_kv_cache_entries              live prefix-cache entries
    lm_kv_cache_evictions_total      prefix-cache entries evicted
    lm_kv_cache_hits_total           warm starts from cached prefixes
    lm_kv_cache_misses_total         lookups with no usable prefix
    lm_kv_cache_tokens_saved_total   prompt tokens not re-prefilled
    lm_server_compile_events_total   decode-graph compile events
    lm_server_decode_tokens_total    tokens decoded (all slots)
    lm_server_prefill_dispatch_seconds  prefill dispatch wall
    lm_server_queue_wait_seconds     request queue wait
    lm_server_readback_seconds       device->host readback stalls
    lm_server_requests_completed_total  LM requests finished
    lm_server_requests_total         LM requests admitted
    lm_server_slot_occupancy         busy decode slots per dispatched step
    lm_server_slots_active           busy decode slots
    lm_server_slots_total            configured decode slots
    lm_server_step_seconds           decode step wall
    lm_server_steps_total            decode steps executed
    lm_sharded_batches_total         LM batches on a group engine by mode
    lm_sharded_prefill_slabs_total   KV slabs built by prefill workers
    lm_sharded_tokens_total          tokens from group-sharded serving
    lm_specdec_accepted_total        draft tokens accepted by verify
    lm_specdec_disabled_total        spec-decode disable events by reason
    lm_specdec_proposed_total        draft tokens proposed to verify
    membership_gossip_entries_total  gossip entries carried by mode
    membership_gossip_exchanges_total  gossip payloads built by mode
    membership_join_admitted_total   runtime joins admitted (new|rejoin)
    membership_join_rejected_total   JOIN_REQUESTs rejected by reason
    membership_leave_rejected_total  LEAVE announcements rejected by reason
    membership_leaves_total          graceful departures retired
    membership_universe_epoch        dynamic node-table version in force
    metrics_relay_fallback_total     relay shards fallen back to direct
    metrics_relay_pulls_total        relay-shard aggregations by role
    metrics_relay_seconds            relay shard pull + pre-merge wall
    request_admitted_total           front-door admissions per SLO class
    request_batch_fill_fraction      formed-batch fill quality
    request_batch_formation_seconds  batch formation wall
    request_completed_total          request terminals per SLO class
    request_deadline_miss_total      completions past their deadline
    request_e2e_latency_seconds      admission -> completion latency
    request_in_flight                admitted, not yet terminal
    request_queue_wait_seconds       admission -> dispatch wait
    request_rejected_total           post-admission typed rejections
    request_session_affinity_evictions_total  session rows aged out
    request_session_affinity_hits_total  sessions routed to KV holder
    request_session_affinity_misses_total  sessions with no live target
    request_shed_total               admission sheds by slo= reason=
    request_stream_tokens_total      tokens pushed into request streams
    signal_crosscheck_flags_total    workers convicted by ACK-wall check
    signal_monitor_transitions_total burn-monitor transitions by signal= to=
    signal_samples_total             signal-plane window sample ticks
    signal_window_value              latest windowed sample per key=
    store_corruption_detected_total  sha256 mismatches quarantined
    store_deletes_total              delete operations
    store_get_seconds                GET wall
    store_gets_total                 GET operations
    store_put_seconds                PUT wall
    store_puts_total                 PUT operations
    store_repair_seconds             chaos: corruption -> repaired wall
    store_replication_failures_total replication attempts failed
    store_replication_seconds        replication wall
    store_replications_total         replication operations
    store_report_delta_entries_total re-report entries carried by kind
    store_report_delta_skipped_total re-report ticks with nothing to say
    store_report_delta_total         inventory re-reports by kind
    store_write_failures_total       local write failures (ENOSPC etc.)
    tracing_exemplars_total          tail-exemplar span captures by kind
    tracing_spans_dropped_total      flight-recorder ring evictions
    tracing_spans_total              finished spans observed by sampled=
    train_effective_batch            shard_batch x world by run=
    train_resharding_total           ckpt-restore re-shards by reason=
    train_step_wall_seconds          dispatch->applied step wall
    train_steps_total                global steps applied exactly once
    transport_bytes_received_total   datagram bytes in by msg type
    transport_bytes_sent_total       datagram bytes out by msg type
    transport_malformed_dropped_total  frames dying in Message.unpack
    transport_packets_delayed_total  link-shaper delayed emits
    transport_packets_dropped_inbound_total  inbound filter drops
    transport_packets_dropped_total  loss-injection outbound drops
    transport_packets_duplicated_total  link-shaper duplicate emits
    transport_packets_received_total datagrams in by msg type
    transport_packets_sent_total     datagrams out by msg type
    worker_batch_failures_total      worker batch executions failed
    worker_batches_total             worker batch executions
    worker_decode_cache_hits_total   decoded-input cache hits
    worker_decode_cache_misses_total decoded-input cache misses
    worker_fetch_seconds             worker input-fetch stage wall
    worker_infer_seconds             worker inference stage wall
    worker_put_seconds               worker output-put stage wall
"""

from __future__ import annotations

import bisect
import contextlib
import json
import logging
import math
import os
import threading
import time
import weakref
from collections import defaultdict
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

# ----------------------------------------------------------------------
# typed metrics registry
# ----------------------------------------------------------------------

_LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, Any]) -> _LabelKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _fmt_key(name: str, key: _LabelKey) -> str:
    if not key:
        return name
    inner = ",".join(f"{k}={v}" for k, v in key)
    return f"{name}{{{inner}}}"


def log_buckets(
    lo: float = 1e-4, hi: float = 100.0, per_decade: int = 6
) -> Tuple[float, ...]:
    """Fixed log-spaced bucket edges: ``per_decade`` edges per decade
    from ``lo`` up to (at least) ``hi``. Constant ratio between
    adjacent edges bounds the worst-case percentile error to one
    ratio step regardless of the value's magnitude."""
    if lo <= 0 or hi <= lo or per_decade < 1:
        raise ValueError(f"bad bucket spec lo={lo} hi={hi}/{per_decade}")
    edges: List[float] = []
    i = 0
    while True:
        e = lo * 10.0 ** (i / per_decade)
        edges.append(e)
        if e >= hi:
            return tuple(edges)
        i += 1


#: default edges for latency-in-seconds histograms: 100 µs .. 100 s
DEFAULT_TIME_BUCKETS = log_buckets(1e-4, 100.0, per_decade=6)


class _Child:
    """A metric bound to one label set. Holds only (parent, key): the
    value slots live in the parent, so a registry reset never strands
    a cached handle."""

    __slots__ = ("_m", "_key")

    def __init__(self, metric: "_Metric", key: _LabelKey):
        self._m = metric
        self._key = key


class _CounterChild(_Child):
    def inc(self, n: float = 1.0) -> None:
        m = self._m
        with m._lock:
            m._values[self._key] = m._values.get(self._key, 0.0) + n


class _GaugeChild(_Child):
    def set(self, v: float) -> None:
        m = self._m
        with m._lock:
            m._values[self._key] = float(v)

    def inc(self, n: float = 1.0) -> None:
        m = self._m
        with m._lock:
            m._values[self._key] = m._values.get(self._key, 0.0) + n

    def dec(self, n: float = 1.0) -> None:
        self.inc(-n)


class _HistChild(_Child):
    def observe(self, v: float) -> None:
        m = self._m
        v = float(v)
        with m._lock:
            st = m._values.get(self._key)
            if st is None:
                # [count, sum, min, max, bucket_counts]; the last
                # bucket is the +Inf overflow
                st = m._values[self._key] = [
                    0, 0.0, math.inf, -math.inf, [0] * (len(m.edges) + 1)
                ]
            st[0] += 1
            st[1] += v
            if v < st[2]:
                st[2] = v
            if v > st[3]:
                st[3] = v
            st[4][bisect.bisect_left(m.edges, v)] += 1


class _Metric:
    kind = ""
    _child_cls = _Child

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._children: Dict[_LabelKey, _Child] = {}
        self._values: Dict[_LabelKey, Any] = {}

    def labels(self, **labels: Any):
        """Bind a label set; returns a cached child handle. Hot paths
        should call this once and keep the handle."""
        key = _label_key(labels)
        child = self._children.get(key)
        if child is None:
            with self._lock:
                child = self._children.setdefault(
                    key, self._child_cls(self, key)
                )
        return child

    def reset(self) -> None:
        with self._lock:
            self._values.clear()

    def items(self) -> List[Tuple[_LabelKey, Any]]:
        with self._lock:
            return list(self._values.items())


class Counter(_Metric):
    kind = "counter"
    _child_cls = _CounterChild

    def inc(self, n: float = 1.0, **labels: Any) -> None:
        self.labels(**labels).inc(n)

    def value(self, **labels: Any) -> float:
        with self._lock:
            return float(self._values.get(_label_key(labels), 0.0))


class Gauge(_Metric):
    kind = "gauge"
    _child_cls = _GaugeChild

    def set(self, v: float, **labels: Any) -> None:
        self.labels(**labels).set(v)

    def value(self, **labels: Any) -> float:
        with self._lock:
            return float(self._values.get(_label_key(labels), 0.0))


class Histogram(_Metric):
    kind = "histogram"
    _child_cls = _HistChild

    def __init__(
        self,
        name: str,
        help: str = "",
        edges: Sequence[float] = DEFAULT_TIME_BUCKETS,
    ):
        super().__init__(name, help)
        edges = tuple(float(e) for e in edges)
        if list(edges) != sorted(edges) or len(set(edges)) != len(edges):
            raise ValueError(f"{name}: bucket edges must strictly increase")
        self.edges = edges

    def observe(self, v: float, **labels: Any) -> None:
        self.labels(**labels).observe(v)


class MetricsRegistry:
    """Process-wide named-metric table. `counter`/`gauge`/`histogram`
    are get-or-create (idempotent by name; a kind clash raises), so
    any module can declare its metrics at import time."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}
        # weakly-held callables run before every exposition to refresh
        # DERIVED values (e.g. the scheduler's trailing query rate,
        # which must decay at read time, not freeze at its last
        # event-driven update)
        self._collectors: List[weakref.ref] = []

    def _get(self, cls, name: str, help: str, **kw) -> _Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, help, **kw)
            elif not isinstance(m, cls):
                raise ValueError(
                    f"metric {name!r} already registered as {m.kind}"
                )
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)  # type: ignore[return-value]

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)  # type: ignore[return-value]

    def histogram(
        self,
        name: str,
        help: str = "",
        edges: Sequence[float] = DEFAULT_TIME_BUCKETS,
    ) -> Histogram:
        return self._get(Histogram, name, help, edges=edges)  # type: ignore[return-value]

    def reset(self) -> None:
        """Zero every metric's values. Registered metric objects (and
        any cached child handles) stay valid — tests isolate state
        without invalidating module-level handles."""
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            m.reset()

    # -- exposition ----------------------------------------------------

    def add_collector(self, fn: Any) -> None:
        """Register a BOUND METHOD to run before every exposition
        (snapshot / Prometheus text), for gauges derived from state
        that only the owner can read — e.g. a trailing-window rate
        that must decay on an idle system. Held weakly: the collector
        dies with its owner, so short-lived instances (tests, sims)
        never accumulate."""
        ref = (
            weakref.WeakMethod(fn)
            if hasattr(fn, "__self__")
            else weakref.ref(fn)
        )
        with self._lock:
            self._collectors.append(ref)

    def _run_collectors(self) -> None:
        with self._lock:
            refs = list(self._collectors)
        dead = False
        for r in refs:
            fn = r()
            if fn is None:
                dead = True
                continue
            try:
                fn()
            except Exception:  # a collector must never break exposition
                logging.getLogger(__name__).debug(
                    "metrics collector failed", exc_info=True
                )
        if dead:
            with self._lock:
                self._collectors = [
                    r for r in self._collectors if r() is not None
                ]

    def snapshot(self, node: Optional[str] = None) -> Dict[str, Any]:
        """JSON-able dump. Histogram buckets are sparse ({index:
        count} for nonzero buckets) to keep METRICS_PULL replies well
        under the UDP frame cap."""
        out: Dict[str, Any] = {
            "v": 1,
            "proc": os.getpid(),
            "ts": time.time(),
            "counters": {},
            "gauges": {},
            "histograms": {},
        }
        if node is not None:
            out["node"] = node
        self._run_collectors()
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            for key, val in m.items():
                fk = _fmt_key(m.name, key)
                if m.kind == "counter":
                    out["counters"][fk] = val
                elif m.kind == "gauge":
                    out["gauges"][fk] = val
                else:
                    count, total, mn, mx, buckets = val
                    edges = m.edges  # type: ignore[attr-defined]
                    out["histograms"][fk] = {
                        "count": count,
                        "sum": total,
                        "min": mn if count else None,
                        "max": mx if count else None,
                        # the common edge set compresses to a sentinel
                        # (~37 floats per labeled entry otherwise —
                        # real pressure against the UDP frame cap)
                        "edges": (
                            "default"
                            if edges == DEFAULT_TIME_BUCKETS
                            else list(edges)
                        ),
                        "bkt": {
                            str(i): c
                            for i, c in enumerate(buckets)
                            if c
                        },
                    }
        return out

    def to_prometheus_text(self) -> str:
        """Prometheus exposition format (text/plain version 0.0.4)."""
        lines: List[str] = []
        self._run_collectors()
        with self._lock:
            metrics = sorted(self._metrics.values(), key=lambda m: m.name)
        for m in metrics:
            items = m.items()
            if not items:
                continue
            if m.help:
                lines.append(f"# HELP {m.name} {m.help}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            for key, val in sorted(items):
                if m.kind in ("counter", "gauge"):
                    lines.append(f"{m.name}{_prom_labels(key)} {_g(val)}")
                    continue
                count, total, _mn, _mx, buckets = val
                cum = 0
                for i, edge in enumerate(m.edges):  # type: ignore[attr-defined]
                    cum += buckets[i]
                    lines.append(
                        f"{m.name}_bucket"
                        f"{_prom_labels(key, le=_g(edge))} {cum}"
                    )
                lines.append(
                    f"{m.name}_bucket{_prom_labels(key, le='+Inf')} {count}"
                )
                lines.append(f"{m.name}_sum{_prom_labels(key)} {_g(total)}")
                lines.append(f"{m.name}_count{_prom_labels(key)} {count}")
        return "\n".join(lines) + ("\n" if lines else "")


def _g(v: float) -> str:
    return f"{float(v):g}"


def _prom_labels(key: _LabelKey, **extra: str) -> str:
    pairs = list(key) + sorted(extra.items())
    if not pairs:
        return ""
    inner = ",".join(
        '{}="{}"'.format(
            k, str(v).replace("\\", r"\\").replace('"', r"\"")
        )
        for k, v in pairs
    )
    return f"{{{inner}}}"


#: the process-wide registry every subsystem writes into
METRICS = MetricsRegistry()


def counter(name: str, help: str = "") -> Counter:
    return METRICS.counter(name, help)


def gauge(name: str, help: str = "") -> Gauge:
    return METRICS.gauge(name, help)


def histogram(
    name: str, help: str = "", edges: Sequence[float] = DEFAULT_TIME_BUCKETS
) -> Histogram:
    return METRICS.histogram(name, help, edges)


# ----------------------------------------------------------------------
# snapshot math: percentiles, summaries, cross-node merge
# ----------------------------------------------------------------------


def _entry_edges(entry: Dict[str, Any]) -> Optional[Sequence[float]]:
    """Resolve a snapshot entry's bucket edges: the ``"default"``
    sentinel (wire compression), an explicit list, or None for a
    bucket-stripped entry."""
    e = entry.get("edges")
    if e == "default":
        return DEFAULT_TIME_BUCKETS
    if isinstance(e, (list, tuple)) and e:
        return e
    return None


def hist_quantile(entry: Dict[str, Any], q: float) -> Optional[float]:
    """Quantile estimate from a snapshot histogram entry: walk the
    cumulative bucket counts to the target rank, then geometrically
    interpolate inside the landing bucket (log-spaced edges make the
    geometric mean the max-likelihood point). Clamped to the observed
    [min, max]; the overflow bucket reports the observed max.

    The rank base is the number of samples the BUCKETS represent
    (``bkt_count`` on merged entries), not the total count: a cluster
    merge may fold in bucket-stripped nodes whose samples contribute
    to count/sum/mean but are invisible to the buckets, and ranking
    over the inflated total would systematically skew the walk toward
    the high buckets. Percentiles then describe the bucketed
    subpopulation; an entry with no bucketed samples returns None."""
    count = entry.get("count", 0)
    if not count:
        return None
    edges = _entry_edges(entry)
    if edges is None:  # bucket-stripped entry: percentiles unknowable
        return None
    buckets = entry.get("bkt", {})
    mn = entry.get("min")
    mx = entry.get("max")
    base = entry.get("bkt_count", count)
    if not base:
        return None
    target = q * base
    cum = 0.0
    for i in range(len(edges) + 1):
        c = buckets.get(str(i), 0)
        if not c:
            continue
        if cum + c >= target:
            if i >= len(edges):  # overflow: only the max is known
                return mx
            hi = edges[i]
            lo = edges[i - 1] if i > 0 else (
                mn if mn and mn > 0 else hi / 10.0
            )
            if lo <= 0:
                lo = hi / 10.0
            frac = max(0.0, min(1.0, (target - cum) / c))
            est = lo * (hi / lo) ** frac
            if mn is not None:
                est = max(est, mn)
            if mx is not None:
                est = min(est, mx)
            return est
        cum += c
    return mx


def summarize_histogram(entry: Dict[str, Any]) -> Dict[str, Any]:
    """C2-style roll-up of a snapshot histogram entry: count, mean,
    min/max, p50/p95/p99."""
    count = entry.get("count", 0)
    out: Dict[str, Any] = {"count": count}
    if not count:
        return out
    out["mean"] = entry.get("sum", 0.0) / count
    out["min"] = entry.get("min")
    out["max"] = entry.get("max")
    for name, q in (("p50", 0.50), ("p95", 0.95), ("p99", 0.99)):
        out[name] = hist_quantile(entry, q)
    bc = entry.get("bkt_count")
    if bc is not None and bc < count:
        # some merged-in nodes were bucket-stripped: the percentiles
        # above describe only these samples (mean/min/max are global)
        out["percentile_count"] = bc
    return out


def summarize_snapshot(snap: Dict[str, Any]) -> Dict[str, Any]:
    """Human/CLI view of a snapshot (or merged cluster snapshot):
    counters and gauges verbatim, histograms rolled up to
    count/mean/percentiles."""
    return {
        "counters": dict(snap.get("counters", {})),
        "gauges": dict(snap.get("gauges", {})),
        "histograms": {
            k: summarize_histogram(h)
            for k, h in sorted(snap.get("histograms", {}).items())
        },
    }


def merge_snapshots(
    snaps: Sequence[Dict[str, Any]], dedupe_by_proc: bool = True
) -> Dict[str, Any]:
    """Fold per-node snapshots into one cluster view: counters and
    gauges sum, histograms merge bucket-wise (same-name histograms
    must share edges — they do, the metric declarations are code).

    ``dedupe_by_proc`` counts each producing PROCESS once: in-process
    simulations run every node over one shared registry, and summing
    N identical copies would report an N× phantom cluster. Real
    deployments are one process per node, so nothing is dropped.

    Inputs may themselves be MERGED blobs (the two-level relay
    aggregation pre-merges each shard): such a blob carries ``procs``
    (every process it folded) instead of ``proc``, and is skipped
    only when EVERY one of its processes was already counted — so an
    in-process sim's relay blobs dedupe against the leader's own
    snapshot exactly like direct pulls do, while real multi-process
    shards all count. The output carries ``procs`` and a
    ``merged_from`` that sums nested counts, keeping the node count
    honest through both aggregation levels."""
    out: Dict[str, Any] = {
        "v": 1,
        "counters": {},
        "gauges": {},
        "histograms": {},
        "merged_from": 0,
    }
    seen_procs = set()
    for snap in snaps:
        procs = snap.get("procs")
        if not isinstance(procs, list):
            proc = snap.get("proc")
            procs = [proc] if proc is not None else []
        if dedupe_by_proc and procs and all(p in seen_procs for p in procs):
            continue
        seen_procs.update(procs)
        out["merged_from"] += int(snap.get("merged_from", 1) or 1)
        for k, v in snap.get("counters", {}).items():
            out["counters"][k] = out["counters"].get(k, 0.0) + v
        for k, v in snap.get("gauges", {}).items():
            out["gauges"][k] = out["gauges"].get(k, 0.0) + v
        for k, h in snap.get("histograms", {}).items():
            cur = out["histograms"].get(k)
            if cur is None:
                cur = out["histograms"][k] = {
                    "count": 0,
                    "sum": 0.0,
                    "min": None,
                    "max": None,
                    "bkt": {},
                    # how many of `count` the buckets represent: a
                    # bucket-stripped node's samples join count/sum
                    # (mean stays exact) but not the buckets, and
                    # quantile ranking must know the difference
                    "bkt_count": 0,
                }
            cur["count"] += h.get("count", 0)
            cur["sum"] += h.get("sum", 0.0)
            for bound, pick in (("min", min), ("max", max)):
                v = h.get(bound)
                if v is not None:
                    cur[bound] = v if cur[bound] is None else pick(cur[bound], v)
            if _entry_edges(h) is None:  # stripped: no buckets to fold
                continue
            if "edges" not in cur:  # first bucketed contributor
                cur["edges"] = h["edges"]
            cur["bkt_count"] += h.get("bkt_count", h.get("count", 0))
            for i, c in h.get("bkt", {}).items():
                cur["bkt"][i] = cur["bkt"].get(i, 0) + c
    out["procs"] = sorted(seen_procs)
    return out


def strip_buckets(snap: Dict[str, Any]) -> Dict[str, Any]:
    """Shrink a snapshot for a constrained wire frame: histogram
    entries keep count/sum/min/max (mean stays computable) but drop
    the bucket counts (and with them percentiles). The METRICS_PULL
    handler falls back to this when the full snapshot would exceed
    the UDP frame cap."""
    out = dict(snap)
    out["histograms"] = {
        k: {
            kk: vv
            for kk, vv in h.items()
            if kk not in ("bkt", "edges", "bkt_count")
        }
        for k, h in snap.get("histograms", {}).items()
    }
    out["stripped"] = True
    return out


def bench_metrics_block() -> Dict[str, Any]:
    """The ``metrics`` block a bench artifact embeds: summarized
    registry contents, so the artifact carries per-stage breakdowns
    (lm_server decode counters, worker stage timings, transport
    totals) alongside the headline numbers."""
    block = summarize_snapshot(METRICS.snapshot())
    block["schema"] = 1
    return block


# ----------------------------------------------------------------------
# device profiling + wall-clock spans + JSONL logging
# ----------------------------------------------------------------------


@contextlib.contextmanager
def profile(logdir: str) -> Iterator[None]:
    """Capture a `torch.profiler` trace of the host and, where a CUDA
    device is present, the card, written to `logdir` as a Chrome trace
    (view in Perfetto or TensorBoard). Wrap a few representative steps,
    not a whole run: traces are large."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(
        activities=acts,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir),
    ):
        yield


class Spans:
    """Process-wide wall-clock span registry (mean/count per label)."""

    def __init__(self):
        self._acc: Dict[str, List[float]] = defaultdict(list)

    @contextlib.contextmanager
    def span(self, label: str) -> Iterator[None]:
        t0 = time.monotonic()
        try:
            yield
        finally:
            self._acc[label].append(time.monotonic() - t0)

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for label, xs in sorted(self._acc.items()):
            out[label] = {
                "count": float(len(xs)),
                "total_s": sum(xs),
                "mean_s": sum(xs) / len(xs),
                "max_s": max(xs),
            }
        return out

    def reset(self) -> None:
        self._acc.clear()


SPANS = Spans()
span = SPANS.span


class _JsonFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        obj = {
            "ts": round(record.created, 3),
            "level": record.levelname,
            "logger": record.name,
            "msg": record.getMessage(),
        }
        if record.exc_info:
            obj["exc"] = self.formatException(record.exc_info)
        return json.dumps(obj, ensure_ascii=False)


def jsonl_logging(
    path: Optional[str] = None, level: int = logging.INFO
) -> logging.Handler:
    """Install a JSON-lines handler on the root logger (file or stderr)."""
    handler: logging.Handler = (
        logging.FileHandler(path) if path else logging.StreamHandler()
    )
    handler.setFormatter(_JsonFormatter())
    root = logging.getLogger()
    root.addHandler(handler)
    if root.level > level:
        root.setLevel(level)
    return handler

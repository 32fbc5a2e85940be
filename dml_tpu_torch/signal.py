"""SLO signal plane: windowed time-series, burn-rate monitors, health
scoring with a straggler cross-check, and a typed cluster alert
lifecycle.

The cluster emits every measurement a closed-loop autoscaler (ROADMAP
item 2) needs — per-class p99/goodput, shed reasons, trace stage
attribution, per-slot weights — but only as point-in-time snapshots.
This module is the sensor layer on top of them, in four coupled
pieces:

- ``MetricWindow`` / ``HistWindow`` / ``WindowSet``: fixed-stride ring
  windows over registry counters/gauges/histograms, sampled on
  explicit ticks with an INJECTED clock, exposing rate / delta /
  trend / windowed-quantile queries. Same clock + same observations ⇒
  identical windows (the seeded-determinism discipline the chaos
  engine and benches rely on everywhere else).
- ``BurnRatePolicy`` / ``BurnRateMonitor``: multi-window (short/long)
  burn-rate evaluation — the Google-SRE shape: the error budget is
  burning only when BOTH windows agree, so a one-tick blip cannot
  fire and a long-dead signal cannot linger — with ``Hysteresis``
  debouncing so a flapping signal cannot oscillate the alert state
  machine.
- ``HealthScorer``: leader-side per-node scoring from ACK evidence.
  Stage-wall z-scores (robust: median + MAD vs the pool) catch honest
  stragglers; the CROSS-CHECK compares each worker's self-reported
  batch wall against the wall the leader itself observed between
  dispatch and ACK — evidence the worker cannot forge, so a
  lying-metrics straggler (the ``liar`` chaos seam injects exactly
  that) is flagged even while its self-reported metrics stay clean.
- ``AlertManager`` + ``SignalPlane``: a CLOSED ``ALERT_NAMES``
  registry (the SPAN_NAMES pattern, lint rule drift-alert-names),
  firing→resolved transitions with dedup + severity + exemplar trace
  ids from the flight recorder, the ``ALERT`` standby relay so the
  ledger survives leader failover, and the ``ALERT_PULL``
  request/reply wire surface the CLI ``health``/``alerts`` verbs read.
"""

from __future__ import annotations

import asyncio
import json
import logging
import math
import time
from collections import OrderedDict, deque
from dataclasses import dataclass
from typing import (
    Any, Callable, Deque, Dict, List, Optional, Sequence, Tuple,
)

from .cluster.util import reap_task
from .cluster.wire import Message, MsgType
from .ingress.slo import burn_budget
from .observability import METRICS, hist_quantile
from .tracing import TRACER

log = logging.getLogger(__name__)

# ----------------------------------------------------------------------
# alert-name registry (lint-enforced: dmllint rule drift-alert-names)
# ----------------------------------------------------------------------

#: Every name ``fire_alert(...)`` / ``resolve_alert(...)`` may emit,
#: and therefore every typed condition an operator (or the autoscaler)
#: can subscribe to. tools/dmllint.py cross-checks all literal
#: emission sites in the tree against this tuple — add the name HERE
#: first, or the build fails. Keep the comment on each line: it is the
#: alert catalog.
# plain assignment (no annotation): dmllint's _module_const_strs reads
# top-level Assign nodes, and this tuple IS its machine contract
ALERT_NAMES = (
    "slo_burn_rate",   # an SLO class/model error budget is burning
                       # (multi-window burn-rate breach: deadline-miss
                       # rate, shed ratio, queue-wait trend, or a
                       # model's queue starving with zero ACK flow)
    "node_unhealthy",  # a node's stage walls are a robust-z outlier
                       # vs the pool median (honest straggler)
    "metrics_liar",    # a node's self-reported batch walls disagree
                       # with the leader's own dispatch->ACK
                       # observation (forged-evidence straggler)
)

#: alert severity scale, mildest first
SEVERITIES = ("info", "warning", "critical")

_M_ALERT_FIRED = METRICS.counter(
    "alert_fired_total",
    "alert firing transitions, per name= severity=")
_M_ALERT_RESOLVED = METRICS.counter(
    "alert_resolved_total", "alert resolved transitions, per name=")
_M_ALERT_FIRING = METRICS.gauge(
    "alert_firing", "currently-firing alerts, per name=")
_M_ALERT_RELAYS = METRICS.counter(
    "alert_relays_total",
    "alert ledger transitions relayed leader -> standby")
_M_SIG_SAMPLES = METRICS.counter(
    "signal_samples_total", "signal-plane window sample ticks")
_M_SIG_TRANSITIONS = METRICS.counter(
    "signal_monitor_transitions_total",
    "burn-rate monitor hysteresis transitions, per signal= to=")
_M_SIG_LIAR = METRICS.counter(
    "signal_crosscheck_flags_total",
    "workers newly flagged by the ACK-wall cross-check")


# ----------------------------------------------------------------------
# (a) windowed time-series
# ----------------------------------------------------------------------

class MetricWindow:
    """Fixed-stride ring of ``(bucket_start, value)`` samples.

    ``observe`` replaces the sample in the current stride bucket or
    appends a new one; the deque bound retires buckets older than
    ``width_s``. Values are whatever the caller samples — cumulative
    counter totals (query with ``delta``/``rate``) or point-in-time
    gauge levels (query with ``last``/``trend``). Every query takes
    ``now`` explicitly: the window never reads a wall clock, so the
    same injected clock and the same observations reproduce the same
    answers bit for bit."""

    def __init__(self, width_s: float = 60.0, stride_s: float = 1.0):
        if stride_s <= 0 or width_s < stride_s:
            raise ValueError(
                f"bad window geometry width={width_s} stride={stride_s}"
            )
        self.width_s = float(width_s)
        self.stride_s = float(stride_s)
        self._buckets: Deque[Tuple[float, float]] = deque(
            maxlen=int(math.ceil(width_s / stride_s)) + 1
        )

    def observe(self, now: float, value: float) -> None:
        b = math.floor(now / self.stride_s) * self.stride_s
        if self._buckets:
            last_b = self._buckets[-1][0]
            if b == last_b:
                self._buckets[-1] = (b, float(value))
                return
            if b < last_b:
                return  # non-monotonic clock: drop, never reorder
        self._buckets.append((b, float(value)))

    def _span(
        self, now: float, window_s: Optional[float]
    ) -> List[Tuple[float, float]]:
        w = self.width_s if window_s is None else min(
            float(window_s), self.width_s
        )
        lo = now - w
        return [bv for bv in self._buckets if bv[0] >= lo]

    def last(self) -> Optional[float]:
        return self._buckets[-1][1] if self._buckets else None

    def delta(self, now: float, window_s: Optional[float] = None) -> float:
        """newest − oldest sample inside the window (cumulative
        series: how much the counter moved)."""
        pts = self._span(now, window_s)
        if len(pts) < 2:
            return 0.0
        return pts[-1][1] - pts[0][1]

    def rate(self, now: float, window_s: Optional[float] = None) -> float:
        """``delta`` per second over the covered span (not the nominal
        window: a half-filled window reports the rate it has evidence
        for)."""
        pts = self._span(now, window_s)
        if len(pts) < 2:
            return 0.0
        dt = pts[-1][0] - pts[0][0]
        return (pts[-1][1] - pts[0][1]) / dt if dt > 0 else 0.0

    def trend(self, now: float, window_s: Optional[float] = None) -> float:
        """Least-squares slope (value units per second) over the
        window's samples — the direction a gauge (or a derived
        quantile series) is heading."""
        pts = self._span(now, window_s)
        if len(pts) < 2:
            return 0.0
        n = len(pts)
        t0 = pts[0][0]
        xs = [t - t0 for t, _ in pts]
        ys = [v for _, v in pts]
        mx = sum(xs) / n
        my = sum(ys) / n
        den = sum((x - mx) ** 2 for x in xs)
        if den <= 0:
            return 0.0
        num = sum((x - mx) * (y - my) for x, y in zip(xs, ys))
        return num / den

    def to_dict(self) -> Dict[str, Any]:
        return {
            "width_s": self.width_s,
            "stride_s": self.stride_s,
            "samples": [[t, v] for t, v in self._buckets],
        }


class HistWindow:
    """Ring of CUMULATIVE histogram states; windowed quantiles come
    from diffing the cumulative bucket counts at the window's two ends
    and handing the difference to ``observability.hist_quantile``.
    min/max are taken from the newest state (a cumulative histogram
    cannot un-see an extreme), which only widens the clamp — the
    bucket walk stays window-accurate."""

    def __init__(
        self,
        edges: Sequence[float],
        width_s: float = 60.0,
        stride_s: float = 1.0,
    ):
        self.edges = [float(e) for e in edges]
        self._ring = MetricWindow(width_s=width_s, stride_s=stride_s)
        # bucket states ride alongside the scalar ring keyed by the
        # same stride bucket (the scalar value is the cumulative count,
        # which delta() queries can reuse directly)
        self._states: Dict[float, Dict[str, Any]] = {}

    def observe(
        self,
        now: float,
        count: float,
        total: float,
        bkt: Dict[str, float],
        mn: Optional[float] = None,
        mx: Optional[float] = None,
    ) -> None:
        self._ring.observe(now, count)
        live = {b for b, _ in self._ring._buckets}
        b = math.floor(now / self._ring.stride_s) * self._ring.stride_s
        if b in live:
            self._states[b] = {
                "count": float(count), "sum": float(total),
                "bkt": dict(bkt), "min": mn, "max": mx,
            }
        for k in [k for k in self._states if k not in live]:
            del self._states[k]

    def window_entry(
        self, now: float, window_s: Optional[float] = None
    ) -> Optional[Dict[str, Any]]:
        pts = self._ring._span(now, window_s)
        if not pts:
            return None
        newest = self._states.get(pts[-1][0])
        if newest is None:
            return None
        oldest = self._states.get(pts[0][0]) if len(pts) > 1 else None
        base = oldest or {"count": 0.0, "sum": 0.0, "bkt": {}}
        dcount = newest["count"] - base["count"]
        if dcount <= 0:
            return None
        dbkt = {}
        for k, v in newest["bkt"].items():
            d = v - base["bkt"].get(k, 0.0)
            if d > 0:
                dbkt[k] = d
        return {
            "count": dcount,
            "sum": newest["sum"] - base["sum"],
            "edges": list(self.edges),
            "bkt": dbkt,
            "min": newest.get("min"),
            "max": newest.get("max"),
        }

    def quantile(
        self, q: float, now: float, window_s: Optional[float] = None
    ) -> Optional[float]:
        entry = self.window_entry(now, window_s)
        if entry is None:
            return None
        return hist_quantile(entry, q)


class WindowSet:
    """Named windows over registry metrics, sampled on explicit
    ``sample(now)`` ticks. Readers are plain callables (usually bound
    to a registry metric's ``value``/``items``), so the set works
    identically against the live registry and against a recorded
    observation dict in a deterministic replay.

    ``publish()`` is the registry hook: it registers a collector
    (``MetricsRegistry.add_collector``, weakly held) that refreshes a
    small ``signal_window_value`` gauge family at every exposition, so
    METRICS_PULL / Prometheus text see the windows' latest levels
    without the signal plane pushing anything."""

    def __init__(
        self,
        clock: Callable[[], float] = time.monotonic,
        width_s: float = 120.0,
        stride_s: float = 0.5,
    ):
        self._clock = clock
        self.width_s = float(width_s)
        self.stride_s = float(stride_s)
        self._readers: Dict[str, Callable[[], Optional[float]]] = {}
        self._windows: Dict[str, MetricWindow] = {}
        self._hist_readers: Dict[
            str, Callable[[], Optional[Tuple[float, float, Dict[str, float],
                                             Optional[float],
                                             Optional[float]]]]
        ] = {}
        self._hists: Dict[str, HistWindow] = {}
        self._published = False

    def now(self) -> float:
        return self._clock()

    def track(
        self, key: str, reader: Callable[[], Optional[float]]
    ) -> MetricWindow:
        w = self._windows.get(key)
        if w is None:
            w = self._windows[key] = MetricWindow(
                width_s=self.width_s, stride_s=self.stride_s
            )
            self._readers[key] = reader
        return w

    def track_hist(
        self,
        key: str,
        edges: Sequence[float],
        reader: Callable[[], Optional[Tuple[float, float, Dict[str, float],
                                            Optional[float],
                                            Optional[float]]]],
    ) -> HistWindow:
        h = self._hists.get(key)
        if h is None:
            h = self._hists[key] = HistWindow(
                edges, width_s=self.width_s, stride_s=self.stride_s
            )
            self._hist_readers[key] = reader
        return h

    def window(self, key: str) -> Optional[MetricWindow]:
        return self._windows.get(key)

    def hist(self, key: str) -> Optional[HistWindow]:
        return self._hists.get(key)

    def sample(self, now: Optional[float] = None) -> float:
        """One tick: read every tracked reader into its window.
        Returns the tick time (injected clock unless given)."""
        t = self._clock() if now is None else float(now)
        for key, reader in self._readers.items():
            try:
                v = reader()
            except Exception:
                log.debug("window reader %s failed", key, exc_info=True)
                continue
            if v is not None:
                self._windows[key].observe(t, float(v))
        for key, reader in self._hist_readers.items():
            try:
                state = reader()
            except Exception:
                log.debug("hist reader %s failed", key, exc_info=True)
                continue
            if state is not None:
                count, total, bkt, mn, mx = state
                self._hists[key].observe(t, count, total, bkt, mn, mx)
        return t

    def publish(self) -> None:
        if self._published:
            return
        self._published = True
        METRICS.gauge(
            "signal_window_value",
            "latest windowed sample per tracked signal, per key=")
        METRICS.add_collector(self._collect)

    def _collect(self) -> None:
        g = METRICS.gauge("signal_window_value")
        for key, w in self._windows.items():
            v = w.last()
            if v is not None:
                g.set(v, key=key)

    def to_dict(self) -> Dict[str, Any]:
        return {k: w.to_dict() for k, w in sorted(self._windows.items())}


# ----------------------------------------------------------------------
# (b) burn-rate monitors
# ----------------------------------------------------------------------

@dataclass(frozen=True)
class BurnRatePolicy:
    """One monitor's knobs.

    ``budget``      allowed bad fraction (0.02 = 2% of requests may
                    miss/shed before the budget is spent at burn 1.0).
    ``short_s``/``long_s``  the two evaluation windows; BOTH must
                    breach to fire and BOTH must clear to resolve.
    ``fire_burn``/``clear_burn``  the hysteresis band: burn ≥
                    fire_burn breaches, burn ≤ clear_burn clears,
                    in between holds state (a signal flapping inside
                    the band cannot oscillate the alert).
    ``fire_after``/``clear_after``  consecutive evaluations required
                    for each transition (time-domain debounce on top
                    of the band).
    ``min_events``  below this many events in a window the ratio is
                    treated as 0 — zero-traffic denominators (total
                    outage, idle cluster) must read as "not burning",
                    not NaN (the loadgen degenerate-input discipline).
    """

    budget: float = 0.02
    short_s: float = 10.0
    long_s: float = 60.0
    fire_burn: float = 1.0
    clear_burn: float = 0.5
    fire_after: int = 2
    clear_after: int = 3
    min_events: int = 8


class Hysteresis:
    """Debounced two-state machine. ``update(breach)`` takes True
    (breaching), False (clear) or None (inside the band: hold state,
    reset streaks) and returns ``"fire"`` / ``"resolve"`` on the
    debounced transition, else None."""

    def __init__(self, fire_after: int = 2, clear_after: int = 3):
        self.fire_after = max(1, int(fire_after))
        self.clear_after = max(1, int(clear_after))
        self.firing = False
        self._breach_streak = 0
        self._clear_streak = 0

    def update(self, breach: Optional[bool]) -> Optional[str]:
        if breach is None:
            self._breach_streak = 0
            self._clear_streak = 0
            return None
        if breach:
            self._clear_streak = 0
            self._breach_streak += 1
            if not self.firing and self._breach_streak >= self.fire_after:
                self.firing = True
                return "fire"
            return None
        self._breach_streak = 0
        self._clear_streak += 1
        if self.firing and self._clear_streak >= self.clear_after:
            self.firing = False
            return "resolve"
        return None


class BurnRateMonitor:
    """Multi-window burn-rate over one bad/total cumulative pair (or
    pre-computed burn numbers via ``evaluate_burns`` — the queue-wait
    trend signal maps its slope onto the same scale)."""

    def __init__(self, policy: Optional[BurnRatePolicy] = None):
        self.policy = policy or BurnRatePolicy()
        self.hyst = Hysteresis(self.policy.fire_after,
                               self.policy.clear_after)
        self.last: Dict[str, Any] = {}

    def _burn(
        self, now: float, bad: MetricWindow, total: MetricWindow,
        window_s: float,
    ) -> float:
        p = self.policy
        dt = total.delta(now, window_s)
        if dt < p.min_events:
            return 0.0
        db = max(0.0, bad.delta(now, window_s))
        return (db / dt) / p.budget if dt > 0 else 0.0

    def evaluate(
        self, now: float, bad: MetricWindow, total: MetricWindow
    ) -> Optional[str]:
        p = self.policy
        return self.evaluate_burns(
            now,
            self._burn(now, bad, total, p.short_s),
            self._burn(now, bad, total, p.long_s),
        )

    def evaluate_burns(
        self, now: float, burn_short: float, burn_long: float
    ) -> Optional[str]:
        p = self.policy
        if burn_short >= p.fire_burn and burn_long >= p.fire_burn:
            breach: Optional[bool] = True
        elif burn_short <= p.clear_burn and burn_long <= p.clear_burn:
            breach = False
        else:
            breach = None
        self.last = {
            "t": now,
            "burn_short": round(burn_short, 4),
            "burn_long": round(burn_long, 4),
            "firing": self.hyst.firing,
        }
        trans = self.hyst.update(breach)
        if trans is not None:
            self.last["firing"] = self.hyst.firing
        return trans


# ----------------------------------------------------------------------
# (c) health scoring + straggler cross-check
# ----------------------------------------------------------------------

def _median(vals: Sequence[float]) -> float:
    s = sorted(vals)
    n = len(s)
    if not n:
        return 0.0
    mid = n // 2
    return s[mid] if n % 2 else (s[mid - 1] + s[mid]) / 2.0


class HealthScorer:
    """Leader-side per-node health from the two ACK evidence streams.

    ``observe_ack`` records, per worker, (a) the self-reported batch
    exec wall normalized per item — the z-score input — and (b) the
    pair (leader-OBSERVED dispatch→ACK wall, self-REPORTED exec wall)
    — the cross-check input. The z-score is robust (median + MAD with
    a floored sigma, so a near-constant pool cannot manufacture
    outliers); the cross-check flags a worker whose observed wall
    exceeds its reported wall by both a ratio and an absolute margin
    over a median of ≥ ``min_samples`` ACKs — one slow datagram can't
    convict, and a liar can't talk its way out because the observed
    side is the leader's own clock."""

    def __init__(
        self,
        ratio: float = 1.4,
        abs_margin_s: float = 0.25,
        min_samples: int = 4,
        z_fire: float = 3.0,
        keep: int = 64,
    ):
        self.ratio = float(ratio)
        self.abs_margin_s = float(abs_margin_s)
        self.min_samples = int(min_samples)
        self.z_fire = float(z_fire)
        self._keep = int(keep)
        self._walls: Dict[str, Deque[float]] = {}
        self._pairs: Dict[str, Deque[Tuple[float, float]]] = {}

    def observe_ack(
        self,
        worker: str,
        observed_s: float,
        reported_s: float,
        n_items: int = 1,
    ) -> None:
        per_item = float(reported_s) / max(1, int(n_items))
        self._walls.setdefault(
            worker, deque(maxlen=self._keep)
        ).append(per_item)
        self._pairs.setdefault(
            worker, deque(maxlen=self._keep)
        ).append((float(observed_s), float(reported_s)))

    def forget(self, worker: str) -> None:
        self._walls.pop(worker, None)
        self._pairs.pop(worker, None)

    def crosscheck(self, worker: str) -> Optional[Dict[str, Any]]:
        """Evidence dict if ``worker`` looks like a liar, else None.

        Evaluated over the NEWEST ``2*min_samples`` ACKs, not the whole
        retention deque: a worker that turns liar mid-run must be
        convictable within a bounded number of fresh ACKs instead of
        having to outvote its own honest history (the deque's full
        depth still feeds the z-scores, where history is the point)."""
        rows = self._pairs.get(worker)
        if not rows or len(rows) < self.min_samples:
            return None
        recent = list(rows)[-(2 * self.min_samples):]
        obs_med = _median([o for o, _ in recent])
        rep_med = _median([r for _, r in recent])
        if obs_med > rep_med * self.ratio + self.abs_margin_s:
            return {
                "observed_s": round(obs_med, 4),
                "reported_s": round(rep_med, 4),
                "samples": len(recent),
            }
        return None

    def liars(self) -> Dict[str, Dict[str, Any]]:
        out = {}
        for w in self._pairs:
            ev = self.crosscheck(w)
            if ev is not None:
                out[w] = ev
        return out

    def zscores(self) -> Dict[str, float]:
        """Robust z per worker: its recent median per-item wall vs the
        pool median, scaled by MAD (floored so a uniform pool reads
        z≈0 everywhere instead of dividing by ~0)."""
        meds = {
            w: _median(list(vals))
            for w, vals in self._walls.items() if vals
        }
        if len(meds) < 3:
            return {w: 0.0 for w in meds}
        pool = _median(list(meds.values()))
        mad = _median([abs(v - pool) for v in meds.values()])
        sigma = max(mad / 0.6745, 0.1 * pool, 1e-3)
        return {w: (v - pool) / sigma for w, v in meds.items()}

    def scores(self) -> Dict[str, Dict[str, Any]]:
        """Per-node health rollup: 1.0 = healthy; z outliers lose
        score proportionally; a cross-check liar scores 0 (its
        self-reported walls are untrustworthy by construction)."""
        zs = self.zscores()
        liars = self.liars()
        out: Dict[str, Dict[str, Any]] = {}
        for w in sorted(set(zs) | set(liars)):
            z = zs.get(w, 0.0)
            score = max(0.0, 1.0 - max(0.0, z) / (2 * self.z_fire))
            row: Dict[str, Any] = {
                "score": round(0.0 if w in liars else score, 3),
                "z": round(z, 3),
                "liar": w in liars,
                "samples": len(self._walls.get(w, ())),
            }
            if w in liars:
                row["crosscheck"] = liars[w]
            out[w] = row
        return out


# ----------------------------------------------------------------------
# (d) typed alert lifecycle
# ----------------------------------------------------------------------

class AlertManager:
    """Leader-resident alert ledger with firing→resolved transitions,
    dedup, severity, exemplar trace ids, and an append-only event
    stream.

    Determinism contract: with an injected clock, the same sequence of
    ``fire_alert``/``resolve_alert`` calls produces a byte-identical
    ``stream_json()`` — the bench replays a recorded observation
    schedule through fresh monitors + a fresh manager twice and
    compares the bytes. ``adopt`` merges relayed rows so a promoted
    leader inherits the dead leader's firing alerts and can still
    resolve them."""

    def __init__(
        self,
        clock: Callable[[], float] = time.monotonic,
        max_alerts: int = 256,
        max_events: int = 1024,
    ):
        self._clock = clock
        self.max_alerts = int(max_alerts)
        self._alerts: "OrderedDict[str, Dict[str, Any]]" = OrderedDict()
        self._events: Deque[Dict[str, Any]] = deque(maxlen=int(max_events))
        self._seq = 0
        #: transition observers, called as cb(event, row); must not
        #: raise (guarded) — the SignalPlane's standby relay rides this
        self.on_transition: List[
            Callable[[Dict[str, Any], Dict[str, Any]], None]
        ] = []

    @staticmethod
    def _key(name: str, labels: Optional[Dict[str, Any]]) -> str:
        return name + "|" + json.dumps(
            labels or {}, sort_keys=True, separators=(",", ":")
        )

    def _now(self, now: Optional[float]) -> float:
        return self._clock() if now is None else float(now)

    def _check(self, name: str) -> None:
        if name not in ALERT_NAMES:
            raise ValueError(
                f"unregistered alert name {name!r}; add it to "
                f"signal.ALERT_NAMES (and the alert catalog) first"
            )

    def _emit(self, event: Dict[str, Any], row: Dict[str, Any]) -> None:
        self._events.append(event)
        for cb in list(self.on_transition):
            try:
                cb(event, row)
            except Exception:
                log.exception("alert transition observer failed")

    def _gauge_sync(self) -> None:
        counts: Dict[str, int] = {n: 0 for n in ALERT_NAMES}
        for row in self._alerts.values():
            if row["state"] == "firing":
                counts[row["name"]] = counts.get(row["name"], 0) + 1
        for n, c in counts.items():
            _M_ALERT_FIRING.set(c, name=n)

    def _bound(self) -> None:
        while len(self._alerts) > self.max_alerts:
            victim = next(
                (k for k, r in self._alerts.items()
                 if r["state"] == "resolved"),
                next(iter(self._alerts)),
            )
            del self._alerts[victim]

    def fire_alert(
        self,
        name: str,
        labels: Optional[Dict[str, Any]] = None,
        *,
        severity: str = "warning",
        summary: str = "",
        exemplar: Optional[str] = None,
        now: Optional[float] = None,
    ) -> bool:
        """Raise (or refresh) an alert. Returns True on a firing
        TRANSITION; a dedup hit on an already-firing alert bumps its
        count/last and returns False."""
        self._check(name)
        if severity not in SEVERITIES:
            raise ValueError(f"unknown severity {severity!r}")
        t = self._now(now)
        key = self._key(name, labels)
        row = self._alerts.get(key)
        if row is not None and row["state"] == "firing":
            row["count"] += 1
            row["last"] = t
            if severity == "critical":
                row["severity"] = severity
            if exemplar and not row.get("exemplar"):
                row["exemplar"] = exemplar
            return False
        self._seq += 1
        row = {
            "name": name,
            "labels": dict(labels or {}),
            "state": "firing",
            "severity": severity,
            "summary": summary,
            "since": t,
            "last": t,
            "count": (row["count"] + 1) if row else 1,
            "seq": self._seq,
            "exemplar": exemplar,
        }
        self._alerts[key] = row
        self._alerts.move_to_end(key)
        self._bound()
        _M_ALERT_FIRED.inc(name=name, severity=severity)
        self._gauge_sync()
        self._emit(
            {"seq": self._seq, "t": t, "event": "fire", "name": name,
             "labels": dict(labels or {}), "severity": severity,
             "summary": summary, "exemplar": exemplar},
            row,
        )
        return True

    def resolve_alert(
        self,
        name: str,
        labels: Optional[Dict[str, Any]] = None,
        *,
        summary: str = "",
        now: Optional[float] = None,
    ) -> bool:
        """Resolve a firing alert. Returns True on the resolved
        transition; resolving an unknown or already-resolved alert is
        a no-op (idempotent across retries and failovers)."""
        self._check(name)
        key = self._key(name, labels)
        row = self._alerts.get(key)
        if row is None or row["state"] != "firing":
            return False
        t = self._now(now)
        self._seq += 1
        row["state"] = "resolved"
        row["last"] = t
        row["seq"] = self._seq
        if summary:
            row["summary"] = summary
        _M_ALERT_RESOLVED.inc(name=name)
        self._gauge_sync()
        self._emit(
            {"seq": self._seq, "t": t, "event": "resolve", "name": name,
             "labels": dict(labels or {}),
             "severity": row["severity"], "summary": row["summary"],
             "exemplar": row.get("exemplar")},
            row,
        )
        return True

    def is_firing(
        self, name: str, labels: Optional[Dict[str, Any]] = None
    ) -> bool:
        row = self._alerts.get(self._key(name, labels))
        return row is not None and row["state"] == "firing"

    def active(self) -> List[Dict[str, Any]]:
        return sorted(
            (dict(r) for r in self._alerts.values()
             if r["state"] == "firing"),
            key=lambda r: r["seq"],
        )

    def rows(self) -> List[Dict[str, Any]]:
        return sorted(
            (dict(r) for r in self._alerts.values()),
            key=lambda r: r["seq"],
        )

    def stream(self) -> List[Dict[str, Any]]:
        return list(self._events)

    def stream_json(self) -> bytes:
        """Canonical serialization of the event stream — the byte-
        identical determinism surface the bench compares."""
        return json.dumps(
            self.stream(), sort_keys=True, separators=(",", ":")
        ).encode("utf-8")

    def adopt(self, rows: Sequence[Dict[str, Any]]) -> int:
        """Merge relayed ledger rows (standby side of the ALERT relay;
        also the promoted leader's inheritance path). Newest-wins by
        the row's ``last`` stamp; malformed rows and unregistered
        names are dropped, not raised — the relay rides fire-and-
        forget datagrams. Returns rows adopted."""
        n = 0
        for row in rows:
            if not isinstance(row, dict):
                continue
            name = row.get("name")
            if name not in ALERT_NAMES:
                continue
            if row.get("state") not in ("firing", "resolved"):
                continue
            labels = row.get("labels")
            if labels is not None and not isinstance(labels, dict):
                continue
            key = self._key(name, labels)
            cur = self._alerts.get(key)
            if cur is not None and cur.get("last", 0) >= row.get("last", 0):
                continue
            adopted = dict(row)
            adopted["labels"] = dict(labels or {})
            self._seq = max(self._seq, int(adopted.get("seq", 0)))
            self._alerts[key] = adopted
            self._alerts.move_to_end(key)
            n += 1
        if n:
            self._bound()
            self._gauge_sync()
        return n


# ----------------------------------------------------------------------
# the plane: composition + wire surface
# ----------------------------------------------------------------------

# registry handles the window set samples. Get-or-create by name is
# idempotent, so these bind to the SAME objects the router/jobs
# modules registered (or pre-register them in import orders where the
# signal plane loads first).
_M_REQ_ADMITTED = METRICS.counter(
    "request_admitted_total",
    "requests admitted at the front door, per class")
_M_REQ_SHED = METRICS.counter(
    "request_shed_total",
    "requests shed at admission with a typed rejection, per class+reason")
_M_REQ_COMPLETED = METRICS.counter(
    "request_completed_total", "requests completed, per class")
_M_REQ_MISS = METRICS.counter(
    "request_deadline_miss_total",
    "completions that landed past their SLO deadline, per class")
_M_REQ_QWAIT = METRICS.histogram(
    "request_queue_wait_seconds",
    "admission -> batch dispatch wait, per class")
_M_COORD_ACKS = METRICS.counter(
    "coordinator_batch_acks_total",
    "worker batch ACKs processed by the coordinator, per model")


def _labeled_sum(metric: Any, **match: str) -> float:
    """Sum a metric's children whose label set contains ``match``."""
    want = set(match.items())
    total = 0.0
    for key, val in metric.items():
        if want.issubset(set(key)):
            total += float(val)
    return total


def _label_values(metric: Any, label: str) -> List[str]:
    """Distinct values of ``label`` across a metric's children."""
    vals = set()
    for key, _ in metric.items():
        for k, v in key:
            if k == label:
                vals.add(str(v))
    return sorted(vals)


def _hist_state(
    metric: Any, **match: str
) -> Optional[Tuple[float, float, Dict[str, float],
                    Optional[float], Optional[float]]]:
    """Merged cumulative state of a histogram's matching children as
    (count, sum, sparse buckets, min, max)."""
    want = set(match.items())
    count = total = 0.0
    bkt: Dict[str, float] = {}
    mn: Optional[float] = None
    mx: Optional[float] = None
    hit = False
    for key, val in metric.items():
        if not want.issubset(set(key)):
            continue
        hit = True
        c, s, lo, hi, buckets = val
        count += c
        total += s
        if c:
            mn = lo if mn is None else min(mn, lo)
            mx = hi if mx is None else max(mx, hi)
        for i, b in enumerate(buckets):
            if b:
                bkt[str(i)] = bkt.get(str(i), 0.0) + b
    return (count, total, bkt, mn, mx) if hit else None


class SignalPlane:
    """One per node (constructed by JobService): samples windows on
    every tick everywhere, but EVALUATES — burn monitors, health
    scores, alert transitions — only while this node leads. Registers
    the ALERT standby relay and the ALERT_PULL request/reply handlers
    (HANDLER_OWNERS owner: SignalPlane)."""

    #: queue-wait p95 slope (seconds of wait gained per second) that
    #: spends the trend budget at burn 1.0
    QWAIT_SLOPE_BUDGET = 0.05

    def __init__(
        self,
        node: Any,
        jobs: Any = None,
        clock: Callable[[], float] = time.monotonic,
        stride_s: Optional[float] = None,
    ):
        self.node = node
        self.jobs = jobs
        stride = (
            float(stride_s) if stride_s is not None
            else max(0.25, float(node.spec.timing.ping_interval))
        )
        self.windows = WindowSet(clock=clock, width_s=240 * stride,
                                 stride_s=stride)
        self.windows.publish()
        self.health = HealthScorer()
        self.alerts = AlertManager(clock=clock)
        self.alerts.on_transition.append(self._relay_transition)
        #: (signal, scope) -> monitor; created lazily on first
        #: evaluation so ``policy_factory`` overrides installed before
        #: traffic (benches, tests) shape every monitor
        self.monitors: Dict[Tuple[str, str], BurnRateMonitor] = {}
        self.policy_factory: Callable[[str, str], BurnRatePolicy] = (
            self._default_policy
        )
        self._node_hyst: Dict[str, Hysteresis] = {}
        self._liar_hyst: Dict[str, Hysteresis] = {}
        #: freshest bad-request exemplars pushed by the router at the
        #: shed / deadline-miss sites: kind -> recent (slo, trace_id)
        self._exemplars: Dict[str, Deque[Tuple[str, str]]] = {}
        self._tick_task: Optional[asyncio.Task] = None
        node.register(MsgType.ALERT, self._h_alert)
        node.register(MsgType.ALERT_PULL, self._h_alert_pull)

    @staticmethod
    def _default_policy(signal: str, scope: str) -> BurnRatePolicy:
        if signal == "shed_ratio":
            # shedding is the door doing its job; page only when it
            # is sustained and material
            return BurnRatePolicy(budget=2 * burn_budget(scope))
        return BurnRatePolicy(budget=burn_budget(scope))

    # -- lifecycle -----------------------------------------------------

    def start(self) -> None:
        if self._tick_task is None:
            self._tick_task = asyncio.create_task(
                self._tick_loop(),
                name=f"{self.node.me}-signal",
            )

    async def stop(self) -> None:
        t = self._tick_task
        self._tick_task = None
        await reap_task(t, self.node.me, "signal tick loop")

    async def _tick_loop(self) -> None:
        while True:
            await asyncio.sleep(self.windows.stride_s)
            try:
                self.tick()
            except Exception:
                log.exception(
                    "%s: signal tick failed", self.node.me.unique_name
                )

    # -- observation intake --------------------------------------------

    def observe_ack(
        self, worker: str, observed_s: float, ack: Dict[str, Any]
    ) -> None:
        """Coordinator hook (JobService._h_task_ack): one worker batch
        ACK's two walls — the leader-observed dispatch→ACK wall and
        the worker's self-reported exec wall."""
        try:
            reported = float(ack.get("exec_time", 0.0))
            n = int(ack.get("n_images", 1))
        except (TypeError, ValueError):
            return
        self.health.observe_ack(worker, observed_s, reported, n)

    def note_bad_request(
        self, kind: str, slo: str, trace_id: Optional[str]
    ) -> None:
        """Router hook at the shed / deadline-miss sites: remember the
        freshest bad-request trace per kind+class so a firing alert
        can attach the exemplar that EXPLAINS it (not merely a recent
        one)."""
        if not trace_id:
            return
        self._exemplars.setdefault(
            kind, deque(maxlen=32)
        ).append((slo, trace_id))

    def _exemplar_for(self, kind: str, slo: str) -> Optional[str]:
        rows = self._exemplars.get(kind)
        if rows:
            for s, tid in reversed(rows):
                if s == slo:
                    return tid
            return rows[-1][1]
        # fall back to the flight recorder's pinned exemplar traces
        tids = TRACER.exemplar_trace_ids(kind=kind)
        return tids[-1] if tids else None

    # -- tick ----------------------------------------------------------

    def tick(self, now: Optional[float] = None) -> float:
        """One signal-plane step: sample every window, then (leader
        only) evaluate monitors + health and drive the alert ledger.
        ``now`` is injectable for deterministic tests."""
        t = self._sample(now)
        _M_SIG_SAMPLES.inc()
        if self.node.is_leader:
            self._evaluate(t)
        return t

    def _sample(self, now: Optional[float] = None) -> float:
        ws = self.windows
        for cls in set(
            _label_values(_M_REQ_ADMITTED, "slo")
            + _label_values(_M_REQ_SHED, "slo")
        ):
            ws.track(
                f"miss:{cls}",
                lambda c=cls: _labeled_sum(_M_REQ_MISS, slo=c),
            )
            ws.track(
                f"completed:{cls}",
                lambda c=cls: _M_REQ_COMPLETED.value(slo=c),
            )
            ws.track(
                f"shed:{cls}",
                lambda c=cls: _labeled_sum(_M_REQ_SHED, slo=c),
            )
            ws.track(
                f"arrivals:{cls}",
                lambda c=cls: _M_REQ_ADMITTED.value(slo=c)
                + _labeled_sum(_M_REQ_SHED, slo=c),
            )
            ws.track_hist(
                f"qwait:{cls}", _M_REQ_QWAIT.edges,
                lambda c=cls: _hist_state(_M_REQ_QWAIT, slo=c),
            )
        for model in _label_values(_M_COORD_ACKS, "model"):
            ws.track(
                f"acks:{model}",
                lambda m=model: _M_COORD_ACKS.value(model=m),
            )
            if self.jobs is not None:
                ws.track(
                    f"queued:{model}",
                    lambda m=model: float(
                        self.jobs.scheduler.queue_depths().get(m, 0)
                    ),
                )
        t = ws.sample(now)
        # derived series: windowed queue-wait p95 per class, re-fed
        # into a scalar window so `trend` can report its slope
        for key in list(ws._hists):
            cls = key.split(":", 1)[1]
            p95 = ws._hists[key].quantile(0.95, t)
            if p95 is not None:
                ws.track(f"qwait_p95:{cls}", lambda: None).observe(t, p95)
        return t

    def _monitor(
        self, signal: str, scope: str, name: str,
        labels: Dict[str, Any],
    ) -> BurnRateMonitor:
        key = (signal, scope)
        m = self.monitors.get(key)
        if m is None:
            m = self.monitors[key] = BurnRateMonitor(
                self.policy_factory(signal, scope)
            )
            # a promoted leader inherits the dead leader's firing rows
            # via adopt(); its fresh monitors must start in the firing
            # state or the resolve transition could never happen
            m.hyst.firing = self.alerts.is_firing(name, labels)
        return m

    def _drive(
        self,
        trans: Optional[str],
        monitor: BurnRateMonitor,
        name: str,
        labels: Dict[str, Any],
        summary: str,
        exemplar: Optional[str],
        now: float,
    ) -> None:
        if trans is None:
            return
        sig = labels.get("signal", name)
        _M_SIG_TRANSITIONS.inc(signal=str(sig), to=trans)
        if trans == "fire":
            burn = max(
                monitor.last.get("burn_short", 0.0),
                monitor.last.get("burn_long", 0.0),
            )
            sev = "critical" if burn >= 2 * monitor.policy.fire_burn \
                else "warning"
            self.fire_alert(
                name, labels, severity=sev, summary=summary,
                exemplar=exemplar, now=now,
            )
        else:
            self.resolve_alert(name, labels, now=now)

    def _evaluate(self, now: float) -> None:
        ws = self.windows
        classes = sorted({
            k.split(":", 1)[1] for k in ws._windows if k.startswith("miss:")
        })
        for cls in classes:
            miss = ws.window(f"miss:{cls}")
            done = ws.window(f"completed:{cls}")
            shed = ws.window(f"shed:{cls}")
            arrivals = ws.window(f"arrivals:{cls}")
            if miss is not None and done is not None:
                labels = {"slo": cls, "signal": "deadline_miss"}
                m = self._monitor(
                    "deadline_miss", cls, "slo_burn_rate", labels
                )
                self._drive(
                    m.evaluate(now, miss, done), m,
                    "slo_burn_rate", labels,
                    f"{cls}: deadline-miss burn "
                    f"{m.last.get('burn_short')}x/{m.last.get('burn_long')}x "
                    f"of budget",
                    self._exemplar_for("deadline_miss", cls), now,
                )
            if shed is not None and arrivals is not None:
                labels = {"slo": cls, "signal": "shed_ratio"}
                m = self._monitor(
                    "shed_ratio", cls, "slo_burn_rate", labels
                )
                self._drive(
                    m.evaluate(now, shed, arrivals), m,
                    "slo_burn_rate", labels,
                    f"{cls}: shed-ratio burn "
                    f"{m.last.get('burn_short')}x/{m.last.get('burn_long')}x "
                    f"of budget",
                    self._exemplar_for("shed", cls), now,
                )
            p95w = ws.window(f"qwait_p95:{cls}")
            if p95w is not None:
                labels = {"slo": cls, "signal": "queue_wait_trend"}
                m = self._monitor(
                    "queue_wait_trend", cls, "slo_burn_rate", labels
                )
                p = m.policy
                bs = p95w.trend(now, p.short_s) / self.QWAIT_SLOPE_BUDGET
                bl = p95w.trend(now, p.long_s) / self.QWAIT_SLOPE_BUDGET
                self._drive(
                    m.evaluate_burns(now, bs, bl), m,
                    "slo_burn_rate", labels,
                    f"{cls}: queue-wait p95 rising "
                    f"{m.last.get('burn_short')}x/{m.last.get('burn_long')}x "
                    f"of trend budget",
                    self._exemplar_for("deadline_miss", cls), now,
                )
        # per model: the queue has work but ACK flow stalled
        models = sorted({
            k.split(":", 1)[1] for k in ws._windows if k.startswith("acks:")
        })
        for model in models:
            acks = ws.window(f"acks:{model}")
            queued = ws.window(f"queued:{model}")
            if acks is None or queued is None:
                continue
            labels = {"model": model, "signal": "model_stall"}
            m = self._monitor("model_stall", model, "slo_burn_rate", labels)
            p = m.policy
            burns = []
            for w in (p.short_s, p.long_s):
                pts = queued._span(now, w)
                starving = (
                    len(pts) >= 2
                    and all(v > 0 for _, v in pts)
                    and acks.delta(now, w) <= 0
                )
                burns.append(2.0 * p.fire_burn if starving else 0.0)
            self._drive(
                m.evaluate_burns(now, burns[0], burns[1]), m,
                "slo_burn_rate", labels,
                f"{model}: queued work with no ACK flow",
                None, now,
            )
        self._evaluate_health(now)

    def _evaluate_health(self, now: float) -> None:
        zs = self.health.zscores()
        for worker, z in zs.items():
            h = self._node_hyst.setdefault(worker, Hysteresis(2, 3))
            h.firing = h.firing or self.alerts.is_firing(
                "node_unhealthy", {"node": worker}
            )
            trans = h.update(
                True if z >= self.health.z_fire
                else (False if z <= self.health.z_fire / 2 else None)
            )
            if trans == "fire":
                _M_SIG_TRANSITIONS.inc(signal="node_z", to="fire")
                self.fire_alert(
                    "node_unhealthy", {"node": worker},
                    severity="warning",
                    summary=f"{worker}: stage walls z={z:.1f} vs pool",
                    now=now,
                )
            elif trans == "resolve":
                _M_SIG_TRANSITIONS.inc(signal="node_z", to="resolve")
                self.resolve_alert(
                    "node_unhealthy", {"node": worker}, now=now
                )
        for worker in list(self.health._pairs):
            ev = self.health.crosscheck(worker)
            h = self._liar_hyst.setdefault(worker, Hysteresis(1, 8))
            h.firing = h.firing or self.alerts.is_firing(
                "metrics_liar", {"node": worker}
            )
            trans = h.update(ev is not None)
            if trans == "fire":
                _M_SIG_LIAR.inc()
                _M_SIG_TRANSITIONS.inc(signal="crosscheck", to="fire")
                self.fire_alert(
                    "metrics_liar", {"node": worker},
                    severity="critical",
                    summary=(
                        f"{worker}: observed wall "
                        f"{ev['observed_s']}s vs self-reported "
                        f"{ev['reported_s']}s over {ev['samples']} ACKs"
                    ),
                    now=now,
                )
            elif trans == "resolve":
                _M_SIG_TRANSITIONS.inc(signal="crosscheck", to="resolve")
                self.resolve_alert(
                    "metrics_liar", {"node": worker}, now=now
                )

    # convenience pass-throughs so emission sites stay on the plane
    # (and the lint rule sees one call-shape everywhere)
    def fire_alert(self, name: str, labels=None, **kw: Any) -> bool:
        return self.alerts.fire_alert(name, labels, **kw)

    def resolve_alert(self, name: str, labels=None, **kw: Any) -> bool:
        return self.alerts.resolve_alert(name, labels, **kw)

    # -- wire surface --------------------------------------------------

    def _relay_transition(
        self, event: Dict[str, Any], row: Dict[str, Any]
    ) -> None:
        """Every ledger transition rides one small datagram to the hot
        standby, so a promoted leader inherits the firing set (the
        INGRESS_RELAY / STORE_IDEMPOTENCY_RELAY discipline applied to
        alerts)."""
        if not self.node.is_leader:
            return
        sb = self.node.standby_node()
        if sb is None or sb.unique_name == self.node.me.unique_name:
            return
        try:
            self.node.send(
                sb, MsgType.ALERT, {"row": row, "event": event["event"]}
            )
            _M_ALERT_RELAYS.inc()
        except ValueError:
            # a single row over the frame cap would need a ~60 KB
            # label set; drop rather than kill the transition path
            log.warning("alert relay row over the datagram cap")

    async def _h_alert(self, msg: Message, addr) -> None:
        """Standby side of the ledger relay: adopt the row. Only the
        CURRENT leader's ledger is authoritative — a stale ex-leader's
        late datagram must not resurrect resolved alerts."""
        if msg.sender != self.node.leader_unique:
            return
        row = msg.data.get("row")
        if isinstance(row, dict):
            if self.alerts.adopt([row]):
                log.debug(
                    "%s: adopted relayed alert %s (%s)",
                    self.node.me.unique_name, row.get("name"),
                    msg.data.get("event"),
                )

    async def _h_alert_pull(self, msg: Message, addr) -> None:
        """ALERT_PULL is request/reply on ONE MsgType: a reply leg
        carries our own rid and resolves the awaiting future here
        (the DOWNLOAD_FILE_SUCCESS discipline); a request leg gets
        the ledger + recent events + health rollup, degrading tier by
        tier through the shared cap machinery."""
        if self.node.resolve_rid(msg):
            return
        if self.node.spec.node_by_unique_name(msg.sender) is None:
            return  # forged out-of-universe datagram
        d = msg.data
        try:
            max_events = int(d.get("max_events", 256))
        except (TypeError, ValueError):
            return
        max_events = min(max(max_events, 1), 2048)
        rows = self.alerts.rows()
        events = self.alerts.stream()[-max_events:]
        health = self.health_summary()
        extra = {
            "rid": d.get("rid"),
            "ok": True,
            "node": self.node.me.unique_name,
        }
        self.node.send_tiered(
            msg.sender, MsgType.ALERT_PULL, extra,
            tiers=(
                lambda: {"alerts": rows, "events": events,
                         "health": health},
                lambda: {"alerts": rows, "events": events[-32:],
                         "health": health, "truncated": "events"},
                lambda: {"alerts": rows[-32:], "events": [],
                         "health": {}, "truncated": "events,health"},
            ),
            what="alert ledger",
        )

    def autoscale_snapshot(self, now: Optional[float] = None) -> Dict[str, Any]:
        """Controller-facing digest of the plane's current verdicts
        (dml_tpu/autoscale.py consumes one per evaluation tick):
        firing burn monitors, the SLO classes they convict, stalled
        models, per-model queue backlog, per-class arrival rates, and
        the liar/unhealthy node sets. Everything is sorted + rounded
        so a recorded tick schedule is JSON-able and replays through
        ``autoscale.replay_decision_stream`` byte-identically."""
        ws = self.windows
        t = ws.now() if now is None else float(now)
        burn: List[str] = []
        culprits: set = set()
        stalled: List[str] = []
        for (sig, scope), m in sorted(self.monitors.items()):
            if not m.hyst.firing:
                continue
            burn.append(f"{sig}|{scope}")
            if sig == "model_stall":
                stalled.append(scope)
            else:
                culprits.add(scope)
        backlog: Dict[str, float] = {}
        arrivals: Dict[str, float] = {}
        for key, w in sorted(ws._windows.items()):
            if key.startswith("queued:"):
                v = w.last()
                if v:
                    backlog[key.split(":", 1)[1]] = round(float(v), 2)
            elif key.startswith("arrivals:"):
                # lookback rides the window geometry (10 strides): the
                # idleness verdict must clear within a few evaluation
                # ticks of traffic actually stopping, at bench and
                # product timescales alike
                arrivals[key.split(":", 1)[1]] = round(
                    w.rate(t, 10.0 * ws.stride_s), 4
                )
        liars = set(self.health.liars())
        unhealthy: set = set()
        for row in self.alerts.active():
            if row["name"] == "metrics_liar":
                liars.add(str(row["labels"].get("node")))
            elif row["name"] == "node_unhealthy":
                unhealthy.add(str(row["labels"].get("node")))
        return {
            "t": round(t, 3),
            "burn_firing": burn,
            "culprit_classes": sorted(culprits),
            "stalled_models": sorted(stalled),
            "backlog": backlog,
            "arrivals_qps": arrivals,
            "liars": sorted(liars),
            "unhealthy": sorted(unhealthy),
        }

    def health_summary(self) -> Dict[str, Any]:
        """The CLI ``health`` verb's payload: per-node scores plus the
        latest burn evaluation per monitor scope."""
        return {
            "nodes": self.health.scores(),
            "monitors": {
                f"{sig}:{scope}": dict(m.last)
                for (sig, scope), m in sorted(self.monitors.items())
                if m.last
            },
            "firing": len(self.alerts.active()),
        }


# ----------------------------------------------------------------------
# deterministic replay
# ----------------------------------------------------------------------

def replay_alert_stream(
    ticks: Sequence[Dict[str, Dict[str, Any]]],
    policy: Optional[BurnRatePolicy] = None,
    clock0: float = 0.0,
    stride_s: float = 1.0,
) -> List[Dict[str, Any]]:
    """Drive a recorded observation schedule through FRESH windows,
    monitors, and an AlertManager under an injected clock.

    Each tick maps scope -> {"bad": cumulative, "total": cumulative,
    "exemplar"?: trace_id}. Pure function of its inputs: the same
    ticks and policy produce a byte-identical event stream (compare
    ``json.dumps(..., sort_keys=True)`` of the return), which is how
    the bench proves seed-determinism without pretending live cluster
    walls are reproducible."""
    pol = policy or BurnRatePolicy()
    width = max(pol.long_s * 2, stride_s * 4)
    windows: Dict[str, Tuple[MetricWindow, MetricWindow]] = {}
    monitors: Dict[str, BurnRateMonitor] = {}
    t = clock0
    mgr = AlertManager(clock=lambda: t)
    for i, tick in enumerate(ticks):
        t = clock0 + i * stride_s
        for scope, obs in sorted(tick.items()):
            bw, tw = windows.setdefault(scope, (
                MetricWindow(width_s=width, stride_s=stride_s),
                MetricWindow(width_s=width, stride_s=stride_s),
            ))
            bw.observe(t, float(obs.get("bad", 0.0)))
            tw.observe(t, float(obs.get("total", 0.0)))
            m = monitors.setdefault(scope, BurnRateMonitor(pol))
            trans = m.evaluate(t, bw, tw)
            if trans == "fire":
                mgr.fire_alert(
                    "slo_burn_rate", {"slo": scope},
                    summary=f"{scope}: replayed burn breach",
                    exemplar=obs.get("exemplar"), now=t,
                )
            elif trans == "resolve":
                mgr.resolve_alert("slo_burn_rate", {"slo": scope}, now=t)
    return mgr.stream()

"""Closed-loop autoscaler: SLO-burn-driven scale-out/in and capacity
reallocation (ROADMAP item 2, the loop the signal plane was built
for).

The signal plane (signal.py) turns the cluster's raw counters into
typed verdicts — burn-rate alerts, queue backlog, liar convictions —
but nothing acts on them: a saturated cluster pages and keeps burning.
This module closes the loop with a leader-resident, deterministic
controller in three pieces:

- ``AutoscalePolicy``: the knobs — pool floor/ceiling, pressure and
  idleness thresholds, per-kind cooldowns, hysteresis depths, the
  scale-in confirm window, reallocation step/cap.
- ``DecisionLedger``: the controller's memory — an append-only typed
  decision stream (``propose`` → ``apply``/``cancel``) with the same
  byte-identical ``stream_json()`` replay discipline as
  ``AlertManager``, plus the per-kind cooldown ledger. Every event is
  relayed to the hot standby (``MsgType.AUTOSCALE``) so a promoted
  leader inherits cooldowns and in-flight decisions and settles each
  decision id EXACTLY ONCE across the failover.
- ``AutoscaleController``: reads one ``SignalPlane.autoscale_snapshot``
  per tick through an injected clock and drives three decision kinds
  over the elastic-membership machinery:

  * **scale-out** — sustained pressure (firing burn alerts, or queue
    backlog beyond ``backlog_per_slot`` per schedulable slot) admits
    standby capacity via the environment's ``scale_out_fn`` (runtime
    JOIN, chaos/bench wire it to ``LocalCluster.scale_out``). While a
    ``metrics_liar`` conviction is live, scale-out pressure is MASKED:
    a forged-evidence straggler manufactures backlog, and paying for
    chips is not the cure for a liar.
  * **scale-in** — sustained idleness retires the newest idle slot by
    graceful LEAVE, never a node convicted unhealthy/liar, never one
    holding in-flight batches, never below ``floor``. Proposals hold
    for ``confirm_ticks`` evaluations and are CANCELLED (typed
    ``cancel``, reason ``spike``) if pressure returns first — the
    scale-in-racing-a-spike chaos case.
  * **reallocation** — when the plane's burn attribution names exactly
    one SLO class as the culprit, its ``Scheduler.class_weights``
    share is stepped up (capped), applied immediately and carried in
    the decision row so a promoted leader re-applies the same split.

Determinism contract: ``step()`` is a pure function of the snapshot
dicts and the controller's own state — ``replay_decision_stream``
drives a recorded tick schedule through a fresh controller and the
bench compares ``stream_json()`` bytes across two replays.
"""

from __future__ import annotations

import asyncio
import json
import logging
import time
from collections import OrderedDict, deque
from dataclasses import dataclass
from typing import (
    Any, Awaitable, Callable, Deque, Dict, List, Optional, Sequence,
    Set, Tuple,
)

from .cluster.util import reap_task
from .cluster.wire import Message, MsgType
from .observability import METRICS
from .signal import Hysteresis

log = logging.getLogger(__name__)

#: the closed decision taxonomy; every ledger row carries one of these
DECISION_KINDS = ("scale_out", "scale_in", "reallocate")

_M_AS_DECISIONS = METRICS.counter(
    "autoscale_decisions_total",
    "controller decision-stream events, per kind= event=")
_M_AS_POOL = METRICS.gauge(
    "autoscale_pool_size",
    "schedulable worker slots the controller last observed")
_M_AS_RELAYS = METRICS.counter(
    "autoscale_relays_total",
    "decision-ledger events relayed leader -> standby")
_M_AS_SUPPRESSED = METRICS.counter(
    "autoscale_suppressed_total",
    "decisions suppressed by a policy guard, per reason=")


@dataclass(frozen=True)
class AutoscalePolicy:
    """The controller's knobs.

    ``floor``/``ceiling``  hard pool bounds: scale-in never proposes
                    below ``floor`` (counting its own un-settled
                    proposals), scale-out never above ``ceiling``.
    ``backlog_per_slot``  queued batches per schedulable slot that
                    count as pressure even before a burn alert fires
                    (the coordinator-side signal: job bursts without
                    ingress traffic still saturate the pool).
    ``idle_arrival_qps``  arrival rate at/below which a drained pool
                    reads as idle.
    ``out_*``/``in_*``  hysteresis depths per direction — scale-in
                    demands a longer streak than scale-out because
                    shedding capacity is the riskier mistake — plus
                    per-kind cooldowns debouncing repeat decisions.
    ``confirm_ticks``  evaluations a scale-in proposal holds before
                    actuating; pressure returning inside the window
                    cancels it (typed ``cancel``, reason ``spike``).
    ``realloc_step``/``realloc_cap``  multiplicative class-weight step
                    for the culprit class and its absolute cap.
    ``apply_timeout_s``  a proposed decision whose effect never lands
                    (join refused, leaver wedged) is cancelled instead
                    of pinning its kind's in-flight slot forever.
    """

    floor: int = 2
    ceiling: int = 8
    backlog_per_slot: float = 8.0
    idle_arrival_qps: float = 0.05
    out_fire_after: int = 2
    out_clear_after: int = 2
    in_fire_after: int = 4
    in_clear_after: int = 1
    confirm_ticks: int = 1
    out_cooldown_s: float = 10.0
    in_cooldown_s: float = 20.0
    realloc_cooldown_s: float = 30.0
    realloc_step: float = 0.5
    realloc_cap: float = 8.0
    apply_timeout_s: float = 30.0


class DecisionLedger:
    """Append-only autoscale decision stream + cooldown ledger.

    Rows move ``proposed`` → ``applied`` | ``cancelled`` exactly once
    (``settle`` on a non-proposed row is a no-op — idempotent across
    relays and failovers, the exactly-once actuation surface the chaos
    sweep asserts on). The event stream carries one typed event per
    transition and serializes byte-identically under an injected clock
    (``AlertManager.stream_json`` discipline); ``adopt`` merges relayed
    rows + cooldowns so a promoted leader inherits both."""

    def __init__(
        self,
        clock: Callable[[], float] = time.monotonic,
        max_rows: int = 256,
        max_events: int = 1024,
    ):
        self._clock = clock
        self.max_rows = int(max_rows)
        self._rows: "OrderedDict[str, Dict[str, Any]]" = OrderedDict()
        self._events: Deque[Dict[str, Any]] = deque(maxlen=int(max_events))
        self._seq = 0
        #: kind -> not-before time (injected-clock domain)
        self.cooldowns: Dict[str, float] = {}
        #: transition observers, called as cb(event, row); must not
        #: raise (guarded) — the controller's standby relay rides this
        self.on_event: List[
            Callable[[Dict[str, Any], Dict[str, Any]], None]
        ] = []

    def _now(self, now: Optional[float]) -> float:
        return self._clock() if now is None else float(now)

    def in_cooldown(self, kind: str, now: Optional[float] = None) -> bool:
        return self._now(now) < self.cooldowns.get(kind, float("-inf"))

    def arm_cooldown(self, kind: str, until: float) -> None:
        self.cooldowns[kind] = round(float(until), 3)

    def _emit(self, event: Dict[str, Any], row: Dict[str, Any]) -> None:
        self._events.append(event)
        for cb in list(self.on_event):
            try:
                cb(event, row)
            except Exception:
                log.exception("decision event observer failed")

    def _bound(self) -> None:
        while len(self._rows) > self.max_rows:
            victim = next(
                (k for k, r in self._rows.items()
                 if r["state"] != "proposed"),
                next(iter(self._rows)),
            )
            del self._rows[victim]

    def propose(
        self,
        kind: str,
        target: Optional[str] = None,
        *,
        reason: str = "",
        detail: Optional[Dict[str, Any]] = None,
        now: Optional[float] = None,
    ) -> Dict[str, Any]:
        """Open a decision. The id embeds the ledger seq, so a decision
        minted by the dead leader and one minted by its successor can
        never collide (the successor's seq continues past every adopted
        row's)."""
        if kind not in DECISION_KINDS:
            raise ValueError(f"unknown decision kind {kind!r}")
        t = round(self._now(now), 3)
        self._seq += 1
        did = f"{kind}:{target or '-'}:{self._seq}"
        row = {
            "id": did,
            "kind": kind,
            "target": target,
            "state": "proposed",
            "reason": reason,
            "since": t,
            "last": t,
            "seq": self._seq,
            "detail": dict(detail or {}),
        }
        self._rows[did] = row
        self._rows.move_to_end(did)
        self._bound()
        _M_AS_DECISIONS.inc(kind=kind, event="propose")
        self._emit(
            {"seq": self._seq, "t": t, "event": "propose", "id": did,
             "kind": kind, "target": target, "reason": reason},
            row,
        )
        return row

    def settle(
        self,
        did: str,
        outcome: str,
        *,
        reason: str = "",
        now: Optional[float] = None,
    ) -> bool:
        """Close a proposed decision as ``applied`` or ``cancelled``.
        Returns True on the transition; settling an unknown or already-
        settled row is a no-op — the exactly-once guarantee a promoted
        leader leans on after adopting the dead leader's ledger."""
        if outcome not in ("applied", "cancelled"):
            raise ValueError(f"unknown decision outcome {outcome!r}")
        row = self._rows.get(did)
        if row is None or row["state"] != "proposed":
            return False
        t = round(self._now(now), 3)
        self._seq += 1
        row["state"] = outcome
        row["last"] = t
        row["seq"] = self._seq
        if reason:
            row["reason"] = reason
        ev = "apply" if outcome == "applied" else "cancel"
        _M_AS_DECISIONS.inc(kind=row["kind"], event=ev)
        self._emit(
            {"seq": self._seq, "t": t, "event": ev, "id": did,
             "kind": row["kind"], "target": row["target"],
             "reason": reason},
            row,
        )
        return True

    def mark_actuated(
        self, did: str, *, now: Optional[float] = None
    ) -> bool:
        """Record that a proposed decision's actuator FIRED (the LEAVE
        was sent, the join was requested) before its effect is
        observable in the universe. A typed ``actuate`` event hits the
        stream — and therefore the standby relay — so a leader killed
        between firing and the actuation ACK leaves a successor that
        knows not to fire again, and the merged per-node streams
        expose exactly-once actuation directly."""
        row = self._rows.get(did)
        if (
            row is None
            or row["state"] != "proposed"
            or row["detail"].get("actuated")
        ):
            return False
        t = round(self._now(now), 3)
        self._seq += 1
        row["detail"]["actuated"] = True
        row["last"] = t
        row["seq"] = self._seq
        _M_AS_DECISIONS.inc(kind=row["kind"], event="actuate")
        self._emit(
            {"seq": self._seq, "t": t, "event": "actuate", "id": did,
             "kind": row["kind"], "target": row["target"], "reason": ""},
            row,
        )
        return True

    def pending(self, kind: Optional[str] = None) -> List[Dict[str, Any]]:
        return sorted(
            (r for r in self._rows.values()
             if r["state"] == "proposed"
             and (kind is None or r["kind"] == kind)),
            key=lambda r: r["seq"],
        )

    def rows(self) -> List[Dict[str, Any]]:
        return sorted(
            (dict(r) for r in self._rows.values()),
            key=lambda r: r["seq"],
        )

    def stream(self) -> List[Dict[str, Any]]:
        return list(self._events)

    def stream_json(self) -> bytes:
        """Canonical serialization of the decision stream — the byte-
        identical determinism surface the bench compares."""
        return json.dumps(
            self.stream(), sort_keys=True, separators=(",", ":")
        ).encode("utf-8")

    def adopt(
        self,
        rows: Sequence[Dict[str, Any]],
        cooldowns: Optional[Dict[str, Any]] = None,
    ) -> int:
        """Merge relayed rows + cooldowns (standby side of the
        AUTOSCALE relay; also the promoted leader's inheritance path).
        Newest-wins by the row's ``last`` stamp; cooldowns merge by
        max, so the successor can only be MORE debounced than the dead
        leader, never less. Malformed rows are dropped, not raised —
        the relay rides fire-and-forget datagrams."""
        n = 0
        for row in rows:
            if not isinstance(row, dict):
                continue
            did = row.get("id")
            if not isinstance(did, str):
                continue
            if row.get("kind") not in DECISION_KINDS:
                continue
            if row.get("state") not in ("proposed", "applied", "cancelled"):
                continue
            cur = self._rows.get(did)
            if cur is not None and cur.get("last", 0) >= row.get("last", 0):
                continue
            adopted = dict(row)
            adopted["detail"] = dict(row.get("detail") or {})
            self._seq = max(self._seq, int(adopted.get("seq", 0)))
            self._rows[did] = adopted
            self._rows.move_to_end(did)
            n += 1
        if n:
            self._bound()
        for kind, until in (cooldowns or {}).items():
            if kind in DECISION_KINDS:
                try:
                    u = float(until)
                except (TypeError, ValueError):
                    continue
                if u > self.cooldowns.get(kind, float("-inf")):
                    self.cooldowns[kind] = u
        return n


class AutoscaleController:
    """One per node (constructed by JobService next to the
    SignalPlane): adopts relayed ledger state everywhere, but
    EVALUATES — and actuates — only while this node leads. Registers
    the AUTOSCALE standby relay handler (HANDLER_OWNERS owner:
    AutoscaleController).

    Actuation is environment-provided: ``scale_out_fn`` /
    ``scale_in_fn`` are injected by whatever owns real capacity (the
    chaos harness and bench wire ``LocalCluster.scale_out`` /
    ``scale_in``; a bare controller emits decisions only), while
    reallocation applies directly to the scheduler. A ``node=None``
    controller is the pure policy core ``replay_decision_stream``
    drives."""

    def __init__(
        self,
        node: Any = None,
        jobs: Any = None,
        plane: Any = None,
        policy: Optional[AutoscalePolicy] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.node = node
        self.jobs = jobs
        self.plane = plane
        self.policy = policy or AutoscalePolicy()
        self._clock = clock
        self.ledger = DecisionLedger(clock=clock)
        self.ledger.on_event.append(self._relay_event)
        self._out_hyst = Hysteresis(
            self.policy.out_fire_after, self.policy.out_clear_after
        )
        self._in_hyst = Hysteresis(
            self.policy.in_fire_after, self.policy.in_clear_after
        )
        #: environment actuators (None = decision-only mode)
        self.scale_out_fn: Optional[Callable[[], Awaitable[Any]]] = None
        self.scale_in_fn: Optional[Callable[[str], Awaitable[Any]]] = None
        #: smallest pool the controller ever evaluated — the invariant
        #: sweep's pool-never-below-floor witness
        self.min_pool_seen: Optional[int] = None
        self._eval_task: Optional[asyncio.Task] = None
        self._bg: Set[asyncio.Task] = set()
        if node is not None:
            node.register(MsgType.AUTOSCALE, self._h_autoscale)
            node.on_became_leader_cbs.append(self._on_promoted)
            node.on_node_left_cbs.append(self._on_node_left)

    def configure(self, policy: AutoscalePolicy) -> None:
        """Swap the policy in place (harnesses wire this after the
        JobService constructed the controller). Hysteresis depths
        rebuild from the new policy; call before traffic, not
        mid-flight, or streak state resets under the controller."""
        self.policy = policy
        self._out_hyst = Hysteresis(
            policy.out_fire_after, policy.out_clear_after
        )
        self._in_hyst = Hysteresis(
            policy.in_fire_after, policy.in_clear_after
        )

    # -- lifecycle -----------------------------------------------------

    def start(self) -> None:
        if self._eval_task is None and self.plane is not None:
            self._eval_task = asyncio.create_task(
                self._eval_loop(),
                name=f"{self.node.me}-autoscale",
            )

    async def stop(self) -> None:
        t = self._eval_task
        self._eval_task = None
        await reap_task(t, self.node.me if self.node else "-", "autoscale loop")
        for bg in list(self._bg):
            bg.cancel()
        self._bg.clear()

    async def _eval_loop(self) -> None:
        while True:
            await asyncio.sleep(self.plane.windows.stride_s)
            try:
                self.evaluate()
            except Exception:
                log.exception(
                    "%s: autoscale evaluation failed",
                    self.node.me.unique_name,
                )

    # -- evaluation ----------------------------------------------------

    def evaluate(self, now: Optional[float] = None) -> List[Dict[str, Any]]:
        """One live control step (leader only): snapshot the signal
        plane + scheduler, run the deterministic core, then fire the
        environment actuators for whatever the core decided. Returns
        the decision events this step emitted."""
        if self.node is None or not self.node.is_leader:
            return []
        t = self._clock() if now is None else float(now)
        snap = self.plane.autoscale_snapshot(t)
        snap["pool"] = sorted(self.jobs.worker_pool())
        snap["busy"] = sorted(
            set(self.jobs.scheduler.in_progress)
            | set(self.jobs.scheduler.prefetch)
        )
        snap["class_weights"] = {
            k: round(float(v), 4)
            for k, v in sorted(self.jobs.scheduler.class_weights.items())
        }
        before = len(self.ledger.stream())
        acts = self.step(snap)
        for kind, target in acts:
            self._actuate(kind, target)
        return self.ledger.stream()[before:]

    def step(
        self, snap: Dict[str, Any]
    ) -> List[Tuple[str, Optional[str]]]:
        """The deterministic policy core: one snapshot in, ledger
        transitions + an actuation list out. Pure function of the
        snapshot sequence and the controller's own state — no wall
        clock, no registry reads — so a recorded tick schedule replays
        byte-identically (``replay_decision_stream``)."""
        p = self.policy
        t = float(snap["t"])
        pool = list(snap.get("pool") or [])
        n = len(pool)
        self.min_pool_seen = (
            n if self.min_pool_seen is None else min(self.min_pool_seen, n)
        )
        _M_AS_POOL.set(n)
        acts: List[Tuple[str, Optional[str]]] = []

        # settle in-flight decisions against the observed pool: a
        # scale-out applies when capacity actually joined, a scale-in
        # when the target actually left — the actuation ACK is the
        # universe itself, so a promoted leader settles an inherited
        # decision from observation instead of trusting relay order
        for row in self.ledger.pending():
            if row["kind"] == "scale_out":
                if n > int(row["detail"].get("pool_n", 0)):
                    self.ledger.settle(
                        row["id"], "applied",
                        reason="capacity-joined", now=t,
                    )
                elif t - row["since"] > p.apply_timeout_s:
                    self.ledger.settle(
                        row["id"], "cancelled", reason="timeout", now=t,
                    )
            elif row["kind"] == "scale_in":
                if row["target"] not in pool:
                    self.ledger.settle(
                        row["id"], "applied",
                        reason="leave-observed", now=t,
                    )
                elif t - row["since"] > p.apply_timeout_s:
                    self.ledger.settle(
                        row["id"], "cancelled", reason="timeout", now=t,
                    )

        backlog = sum(
            float(v) for v in (snap.get("backlog") or {}).values()
        )
        arrivals = sum(
            float(v) for v in (snap.get("arrivals_qps") or {}).values()
        )
        liars = set(snap.get("liars") or [])
        unhealthy = set(snap.get("unhealthy") or [])
        burn = list(snap.get("burn_firing") or [])
        pressure = bool(burn) or backlog > p.backlog_per_slot * max(1, n)
        idle = (
            not pressure
            and backlog <= 0
            and arrivals <= p.idle_arrival_qps
        )
        if pressure and liars:
            # a convicted liar's stall manufactures backlog and burn;
            # admitting capacity would pay for forged evidence, so the
            # pressure streak HOLDS (None) instead of advancing
            self._out_hyst.update(None)
            _M_AS_SUPPRESSED.inc(reason="liar")
        else:
            self._out_hyst.update(True if pressure else False)
        self._in_hyst.update(
            True if idle else (False if pressure else None)
        )

        pending_out = len(self.ledger.pending("scale_out"))
        pending_in = len(self.ledger.pending("scale_in"))

        # scale-out: debounced pressure admits one slot per cooldown
        if self._out_hyst.firing and pressure and not liars:
            if n + pending_out >= p.ceiling:
                _M_AS_SUPPRESSED.inc(reason="ceiling")
            elif self.ledger.in_cooldown("scale_out", t):
                _M_AS_SUPPRESSED.inc(reason="cooldown")
            elif pending_out == 0:
                self.ledger.propose(
                    "scale_out", None,
                    reason="slo-burn" if burn else "backlog",
                    detail={
                        "pool_n": n,
                        "burn": burn[:4],
                        "backlog": round(backlog, 2),
                    },
                    now=t,
                )
                self.ledger.arm_cooldown("scale_out", t + p.out_cooldown_s)
                acts.append(("scale_out", None))

        # scale-in: pending proposals ride the confirm window; a spike
        # arriving inside it cancels rather than races the LEAVE. A row
        # whose actuator already fired is past cancelling — the LEAVE
        # is in flight and the pool shrink itself re-arms the pressure
        # path, which is the compensation
        for row in self.ledger.pending("scale_in"):
            if row["detail"].get("actuated"):
                continue
            if pressure:
                self.ledger.settle(
                    row["id"], "cancelled", reason="spike", now=t,
                )
            else:
                left = int(row["detail"].get("confirm_left", 0))
                if left > 0:
                    row["detail"]["confirm_left"] = left - 1
                elif self.ledger.mark_actuated(row["id"], now=t):
                    acts.append(("scale_in", row["target"]))
        if self._in_hyst.firing and idle:
            if n - pending_in <= p.floor:
                _M_AS_SUPPRESSED.inc(reason="floor")
            elif self.ledger.in_cooldown("scale_in", t):
                _M_AS_SUPPRESSED.inc(reason="cooldown")
            elif pending_in == 0:
                victim = self._victim(snap, pool, liars | unhealthy)
                if victim is not None:
                    self.ledger.propose(
                        "scale_in", victim, reason="idle",
                        detail={
                            "pool_n": n,
                            "confirm_left": p.confirm_ticks,
                        },
                        now=t,
                    )
                    self.ledger.arm_cooldown(
                        "scale_in", t + p.in_cooldown_s
                    )

        # reallocation: exactly one SLO class named as the burn
        # culprit while others are healthy -> step its fair share up
        culprits = list(snap.get("culprit_classes") or [])
        weights = {
            k: float(v)
            for k, v in (snap.get("class_weights") or {}).items()
        }
        if (
            len(culprits) == 1
            and len(weights) >= 2
            and culprits[0] in weights
        ):
            if self.ledger.in_cooldown("reallocate", t):
                _M_AS_SUPPRESSED.inc(reason="cooldown")
            else:
                cls = culprits[0]
                new = {k: round(v, 4) for k, v in weights.items()}
                new[cls] = round(
                    min(weights[cls] * (1.0 + p.realloc_step),
                        p.realloc_cap),
                    4,
                )
                if new != {k: round(v, 4) for k, v in weights.items()}:
                    row = self.ledger.propose(
                        "reallocate", cls, reason="p99-culprit",
                        detail={"weights": new, "prev": {
                            k: round(v, 4) for k, v in weights.items()
                        }},
                        now=t,
                    )
                    # weight surgery is local + instant: applied in
                    # the same step, no external ACK to wait on
                    self.ledger.settle(
                        row["id"], "applied", reason="weights-set", now=t,
                    )
                    self.ledger.arm_cooldown(
                        "reallocate", t + p.realloc_cooldown_s
                    )
                    acts.append(("reallocate", cls))
        return acts

    @staticmethod
    def _victim(
        snap: Dict[str, Any], pool: List[str], convicted: Set[str]
    ) -> Optional[str]:
        """Deterministic scale-in victim: never a convicted node,
        never one holding in-flight/staged batches; among the eligible,
        the newest capacity goes first — runtime joiners get the
        highest ports, and the (len, str) key orders ``host:port``
        unames numerically by port."""
        busy = set(snap.get("busy") or [])
        elig = [u for u in pool if u not in convicted and u not in busy]
        if not elig:
            return None
        return max(elig, key=lambda u: (len(u), u))

    def _actuate(self, kind: str, target: Optional[str]) -> None:
        if kind == "reallocate":
            if self.jobs is not None:
                rows = [
                    r for r in self.ledger.rows()
                    if r["kind"] == "reallocate" and r["state"] == "applied"
                ]
                if rows:
                    w = rows[-1]["detail"].get("weights")
                    if isinstance(w, dict):
                        self.jobs.scheduler.reweight_classes(
                            {k: float(v) for k, v in w.items()}
                        )
            return
        fn: Optional[Callable[..., Awaitable[Any]]] = None
        args: Tuple[Any, ...] = ()
        if kind == "scale_out" and self.scale_out_fn is not None:
            fn = self.scale_out_fn
        elif kind == "scale_in" and self.scale_in_fn is not None:
            fn = self.scale_in_fn
            args = (target,)
        if fn is None:
            return
        try:
            task = asyncio.get_running_loop().create_task(fn(*args))
        except RuntimeError:
            log.debug("no running loop; %s actuation skipped", kind)
            return
        self._bg.add(task)
        task.add_done_callback(self._bg.discard)

    # -- failover inheritance ------------------------------------------

    def _on_promoted(self) -> None:
        """Promotion hook: the adopted ledger already carries the dead
        leader's cooldowns and in-flight decisions (settled exactly
        once by observation in the next ``step``); the one piece that
        needs re-actuation is the class-weight split, which lives in
        the scheduler the dead leader mutated, not ours."""
        if self.jobs is None:
            return
        rows = [
            r for r in self.ledger.rows()
            if r["kind"] == "reallocate" and r["state"] == "applied"
        ]
        if rows:
            w = rows[-1]["detail"].get("weights")
            if isinstance(w, dict):
                try:
                    self.jobs.scheduler.reweight_classes(
                        {k: float(v) for k, v in w.items()}
                    )
                except (TypeError, ValueError):
                    log.warning("adopted reallocation row malformed")

    def _on_node_left(self, uname: str) -> None:
        """Graceful-LEAVE observation (fires on every node applying
        the universe removal): the leader settles a matching in-flight
        scale-in immediately instead of waiting a tick."""
        if self.node is None or not self.node.is_leader:
            return
        for row in self.ledger.pending("scale_in"):
            if row["target"] == uname:
                self.ledger.settle(
                    row["id"], "applied", reason="leave-observed"
                )

    # -- wire surface --------------------------------------------------

    def _relay_event(
        self, event: Dict[str, Any], row: Dict[str, Any]
    ) -> None:
        """Every ledger transition rides one small datagram to the hot
        standby (the ALERT relay discipline applied to decisions), so
        a promoted leader inherits cooldowns + in-flight decisions."""
        if self.node is None or not self.node.is_leader:
            return
        sb = self.node.standby_node()
        if sb is None or sb.unique_name == self.node.me.unique_name:
            return
        try:
            self.node.send(
                sb, MsgType.AUTOSCALE,
                {"row": row, "event": event["event"],
                 "cooldowns": dict(self.ledger.cooldowns)},
            )
            _M_AS_RELAYS.inc()
        except ValueError:
            log.warning("autoscale relay row over the datagram cap")

    async def _h_autoscale(self, msg: Message, addr) -> None:
        """Standby side of the decision relay: adopt the row + the
        cooldown ledger. Only the CURRENT leader's ledger is
        authoritative — a stale ex-leader's late datagram must not
        reopen settled decisions."""
        if msg.sender != self.node.leader_unique:
            return
        row = msg.data.get("row")
        cds = msg.data.get("cooldowns")
        if self.ledger.adopt(
            [row] if isinstance(row, dict) else [],
            cooldowns=cds if isinstance(cds, dict) else None,
        ):
            log.debug(
                "%s: adopted relayed decision %s (%s)",
                self.node.me.unique_name,
                row.get("id") if isinstance(row, dict) else None,
                msg.data.get("event"),
            )

    def summary(self) -> Dict[str, Any]:
        """Operator rollup: latest rows, cooldowns, pool floor
        evidence."""
        return {
            "rows": self.ledger.rows()[-16:],
            "cooldowns": dict(self.ledger.cooldowns),
            "min_pool_seen": self.min_pool_seen,
            "policy": {
                "floor": self.policy.floor,
                "ceiling": self.policy.ceiling,
            },
        }


# ----------------------------------------------------------------------
# deterministic replay + scoring
# ----------------------------------------------------------------------

def replay_decision_stream(
    ticks: Sequence[Dict[str, Any]],
    policy: Optional[AutoscalePolicy] = None,
) -> List[Dict[str, Any]]:
    """Drive a recorded snapshot schedule through a FRESH controller
    core (no node, no actuators). Pure function of its inputs: the
    same ticks and policy produce a byte-identical event stream
    (compare ``json.dumps(..., sort_keys=True)`` of the return) — how
    the bench proves the decision plane is seed-deterministic without
    pretending live cluster walls are reproducible."""
    ctl = AutoscaleController(policy=policy, clock=lambda: 0.0)
    for snap in ticks:
        ctl.step(snap)
    return ctl.ledger.stream()


def slo_violation_minutes(
    trace: Any,
    outcomes: Sequence[Any],
    bucket_s: float = 5.0,
    budget: float = 0.05,
) -> float:
    """Score an open-loop run as SLO-violation-MINUTES: the trace is
    cut into ``bucket_s`` buckets by arrival time (outcomes align with
    ``trace.arrivals`` by index — ``run_open_loop``'s contract) and a
    bucket is violating when more than ``budget`` of its arrivals
    missed their deadline or were shed/lost. The diurnal bench compares
    this integral between static and autoscaled provisioning."""
    if not trace.arrivals or not outcomes:
        return 0.0
    buckets: Dict[int, List[bool]] = {}
    for a, o in zip(trace.arrivals, outcomes):
        bad = not (
            getattr(o, "terminal", None) == "completed"
            and getattr(o, "deadline_met", False)
        )
        buckets.setdefault(int(a.t // bucket_s), []).append(bad)
    violating = sum(
        1 for rows in buckets.values()
        if (sum(rows) / len(rows)) > budget
    )
    return round(violating * bucket_s / 60.0, 4)

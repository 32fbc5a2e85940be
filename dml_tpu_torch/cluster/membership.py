"""SWIM-style membership list with suspicion, cleanup, and repair hooks.

Replaces the reference's MemberShipList (membershipList.py:1-154) with a
pure-logic core: no I/O, injectable clock, explicit hook callbacks —
so the merge/suspicion/cleanup semantics are unit-testable (the
reference has zero tests for this, SURVEY §4).

Semantics preserved from the reference:
- entry = unique_name -> (timestamp, status); merge keeps the newest
  timestamp (membershipList.py:103-130)
- suspicion after the failure detector reports >N missed ACKs
  (worker.py:1090-1121 -> update_node_status, membershipList.py:132-139)
- suspects are removed after `cleanup_time` seconds; removal fires
  hooks: leader-death -> election (membershipList.py:39-43), node-death
  -> job requeue (membershipList.py:46), >=k cleaned -> re-replication
  (membershipList.py:49-52), ping-target repair (membershipList.py:54-59)
- a suspect that ACKs again before cleanup is restored and counted as
  a false positive (membershipList.py:23-24, 113-118)
"""

from __future__ import annotations

import random
import time
import zlib
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from ..config import ClusterSpec, NodeId
from ..observability import METRICS

ALIVE = 1
SUSPECT = 0

# SWIM failure-detector events as registry metrics (the fp-rate CLI
# counters, made scrapeable and cluster-aggregatable)
_M_SUSPECT = METRICS.counter(
    "cluster_suspicions_total",
    "nodes marked SUSPECT (direct + gossip-indirect)")
_M_FALSE_POS = METRICS.counter(
    "cluster_false_positives_total",
    "suspects that proved alive before cleanup")
_M_FAILED = METRICS.counter(
    "cluster_node_failures_total", "suspects cleaned up as dead")
_M_ALIVE = METRICS.gauge(
    "cluster_alive_nodes", "members this node currently sees ALIVE")
# delta-gossip accounting: how many piggyback payloads go out bounded
# vs full-table, and how many member entries they carry — the
# per-datagram O(N) vs O(K) story the control_plane_scale bench scores
_M_GOSSIP_EX = METRICS.counter(
    "membership_gossip_exchanges_total",
    "gossip piggyback payloads built, by mode (delta|full)")
_M_GOSSIP_ENTRIES = METRICS.counter(
    "membership_gossip_entries_total",
    "member entries carried by gossip piggybacks, by mode (delta|full)")


@dataclass
class MembershipHooks:
    """Callbacks fired by cleanup — wired by the node composition layer."""

    on_leader_failed: Optional[Callable[[str], None]] = None
    on_node_failed: Optional[Callable[[str], None]] = None
    on_replication_needed: Optional[Callable[[List[str]], None]] = None
    on_topology_change: Optional[Callable[[], None]] = None


@dataclass
class MembershipList:
    spec: ClusterSpec
    me: NodeId
    hooks: MembershipHooks = field(default_factory=MembershipHooks)
    clock: Callable[[], float] = time.time
    #: fault-injection seam: this node's wall clock is wrong by this
    #: many seconds. Every SWIM timestamp this node mints (self
    #: heartbeats, suspicion marks, merge bookkeeping) is skewed, so
    #: the chaos clock-skew scenario exercises the real gossip paths.
    clock_offset: float = 0.0
    #: merge-time clamp on FUTURE timestamps, in seconds past our own
    #: now (None disables). Without it, gossip from a skewed-AHEAD
    #: node is unbeatable once that node dies: our SUSPECT mark uses
    #: our clock, the circulating ALIVE entry carries the future ts,
    #: and every merge "resurrects" the corpse until our clock catches
    #: up — clock skew would mask a real failure for its full
    #: magnitude. Clamping to now+cleanup_time bounds the extra
    #: eviction delay to one cleanup window. (SWIM proper uses
    #: incarnation numbers; the reference — and this repro — use wall
    #: timestamps, so the clamp is the minimal skew armor.)
    max_future_skew: Optional[float] = None
    #: seed for the delta-gossip random-tail selection stream; the
    #: node runtime passes its own seed so one cluster seed
    #: reproduces every node's piggyback choices (tested:
    #: same seed ⇒ identical selection stream)
    gossip_seed: int = 0

    def __post_init__(self):
        if self.max_future_skew is None:
            self.max_future_skew = self.spec.timing.cleanup_time
        self._members: Dict[str, Tuple[float, int]] = {
            self.me.unique_name: (self._now(), ALIVE)
        }
        # delta-gossip state: per-entry piggyback count since the
        # entry last CHANGED (new member, status flip). Fresh entries
        # (low counts) get piggyback priority; timestamps-only
        # refreshes don't reset it (steady-state heartbeats ride the
        # self-entry + random tail + periodic full exchange instead).
        self._fresh: Dict[str, int] = {}
        self._gossip_rounds = 0
        self._gossip_rng = random.Random(
            zlib.crc32(f"{self.gossip_seed}/{self.me.unique_name}"
                       .encode()) & 0x7FFFFFFF
        )
        self._suspect_since: Dict[str, float] = {}
        # tombstones: uname -> last gossip timestamp at cleanup time.
        # Without these, a lagging peer's stale gossip re-adds a cleaned
        # node (merge sees "unknown entry") and the failure hooks
        # re-fire — restarting resolved elections and repairs.
        self._tombstones: Dict[str, float] = {}
        self.leader: Optional[str] = None
        self.false_positives = 0
        self.indirect_failures = 0
        self.cleaned_since_replication: List[str] = []
        self._ping_targets: List[NodeId] = []
        #: monotonic SWIM-view epoch: bumps whenever the alive set (or
        #: any member's status) changes. Derivations that are pure
        #: functions of the view — e.g. the worker-group pool collapse
        #: (jobs/groups.py) — memoize on this instead of re-deriving
        #: O(groups×members) every scheduling tick.
        self.view_epoch = 0
        self.recompute_ping_targets()

    def _now(self) -> float:
        """This node's (possibly skewed) SWIM clock."""
        return self.clock() + self.clock_offset

    # ---- views ----

    def snapshot(self) -> Dict[str, Tuple[float, int]]:
        """Gossip payload + cleanup pass (reference .get(),
        membershipList.py:97-101, runs _cleanup on every call)."""
        self.cleanup()
        return dict(self._members)

    def delta_active(self) -> bool:
        """True when ``gossip()`` is actually bounding its payloads
        (delta protocol AND the table has outgrown the bound). The
        node runtime keys its scale behaviors off this — e.g. the
        extra random-member ping that turns ring-structured gossip
        spread into an epidemic — so small-N clusters stay
        bit-compatible with the reference protocol."""
        return (
            self.spec.gossip_protocol == "delta"
            and len(self._members)
            > 1 + max(0, self.spec.gossip_delta_k)
            + max(0, self.spec.gossip_delta_tail)
        )

    def gossip(self) -> Dict[str, Tuple[float, int]]:
        """The piggyback payload for one PING/ACK.

        In ``full`` mode (or whenever the table is small enough that a
        bound would be a no-op) this IS ``snapshot()`` — bit-identical
        to the reference protocol, which is why the small-N tier-1
        tests pass unmodified. In ``delta`` mode the payload is
        bounded: our own entry (heartbeat freshness must always
        propagate), the ``gossip_delta_k`` entries with the highest
        recent-change priority (fewest piggybacks since their status
        last changed; newest timestamp, then name, as deterministic
        tie-breaks), and a seeded random tail of ``gossip_delta_tail``
        of the rest (the slow anti-entropy that keeps stable entries'
        timestamps circulating). Every ``gossip_full_every``-th
        payload is a full table — the bounded-delta analog of SWIM's
        periodic anti-entropy sync, closing any gap the bounded
        selection left.

        The receiving side is unchanged: a delta payload is just a
        partial members dict and ``merge`` is already newest-wins per
        entry, so delta and full peers interoperate freely."""
        self.cleanup()
        spec = self.spec
        k = max(0, spec.gossip_delta_k)
        tail = max(0, spec.gossip_delta_tail)
        if not self.delta_active():
            out = dict(self._members)
            _M_GOSSIP_EX.inc(1, mode="full")
            _M_GOSSIP_ENTRIES.inc(len(out), mode="full")
            return out
        self._gossip_rounds += 1
        if (
            spec.gossip_full_every > 0
            and self._gossip_rounds % spec.gossip_full_every == 0
        ):
            out = dict(self._members)
            _M_GOSSIP_EX.inc(1, mode="full")
            _M_GOSSIP_ENTRIES.inc(len(out), mode="full")
            return out
        me = self.me.unique_name
        others = [u for u in self._members if u != me]
        # freshness priority: fewest sends since change, then newest
        # timestamp, then name — a total, deterministic order
        others.sort(key=lambda u: (
            self._fresh.get(u, 1 << 30), -self._members[u][0], u
        ))
        chosen = others[:k]
        rest = others[k:]
        if rest and tail:
            chosen += self._gossip_rng.sample(rest, min(tail, len(rest)))
        out = {me: self._members[me]}
        for u in chosen:
            out[u] = self._members[u]
            # only tracked-fresh entries age; a random-tail pick of a
            # long-stable entry must not be re-minted as "fresh"
            if u in self._fresh:
                self._fresh[u] += 1
        _M_GOSSIP_EX.inc(1, mode="delta")
        _M_GOSSIP_ENTRIES.inc(len(out), mode="delta")
        return out

    def alive_nodes(self) -> List[NodeId]:
        out = []
        for uname, (_, status) in self._members.items():
            if status == ALIVE:
                node = self.spec.node_by_unique_name(uname)
                if node is not None:
                    out.append(node)
        return out

    def is_alive(self, unique_name: str) -> bool:
        ent = self._members.get(unique_name)
        return ent is not None and ent[1] == ALIVE

    @property
    def ping_targets(self) -> List[NodeId]:
        return list(self._ping_targets)

    # ---- mutation ----

    def heartbeat_self(self) -> None:
        self._members[self.me.unique_name] = (self._now(), ALIVE)

    def merge(self, gossip: Dict[str, Tuple[float, int]]) -> None:
        """Newest-timestamp merge (reference update(),
        membershipList.py:103-130). A remote ALIVE entry newer than our
        SUSPECT entry un-suspects the node (false-positive accounting,
        membershipList.py:113-118)."""
        changed = False
        horizon = (
            None if self.max_future_skew is None
            else self._now() + self.max_future_skew
        )
        for uname, entry in gossip.items():
            try:
                ts, status = float(entry[0]), int(entry[1])
            except (TypeError, ValueError, IndexError, KeyError):
                continue  # garbled/byzantine entry: skip, keep the rest
            if status not in (ALIVE, SUSPECT):
                continue
            if horizon is not None and ts > horizon:
                # future-dated gossip (a skewed-ahead clock): clamp to
                # our horizon so the entry is still beatable by our own
                # observations once its producer stops refreshing it
                ts = horizon
            if uname == self.me.unique_name:
                continue
            if self.spec.node_by_unique_name(uname) is None:
                continue  # unknown node: ignore (static universe, like reference)
            cur = self._members.get(uname)
            if cur is None:
                dead_ts = self._tombstones.get(uname)
                if dead_ts is not None and ts <= dead_ts:
                    continue  # stale gossip about a node we already cleaned
                self._tombstones.pop(uname, None)  # genuinely rejoined
                self._members[uname] = (ts, status)
                self._fresh[uname] = 0  # new entry: piggyback priority
                changed = True
                if status == SUSPECT:
                    self._suspect_since[uname] = self._now()
                    self.indirect_failures += 1
                    _M_SUSPECT.inc()
                continue
            if ts > cur[0]:
                if cur[1] == SUSPECT and status == ALIVE:
                    self.false_positives += 1
                    _M_FALSE_POS.inc()
                    self._suspect_since.pop(uname, None)
                if cur[1] == ALIVE and status == SUSPECT:
                    self._suspect_since[uname] = self._now()
                    self.indirect_failures += 1
                    _M_SUSPECT.inc()
                if cur[1] != status:
                    changed = True
                    self._fresh[uname] = 0  # status flip: re-prioritize
                self._members[uname] = (ts, status)
        if changed:
            self.recompute_ping_targets()
            if self.hooks.on_topology_change:
                self.hooks.on_topology_change()

    def suspect(self, unique_name: str) -> None:
        """Failure detector reports missed ACKs (reference
        update_node_status, membershipList.py:132-139)."""
        if unique_name == self.me.unique_name:
            return
        cur = self._members.get(unique_name)
        if cur is None or cur[1] == SUSPECT:
            return
        self._members[unique_name] = (self._now(), SUSPECT)
        self._suspect_since[unique_name] = self._now()
        self._fresh[unique_name] = 0  # the suspicion must spread fast
        _M_SUSPECT.inc()
        self.recompute_ping_targets()
        if self.hooks.on_topology_change:
            self.hooks.on_topology_change()

    def mark_alive(self, unique_name: str) -> None:
        """Direct evidence of life (an ACK from the node itself)."""
        if self.spec.node_by_unique_name(unique_name) is None:
            return  # forged/stray sender outside the cluster spec
        cur = self._members.get(unique_name)
        changed = cur is None or cur[1] == SUSPECT
        if cur is not None and cur[1] == SUSPECT:
            self.false_positives += 1
            _M_FALSE_POS.inc()
        self._tombstones.pop(unique_name, None)  # direct evidence beats a tombstone
        self._suspect_since.pop(unique_name, None)
        self._members[unique_name] = (self._now(), ALIVE)
        if changed:
            self._fresh[unique_name] = 0  # resurrection must spread fast
            self.recompute_ping_targets()
            if self.hooks.on_topology_change:
                self.hooks.on_topology_change()

    def remove(self, unique_name: str) -> None:
        """Voluntary leave (reference CLI option 4)."""
        self._members.pop(unique_name, None)
        self._suspect_since.pop(unique_name, None)
        self._fresh.pop(unique_name, None)
        self.recompute_ping_targets()

    def retire(self, unique_name: str) -> bool:
        """Graceful departure (elastic LEAVE): drop the member NOW —
        no suspicion window, no cleanup delay, no failure counters —
        and tombstone it so a lagging peer's stale ALIVE gossip can't
        resurrect the entry. A planned scale-in must never read as an
        outage: the SWIM failure path (suspect -> cleanup ->
        _M_FAILED) is for nodes that DIDN'T say goodbye. Returns True
        when the member was present."""
        ent = self._members.pop(unique_name, None)
        self._suspect_since.pop(unique_name, None)
        self._fresh.pop(unique_name, None)
        self._tombstones[unique_name] = (
            max(ent[0], self._now()) if ent is not None else self._now()
        )
        if ent is None:
            return False
        self.recompute_ping_targets()
        if self.hooks.on_topology_change:
            self.hooks.on_topology_change()
        return True

    def prune_unknown(self) -> List[str]:
        """Drop members the spec no longer knows (they LEFT the
        universe): without this an entry for a retired node lingers
        ALIVE in the table forever — it is never pinged (ring comes
        from the spec) so it can never be suspected, but it skews the
        alive gauge and keeps riding our gossip. Not a failure:
        no hooks, no counters."""
        gone = [
            u for u in self._members
            if u != self.me.unique_name
            and self.spec.node_by_unique_name(u) is None
        ]
        for u in gone:
            ent = self._members.pop(u, None)
            self._suspect_since.pop(u, None)
            self._fresh.pop(u, None)
            if ent is not None:
                self._tombstones[u] = max(ent[0], self._now())
        if gone:
            self.recompute_ping_targets()
        return gone

    def reset(self) -> None:
        """Leave the cluster: forget everyone but self."""
        self._members = {self.me.unique_name: (self._now(), ALIVE)}
        self._suspect_since.clear()
        self._tombstones.clear()
        self._fresh.clear()
        self.leader = None
        self.recompute_ping_targets()

    # ---- cleanup + hooks (reference _cleanup, membershipList.py:26-59) ----

    def cleanup(self) -> List[str]:
        now = self._now()
        expired = [
            u
            for u, since in self._suspect_since.items()
            if now - since >= self.spec.timing.cleanup_time
        ]
        for uname in expired:
            _M_FAILED.inc()
            ent = self._members.pop(uname, None)
            if ent is not None:
                self._tombstones[uname] = ent[0]
            self._suspect_since.pop(uname, None)
            self._fresh.pop(uname, None)
            self.cleaned_since_replication.append(uname)
            if uname == self.leader:
                self.leader = None
                if self.hooks.on_leader_failed:
                    self.hooks.on_leader_failed(uname)
            if self.hooks.on_node_failed:
                self.hooks.on_node_failed(uname)
        if expired:
            self.recompute_ping_targets()
            if self.hooks.on_topology_change:
                self.hooks.on_topology_change()
            # re-replicate once >= ring_k nodes have been cleaned
            # (reference membershipList.py:49-52 waits for >= M)
            if len(self.cleaned_since_replication) >= self.spec.ring_k:
                batch = list(self.cleaned_since_replication)
                self.cleaned_since_replication.clear()
                if self.hooks.on_replication_needed:
                    self.hooks.on_replication_needed(batch)
        return expired

    def flush_replication_backlog(self) -> None:
        """Force the pending-cleanup batch out (used when the caller
        wants prompt re-replication rather than waiting for >=k)."""
        if self.cleaned_since_replication and self.hooks.on_replication_needed:
            batch = list(self.cleaned_since_replication)
            self.cleaned_since_replication.clear()
            self.hooks.on_replication_needed(batch)

    # ---- ping-target repair (reference topology_change +
    #      _find_replacement_node, membershipList.py:61-95) ----

    def recompute_ping_targets(self) -> None:
        """Ping the next k *live* ring successors, walking past
        suspects and not-yet-joined nodes — the reference does this
        with a recursive replacement search (_find_replacement_node);
        computing from the canonical ring is equivalent and simpler.

        Every caller reaches here exactly when the membership view
        changed, so this is also where the view epoch advances."""
        self.view_epoch += 1
        _M_ALIVE.set(
            sum(1 for _, st in self._members.values() if st == ALIVE)
        )
        ring = self.spec.ring()
        if self.me not in ring or len(ring) <= 1:
            self._ping_targets = []
            return
        i = ring.index(self.me)
        k = min(self.spec.ring_k, len(ring) - 1)
        targets: List[NodeId] = []
        j = 1
        while len(targets) < k and j < len(ring):
            cand = ring[(i + j) % len(ring)]
            ent = self._members.get(cand.unique_name)
            if ent is not None and ent[1] == ALIVE:
                targets.append(cand)
            j += 1
        self._ping_targets = targets

    # ---- display (reference print(), membershipList.py:141-154) ----

    def format(self) -> str:
        lines = []
        for uname, (ts, status) in sorted(self._members.items()):
            node = self.spec.node_by_unique_name(uname)
            tag = "ALIVE " if status == ALIVE else "SUSPECT"
            mark = " *leader*" if uname == self.leader else ""
            lines.append(f"{str(node or uname):>20}  {tag}  ts={ts:.3f}{mark}")
        return "\n".join(lines)

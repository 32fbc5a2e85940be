"""The node runtime: composition layer tying every subsystem together.

Replaces the reference's 2,000-line `Worker` god-class (worker.py) with
a small core that owns the transport, membership, election, and the
background loops, and delegates subsystem message handling to pluggable
services (store, jobs) via a handler registry.

Core responsibilities (reference call stacks, SURVEY §3):
- packet dispatch loop          (reference _run_handler, worker.py:539)
- failure-detection ping loop   (reference run_failure_detection,
                                 worker.py:1181-1199)
- join/bootstrap via introducer (reference worker.py:551-614, 1137-1148)
- election driving + COORDINATE (reference worker.py:621-649, 1161-1179)

Key design fixes over the reference (SURVEY §7 quirks):
- request/response correlation uses per-request ids and futures, not
  single-slot Events (reference worker.py:43-44 is race-prone)
- the election winner is computed, not hardcoded to H2
- suspects/cleanup/topology repair live in the pure-logic
  MembershipList; this file only does I/O
"""

from __future__ import annotations

import asyncio
import hmac as _hmac
import itertools
import logging
import math
import os
import random
import time
from typing import (
    Any, Awaitable, Callable, Dict, Iterable, List, Optional, Tuple,
)

from ..config import ClusterSpec, NodeId, join_mac, leave_mac, reply_mac
from ..observability import METRICS
from .election import Election
from .membership import MembershipHooks, MembershipList
from .transport import UdpTransport
from .util import reap_task
from .wire import Message, MsgType

log = logging.getLogger(__name__)

# two-level metrics aggregation accounting (Node.pull_cluster_metrics
# relay mode): shard pulls executed by role, the per-shard wall, and
# shards that fell back to direct leader pulls after a relay failure
_M_RELAY_PULLS = METRICS.counter(
    "metrics_relay_pulls_total",
    "relay-shard metrics aggregations executed, by role (leader|relay)")
_M_RELAY_T = METRICS.histogram(
    "metrics_relay_seconds",
    "one relay shard: bounded peer pulls + pre-merge wall")
_M_RELAY_FALLBACK = METRICS.counter(
    "metrics_relay_fallback_total",
    "relay shards that failed and fell back to direct leader pulls")

# elastic membership (authenticated runtime join/leave): admissions,
# typed rejections, graceful departures, and the universe version in
# force — the byzantine-join chaos scenario asserts the rejection
# counters move while no phantom enters the table
_M_JOIN_ADMIT = METRICS.counter(
    "membership_join_admitted_total",
    "authenticated runtime joins admitted, by kind (new|rejoin)")
_M_JOIN_REJECT = METRICS.counter(
    "membership_join_rejected_total",
    "JOIN_REQUESTs rejected, by reason "
    "(disabled|garbled|bad_mac|stale_epoch|replay)")
_M_LEAVES = METRICS.counter(
    "membership_leaves_total",
    "graceful LEAVE departures retired by the leader")
_M_LEAVE_REJECT = METRICS.counter(
    "membership_leave_rejected_total",
    "LEAVE announcements rejected, by reason "
    "(disabled|garbled|bad_mac|stale_epoch|replay)")
_M_UEPOCH = METRICS.gauge(
    "membership_universe_epoch",
    "version of the dynamic node universe this process holds")

#: bound on the leader's seen-nonce replay window (join + leave MACs)
_NONCE_CAP = 4096

Handler = Callable[[Message, Tuple[str, int]], Awaitable[None]]


class Node:
    """One cluster node: transport + membership + election + services."""

    def __init__(
        self,
        spec: ClusterSpec,
        me: NodeId,
        seed: int = 0,
        join_group: Optional[str] = None,
    ):
        self.spec = spec
        self.me = me
        self.seed = seed
        #: worker group this node asks to be absorbed into when it
        #: joins at runtime (rides JOIN_REQUEST; None = plain slot)
        self.join_group = join_group
        self.transport: Optional[UdpTransport] = None
        self.membership = MembershipList(
            spec,
            me,
            hooks=MembershipHooks(
                on_leader_failed=self._on_leader_failed,
                on_node_failed=self._on_node_failed,
                on_replication_needed=self._on_replication_needed,
            ),
            gossip_seed=seed,
        )
        self.election = Election(spec, me)
        self.joined = False
        self._missed_acks: Dict[str, int] = {}
        self._ack_waiters: Dict[str, asyncio.Event] = {}
        self._handlers: Dict[MsgType, Handler] = {}
        self._pending: Dict[str, asyncio.Future] = {}
        self._rid_counter = itertools.count(1)
        self._tasks: List[asyncio.Task] = []
        # short-lived background work spawned by handlers (e.g. a
        # relay-shard metrics pull, which must NOT run inline in the
        # dispatch loop — it awaits replies that arrive through that
        # same loop). Self-pruning; reaped at stop().
        self._bg_tasks: set = set()
        self._introducer_reg_task: Optional[asyncio.Task] = None
        self._stopped = asyncio.Event()
        self._left = False
        self._probe_idx = 0  # anti-entropy probe round-robin cursor
        # elastic membership state: last universe epoch each peer
        # advertised (drives the per-target gossip catch-up), the
        # bounded seen-nonce replay window (leader side), and the
        # authenticated epoch hint a stale-epoch JOIN rejection taught
        # us to claim next try
        self._peer_uepoch: Dict[str, int] = {}
        self._seen_nonces: Dict[str, None] = {}
        self._join_epoch_hint = 0
        self._last_uepoch = spec.universe_epoch
        # seeded chooser for the delta-mode random gossip target (one
        # extra ping per tick at scale; see _random_gossip_target)
        self._gossip_rng = random.Random(
            (seed * 2654435761 + self.me.port) & 0x7FFFFFFF
        )
        # services hook these (wired by store/job services at attach)
        self.on_node_failed_cbs: List[Callable[[str], None]] = []
        # graceful-LEAVE observers: fired (on every node applying the
        # universe removal) IN ADDITION to on_node_failed_cbs when a
        # departure is a scale-in, not a crash — the router purges its
        # session-affinity rows here and the autoscaler settles its
        # in-flight scale-in decisions
        self.on_node_left_cbs: List[Callable[[str], None]] = []
        self.on_coordinate_ack_cbs: List[Callable[[str, Dict], None]] = []
        self.on_replication_needed_cbs: List[Callable[[List[str]], None]] = []
        self.on_became_leader_cbs: List[Callable[[], None]] = []
        self.on_new_leader_cbs: List[Callable[[str], None]] = []
        # inventory provider: returns {file: [versions]} for join/COORDINATE_ACK
        self.local_inventory: Callable[[], Dict[str, List[int]]] = lambda: {}
        self._register_core_handlers()

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------

    async def start(self) -> None:
        self.transport = await UdpTransport.bind(
            self.me.host,
            self.me.port,
            testing=self.spec.testing,
            drop_pct=self.spec.packet_drop_pct,
            seed=self.seed,
        )
        self._stopped.clear()
        self._tasks = [
            asyncio.create_task(self._dispatch_loop(), name=f"{self.me}-dispatch"),
            asyncio.create_task(self._failure_detection_loop(), name=f"{self.me}-fd"),
        ]
        log.info("%s up on %s", self.me, self.me.unique_name)

    async def stop(self) -> None:
        self._stopped.set()
        for t in self._tasks:
            # real teardown bugs get logged (the old blanket
            # `except (CancelledError, Exception)` swallowed them)
            await reap_task(t, self.me, f"task {t.get_name()}")
        self._tasks = []
        for t in list(self._bg_tasks):
            await reap_task(t, self.me, f"bg task {t.get_name()}")
        self._bg_tasks.clear()
        if self.transport is not None:
            self.transport.close()
            self.transport = None

    async def run_forever(self) -> None:
        await self._stopped.wait()

    # ------------------------------------------------------------------
    # messaging primitives
    # ------------------------------------------------------------------

    def register(self, mtype: MsgType, handler: Handler) -> None:
        if mtype in self._handlers:
            raise ValueError(f"handler already registered for {mtype!r}")
        self._handlers[mtype] = handler

    def send(self, to: NodeId, mtype: MsgType, data: Dict[str, Any]) -> None:
        assert self.transport is not None, "node not started"
        self.transport.send(Message(self.me.unique_name, mtype, data), to.addr)

    def send_unique(self, unique_name: str, mtype: MsgType, data: Dict[str, Any]) -> None:
        node = self.spec.node_by_unique_name(unique_name)
        if node is not None:
            self.send(node, mtype, data)

    def new_rid(self) -> str:
        return f"{self.me.unique_name}#{next(self._rid_counter)}"

    async def request(
        self,
        to: NodeId,
        mtype: MsgType,
        data: Dict[str, Any],
        timeout: Optional[float] = None,
    ) -> Dict[str, Any]:
        """Send a message carrying a fresh `rid` and await the reply
        that echoes it. Replaces the reference's single-slot
        `_waiting_for_leader_event` (worker.py:43-44, 1123-1135) with
        per-request futures so concurrent requests don't race.
        """
        rid = self.new_rid()
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._pending[rid] = fut
        try:
            self.send(to, mtype, {**data, "rid": rid})
            t = timeout if timeout is not None else self.spec.timing.leader_rpc_timeout
            return await asyncio.wait_for(fut, t)
        finally:
            self._pending.pop(rid, None)

    def resolve_rid(self, msg: Message) -> bool:
        """Route a reply carrying `rid` to its waiting future. Services
        call this from their ACK handlers (or rely on the dispatcher's
        fallback, which resolves any un-handled message with a rid)."""
        rid = msg.data.get("rid")
        if not isinstance(rid, str):
            return False  # absent — or byzantine junk (unhashable)
        fut = self._pending.get(rid)
        if fut is not None and not fut.done():
            fut.set_result(msg.data)
            return True
        return False

    @property
    def leader_unique(self) -> Optional[str]:
        return self.membership.leader

    @property
    def leader_node(self) -> Optional[NodeId]:
        if self.membership.leader is None:
            return None
        return self.spec.node_by_unique_name(self.membership.leader)

    @property
    def is_leader(self) -> bool:
        return self.joined and self.membership.leader == self.me.unique_name

    def standby_node(self) -> Optional[NodeId]:
        """The hot standby: the would-be election winner if the
        leader died now (reference hardcodes H2; we compute it). The
        ONE definition — the store's failover relays and the chaos
        engine's target resolution both delegate here, so the rule
        can't drift between them."""
        alive = [
            n for n in self.membership.alive_nodes()
            if n.unique_name != self.me.unique_name
        ]
        return self.spec.election_winner(alive)

    async def leader_request(
        self, mtype: MsgType, data: Dict[str, Any], timeout: Optional[float] = None
    ) -> Dict[str, Any]:
        leader = self.leader_node
        if leader is None:
            raise RuntimeError("no leader known")
        return await self.request(leader, mtype, data, timeout)

    # ------------------------------------------------------------------
    # dispatch loop (reference _run_handler, worker.py:539)
    # ------------------------------------------------------------------

    async def _dispatch_loop(self) -> None:
        assert self.transport is not None
        while True:
            msg, addr = await self.transport.recv()
            handler = self._handlers.get(msg.type)
            try:
                if handler is not None:
                    await handler(msg, addr)
                else:
                    # default: a reply to an in-flight request
                    self.resolve_rid(msg)
            except Exception:  # keep the loop alive (reference does too)
                log.exception("%s: handler for %s failed", self.me, msg.type.name)

    # ------------------------------------------------------------------
    # failure detection (reference run_failure_detection, worker.py:1181)
    # ------------------------------------------------------------------

    async def _failure_detection_loop(self) -> None:
        while True:
            try:
                if self._left:
                    pass  # voluntarily left: silent until rejoin()
                elif not self.joined:
                    await self._try_join()
                else:
                    if self.spec.universe_epoch != self._last_uepoch:
                        # the spec changed under us without a wire
                        # event on THIS node (in-process sims share
                        # one spec object; production paths go
                        # through _adopt_universe): re-derive
                        self._universe_changed()
                    self.membership.heartbeat_self()
                    self.membership.cleanup()
                    if self.election.in_progress:
                        self._election_tick()
                    await self._ping_round()
                    self._anti_entropy_probe()
            except Exception:
                log.exception("%s: failure-detection tick failed", self.me)
            await asyncio.sleep(self.spec.timing.ping_interval)

    async def _ping_round(self) -> None:
        targets = self.membership.ping_targets
        extra = self._random_gossip_targets(targets)
        if extra:
            targets = targets + extra
        # bounded piggyback (full table in "full" mode / at small N /
        # on the periodic anti-entropy round) — built ONCE per round,
        # shared by every target, like the reference
        gossip = self.membership.gossip()
        await asyncio.gather(
            *(self._ping_one(t, gossip) for t in targets), return_exceptions=True
        )

    def _random_gossip_targets(
        self, ring_targets: List[NodeId]
    ) -> List[NodeId]:
        """Seeded-random ALIVE members pinged on top of the ring
        successors — only while the bounded delta protocol is active
        (``MembershipList.delta_active``; small-N clusters stay
        bit-compatible with the reference's pure ring pings).

        Ring-structured gossip spreads a status change LINEARLY in N
        (each tick pushes it ring_k hops along the ring): at 128
        nodes a suspicion took ~N/ring_k ticks to reach everyone and
        cluster-wide failure detection scaled with N. Random peers
        per tick make the spread an epidemic — O(log N) rounds —
        which is exactly SWIM's random-member probe; the ring pings
        remain the deterministic failure-detection backbone. One
        random target suffices for the epidemic exponent; a second
        joins past ~64 alive members to keep the constant factor (and
        with it cluster-wide failure-detection latency) flat in N."""
        if not self.membership.delta_active():
            return []
        exclude = {t.unique_name for t in ring_targets}
        exclude.add(self.me.unique_name)
        candidates = [
            n for n in self.membership.alive_nodes()
            if n.unique_name not in exclude
        ]
        if not candidates:
            return []
        want = min(len(candidates), 2 if len(candidates) > 64 else 1)
        return self._gossip_rng.sample(candidates, want)

    def _universe_piggyback(
        self, data: Dict[str, Any], peer_epoch: Optional[int]
    ) -> Dict[str, Any]:
        """Attach the elastic-universe fields to a gossip payload:
        our epoch (`ue`, so the peer knows whether to catch US up) and
        — when we know the peer is behind — a contiguous WINDOW of
        HMAC-stamped change entries past its epoch (`uni`); a peer
        far behind converges window by window over successive
        exchanges. Only log entries ride gossip; the `full` table
        form (needed only past the retained UNIVERSE_LOG_CAP) rides
        the authenticated JOIN_ACK path alone. No-ops (and keeps the
        wire byte-identical) when the join policy is off."""
        if not self.spec.join_secret:
            return data
        data["ue"] = self.spec.universe_epoch
        if peer_epoch is not None and peer_epoch < self.spec.universe_epoch:
            uni = self.spec.universe_delta(peer_epoch, max_entries=16)
            if "full" not in uni:
                data["uni"] = uni
        return data

    def _note_universe(self, msg: Message) -> None:
        """Fold a gossip datagram's universe fields into our state:
        remember the peer's epoch, apply any change entries (each
        verifies its own HMAC stamp — a forged sender can ship them
        but cannot mint them). Out-of-universe senders are ignored
        wholesale: the unauthenticated drop posture stays intact."""
        if not self.spec.join_secret:
            return
        if self.spec.node_by_unique_name(msg.sender) is None:
            return
        ue = msg.data.get("ue")
        if isinstance(ue, int) and ue >= 0:
            self._peer_uepoch[msg.sender] = ue
        uni = msg.data.get("uni")
        if isinstance(uni, dict):
            self._adopt_universe(uni)

    async def _ping_one(self, target: NodeId, gossip: Dict[str, Any]) -> None:
        """One ping + ACK wait (reference check/_wait,
        worker.py:1083-1159). >N consecutive misses => suspect."""
        uname = target.unique_name
        ev = asyncio.Event()
        self._ack_waiters[uname] = ev
        self.send(target, MsgType.PING, self._universe_piggyback(
            {"members": gossip, "leader": self.membership.leader},
            self._peer_uepoch.get(uname),
        ))
        try:
            await asyncio.wait_for(ev.wait(), self.spec.timing.ack_timeout)
            self._missed_acks[uname] = 0
        except asyncio.TimeoutError:
            self._missed_acks[uname] = self._missed_acks.get(uname, 0) + 1
            if self._missed_acks[uname] > self.spec.timing.missed_acks_to_suspect:
                log.info("%s: suspecting %s", self.me, uname)
                if log.isEnabledFor(logging.DEBUG):
                    # the table render is O(N) string work — at 128
                    # nodes that's real money on a hot path, so it is
                    # never built unless DEBUG is actually on
                    log.debug("%s membership table:\n%s",
                              self.me, self.membership.format())
                self.membership.suspect(uname)
                self._missed_acks[uname] = 0
        finally:
            if self._ack_waiters.get(uname) is ev:
                del self._ack_waiters[uname]

    def _anti_entropy_probe(self) -> None:
        """Each tick, ping ONE spec node we currently believe dead
        (round-robin). Ping targets come from the ALIVE list, so once
        a node is cleaned up nothing would ever talk to it again —
        a healed network partition (or a false-positive cleanup the
        node never noticed) would leave the cluster permanently split.
        The probe re-establishes contact: its ACK resurrects the peer
        here (mark_alive clears the tombstone) and the piggybacked
        gossip + leader fields resurrect this side over there. One
        datagram per tick; dead-forever nodes just never answer.
        (The reference has no equivalent — a cleaned node can only
        return via a voluntary re-join, README STEP-4.)"""
        alive = {n.unique_name for n in self.membership.alive_nodes()}
        candidates = [
            n for n in self.spec.nodes
            if n.unique_name != self.me.unique_name
            and n.unique_name not in alive
        ]
        if not candidates:
            return
        target = candidates[self._probe_idx % len(candidates)]
        self._probe_idx += 1
        self.send(target, MsgType.PING, self._universe_piggyback(
            {
                "members": self.membership.snapshot(),
                "leader": self.membership.leader,
            },
            self._peer_uepoch.get(target.unique_name),
        ))

    def _check_leader_conflict(self, their_leader: Optional[str]) -> None:
        """Two sides of a healed partition each elected a leader; the
        disagreement is only observable through the leader field that
        pings/ACKs piggyback. Re-running the bully election converges
        everyone on the rank winner AND rebuilds the store's global
        table from the COORDINATE_ACK inventories — the same
        reconciliation a failover uses.

        Guard: the foreign leader must be ALIVE in our merged view.
        During an ordinary failover, a node still carrying the DEAD
        old leader in its gossip would otherwise trigger a spurious
        cluster-wide re-election (+ metadata rebuild) on every
        staggered suspicion; in the genuine partition-heal case the
        merge that just ran has already resurrected the other side's
        leader, so the guard never masks a real conflict."""
        mine = self.membership.leader
        if (
            self.joined
            and their_leader
            and mine
            and their_leader != mine
            and self.membership.is_alive(their_leader)
            and not self.election.in_progress
        ):
            log.info(
                "%s: leader conflict (%s here vs %s there) -> election",
                self.me, mine, their_leader,
            )
            self.election.start()

    # ------------------------------------------------------------------
    # join/bootstrap (reference worker.py:551-614, 1137-1148)
    # ------------------------------------------------------------------

    async def _try_join(self) -> None:
        if self.spec.introducer is None:
            # no introducer: standalone/leader-of-one mode
            self._become_leader()
            return
        try:
            reply = await self.request(
                self.spec.introducer,
                MsgType.FETCH_INTRODUCER,
                {},
                timeout=self.spec.timing.ack_timeout,
            )
        except asyncio.TimeoutError:
            log.debug("%s: introducer DNS unreachable, retrying", self.me)
            return
        introducer = reply.get("introducer", "")
        if introducer == self.me.unique_name:
            self._become_leader()
            return
        target = self.spec.node_by_unique_name(introducer)
        if self.spec.join_secret:
            # join policy on: EVERY join is the authenticated
            # handshake — for a node the leader already knows it is a
            # mark-alive rejoin (no epoch bump), for a new node it is
            # admission into a bumped universe. The leader may itself
            # be a runtime joiner we haven't learned yet, so resolve
            # its address from the unique name when the table can't.
            await self._join_authenticated(
                introducer, target or self._nid_from_unique(introducer)
            )
            return
        if target is None:
            return
        try:
            ack = await self.request(
                target, MsgType.INTRODUCE, {}, timeout=self.spec.timing.ack_timeout
            )
        except asyncio.TimeoutError:
            log.debug("%s: leader %s not answering INTRODUCE", self.me, introducer)
            return
        self.membership.merge(ack.get("members", {}))
        self.membership.mark_alive(introducer)
        self._set_leader(ack.get("leader") or introducer)
        self.joined = True
        log.info("%s joined; leader=%s", self.me, self.membership.leader)
        # report local files so the leader's global table includes us
        # (reference ALL_LOCAL_FILES, worker.py:592-593)
        self.send(target, MsgType.ALL_LOCAL_FILES, {"files": self.local_inventory()})

    @staticmethod
    def _nid_from_unique(uname: str) -> Optional[NodeId]:
        """A dialable NodeId from a bare ``host:port`` unique name —
        the elastic-membership escape hatch for addressing a leader
        that joined after our table was written."""
        host, _, port = str(uname).rpartition(":")
        try:
            p = int(port)
        except (TypeError, ValueError):
            return None
        if not host or not (0 < p < 65536):
            return None
        return NodeId(host, p)

    async def _join_authenticated(
        self, introducer: str, target: Optional[NodeId]
    ) -> None:
        """The JOIN_REQUEST handshake (one attempt; the failure-
        detection loop retries each tick). The request carries our
        identity + a fresh nonce + the universe epoch we believe
        current, HMAC-bound to the shared cluster secret; the reply is
        MAC-verified before ANY field of it is trusted. A stale_epoch
        rejection teaches us the cluster's epoch (authenticated), so
        the next tick's attempt claims it — replayed captures can't
        follow, which is the point of binding the epoch."""
        if target is None:
            return
        secret = self.spec.join_secret
        epoch = max(self.spec.universe_epoch, self._join_epoch_hint)
        nonce = os.urandom(8).hex()
        node_d = {"host": self.me.host, "port": self.me.port,
                  "name": self.me.name, "rank": self.me.rank}
        data: Dict[str, Any] = {
            "node": node_d, "nonce": nonce, "epoch": epoch,
            "have": self.spec.universe_epoch,
            "mac": join_mac(secret, node_d, nonce, epoch,
                            group=self.join_group or ""),
        }
        if self.join_group:
            data["group"] = self.join_group
        try:
            ack = await self.request(
                target, MsgType.JOIN_REQUEST, data,
                timeout=self.spec.timing.ack_timeout,
            )
        except asyncio.TimeoutError:
            log.debug("%s: leader %s not answering JOIN_REQUEST",
                      self.me, introducer)
            return
        uni = ack.get("universe")
        try:
            ack_epoch = int(ack.get("epoch", -1))
        except (TypeError, ValueError):
            return
        mac = ack.get("mac")
        want = reply_mac(secret, nonce, ack_epoch,
                         uni if isinstance(uni, dict) else {})
        if not isinstance(mac, str) or not _hmac.compare_digest(mac, want):
            log.warning(
                "%s: JOIN_ACK failed authentication; ignoring", self.me
            )
            return
        if not ack.get("ok"):
            reason = ack.get("reason")
            if reason == "stale_epoch" and ack_epoch >= 0:
                self._join_epoch_hint = ack_epoch
                log.info(
                    "%s: join told stale_epoch; retrying at epoch %d",
                    self.me, ack_epoch,
                )
            else:
                log.warning("%s: join rejected (%r)", self.me, reason)
            return
        if isinstance(uni, dict):
            self._adopt_universe(uni, verified=True)
        self.membership.merge(ack.get("members", {}))
        self.membership.mark_alive(introducer)
        self._set_leader(ack.get("leader") or introducer)
        self.joined = True
        self._join_epoch_hint = 0
        log.info("%s joined (authenticated); leader=%s epoch=%d",
                 self.me, self.membership.leader, self.spec.universe_epoch)
        self.send(target, MsgType.ALL_LOCAL_FILES,
                  {"files": self.local_inventory()})

    def _adopt_universe(self, delta: Any, verified: bool = False) -> bool:
        """Apply a universe catch-up and re-derive everything keyed on
        the node table. A `leave` entry retires the member from SWIM
        immediately (graceful scale-in must not ride the suspicion
        path as a false failure) and fires the node-failed service
        hooks so in-flight work requeues — minus the failure counters."""
        before = {n.unique_name for n in self.spec.nodes}
        if not self.spec.apply_universe(delta, verified=verified):
            return False
        for gone in sorted(before - {n.unique_name for n in self.spec.nodes}):
            self.membership.retire(gone)
            self._missed_acks.pop(gone, None)
            for cb in self.on_node_failed_cbs:
                cb(gone)
            # a universe removal is always a graceful departure (a
            # crash only marks membership failed; the table entry
            # stays) — tell the leave-specific observers too
            for cb in self.on_node_left_cbs:
                cb(gone)
        self._universe_changed()
        return True

    def _universe_changed(self) -> None:
        """The node table changed under us: ring/ping targets and the
        epoch gauge re-derive, membership entries for departed nodes
        retire (not fail), and bookkeeping for departed peers drops."""
        self._last_uepoch = self.spec.universe_epoch
        _M_UEPOCH.set(self.spec.universe_epoch)
        self.membership.prune_unknown()
        self.membership.recompute_ping_targets()
        for u in list(self._peer_uepoch):
            if self.spec.node_by_unique_name(u) is None:
                self._peer_uepoch.pop(u, None)

    def _become_leader(self) -> None:
        self.joined = True
        self._set_leader(self.me.unique_name)
        log.info("%s is the leader", self.me)
        for cb in self.on_became_leader_cbs:
            cb()
        # own the DNS record for as long as we lead (see the loop's
        # docstring) — spawned here, not in _announce_coordinator, so
        # the bootstrap leader (who never runs an election) keeps a
        # restarted DNS honest too
        if self.spec.introducer is not None and (
            self._introducer_reg_task is None
            or self._introducer_reg_task.done()
        ):
            self._introducer_reg_task = asyncio.create_task(
                self._introducer_registration_loop(),
                name=f"{self.me}-introducer-reg",
            )
            self._tasks.append(self._introducer_reg_task)

    def _set_leader(self, unique_name: Optional[str]) -> None:
        prev = self.membership.leader
        self.membership.leader = unique_name
        if unique_name and unique_name != prev:
            for cb in self.on_new_leader_cbs:
                cb(unique_name)

    # ------------------------------------------------------------------
    # election driving (reference worker.py:621-649, 1161-1179)
    # ------------------------------------------------------------------

    def _on_leader_failed(self, dead_leader: str) -> None:
        log.info("%s: leader %s died -> election", self.me, dead_leader)
        self.election.start()

    def _on_node_failed(self, uname: str) -> None:
        self._missed_acks.pop(uname, None)
        for cb in self.on_node_failed_cbs:
            cb(uname)

    def _on_replication_needed(self, cleaned: List[str]) -> None:
        for cb in self.on_replication_needed_cbs:
            cb(cleaned)

    def _election_tick(self) -> None:
        """Per-tick election gossip (reference send_election_messages,
        worker.py:1161-1169) + winner self-check."""
        for t in self.membership.ping_targets:
            self.send(t, MsgType.ELECTION, {})
        if self.election.i_win(self.membership.alive_nodes()):
            self._announce_coordinator()

    def _announce_coordinator(self) -> None:
        """I won: multicast COORDINATE (reference worker.py:1171-1179),
        become leader, update the introducer DNS."""
        self.election.resolved(self.me.unique_name)
        self._become_leader()
        for node in self.membership.alive_nodes():
            if node.unique_name != self.me.unique_name:
                self.send(node, MsgType.COORDINATE, {})
        # (the DNS registration loop is spawned by _become_leader)

    async def _introducer_registration_loop(self) -> None:
        """Keep the introducer DNS pointing at us for as long as we
        lead. Two regimes:

        - un-ACKed: tight capped-backoff retries. No fixed attempt
          budget — a DNS *outage* spanning a failover (the chaos
          introducer-outage scenario) outlives any fixed count, and
          giving up strands every future joiner at the dead
          ex-leader; the moment the DNS returns, we register.
        - ACKed: slow periodic re-assert. A one-shot update is not
          enough: a nameserver that restarts WITH STATE LOSS after
          our ACK serves its stale static default (typically a dead
          ex-leader) until someone re-teaches it — and nothing else
          ever would. One datagram per interval is the whole cost.

        Exits when we stop being leader; the next leader runs its
        own."""
        assert self.spec.introducer is not None
        attempt = 0
        while self.is_leader:
            try:
                update: Dict[str, Any] = {
                    "introducer": self.me.unique_name}
                if self.spec.join_secret and self.spec.universe_epoch:
                    # the DNS validates UPDATE_INTRODUCER senders
                    # against ITS node table, and it restarts with
                    # state loss — so the introducer must keep
                    # learning runtime-joined nodes, or a joined node
                    # promoted to leader could never re-register.
                    # Entries self-verify their HMAC stamps there.
                    uni = self.spec.universe_delta(0)
                    if "full" not in uni:
                        update["uni"] = uni
                await self.request(
                    self.spec.introducer,
                    MsgType.UPDATE_INTRODUCER,
                    update,
                    timeout=self.spec.timing.ack_timeout,
                )
                attempt = 0
                await asyncio.sleep(
                    max(1.0, 4 * self.spec.timing.ping_interval)
                )
            except asyncio.TimeoutError:
                attempt += 1
                if attempt == 20:
                    log.warning(
                        "%s: introducer DNS not ACKing the leader update "
                        "(outage?); retrying until it returns", self.me,
                    )
                await asyncio.sleep(
                    min(1.0, self.spec.timing.ack_timeout * 2 ** min(attempt, 6))
                )

    # ------------------------------------------------------------------
    # core handlers
    # ------------------------------------------------------------------

    def _register_core_handlers(self) -> None:
        self.register(MsgType.PING, self._h_ping)
        self.register(MsgType.ACK, self._h_ack)
        self.register(MsgType.INTRODUCE, self._h_introduce)
        self.register(MsgType.ELECTION, self._h_election)
        self.register(MsgType.COORDINATE, self._h_coordinate)
        self.register(MsgType.COORDINATE_ACK, self._h_coordinate_ack)
        self.register(MsgType.METRICS_PULL, self._h_metrics_pull)
        self.register(MsgType.METRICS_RELAY_PULL, self._h_metrics_relay)
        self.register(MsgType.TRACE_PULL, self._h_trace_pull)
        self.register(MsgType.JOIN_REQUEST, self._h_join_request)
        self.register(MsgType.LEAVE, self._h_leave)

    def _spawn_bg(self, coro: Awaitable, name: str) -> asyncio.Task:
        """Background task spawned from a handler: held (never naked),
        self-pruning, reaped at stop(), exceptions logged."""

        async def guarded() -> None:
            try:
                await coro
            except asyncio.CancelledError:
                raise
            except Exception:
                log.exception("%s: bg task %s failed", self.me, name)

        t = asyncio.create_task(guarded(), name=name)
        self._bg_tasks.add(t)
        t.add_done_callback(self._bg_tasks.discard)
        return t

    def send_tiered(
        self,
        to_unique: str,
        mtype: MsgType,
        extra: Dict[str, Any],
        tiers: Iterable[Callable[[], Dict[str, Any]]],
        what: str = "payload",
    ) -> None:
        """Send a reply that degrades to fit the UDP frame cap: try
        each tier's payload fragment in order (merged over ``extra``
        with ``ok: True``) until one packs; a reply ALWAYS goes out —
        the final fallback is an explicit ``ok: False`` error carrying
        ``what``, so a node degrades visibly instead of vanishing from
        the cluster view because its payload grew. The ONE shared cap
        machinery behind METRICS_PULL_ACK, METRICS_RELAY_ACK,
        TRACE_PULL_ACK, and the signal plane's ALERT_PULL replies
        (PRs 10/11 carried two parallel copies of this loop; a third
        would have been one too many)."""
        degraded = 0
        for tier in tiers:
            try:
                self.send_unique(
                    to_unique, mtype, {**extra, "ok": True, **tier()}
                )
                if degraded:
                    # to_unique is already the unique_name string
                    # (wire.Message contract) — an attribute access
                    # here raised AttributeError and turned every
                    # degraded reply into a handler-failure traceback
                    log.warning(
                        "%s: %s over the frame cap, "
                        "degraded to tier %d for %s",
                        self.me.unique_name, what, degraded, to_unique,
                    )
                return
            except ValueError:
                degraded += 1
                continue
        log.error(
            "%s: %s unsendable even fully degraded",
            self.me.unique_name, what,
        )
        self.send_unique(
            to_unique, mtype,
            {**extra, "ok": False,
             "error": f"{what} exceeds datagram cap"},
        )

    def _send_metrics_tiered(
        self,
        to_unique: str,
        mtype: MsgType,
        snap: Dict[str, Any],
        extra: Dict[str, Any],
    ) -> None:
        """Metrics tier ladder: full -> bucket-stripped (mean/count
        survive, percentiles drop) -> counters+gauges only. The one
        shared form for METRICS_PULL_ACK and METRICS_RELAY_ACK."""
        from .. import observability as obs

        self.send_tiered(
            to_unique, mtype, extra,
            tiers=(
                lambda: {"metrics": snap},
                lambda: {"metrics": obs.strip_buckets(snap)},
                lambda: {"metrics": {
                    **{
                        k: snap.get(k)
                        for k in ("v", "proc", "procs", "ts", "node",
                                  "merged_from")
                        if k in snap
                    },
                    "counters": snap.get("counters", {}),
                    "gauges": snap.get("gauges", {}),
                    "histograms": {},
                    "stripped": True,
                    "truncated": "histograms",
                }},
            ),
            what="metrics snapshot",
        )

    async def _h_metrics_pull(self, msg: Message, addr) -> None:
        """Reply with this process's metrics-registry snapshot (the
        node-side half of the leader-aggregated cluster view)."""
        from .. import observability as obs

        self._send_metrics_tiered(
            msg.sender,
            MsgType.METRICS_PULL_ACK,
            obs.METRICS.snapshot(node=self.me.unique_name),
            {"rid": msg.data.get("rid")},
        )

    async def _h_metrics_relay(self, msg: Message, addr) -> None:
        """Relay side of two-level aggregation: pull the assigned peer
        shard (bounded concurrency), pre-merge with our own snapshot,
        reply one merged blob. The work runs in a BACKGROUND task —
        inline it would wedge the dispatch loop this relay needs to
        receive its own METRICS_PULL_ACKs through."""
        if self.spec.node_by_unique_name(msg.sender) is None:
            # a forged out-of-universe datagram must not be able to
            # trigger an O(shard) METRICS_PULL fan-out (amplification)
            return
        peers = msg.data.get("peers")
        if not isinstance(peers, list):
            return  # byzantine/garbled shard request
        try:
            # parsed BEFORE the coroutine is built: junk here must
            # drop the request, not orphan a never-awaited coroutine
            timeout = float(msg.data.get("timeout", 3.0))
        except (TypeError, ValueError):
            return
        if not math.isfinite(timeout):
            return  # NaN/inf deadlines die here, not in wait_for
        # clamp: a wire-supplied timeout must not pin request futures
        # (and this bg task) for the node's remaining lifetime
        timeout = min(max(timeout, 0.1), 30.0)
        self._spawn_bg(
            self._relay_shard(
                msg.sender,
                msg.data.get("rid"),
                [p for p in peers if isinstance(p, str)],
                timeout,
            ),
            name=f"{self.me}-metrics-relay",
        )

    async def _relay_shard(
        self,
        requester: str,
        rid: Any,
        peers: List[str],
        timeout: float,
    ) -> None:
        from .. import observability as obs

        t0 = time.monotonic()
        snaps, failed = await self._pull_peer_snapshots(
            [
                n for p in peers
                if (n := self.spec.node_by_unique_name(p)) is not None
            ],
            timeout=timeout,
        )
        snaps[self.me.unique_name] = obs.METRICS.snapshot(
            node=self.me.unique_name
        )
        merged = obs.merge_snapshots(list(snaps.values()))
        _M_RELAY_PULLS.inc(1, role="relay")
        _M_RELAY_T.observe(time.monotonic() - t0)
        self._send_metrics_tiered(
            requester,
            MsgType.METRICS_RELAY_ACK,
            merged,
            {"rid": rid, "covered": sorted(snaps), "failed": sorted(failed)},
        )

    async def _pull_peer_replies(
        self,
        peers: List[NodeId],
        mtype: MsgType,
        req: Dict[str, Any],
        timeout: float,
        on_reply: Callable[[NodeId, Dict[str, Any]], None],
        failed: List[str],
        concurrency: int = 8,
    ) -> None:
        """Bounded-concurrency request fan-out: at most `concurrency`
        requests in flight, so a straggler (or a dead peer's full
        timeout) costs one slot-wait, not a serial wall — and an
        O(100)-node pull doesn't burst O(N) datagrams at once. A
        timeout appends the peer to ``failed``; any reply is handed to
        ``on_reply`` OUTSIDE the semaphore (reply processing must not
        hold a fan-out slot). The one shared fan-out loop behind
        METRICS_PULL and TRACE_PULL collection."""
        sem = asyncio.Semaphore(max(1, concurrency))

        async def pull_one(peer: NodeId) -> None:
            async with sem:
                try:
                    reply = await self.request(
                        peer, mtype, dict(req), timeout=timeout
                    )
                except (asyncio.TimeoutError, TimeoutError):
                    failed.append(peer.unique_name)
                    return
            on_reply(peer, reply)

        await asyncio.gather(*(pull_one(n) for n in peers))

    @staticmethod
    def _relay_shards(
        peers: List[NodeId], relays: int
    ) -> Tuple[List[NodeId], Dict[str, List[NodeId]]]:
        """Deterministic relay choice (first R peers by the caller's
        sort) + round-robin shard assignment — the one sharding rule
        both the metrics and trace relay fan-outs use."""
        relay_nodes = peers[:relays]
        shards: Dict[str, List[NodeId]] = {
            r.unique_name: [] for r in relay_nodes
        }
        for i, p in enumerate(peers[relays:]):
            shards[relay_nodes[i % len(relay_nodes)].unique_name].append(p)
        return relay_nodes, shards

    @staticmethod
    def _relay_timeout(shard_len: int, timeout: float) -> float:
        """A relay's worst-case shard wall is one `timeout` wave per
        concurrency batch (its bounded pull runs 8 at a time) —
        budget for that plus wire margin, or a healthy relay on a
        sickly shard gets misclassified as failed and its shard
        double-pulled."""
        waves = max(1, -(-shard_len // 8))
        return timeout * (waves + 1) + 1.0

    async def _pull_peer_snapshots(
        self,
        peers: List[NodeId],
        timeout: float,
        concurrency: int = 8,
    ) -> Tuple[Dict[str, Dict[str, Any]], List[str]]:
        """METRICS_PULL over the shared bounded fan-out. Returns
        (snapshots by unique name, unreachable peers)."""
        snaps: Dict[str, Dict[str, Any]] = {}
        failed: List[str] = []

        def on_reply(peer: NodeId, reply: Dict[str, Any]) -> None:
            snap = reply.get("metrics")
            if isinstance(snap, dict):
                snaps[peer.unique_name] = snap
            else:
                failed.append(peer.unique_name)

        await self._pull_peer_replies(
            peers, MsgType.METRICS_PULL, {}, timeout, on_reply, failed,
            concurrency=concurrency,
        )
        return snaps, failed

    async def pull_cluster_metrics(
        self,
        timeout: float = 3.0,
        concurrency: int = 8,
        relays: int = 0,
        peers: Optional[List[NodeId]] = None,
    ) -> Dict[str, Any]:
        """Aggregate every alive node's metrics snapshot into one
        cluster view — the analog of the reference
        coordinator's C1-C5 console, but pull-based and typed. Run
        from the leader for the operator console (any node CAN call
        it; the view is the same).

        Direct mode (``relays=0``): pull every peer with bounded
        concurrency (``concurrency`` in flight at once — one dead
        peer costs one timeout slot, never a serial wall).

        Relay mode (``relays=R``): two-level fan-out — R relay nodes
        each pull a shard of the peers and PRE-MERGE it
        (``observability.merge_snapshots``, same tier-degradation
        contract), so leader ingress is O(R·merged) instead of
        O(N·snapshot). A relay that fails falls back to direct pulls
        of its shard, visible in ``relay.fallbacks``.

        Returns ``{"nodes": {unique_name: snapshot}, "cluster":
        merged, "summary": C2-style roll-up, "unreachable": [...],
        "relay": {...} (relay mode only)}``. In relay mode ``nodes``
        holds only the directly-pulled snapshots (shard members are
        pre-merged inside their relay's blob; their names appear
        under ``covered``). Totals dedupe by producing process, so an
        in-process simulation's shared registry is counted once (see
        observability.merge_snapshots).

        ``peers`` pins the peer set explicitly (default: the current
        ALIVE view) — the scale probe uses it to measure straggler
        behavior against a frozen list that includes just-killed
        nodes, the way a console pulling on a slightly-stale view
        does."""
        from .. import observability as obs

        snaps: Dict[str, Dict[str, Any]] = {
            self.me.unique_name: obs.METRICS.snapshot(
                node=self.me.unique_name
            )
        }
        if peers is None:
            peers = self.membership.alive_nodes()
        peers = sorted(
            (n for n in peers if n.unique_name != self.me.unique_name),
            key=lambda n: n.unique_name,
        )
        failed: List[str] = []
        relay_info: Optional[Dict[str, Any]] = None
        blobs: List[Dict[str, Any]] = []
        if relays > 0 and len(peers) > relays:
            blobs, snaps2, failed, relay_info = await self._pull_via_relays(
                peers, relays, timeout, concurrency
            )
            snaps.update(snaps2)
        elif peers:
            direct, failed = await self._pull_peer_snapshots(
                peers, timeout=timeout, concurrency=concurrency
            )
            snaps.update(direct)
        merged = obs.merge_snapshots(list(snaps.values()) + blobs)
        out: Dict[str, Any] = {
            "nodes": snaps,
            "cluster": merged,
            "summary": obs.summarize_snapshot(merged),
            "unreachable": sorted(failed),
        }
        if relay_info is not None:
            out["relay"] = relay_info
        return out

    async def _pull_via_relays(
        self,
        peers: List[NodeId],
        relays: int,
        timeout: float,
        concurrency: int,
    ) -> Tuple[
        List[Dict[str, Any]],
        Dict[str, Dict[str, Any]],
        List[str],
        Dict[str, Any],
    ]:
        """Two-level fan-out: the shared ``_relay_shards`` split, one
        METRICS_RELAY_PULL per relay, direct-pull fallback per failed
        relay shard. Returns (pre-merged relay blobs, directly-pulled
        snapshots, unreachable peers, relay stats)."""
        relay_nodes, shards = self._relay_shards(peers, relays)
        blobs: List[Dict[str, Any]] = []
        direct: Dict[str, Dict[str, Any]] = {}
        failed: List[str] = []
        covered: List[str] = []
        fallbacks = 0

        async def pull_relay(relay: NodeId) -> None:
            nonlocal fallbacks
            shard = shards[relay.unique_name]
            try:
                reply = await self.request(
                    relay,
                    MsgType.METRICS_RELAY_PULL,
                    {
                        "peers": [p.unique_name for p in shard],
                        "timeout": timeout,
                    },
                    timeout=self._relay_timeout(len(shard), timeout),
                )
            except (asyncio.TimeoutError, TimeoutError):
                reply = {}
            blob = reply.get("metrics")
            if isinstance(blob, dict) and reply.get("ok"):
                blobs.append(blob)
                covered.extend(
                    c for c in reply.get("covered", [])
                    if isinstance(c, str)
                )
                failed.extend(
                    c for c in reply.get("failed", [])
                    if isinstance(c, str)
                )
                return
            # the relay itself is down/degraded: pull its whole shard
            # (and the relay) directly so the view loses nothing
            fallbacks += 1
            _M_RELAY_FALLBACK.inc()
            got, bad = await self._pull_peer_snapshots(
                [relay] + shard, timeout=timeout, concurrency=concurrency
            )
            direct.update(got)
            failed.extend(bad)

        _M_RELAY_PULLS.inc(1, role="leader")
        await asyncio.gather(*(pull_relay(r) for r in relay_nodes))
        info = {
            "relays": len(relay_nodes),
            "relay_nodes": [r.unique_name for r in relay_nodes],
            "covered": sorted(set(covered)),
            "fallbacks": fallbacks,
        }
        return blobs, direct, failed, info

    # ------------------------------------------------------------------
    # distributed tracing collection (dml_tpu/tracing.py)
    # ------------------------------------------------------------------

    @staticmethod
    def _trace_tiers(
        spans: list,
    ) -> Iterable[Callable[[], Dict[str, Any]]]:
        """Span tier ladder for ``send_tiered``: full ->
        labels/events stripped -> repeatedly halved newest-half (down
        to 8 spans) -> count-only. ``held`` always carries the
        recorder's true size so the puller can detect truncation."""
        held = len(spans)
        yield lambda: {"spans": list(spans), "held": held}
        rows = [
            {k: v for k, v in d.items() if k not in ("lb", "ev")}
            for d in spans
        ]
        yield lambda r=rows: {"spans": r, "held": held, "stripped": True}
        while len(rows) > 8:
            rows = rows[len(rows) // 2:]  # keep the newest half
            yield lambda r=rows: {
                "spans": r, "held": held, "stripped": True,
            }
        yield lambda: {"spans": [], "held": held, "truncated": "spans"}

    def _send_trace_tiered(
        self,
        to_unique: str,
        spans: list,
        extra: Dict[str, Any],
    ) -> None:
        """Send a span dump through the shared cap machinery: a
        node's recorder must degrade visibly, never vanish from the
        cluster trace because it grew."""
        self.send_tiered(
            to_unique, MsgType.TRACE_PULL_ACK, extra,
            tiers=self._trace_tiers(spans), what="span dump",
        )

    async def _h_trace_pull(self, msg: Message, addr) -> None:
        """Reply with this process's flight-recorder dump. A request
        carrying ``peers`` makes this node a RELAY: it pulls those
        peers' dumps too (bounded concurrency, in a background task —
        inline would wedge the dispatch loop its own pulls reply
        through) and answers one pre-merged span list, the
        two-level fan-out shape."""
        from .. import tracing as trc

        if self.spec.node_by_unique_name(msg.sender) is None:
            return  # forged out-of-universe datagram: no amplification
        d = msg.data
        trace_ids = d.get("trace_ids")
        if trace_ids is not None and not isinstance(trace_ids, list):
            return
        try:
            max_spans = int(d.get("max_spans", 256))
        except (TypeError, ValueError):
            return
        max_spans = min(max(max_spans, 1), 2048)
        local = trc.TRACER.dump(
            trace_ids=[t for t in trace_ids if isinstance(t, str)]
            if trace_ids is not None else None,
            max_spans=max_spans,
        )
        extra = {"rid": d.get("rid"), "node": self.me.unique_name}
        peers = d.get("peers")
        if not isinstance(peers, list) or not peers:
            self._send_trace_tiered(msg.sender, local, extra)
            return
        try:
            timeout = float(d.get("timeout", 3.0))
        except (TypeError, ValueError):
            return
        if not math.isfinite(timeout):
            return
        timeout = min(max(timeout, 0.1), 30.0)

        async def relay() -> None:
            dumps, failed, degraded = await self._pull_peer_spans(
                [
                    n for p in peers
                    if isinstance(p, str)
                    and (n := self.spec.node_by_unique_name(p)) is not None
                ],
                trace_ids=trace_ids, max_spans=max_spans,
                timeout=timeout,
            )
            from .. import tracing as trc2

            merged = trc2.merge_span_dumps([local] + list(dumps.values()))
            if len(merged) > max_spans:
                merged = merged[-max_spans:]
            self._send_trace_tiered(
                msg.sender, merged,
                {**extra, "covered": sorted(dumps),
                 "failed": sorted(failed),
                 # per-peer degradation must survive the hop: without
                 # it the leader's relay-mode coverage claim is blind
                 # to truncated shard members
                 "degraded": degraded},
            )

        self._spawn_bg(relay(), name=f"{self.me}-trace-relay")

    @staticmethod
    def _trace_reply_degradation(
        reply: Dict[str, Any], got: int
    ) -> Optional[Dict[str, Any]]:
        """Did this TRACE_PULL_ACK fit the frame only by degrading?
        The count-only tier sets ``truncated``, the halved-newest-half
        tiers are detectable as got < held, and label/event stripping
        ships ``stripped``. None = a full reply."""
        held = reply.get("held")
        partial = isinstance(held, int) and got < held
        if not (reply.get("truncated") or reply.get("stripped") or partial):
            return None
        out: Dict[str, Any] = {"held": held, "got": got}
        if reply.get("truncated"):
            out["truncated"] = reply.get("truncated")
        if reply.get("stripped"):
            out["stripped"] = True
        return out

    async def _pull_peer_spans(
        self,
        peers: List[NodeId],
        trace_ids: Optional[list],
        max_spans: int,
        timeout: float,
        concurrency: int = 8,
    ) -> Tuple[Dict[str, list], List[str], Dict[str, Dict[str, Any]]]:
        """TRACE_PULL over the shared bounded fan-out (the span analog
        of ``_pull_peer_snapshots``). The third return maps peers
        whose reply DEGRADED (``truncated`` tier marker, ``held``
        recorder size) — the ACK ships those fields so the aggregated
        view can say "this node's recorder outgrew the frame", and
        until drift-wire-payloads flagged them as sent-never-read they
        were silently dropped here."""
        dumps: Dict[str, list] = {}
        failed: List[str] = []
        degraded: Dict[str, Dict[str, Any]] = {}
        req: Dict[str, Any] = {"max_spans": max_spans}
        if trace_ids is not None:
            req["trace_ids"] = trace_ids

        def on_reply(peer: NodeId, reply: Dict[str, Any]) -> None:
            spans = reply.get("spans")
            if reply.get("ok") and isinstance(spans, list):
                dumps[peer.unique_name] = spans
                deg = self._trace_reply_degradation(reply, len(spans))
                if deg is not None:
                    degraded[peer.unique_name] = deg
            else:
                if reply.get("error"):
                    log.warning(
                        "%s: TRACE_PULL from %s failed explicitly: %s",
                        self.me.unique_name, peer.unique_name,
                        reply.get("error"),
                    )
                failed.append(peer.unique_name)

        await self._pull_peer_replies(
            peers, MsgType.TRACE_PULL, req, timeout, on_reply, failed,
            concurrency=concurrency,
        )
        return dumps, failed, degraded

    async def pull_cluster_traces(
        self,
        trace_ids: Optional[List[str]] = None,
        timeout: float = 3.0,
        concurrency: int = 8,
        relays: int = 0,
        max_spans: int = 1024,
        peers: Optional[List[NodeId]] = None,
    ) -> Dict[str, Any]:
        """Assemble the cluster-wide trace view: every node's flight
        recorder pulled (bounded concurrency; ``relays=R`` shards the
        peers over R relay nodes that pre-merge, exactly the
        pull_cluster_metrics fan-out shape), spans deduped by span id
        (in-process sims share one recorder) and stitched into
        per-trace trees.

        Returns ``{"spans": [...], "traces": {trace_id: [spans]},
        "nodes": {unique_name: span_count}, "unreachable": [...],
        "degraded": {unique_name: {"truncated": ..., "held": n}}}``."""
        from .. import tracing as trc

        per_node = min(max(int(max_spans), 1), 2048)
        local = trc.TRACER.dump(trace_ids=trace_ids, max_spans=per_node)
        dumps: Dict[str, list] = {self.me.unique_name: local}
        failed: List[str] = []
        degraded: Dict[str, Dict[str, Any]] = {}
        if peers is None:
            peers = self.membership.alive_nodes()
        others = sorted(
            (n for n in peers if n.unique_name != self.me.unique_name),
            key=lambda n: n.unique_name,
        )
        if relays > 0 and len(others) > relays:
            relay_nodes, shards = self._relay_shards(others, relays)

            async def pull_relay(relay: NodeId) -> None:
                shard = shards[relay.unique_name]
                req: Dict[str, Any] = {
                    "max_spans": per_node, "timeout": timeout,
                    "peers": [p.unique_name for p in shard],
                }
                if trace_ids is not None:
                    req["trace_ids"] = trace_ids
                try:
                    reply = await self.request(
                        relay, MsgType.TRACE_PULL, req,
                        timeout=self._relay_timeout(len(shard), timeout),
                    )
                except (asyncio.TimeoutError, TimeoutError):
                    reply = {}
                spans = reply.get("spans")
                if reply.get("ok") and isinstance(spans, list):
                    dumps[relay.unique_name] = spans
                    failed.extend(
                        c for c in reply.get("failed", [])
                        if isinstance(c, str)
                    )
                    # shard members whose reply degraded at the relay,
                    # plus the relay's own merged reply if IT hit the
                    # frame cap (the pre-merged shard is the likeliest
                    # frame to truncate)
                    deg = reply.get("degraded")
                    if isinstance(deg, dict):
                        degraded.update({
                            k: v for k, v in deg.items()
                            if isinstance(k, str) and isinstance(v, dict)
                        })
                    own = self._trace_reply_degradation(reply, len(spans))
                    if own is not None:
                        degraded[relay.unique_name] = own
                    return
                # relay down/degraded: pull its shard (and it) direct
                got, bad, deg = await self._pull_peer_spans(
                    [relay] + shard, trace_ids=trace_ids,
                    max_spans=per_node, timeout=timeout,
                    concurrency=concurrency,
                )
                dumps.update(got)
                failed.extend(bad)
                degraded.update(deg)

            await asyncio.gather(*(pull_relay(r) for r in relay_nodes))
        elif others:
            got, failed, degraded = await self._pull_peer_spans(
                others, trace_ids=trace_ids, max_spans=per_node,
                timeout=timeout, concurrency=concurrency,
            )
            dumps.update(got)
        spans = trc.merge_span_dumps(list(dumps.values()))
        return {
            "spans": spans,
            "traces": trc.assemble_traces(spans),
            "nodes": {n: len(d) for n, d in sorted(dumps.items())},
            "unreachable": sorted(failed),
            # peers whose reply hit the datagram cap: the trace view is
            # INCOMPLETE for them (count-only tier) — surfaced so the
            # attribution caller can qualify its coverage claim
            "degraded": dict(sorted(degraded.items())),
        }

    # ------------------------------------------------------------------
    # elastic membership: authenticated runtime join/leave
    # ------------------------------------------------------------------

    def _send_addr(self, addr: Tuple[str, int], mtype: MsgType,
                   data: Dict[str, Any]) -> None:
        """Reply straight to a socket address — the one path allowed
        to answer a sender the node table doesn't (yet) resolve,
        which is exactly a joiner mid-handshake."""
        assert self.transport is not None, "node not started"
        self.transport.send(Message(self.me.unique_name, mtype, data), addr)

    def _nonce_replayed(self, nonce: str) -> bool:
        """Record-and-test against the bounded seen-nonce window."""
        if nonce in self._seen_nonces:
            return True
        self._seen_nonces[nonce] = None
        if len(self._seen_nonces) > _NONCE_CAP:
            self._seen_nonces.pop(next(iter(self._seen_nonces)))
        return False

    async def _h_join_request(self, msg: Message, addr) -> None:
        """Leader-side admission of an authenticated runtime join.
        Every rejection is TYPED and counted
        (membership_join_rejected_total) — forged, replayed, stale-
        epoch, and garbled requests must be observable, not silent —
        and only a request whose HMAC binds (identity, addr, nonce,
        epoch) to the shared secret can touch the universe. A
        stale_epoch rejection echoes the current epoch under the
        reply MAC so a live joiner can re-claim it next tick while a
        replayed capture cannot."""
        if not self.is_leader:
            return  # the joiner re-resolves the leader via DNS and retries
        d = msg.data
        rid = d.get("rid")
        secret = self.spec.join_secret
        nonce = d.get("nonce") if isinstance(d.get("nonce"), str) else ""

        def reject(reason: str, epoch_hint: Optional[int] = None) -> None:
            _M_JOIN_REJECT.inc(reason=reason)
            log.warning("%s: JOIN_REQUEST from %s rejected (%s)",
                        self.me, msg.sender, reason)
            reply: Dict[str, Any] = {"rid": rid, "ok": False,
                                     "reason": reason}
            if epoch_hint is not None:
                reply["epoch"] = epoch_hint
            if secret and nonce:
                reply["mac"] = reply_mac(
                    secret, nonce, int(reply.get("epoch", -1)), {})
            self._send_addr(addr, MsgType.JOIN_ACK, reply)

        if not secret:
            reject("disabled")
            return
        nid = ClusterSpec.node_from_dict(d.get("node"))
        try:
            epoch = int(d.get("epoch"))
        except (TypeError, ValueError):
            epoch = None
        if nid is None or not nonce or epoch is None:
            reject("garbled")
            return
        group = d.get("group") if isinstance(d.get("group"), str) else None
        mac = d.get("mac")
        # the MAC covers the requested group too: an on-path rewrite
        # of a topology-changing field must invalidate the request,
        # not re-shape an attacker-chosen mesh
        want = join_mac(secret, d.get("node"), nonce, epoch,
                        group=group or "")
        if not isinstance(mac, str) or not _hmac.compare_digest(mac, want):
            reject("bad_mac")
            return
        if epoch != self.spec.universe_epoch:
            reject("stale_epoch", epoch_hint=self.spec.universe_epoch)
            return
        if self._nonce_replayed(nonce):
            reject("replay")
            return
        try:
            have = max(0, int(d.get("have", epoch)))
        except (TypeError, ValueError):
            have = epoch
        try:
            added = self.spec.add_node(nid, group=group)
        except ValueError:
            # unknown group: admit as a plain pool slot rather than
            # bouncing capacity over a topology typo
            log.warning("%s: join group %r unknown; admitting %s "
                        "as an ungrouped slot", self.me, group, nid)
            added = self.spec.add_node(nid)
        _M_JOIN_ADMIT.inc(kind="new" if added else "rejoin")
        if added:
            log.info(
                "%s: admitted %s into the universe (epoch %d%s)",
                self.me, nid.unique_name, self.spec.universe_epoch,
                f", group {group}" if group else "",
            )
            self._universe_changed()
        self.membership.mark_alive(nid.unique_name)
        self._peer_uepoch[nid.unique_name] = self.spec.universe_epoch
        uni = self.spec.universe_delta(min(have, self.spec.universe_epoch))
        self._send_addr(addr, MsgType.JOIN_ACK, {
            "rid": rid, "ok": True, "leader": self.me.unique_name,
            "members": self.membership.snapshot(),
            "epoch": self.spec.universe_epoch,
            "universe": uni,
            "mac": reply_mac(secret, nonce, self.spec.universe_epoch, uni),
        })

    async def _h_leave(self, msg: Message, addr) -> None:
        """Leader-side graceful departure: an authenticated LEAVE
        retires the sender from the universe AND the membership table
        immediately — no suspicion window, no cleanup delay, no
        failure counters — then fires the node-failed/replication
        hooks so in-flight batches requeue and the departed replicas
        re-replicate. The MAC binds the SENDER's identity, so a
        spoofed goodbye can't evict someone else."""
        secret = self.spec.join_secret
        if not self.is_leader:
            return
        if not secret:
            _M_LEAVE_REJECT.inc(reason="disabled")
            return
        d = msg.data
        nonce = d.get("nonce")
        mac = d.get("mac")
        try:
            epoch = int(d.get("epoch"))
        except (TypeError, ValueError):
            _M_LEAVE_REJECT.inc(reason="garbled")
            return
        if not isinstance(nonce, str) or not nonce \
                or not isinstance(mac, str):
            _M_LEAVE_REJECT.inc(reason="garbled")
            return
        want = leave_mac(secret, msg.sender, nonce, epoch)
        if not _hmac.compare_digest(mac, want):
            _M_LEAVE_REJECT.inc(reason="bad_mac")
            log.warning("%s: forged LEAVE for %s dropped (bad mac)",
                        self.me, msg.sender)
            return
        if epoch != self.spec.universe_epoch:
            # the goodbye was minted against an old table; the node
            # still goes away via ordinary failure detection
            _M_LEAVE_REJECT.inc(reason="stale_epoch")
            return
        if self._nonce_replayed(nonce):
            _M_LEAVE_REJECT.inc(reason="replay")
            return
        if msg.sender == self.me.unique_name:
            return  # the leader retiring itself is the election's job
        if not self.spec.remove_node(msg.sender):
            return  # duplicate goodbye for an already-retired node
        _M_LEAVES.inc()
        log.info("%s: %s left gracefully (universe epoch %d)",
                 self.me, msg.sender, self.spec.universe_epoch)
        self.membership.retire(msg.sender)
        self._missed_acks.pop(msg.sender, None)
        for cb in self.on_node_failed_cbs:
            cb(msg.sender)
        for cb in self.on_node_left_cbs:
            cb(msg.sender)
        for cb in self.on_replication_needed_cbs:
            cb([msg.sender])
        self._universe_changed()

    async def leave_cluster(self) -> bool:
        """Graceful scale-in: announce LEAVE to the leader (MAC over
        our own identity + nonce + epoch), then go silent. Returns
        True when the goodbye was actually sent — a leaderless window
        or a disabled join policy degrades to the plain `leave()`,
        where SWIM suspicion retires us the crash way."""
        sent = False
        leader = self.leader_node
        if (
            self.spec.join_secret
            and self.joined
            and not self.is_leader
            and leader is not None
        ):
            nonce = os.urandom(8).hex()
            epoch = self.spec.universe_epoch
            self.send(leader, MsgType.LEAVE, {
                "nonce": nonce, "epoch": epoch,
                "mac": leave_mac(self.spec.join_secret,
                                 self.me.unique_name, nonce, epoch),
            })
            sent = True
        elif self.is_leader:
            log.warning(
                "%s: the leader has no graceful LEAVE path; stopping "
                "hands off through the ordinary election", self.me,
            )
        self.leave()
        return sent

    async def _h_ping(self, msg: Message, addr) -> None:
        """Merge piggybacked gossip, ACK with our own (reference PING
        branch, worker.py:616-619)."""
        if not self.joined:
            return
        self._note_universe(msg)
        self.membership.merge(msg.data.get("members", {}))
        self.membership.mark_alive(msg.sender)
        their_leader = msg.data.get("leader")
        if their_leader and self.spec.node_by_unique_name(their_leader) is None:
            their_leader = None  # forged/garbled leader outside the universe
        if their_leader and self.membership.leader is None and not self.election.in_progress:
            self._set_leader(their_leader)
        self._check_leader_conflict(their_leader)
        their_ue = msg.data.get("ue")
        self.send_unique(
            msg.sender,
            MsgType.ACK,
            self._universe_piggyback(
                {"members": self.membership.gossip(),
                 "leader": self.membership.leader},
                their_ue if isinstance(their_ue, int) else None,
            ),
        )

    async def _h_ack(self, msg: Message, addr) -> None:
        """ACK: wake the waiter, merge gossip (reference
        worker.py:551-570 -> _notify_waiting)."""
        self._note_universe(msg)
        self.membership.merge(msg.data.get("members", {}))
        self.membership.mark_alive(msg.sender)
        self._check_leader_conflict(msg.data.get("leader"))
        ev = self._ack_waiters.get(msg.sender)
        if ev is not None:
            ev.set()

    async def _h_introduce(self, msg: Message, addr) -> None:
        """Leader-side join handler (reference INTRODUCE,
        worker.py:616-619): admit the node, reply membership+leader."""
        if not self.is_leader:
            return  # only the leader introduces (joiner will retry)
        self.membership.mark_alive(msg.sender)
        self.send_unique(
            msg.sender,
            MsgType.INTRODUCE_ACK,
            {
                "rid": msg.data.get("rid"),
                "members": self.membership.snapshot(),
                "leader": self.me.unique_name,
            },
        )

    async def _h_election(self, msg: Message, addr) -> None:
        """Join an in-progress election (reference worker.py:621-629)."""
        if not self.joined:
            return
        if self.election.on_election_message():
            log.info("%s: joined election started by %s", self.me, msg.sender)

    async def _h_coordinate(self, msg: Message, addr) -> None:
        """Accept the new leader (reference worker.py:631-637); reply
        COORDINATE_ACK carrying our file inventory so the new leader
        can rebuild the global table (worker.py:639-649).

        Senders outside the static node table are ignored: a byzantine
        datagram that parses as COORDINATE must not be able to crown a
        phantom leader (the membership list applies the same static-
        universe rule to gossip)."""
        if self.spec.node_by_unique_name(msg.sender) is None:
            return
        self.election.resolved(msg.sender)
        self.membership.mark_alive(msg.sender)
        self._set_leader(msg.sender)
        self.send_unique(
            msg.sender,
            MsgType.COORDINATE_ACK,
            {"files": self.local_inventory()},
        )

    async def _h_coordinate_ack(self, msg: Message, addr) -> None:
        """New-leader side: a peer reported its inventory. The store
        service extends this via on_coordinate_ack."""
        self.membership.mark_alive(msg.sender)
        for cb in self.on_coordinate_ack_cbs:
            cb(msg.sender, msg.data.get("files", {}))

    # ------------------------------------------------------------------
    # ops / stats (reference CLI options 9/10)
    # ------------------------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        t = self.transport
        return {
            "me": self.me.unique_name,
            "leader": self.membership.leader,
            "joined": self.joined,
            "universe_epoch": self.spec.universe_epoch,
            "alive": [n.unique_name for n in self.membership.alive_nodes()],
            "false_positives": self.membership.false_positives,
            "indirect_failures": self.membership.indirect_failures,
            "bytes_sent": t.bytes_sent if t else 0,
            "bps": t.bps() if t else 0.0,
            "packets_dropped": t.packets_dropped if t else 0,
        }

    def leave(self) -> None:
        """Voluntary leave (reference CLI option 4): stop ACKing and
        forget the cluster; stays out until `rejoin()`."""
        self.joined = False
        self._left = True
        self.membership.reset()

    def rejoin(self) -> None:
        """Reference CLI option 3: go back through the introducer."""
        self._left = False
        self.joined = False  # _try_join runs on the next tick

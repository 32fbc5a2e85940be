"""Deterministic chaos engine: composable fault plans driven against
the in-process multi-node simulation, with machine-checked recovery.

The reference's only fault story is a hard-coded 3% packet-drop bitmap
(protocol.py:25-29) plus hand-run VM kills; this system grew the *seams*
(seeded LossInjector, partition_filter, LinkShaper dup/reorder/delay,
TunnelFault slow/failing bulk copies, standby relays, scheduler
requeue) but until this module nothing composed them into reproducible
failure scenarios. VirtualFlow (arxiv 2009.09523) makes the same
argument for decoupled resilience: elasticity and fault handling must
be exercised as first-class, schedulable events — not ad-hoc test
hacks.

Three layers:

- **ChaosPlan / ChaosEvent**: a declarative, JSON-able schedule of
  timed fault events (crash, restart-with-same-identity, partition,
  heal, loss ramp, link shaping, store tunnel faults) plus workload
  events (put, job). `random_plan(seed)` generates one from a seeded
  RNG — the same seed always yields the identical schedule;
  `soak_plan(seed)` builds the canonical recovery composition
  (leader killed mid-put and mid-job + a healed partition + 2% loss +
  duplicate delivery) with seed-jittered timing.
- **LocalCluster**: the product-level in-process sim (introducer DNS +
  N nodes + replicated stores + job services with a deterministic
  stub inference backend) that the engine, the `chaos` CLI verb, and
  the bench `chaos` section all share.
- **ChaosRunner**: executes a plan against a LocalCluster, measures
  recovery latencies into the metrics registry
  (`cluster_failover_recovery_seconds`, `store_repair_seconds`), and
  ends every run with an **invariant sweep**: exactly-one-leader
  convergence, every acked job terminal with no lost or duplicated
  completions, every store file back to `replication_factor` live
  copies with seed-file content intact, and no metrics gauge negative.

Determinism contract: the fault *schedule* (which events fire, their
parameters, their planned times) and every injector's per-decision
stream (loss slots, dup/reorder choices, tunnel failures) are
seed-reproducible. Actual interleaving of datagram arrivals rides the
event loop, like a real network — the invariants are what must hold
regardless.
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
import logging
import os
import random
import shutil
import socket
import tempfile
import zlib
from dataclasses import dataclass, field
from typing import Any, Awaitable, Callable, Dict, List, Optional, Tuple

from ..autoscale import AutoscalePolicy, slo_violation_minutes
from ..config import ClusterSpec, NodeId, StoreConfig, Timing
from ..config import join_mac as _join_mac
from ..observability import METRICS
from .introducer import IntroducerService
from .node import Node
from .store.data_plane import TunnelFault
from .store.local_store import DiskFault
from .store_service import StoreService, data_addr
from .util import rebind_retry
from .transport import LinkShaper
from .wire import _HEADER, Message, MsgType

log = logging.getLogger(__name__)

# Recovery-latency histograms: the regression-visible form of the
# paper's failover story. Observed by the runner, merged cluster-wide
# by METRICS_PULL like every other registry metric.
_M_FAILOVER = METRICS.histogram(
    "cluster_failover_recovery_seconds",
    "leader kill -> every live node reconverged on one new leader")
_M_REPAIR = METRICS.histogram(
    "store_repair_seconds",
    "fault event -> every file back to replication_factor live copies")

#: aggressive timing so a whole plan resolves in seconds (the same
#: envelope tests/test_cluster_sim.py uses for its failover scenarios)
FAST_TIMING = Timing(
    ping_interval=0.05,
    ack_timeout=0.15,
    cleanup_time=0.3,
    missed_acks_to_suspect=2,
    leader_rpc_timeout=5.0,
)

#: the O(100)-node envelope: a 128-node sim at FAST_TIMING pushes
#: ~15k datagrams/s through one event loop — protocol behavior would
#: drown in scheduler jitter. This profile keeps a whole 128-node
#: bring-up + kill + election cycle under a minute while every
#: latency is still measured in protocol rounds, comparable across N
#: because ALL N run the same envelope.
SCALE_TIMING = Timing(
    ping_interval=0.25,
    ack_timeout=0.6,
    cleanup_time=2.5,
    missed_acks_to_suspect=2,
    leader_rpc_timeout=10.0,
)

#: model served by the deterministic stub backend (a registry CNN so
#: the coordinator's intake accepts it without register_lm)
STUB_MODEL = "ResNet50"

#: controller knobs for the chaos/bench envelopes: the product
#: defaults (autoscale.AutoscalePolicy) debounce in tens of seconds, a
#: chaos plan lives for ~15 — same shape, faster clocks. floor=2 on a
#: 5-node plan (pool 3: leader + standby are not schedulable slots)
#: leaves exactly one slot of legitimate scale-in headroom; the
#: signal stride under FAST_TIMING is 0.25 s, so out_fire_after=2
#: means half a second of SUSTAINED pressure before capacity moves —
#: the hysteresis the thrash square-wave attacks
CHAOS_AUTOSCALE_POLICY = AutoscalePolicy(
    floor=2,
    ceiling=6,
    backlog_per_slot=2.0,
    idle_arrival_qps=0.5,
    out_fire_after=2,
    out_clear_after=2,
    in_fire_after=6,
    in_clear_after=1,
    confirm_ticks=2,
    out_cooldown_s=3.0,
    in_cooldown_s=5.0,
    realloc_cooldown_s=8.0,
    apply_timeout_s=10.0,
)

#: the diurnal bench arm's knobs: floor 2 / ceiling 4 schedulable
#: slots around a static mid-provisioned baseline of 3, and an
#: idleness bar (idle_arrival_qps) sized so the trace's TROUGH rate
#: reads as idle while its plateau never does
DIURNAL_AUTOSCALE_POLICY = AutoscalePolicy(
    floor=2,
    ceiling=4,
    backlog_per_slot=2.0,
    idle_arrival_qps=8.0,
    out_fire_after=2,
    out_clear_after=2,
    in_fire_after=2,
    in_clear_after=1,
    confirm_ticks=1,
    out_cooldown_s=2.0,
    in_cooldown_s=2.0,
    realloc_cooldown_s=8.0,
    apply_timeout_s=10.0,
)


def _child_seed(seed: int, tag: str) -> int:
    """Stable per-subsystem seed: one plan seed fans out to every
    injector without correlated decision streams."""
    return zlib.crc32(f"{seed}/{tag}".encode()) & 0x7FFFFFFF


# ----------------------------------------------------------------------
# plan model
# ----------------------------------------------------------------------

#: event kinds the runner understands (args they consume):
#: crash        target=name|"leader"|"standby"|"worker"; args.mid =
#:              ["put", "job"] launches that workload just before the
#:              kill so it is genuinely in flight when the node dies
#: restart      target=name|"last" (the most recent crash victim):
#:              same identity, same store root, rejoin via introducer
#: partition    args.fraction (0..1): split the live nodes into
#:              minority/majority by sorted name, bidirectional drop
#:              (installed on BOTH the outbound and inbound filters)
#: partition_asym  args.fraction: same split, but ONE-WAY — the
#:              minority's datagrams to the majority are lost while
#:              the majority's still arrive (A hears B, B doesn't
#:              hear A); installed on both directional seams
#: heal         clear every partition filter (both directions)
#: loss         args.pct: swap every node's loss injector to pct
#: shape        args.{delay_s,jitter_s,dup_pct,reorder_pct,
#:              reorder_extra_s}: install a LinkShaper per node
#:              (all-zero clears shaping)
#: store_fault  args.{delay_s,fail_pct}: install a TunnelFault per
#:              node's data plane
#: store_heal   clear every tunnel fault
#: disk_fault   target node; args.{write_fail_pct,corrupt_pct}:
#:              install a DiskFault on that node's LocalStore
#:              (failing writes = disk full; corrupted reads)
#: disk_heal    clear every disk fault
#: disk_corrupt args.name: flip a byte of one live replica's on-disk
#:              copy of that file (bypassing the checksum sidecar) —
#:              detection happens on the next read of that replica
#: dns_crash    kill the introducer DNS (transport closed, serve
#:              loop dead)
#: dns_restart  bring the DNS back with STATE LOSS: it remembers only
#:              its static default (often a dead ex-leader) and the
#:              live leader's re-register loop must overwrite it
#: skew         target node; args.offset_s: skew that node's SWIM
#:              clock by offset_s seconds (0 clears)
#: fuzz         args.n: inject n seeded byzantine datagrams at every
#:              live node's transport — truncated / bit-flipped /
#:              length-lying / oversized / replayed-header frames
#:              (all must die in Message.unpack, counted) plus
#:              well-formed frames with adversarial content (forged
#:              senders, junk payloads — no coroutine may die)
#: put          args.{name,size}: replicated put of seeded bytes
#: get          args.{name,scrub}: client GET, verified against the
#:              seeded content; scrub=True additionally reads EVERY
#:              live replica directly, so a silently-corrupted copy
#:              is forced through detection
#: job          args.{n}: submit + await a stub-backend job
#: scale_out    args.{n,group}: start n BRAND-NEW nodes (fresh
#:              identities outside the genesis table) that join the
#:              running cluster through the authenticated
#:              JOIN_REQUEST path; args.group absorbs them into that
#:              worker group (requires the plan's join_secret)
#: scale_in     target=name|"joiner" (the most recent runtime
#:              joiner)|"worker": graceful departure — the node
#:              announces LEAVE, is retired from the universe
#:              immediately (no SWIM suspicion window), and its
#:              service stack stops
#: join_storm   args.{n}: blast n forged JOIN_REQUESTs (bad HMAC,
#:              garbled payload, stale epoch, replayed nonce) at the
#:              live nodes — the typed rejection counters must move
#:              and no phantom may enter the universe
#: liar         target node; args.extra_s: make that node a LYING-
#:              METRICS straggler — every batch stalls extra_s seconds
#:              AFTER the self-reported exec wall is measured, so its
#:              own metrics stay clean and only the leader's
#:              dispatch->ACK cross-check (signal.HealthScorer) can
#:              convict it (0 clears)
EVENT_KINDS = (
    "crash", "restart", "partition", "partition_asym", "heal", "loss",
    "shape", "store_fault", "store_heal", "disk_fault", "disk_heal",
    "disk_corrupt", "dns_crash", "dns_restart", "skew", "fuzz",
    "put", "get", "job", "scale_out", "scale_in", "join_storm",
    "liar",
)

#: the adversarial scenario families `scenario_plan` generates and the
#: JAX package's bench chaos section validates per family ("churn" —
#: sustained seeded join/leave, not one-off restarts; "elastic" —
#: capacity change as a first-class event: authenticated scale-out
#: mid-load, graceful LEAVE scale-in, join flapping, and a forged-join
#: storm; "liar" — a lying-metrics straggler whose self-reported walls
#: stay clean while batches stall, flaggable only by the signal plane's
#: dispatch->ACK cross-check; "autoscale" — chaos aimed at the
#: CLOSED-LOOP CONTROLLER itself: thrashing square-wave load against the
#: scale-out hysteresis, a lying straggler feeding the policy, a
#: scale-in racing a traffic spike, and a leader kill between a decision
#: firing and its actuation ACK; "train" — chaos aimed at a TrainJob's
#: exactly-once step contract: a trainer killed mid-epoch, a leader
#: killed inside the checkpoint-every-step window, and a join racing a
#: step boundary — the sweep proves no global step lost or
#: double-applied)
SCENARIO_FAMILIES = ("asym", "disk", "dns", "skew", "fuzz", "churn",
                     "elastic", "liar", "autoscale", "train")


@dataclass(frozen=True)
class ChaosEvent:
    """One timed fault (or workload) event; `t` is seconds from plan
    start. Frozen so a schedule can't drift after generation."""

    t: float
    kind: str
    target: Optional[str] = None
    args: Tuple[Tuple[str, Any], ...] = ()

    def arg(self, key: str, default: Any = None) -> Any:
        return dict(self.args).get(key, default)

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"t": self.t, "kind": self.kind}
        if self.target is not None:
            out["target"] = self.target
        if self.args:
            out["args"] = dict(self.args)
        return out


def event(t: float, kind: str, target: Optional[str] = None,
          **args: Any) -> ChaosEvent:
    if kind not in EVENT_KINDS:
        raise ValueError(f"unknown chaos event kind {kind!r}")
    return ChaosEvent(
        t=round(float(t), 3), kind=kind, target=target,
        # lists normalize to tuples so a JSON round-tripped plan
        # compares (and prints) identically to the generated one
        args=tuple(sorted(
            (k, tuple(v) if isinstance(v, list) else v)
            for k, v in args.items()
        )),
    )


@dataclass(frozen=True)
class ChaosPlan:
    """A seeded, declarative failure scenario. JSON round-trips so
    plans can be saved, diffed, and replayed (`chaos run --plan`)."""

    seed: int
    events: Tuple[ChaosEvent, ...]
    n_nodes: int = 5
    #: quiet tail after the last event before the invariant sweep
    settle_s: float = 1.0
    name: str = "chaos"
    #: non-empty = the cluster runs with the elastic join policy ON
    #: (authenticated runtime join/leave); the elastic scenario
    #: family needs it, everything else keeps the static universe
    join_secret: str = ""
    #: arm the closed-loop autoscaler: every node's controller gets
    #: the chaos policy (CHAOS_AUTOSCALE_POLICY) and real actuators
    #: (LocalCluster.scale_out / scale_in), and the invariant sweep
    #: adds the decision-plane checks — exactly-once actuation, pool
    #: never decided below floor, no in-flight batch on a retiree
    autoscale: bool = False
    #: arm an elastic training run: the runner seeds sharded dataset
    #: files, starts a TrainJob on the coordinator before the event
    #: schedule, waits for it to finish before the sweep, and the
    #: sweep adds the step-exact checks — contiguous exactly-once
    #: ledger, replay-equal final state, zero gradient drift
    train: bool = False

    def __post_init__(self):
        object.__setattr__(
            self, "events", tuple(sorted(self.events, key=lambda e: e.t))
        )

    @property
    def duration(self) -> float:
        return (self.events[-1].t if self.events else 0.0) + self.settle_s

    def to_dict(self) -> Dict[str, Any]:
        out = {
            "name": self.name,
            "seed": self.seed,
            "n_nodes": self.n_nodes,
            "settle_s": self.settle_s,
            "events": [e.to_dict() for e in self.events],
        }
        if self.join_secret:
            out["join_secret"] = self.join_secret
        if self.autoscale:
            out["autoscale"] = True
        if self.train:
            out["train"] = True
        return out

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ChaosPlan":
        return cls(
            seed=int(d.get("seed", 0)),
            n_nodes=int(d.get("n_nodes", 5)),
            settle_s=float(d.get("settle_s", 1.0)),
            name=str(d.get("name", "chaos")),
            join_secret=str(d.get("join_secret", "")),
            autoscale=bool(d.get("autoscale", False)),
            train=bool(d.get("train", False)),
            events=tuple(
                event(e["t"], e["kind"], e.get("target"),
                      **e.get("args", {}))
                for e in d.get("events", [])
            ),
        )

    def describe(self) -> str:
        lines = [f"plan {self.name!r} seed={self.seed} "
                 f"nodes={self.n_nodes} duration={self.duration:.1f}s"]
        for e in self.events:
            args = " ".join(f"{k}={v}" for k, v in e.args)
            tgt = f" @{e.target}" if e.target else ""
            lines.append(f"  t={e.t:6.2f}  {e.kind}{tgt}  {args}".rstrip())
        return "\n".join(lines)


def fuzz_datagrams(
    seed: int, n: int, senders: Tuple[str, ...] = (),
    join_secret: str = "", universe_epoch: int = 0,
    kinds: Optional[Tuple[str, ...]] = None,
) -> Tuple[List[bytes], List[bytes]]:
    """Seeded byzantine-wire generator: ``(malformed, byzantine)``.

    ``malformed`` frames are GUARANTEED to die in ``Message.unpack``
    (each construction breaks an invariant unpack checks), so the
    caller can assert the malformed-drop counter moved by at least
    their count. ``byzantine`` frames parse fine but carry adversarial
    content — forged senders, junk field types, missing keys, deep
    nesting, and JOIN_REQUEST forgeries (bad HMAC, garbled node
    payload, stale epoch, replayed nonce) — and must be survivable:
    handlers may log and drop (the join forgeries COUNTED, in
    membership_join_rejected_total), but no dispatcher coroutine may
    die and no phantom may enter the universe.

    ``join_secret``/``universe_epoch`` arm the two forgery classes
    that need a VALID MAC to reach their check (stale epoch, replayed
    nonce); without the secret those kinds still emit — they just die
    earlier, at bad_mac. ``kinds`` restricts the seeded menu (the
    elastic join-storm event uses the four join_* kinds alone)."""
    rng = random.Random(seed)
    base = Message(
        "127.0.0.1:65001", MsgType.PING, {"members": {}, "leader": None}
    ).pack()
    header = _HEADER  # the real wire header: the malformed-frame
    # constructions below must break the CURRENT format, not a copy

    def forged(mtype: MsgType, data: Dict[str, Any]) -> bytes:
        sender = rng.choice(senders) if senders else "6.6.6.6:666"
        return Message(sender, mtype, data).pack()

    def join_frame(node: Dict[str, Any], nonce: str, epoch: int,
                   mac: Optional[str], sender: str) -> bytes:
        if mac is None:
            mac = "%064x" % rng.getrandbits(256)
        return Message(sender, MsgType.JOIN_REQUEST, {
            "node": node, "nonce": nonce, "epoch": epoch, "mac": mac,
        }).pack()

    menu = kinds or (
        "trunc", "magic", "len_lie", "garbage", "oversize", "replay",
        "byz_forged", "byz_junk_fields", "byz_missing", "byz_nested",
        "join_bad_mac", "join_garbled", "join_stale", "join_replay",
    )
    malformed: List[bytes] = []
    byzantine: List[bytes] = []
    for _ in range(n):
        kind = rng.choice(menu)
        if kind == "trunc":
            malformed.append(base[: rng.randrange(1, len(base))])
        elif kind == "magic":
            b = bytearray(base)
            b[0] ^= 1 << rng.randrange(8)  # high magic byte: unpack rejects
            malformed.append(bytes(b))
        elif kind == "len_lie":
            magic_ver, mtype, slen, plen = header.unpack_from(base)
            lie = header.pack(magic_ver, mtype, slen, plen + rng.randrange(1, 99))
            malformed.append(lie + base[header.size:])
        elif kind == "garbage":
            # leading zero bytes can never match the magic, so random
            # tails stay guaranteed-malformed
            malformed.append(
                b"\x00\x00" + bytes(rng.getrandbits(8) for _ in range(rng.randrange(0, 120)))
            )
        elif kind == "oversize":
            # past wire.MAX_DATAGRAM, internally consistent header,
            # non-UTF-8 payload: decode fails, frame dropped
            plen = 60_500
            magic_ver, mtype, slen, _ = header.unpack_from(base)
            sender_b = base[header.size: header.size + slen]
            malformed.append(
                header.pack(magic_ver, mtype, slen, plen) + sender_b + b"\xff" * plen
            )
        elif kind == "replay":
            # replayed header, garbled body: the original (valid)
            # header glued onto a non-JSON payload of the right length
            magic_ver, mtype, slen, plen = header.unpack_from(base)
            sender_b = base[header.size: header.size + slen]
            malformed.append(
                header.pack(magic_ver, mtype, slen, plen) + sender_b + b"\xfe" * plen
            )
        elif kind == "byz_forged":
            # parses, but the sender is outside the static universe:
            # COORDINATE must not crown it, PING must not adopt its
            # leader claim
            byzantine.append(Message(
                "6.6.6.6:666",
                rng.choice((MsgType.COORDINATE, MsgType.PING, MsgType.ACK)),
                {"leader": "6.6.6.6:666", "members": {"6.6.6.6:666": [9e18, 1]}},
            ).pack())
        elif kind == "byz_junk_fields":
            byzantine.append(forged(MsgType.PING, {
                "members": {s: "not-a-pair" for s in senders[:2]},
                "leader": rng.random(),
            }))
        elif kind == "byz_missing":
            byzantine.append(forged(rng.choice((
                MsgType.PUT_REQUEST, MsgType.GET_FILE_REQUEST,
                MsgType.SUBMIT_JOB_REQUEST, MsgType.DOWNLOAD_FILE,
            )), {}))
        elif kind == "byz_nested":
            nested: Any = rng.random()
            for _ in range(40):
                nested = {"d": nested}
            byzantine.append(forged(MsgType.JOB_STATUS_REQUEST, {"rid": nested}))
        elif kind == "join_bad_mac":
            # a phantom with a random MAC: dies at the HMAC check,
            # counted bad_mac, never touches the universe
            byzantine.append(join_frame(
                {"host": "6.6.6.6", "port": 666, "name": "EVIL",
                 "rank": 99},
                f"fz{rng.getrandbits(48):012x}", universe_epoch,
                None, "6.6.6.6:666",
            ))
        elif kind == "join_garbled":
            byzantine.append(forged(MsgType.JOIN_REQUEST, rng.choice((
                {},
                {"node": "not-a-dict", "nonce": 7, "epoch": "x",
                 "mac": None},
                {"node": {"host": 1, "port": "y"}, "nonce": "n",
                 "epoch": 0, "mac": "m"},
                {"node": {"host": "6.6.6.6", "port": 666},
                 "nonce": "", "epoch": 0, "mac": "m"},
            ))))
        elif kind == "join_stale":
            # valid MAC over an OLD epoch (a captured pre-churn join
            # replayed after the universe moved): with the secret it
            # reaches — and dies at — the stale_epoch check
            node = {"host": "6.6.6.7", "port": 667, "name": "STALE",
                    "rank": 0}
            nonce = f"fz{rng.getrandbits(48):012x}"
            stale = universe_epoch - 1
            mac = (_join_mac(join_secret, node, nonce, stale)
                   if join_secret else None)
            byzantine.append(join_frame(node, nonce, stale, mac,
                                        "6.6.6.7:667"))
        else:  # join_replay
            # the same fully-valid frame twice: the node is an
            # EXISTING member (so the first delivery is an idempotent
            # rejoin, no phantom) and the second dies at the nonce
            # replay window
            target = rng.choice(senders) if senders else "6.6.6.8:668"
            host, _, port = target.rpartition(":")
            node = {"host": host, "port": int(port), "name": "",
                    "rank": 0}
            nonce = f"fz{rng.getrandbits(48):012x}"
            # a valid MAC only when the target IS a real member —
            # otherwise this would be a legitimate admission (secret
            # possession = authorization), not a forgery
            mac = (_join_mac(join_secret, node, nonce, universe_epoch)
                   if join_secret and senders else None)
            frame = join_frame(node, nonce, universe_epoch, mac, target)
            byzantine.append(frame)
            byzantine.append(frame)
    return malformed, byzantine


def churn_plan(
    seed: int,
    n_nodes: int = 5,
    rate_per_s: float = 0.9,
    duration: float = 7.0,
    with_jobs: bool = True,
    max_down: Optional[int] = None,
) -> ChaosPlan:
    """SUSTAINED churn: a seeded stream of join/leave pairs at
    ``rate_per_s`` crash events per second for ``duration`` seconds —
    the membership plane never settles, which is a different regime
    from the soak plans' one-off kill-and-recover. Victims are drawn
    from the non-leader/non-standby name pool (the leader dying is the
    *election* story, measured separately); each crash is paired with
    a same-identity restart after a seeded downtime that straddles the
    cleanup window, so the cluster sees both flavors: a flap that
    returns before cleanup (false-positive pressure) and a real
    death-and-rejoin. At most ``max_down`` nodes are down at once
    (defaults scale with N, bounded so replication_factor survivors
    always exist). Ends with every victim back and a verification
    tail: the invariant sweep must find exactly one leader, every
    seeded store file intact at factor, and no dead coroutines."""
    rng = random.Random(_child_seed(seed, "churn"))
    j = lambda a, b: round(rng.uniform(a, b), 3)  # noqa: E731
    # H1/H2 are the rank-ordered leader + standby; churning them turns
    # every cycle into an election, which drowns the churn signal
    pool = [f"H{i + 1}" for i in range(2, n_nodes)]
    if not pool:
        raise ValueError("churn needs at least 3 nodes")
    if max_down is None:
        max_down = max(1, min(len(pool) - 1 or 1, 1 + n_nodes // 16))
    events = [
        event(j(0.15, 0.3), "put", name="churn_seed_a.bin", size=1024),
        event(j(0.35, 0.5), "put", name="churn_seed_b.bin", size=1024),
    ]
    if with_jobs:
        events.append(event(j(0.6, 0.8), "job", n=16))
    t = 1.2
    #: victim -> time it becomes free again (restart + margin)
    busy: Dict[str, float] = {}
    # seeded rotation: every pool member gets churned before anyone
    # is churned twice (a pure random choice can hammer one node)
    order = list(pool)
    rng.shuffle(order)
    idx = 0
    end = 1.2 + max(1.0, duration)
    while t < end:
        down = sum(1 for until in busy.values() if until > t)
        victim = None
        if down < max_down:
            for off in range(len(order)):
                cand = order[(idx + off) % len(order)]
                if busy.get(cand, 0.0) <= t:
                    victim = cand
                    idx = (idx + off + 1) % len(order)
                    break
        if victim is not None:
            downtime = j(1.2, 2.4)
            events.append(event(t, "crash", victim))
            events.append(event(t + downtime, "restart", victim))
            busy[victim] = t + downtime + 0.5
        t += max(0.15, rng.uniform(0.6, 1.4) / max(rate_per_s, 0.05))
    tail = max(end, max(busy.values(), default=end)) + 0.5
    events.append(event(tail, "get", name="churn_seed_a.bin", scrub=False))
    if with_jobs:
        events.append(event(tail + 0.2, "job", n=12))
    return ChaosPlan(seed=seed, events=tuple(events), n_nodes=n_nodes,
                     settle_s=2.0, name=f"churn-{seed}")


def scenario_plan(family: str, seed: int, n_nodes: int = 5) -> ChaosPlan:
    """One focused plan per adversarial scenario family (the chaos-
    coverage gaps the earlier scenarios left):

    - ``asym``: one-way partition — the minority's datagrams to the
      majority vanish while the reverse direction still delivers;
      SWIM must converge on one leader without flapping, then fully
      re-merge after the heal.
    - ``disk``: a replica's disk fills (all writes fail) during a PUT
      — the leader must re-place the failed slot, not fail the PUT —
      then a stored replica is bit-flipped on disk and a scrubbed GET
      must detect the mismatch, quarantine, and re-repair to factor.
    - ``dns``: the introducer DNS dies, the leader is killed mid-put
      and mid-job DURING the outage, and the DNS returns with stale
      state — clients ride the window via leader_retry and the new
      leader must re-register once it is back.
    - ``skew``: one node's SWIM clock runs seconds ahead, another's
      behind; neither may be falsely evicted — and when the skewed-
      ahead node is killed, its future-dated gossip must not mask the
      real failure (merge clamps future timestamps).
    - ``fuzz``: bursts of seeded byzantine datagrams at every live
      transport; every malformed frame dies in Message.unpack
      (counted by transport_malformed_dropped_total), no coroutine
      dies, and the cluster keeps serving.
    - ``liar``: a worker becomes a lying-metrics straggler mid-load —
      every batch stalls a seeded extra wall AFTER its self-reported
      exec time is measured, so the worker's own metrics stay clean;
      the leader's dispatch->ACK cross-check (signal plane) must
      convict it from evidence it cannot forge, then the node heals
      and jobs keep completing.
    - ``elastic``: capacity change under load — a brand-new node
      joins mid-job through the authenticated JOIN_REQUEST path and
      takes pool slots, a join FLAPS (scale-out immediately followed
      by a graceful scale-in), a forged-join storm (bad HMAC /
      garbled / stale epoch / replayed nonce) moves the typed
      rejection counters without admitting a phantom, and a genesis
      worker leaves gracefully — retired from the table immediately,
      never read as an outage.
    - ``autoscale``: chaos aimed at the closed-loop CONTROLLER
      (plan.autoscale arms it with real actuators): a thrashing
      square wave of job bursts attacks the scale-out hysteresis, a
      lying-metrics straggler manufactures backlog the liar guard
      must refuse to pay chips for, a quiet window baits a scale-in
      proposal that a traffic spike then races, and the leader is
      killed in the decision window — the promoted leader inherits
      the relayed ledger and must not actuate any decision twice.
    - ``train``: chaos aimed at a TrainJob's exactly-once step
      contract (plan.train arms a paced elastic run before the
      schedule): a trainer holding an in-flight shard is killed
      mid-epoch (the step must complete on a survivor, the next
      boundary re-shards), a join races a step boundary (the run
      soaks the new capacity with the LR rescaled), and the leader
      is killed inside the checkpoint-every-step window — the
      promoted coordinator adopts the run from the store blob and
      the monotone ledger refuses whatever the shadow job
      double-completes. The sweep replays the ledger against the
      final state: no step lost, none applied twice.

    Timings are seed-jittered: one seed reproduces one schedule,
    different seeds explore different interleavings.
    """
    if family not in SCENARIO_FAMILIES:
        raise ValueError(f"unknown scenario family {family!r} "
                         f"(choose from {SCENARIO_FAMILIES})")
    if family == "churn":
        # sustained join/leave pressure has its own generator (rate ×
        # duration, paired crash/restart, bounded concurrent downs)
        return churn_plan(seed, n_nodes=n_nodes)
    rng = random.Random(_child_seed(seed, f"scenario/{family}"))
    j = lambda a, b: round(rng.uniform(a, b), 3)  # noqa: E731
    seed_file = f"{family}_seed.bin"
    events = [
        event(j(0.1, 0.3), "put", name=seed_file, size=1024),
        event(j(0.4, 0.6), "job", n=16),
    ]
    if family == "train":
        events += [
            # the run itself is armed by the runner BEFORE the event
            # schedule (paced via min_step_s so it spans it); the job
            # bursts keep SLO-classed inference sharing the pool the
            # whole way through
            event(j(0.9, 1.1), "job", n=16),
            # a trainer dies mid-epoch holding an in-flight shard:
            # the batch requeues onto a survivor, the step completes
            # exactly once, and the next boundary re-shards the run
            # down (reason="failure")
            event(j(1.4, 1.7), "crash", "trainer"),
            event(j(2.4, 2.7), "restart"),
            # a join races a step boundary: the pool grows mid-step
            # and the run soaks the capacity at the NEXT boundary
            # (reason="join"), LR rescaled to the new global batch
            event(j(3.1, 3.4), "scale_out", n=1),
            event(j(3.8, 4.1), "job", n=12),
            # the leader dies inside the checkpoint-every-step
            # window: the promoted coordinator adopts the run from
            # the store's checkpoint blob and the monotone ledger
            # refuses whatever the shadow step job double-completes
            event(j(4.6, 4.9), "crash", "leader"),
            event(j(6.0, 6.4), "job", n=12),
        ]
        return ChaosPlan(seed=seed, events=tuple(events),
                         n_nodes=n_nodes, settle_s=2.0,
                         name=f"train-{seed}",
                         join_secret=f"chaos-train-{seed}",
                         train=True)
    if family == "autoscale":
        events += [
            # phase 1 — thrash: square-wave bursts with gaps shorter
            # than the idle streak, so a well-hysteresed controller
            # rides them out with AT MOST the capacity the sustained
            # envelope justifies (no scale-out/scale-in ping-pong)
            event(j(0.9, 1.1), "job", n=256),
            event(j(1.4, 1.6), "job", n=256),
            event(j(2.8, 3.0), "job", n=256),
            event(j(3.3, 3.5), "job", n=256),
            # phase 2 — liar-fed policy: the straggler manufactures
            # backlog while its self-reported walls stay clean; once
            # the cross-check convicts it, scale-out pressure is
            # MASKED (suppressed, reason="liar"), then the heal
            # releases the guard
            event(j(4.2, 4.4), "liar", "worker",
                  extra_s=round(rng.uniform(0.6, 0.9), 2)),
            event(j(4.7, 4.9), "job", n=64),
            event(j(5.5, 5.7), "job", n=64),
            event(j(6.5, 6.7), "liar", "liar", extra_s=0.0),
            # phase 3 — scale-in racing a spike: the quiet window
            # here baits an idle proposal; this burst lands around
            # its confirm window, so (seed-dependent) the proposal is
            # either CANCELLED (typed cancel, reason="spike") or the
            # already-actuated LEAVE completes and the pool shrink
            # re-arms the pressure path within one evaluation window
            event(j(9.3, 9.6), "job", n=256),
            # phase 4 — controller-aimed kill: the leader dies inside
            # the decision window; the promoted leader inherits the
            # relayed ledger (cooldowns + in-flight rows) and must
            # settle each decision id exactly once, by observation
            event(j(10.3, 10.6), "crash", "leader"),
            event(j(12.2, 12.6), "job", n=24),
        ]
        return ChaosPlan(seed=seed, events=tuple(events),
                         n_nodes=n_nodes, settle_s=2.5,
                         name=f"autoscale-{seed}",
                         join_secret=f"chaos-autoscale-{seed}",
                         autoscale=True)
    if family == "elastic":
        events += [
            event(j(0.9, 1.1), "job", n=20),
            # capacity joins MID-LOAD (the job above is in flight)
            event(j(1.2, 1.4), "scale_out", n=1),
            event(j(2.0, 2.3), "job", n=16),
            # join flapping: out, then immediately gone again —
            # gracefully, so it must never read as a failure
            event(j(2.6, 2.8), "scale_out", n=1),
            event(j(3.4, 3.6), "scale_in", "joiner"),
            # forged-join storm: every frame rejected + counted
            event(j(4.0, 4.2), "join_storm", n=24),
            event(j(4.5, 4.9), "job", n=12),
            # graceful scale-in of a GENESIS worker: retired from the
            # table immediately, replicas re-replicated
            event(j(5.3, 5.5), "scale_in", "worker"),
            event(j(6.0, 6.4), "job", n=12),
        ]
        return ChaosPlan(seed=seed, events=tuple(events),
                         n_nodes=n_nodes, settle_s=1.5,
                         name=f"elastic-{seed}",
                         join_secret=f"chaos-elastic-{seed}")
    if family == "asym":
        events += [
            event(j(1.0, 1.3), "partition_asym",
                  fraction=round(rng.uniform(0.25, 0.45), 2)),
            event(j(2.0, 2.3), "job", n=12),
            event(j(4.0, 4.5), "heal"),
            event(j(5.2, 5.6), "job", n=12),
        ]
    elif family == "disk":
        events += [
            # two full disks: any replication_factor(4)-of-5 placement
            # must hit at least one, so the PUT-reassignment path is
            # exercised on every seed, not just placements that happen
            # to include the victim
            event(j(1.0, 1.1), "disk_fault", "worker", write_fail_pct=100.0),
            event(j(1.15, 1.25), "disk_fault", "standby",
                  write_fail_pct=100.0),
            event(j(1.5, 1.7), "put", name="disk_fault_put.bin", size=2048),
            event(j(2.6, 2.9), "disk_heal"),
            event(j(3.2, 3.4), "disk_corrupt", name=seed_file),
            event(j(3.6, 3.8), "get", name=seed_file, scrub=True),
            event(j(4.8, 5.2), "job", n=12),
        ]
    elif family == "dns":
        events += [
            event(j(1.0, 1.2), "dns_crash"),
            event(j(1.5, 1.8), "crash", "leader", mid=("put", "job")),
            event(j(4.0, 4.4), "dns_restart"),
            event(j(5.4, 5.8), "restart", "last"),
            event(j(6.4, 6.8), "job", n=12),
        ]
    elif family == "skew":
        events += [
            event(j(0.7, 0.9), "skew", "worker",
                  offset_s=round(rng.uniform(2.0, 5.0), 2)),
            event(j(1.0, 1.2), "skew", "standby",
                  offset_s=-round(rng.uniform(2.0, 5.0), 2)),
            event(j(1.8, 2.2), "job", n=12),
            # the skewed-AHEAD node dies: its future-dated gossip must
            # not keep it looking alive (clamped at merge)
            event(j(2.8, 3.2), "crash", "skewed"),
            event(j(5.2, 5.6), "restart", "last"),
            event(j(6.0, 6.4), "job", n=12),
        ]
    elif family == "liar":
        events += [
            # the straggle must dominate honest jitter (the cross-
            # check margin is ratio 1.4 + 0.25s absolute) without
            # stretching the scenario wall
            event(j(0.7, 0.9), "liar", "worker",
                  extra_s=round(rng.uniform(0.6, 1.0), 2)),
            # enough batches for the >= min_samples ACK medians the
            # cross-check needs before it will convict
            event(j(1.2, 1.5), "job", n=16),
            event(j(2.4, 2.7), "job", n=16),
            # heal: extra_s=0 clears the seam; completions continue
            event(j(3.4, 3.6), "liar", "liar", extra_s=0.0),
            event(j(3.9, 4.3), "job", n=12),
        ]
    else:  # fuzz
        events += [
            event(j(1.0, 1.2), "fuzz", n=36),
            event(j(1.6, 2.0), "job", n=12),
            event(j(2.4, 2.7), "fuzz", n=36),
            event(j(3.2, 3.5), "put", name="post_fuzz.bin", size=512),
            event(j(4.0, 4.4), "job", n=12),
        ]
    return ChaosPlan(seed=seed, events=tuple(events), n_nodes=n_nodes,
                     settle_s=1.5, name=f"{family}-{seed}")


def soak_plan(seed: int, n_nodes: int = 5) -> ChaosPlan:
    """The canonical recovery composition the acceptance criteria
    name: duplicate delivery + 2% loss from the start, the leader
    killed while a put AND a job are in flight, a partition that
    heals, and the crashed leader restarted with the same identity.
    Timing offsets and the extra disturbance are seed-jittered, so
    distinct seeds exercise distinct interleavings while one seed
    always reproduces the identical schedule."""
    rng = random.Random(_child_seed(seed, "soak"))
    j = lambda a, b: round(rng.uniform(a, b), 3)  # noqa: E731
    events = [
        # duplicate delivery (every copy also a straggler) + reorder
        event(0.0, "shape", dup_pct=25.0, reorder_pct=10.0,
              reorder_extra_s=0.02),
        event(0.0, "loss", pct=2.0),
        event(j(0.2, 0.4), "put", name="soak_seeded.bin", size=2048),
        event(j(0.5, 0.7), "job", n=24),
        # the headline kill: leader dies with a put and a job mid-wire
        event(j(1.0, 1.4), "crash", "leader", mid=("put", "job")),
        # after failover settles, split and heal the survivors
        event(j(3.2, 3.8), "partition", fraction=0.4),
        event(j(5.8, 6.6), "heal"),
        # the crashed ex-leader returns with the same identity
        event(j(8.0, 8.6), "restart", "last"),
        # post-restart traffic proves the rejoined cluster serves
        event(j(9.0, 9.5), "job", n=16),
    ]
    # one seeded extra disturbance mid-run — the menu spans every
    # scenario family, so soak seeds collectively compose the
    # adversarial faults with the canonical leader-kill recovery
    extra = rng.choice((
        "worker_crash", "store_fault", "loss_ramp", "asym_partition",
        "dns_blip", "clock_skew", "fuzz_burst", "disk_corruption",
    ))
    if extra == "worker_crash":
        t = j(4.0, 4.6)
        events += [event(t, "crash", "worker"),
                   event(t + j(2.0, 2.5), "restart", "last")]
    elif extra == "store_fault":
        t = j(3.0, 3.6)
        events += [event(t, "store_fault", delay_s=0.02, fail_pct=10.0),
                   event(t + j(2.0, 2.5), "store_heal")]
    elif extra == "loss_ramp":
        t = j(3.0, 3.6)
        events += [event(t, "loss", pct=5.0),
                   event(t + j(1.5, 2.0), "loss", pct=2.0)]
    elif extra == "asym_partition":
        # after the symmetric split healed: a one-way partition that
        # may still be live when the ex-leader restarts into it (the
        # directional restart-placement edge)
        t = j(6.8, 7.0)
        events += [event(t, "partition_asym",
                         fraction=round(rng.uniform(0.25, 0.45), 2)),
                   event(t + j(1.4, 1.8), "heal")]
    elif extra == "dns_blip":
        t = j(3.0, 3.4)
        events += [event(t, "dns_crash"),
                   event(t + j(1.5, 2.0), "dns_restart")]
    elif extra == "clock_skew":
        # the heal targets "skewed" (the node actually carrying the
        # offset), not a re-resolved role: the leader kill + partition
        # between the two events can move who "worker" resolves to,
        # and clearing a different node would silently leave the skew
        # in place for the rest of the run
        t = j(2.0, 2.4)
        events += [event(t, "skew", "worker",
                         offset_s=round(rng.uniform(2.0, 4.0), 2)),
                   event(j(7.0, 7.5), "skew", "skewed", offset_s=0.0)]
    elif extra == "fuzz_burst":
        events += [event(j(2.0, 2.6), "fuzz", n=30),
                   event(j(6.8, 7.4), "fuzz", n=30)]
    else:  # disk_corruption
        t = j(6.8, 7.2)
        events += [event(t, "disk_corrupt", name="soak_seeded.bin"),
                   event(t + 0.4, "get", name="soak_seeded.bin", scrub=True)]
    return ChaosPlan(seed=seed, events=tuple(events), n_nodes=n_nodes,
                     settle_s=1.5, name=f"soak-{seed}")


def random_plan(seed: int, n_nodes: int = 5, n_disturbances: int = 4,
                duration: float = 8.0) -> ChaosPlan:
    """Fully random plan: `n_disturbances` seeded picks from the fault
    menu, spread over `duration`, always book-ended by workload and a
    final heal/restart pass so the invariant sweep has something to
    check and a fair chance to pass."""
    rng = random.Random(_child_seed(seed, "random_plan"))
    events = [
        event(0.1, "put", name="rand_seeded.bin", size=1024),
        event(0.3, "job", n=16),
    ]
    crashed = 0
    for _ in range(max(1, n_disturbances)):
        t = round(rng.uniform(0.8, duration * 0.7), 3)
        pick = rng.choice(
            ("crash_leader", "crash_worker", "partition", "loss",
             "shape", "store_fault", "partition_asym", "skew", "fuzz")
        )
        if pick == "crash_leader":
            events.append(event(t, "crash", "leader",
                                mid=("job",) if rng.random() < 0.5 else ()))
            crashed += 1
        elif pick == "crash_worker":
            events.append(event(t, "crash", "worker"))
            crashed += 1
        elif pick == "partition":
            events.append(event(t, "partition",
                                fraction=round(rng.uniform(0.25, 0.45), 2)))
            events.append(event(t + round(rng.uniform(1.5, 2.5), 3), "heal"))
        elif pick == "partition_asym":
            events.append(event(t, "partition_asym",
                                fraction=round(rng.uniform(0.25, 0.45), 2)))
            events.append(event(t + round(rng.uniform(1.5, 2.5), 3), "heal"))
        elif pick == "skew":
            events.append(event(t, "skew", "worker",
                                offset_s=round(rng.uniform(-4.0, 4.0), 2)))
        elif pick == "fuzz":
            events.append(event(t, "fuzz", n=24))
        elif pick == "loss":
            events.append(event(t, "loss",
                                pct=round(rng.uniform(1.0, 5.0), 2)))
        elif pick == "shape":
            events.append(event(
                t, "shape",
                dup_pct=round(rng.uniform(5.0, 30.0), 1),
                reorder_pct=round(rng.uniform(0.0, 15.0), 1),
                reorder_extra_s=0.02,
            ))
        else:
            events.append(event(t, "store_fault", delay_s=0.02,
                                fail_pct=round(rng.uniform(5.0, 20.0), 1)))
            events.append(event(t + round(rng.uniform(1.5, 2.5), 3),
                                "store_heal"))
    # recovery tail: everything heals, crash victims return, and a
    # final job proves the healed cluster still serves
    tail = duration * 0.75
    events.append(event(tail, "heal"))
    events.append(event(tail + 0.1, "store_heal"))
    for i in range(crashed):
        events.append(event(tail + 0.3 + 0.5 * i, "restart", "last"))
    events.append(event(duration * 0.9, "job", n=8))
    return ChaosPlan(seed=seed, events=tuple(events), n_nodes=n_nodes,
                     settle_s=1.5, name=f"random-{seed}")


# ----------------------------------------------------------------------
# the in-process cluster under test
# ----------------------------------------------------------------------


def stub_backend(per_file_s: float = 0.004):
    """Deterministic inference stub: fixed per-file latency, labels
    echo the model. Keeps chaos runs off the device (the control plane is
    what's under test); tests/bench share it."""

    async def backend(model: str, paths: List[str]):
        exec_time = per_file_s * max(1, len(paths))
        await asyncio.sleep(exec_time)
        results = {p: [{"label": model, "score": 1.0}] for p in paths}
        return results, exec_time, None

    return backend


@dataclass
class SimNode:
    """One live node's service stack inside a LocalCluster."""

    node: Node
    #: None when the cluster runs services="core" (membership-only
    #: scale sims: no per-node TCP data plane / store loops)
    store: Optional[StoreService]
    #: JobService (imported lazily); None under
    #: services="core"/"store" — a 128-node control-plane sim must
    #: not pay 128 job-service stacks it never schedules on
    jobs: Any
    #: RequestRouter when the cluster runs with_ingress=True (the
    #: request front door, dml_tpu_torch/ingress/); None otherwise
    ingress: Any = None


class LocalCluster:
    """Product-level in-process cluster: introducer + N nodes, each
    with a replicated store and a job service on the stub backend.
    This is the chassis the chaos engine drives; the `chaos` CLI verb
    and the bench `chaos` section build one too."""

    def __init__(
        self,
        n_nodes: int,
        root: str,
        base_port: int,
        seed: int = 0,
        timing: Timing = FAST_TIMING,
        batch_size: int = 8,
        make_jobs: Optional[Callable[[Node, StoreService], Any]] = None,
        worker_groups: Optional[List[Any]] = None,
        with_ingress: bool = False,
        ingress_formation: str = "continuous",
        ingress_classes: Optional[Dict[str, Any]] = None,
        services: str = "full",
        gossip_protocol: Optional[str] = None,
        join_secret: str = "",
        autoscale: bool = False,
        autoscale_policy: Optional[AutoscalePolicy] = None,
        backend_per_file_s: float = 0.004,
        train: bool = False,
    ):
        """`worker_groups` (config.WorkerGroupSpec list) pools nodes
        into tensor-parallel serving groups (jobs/groups.py); the
        default job factory then gives each group primary a stub
        GROUP backend whose throughput scales with group capacity and
        which degrades (GroupDegraded) when a member dies mid-batch —
        the control-plane shape of sharded serving, off the device.

        `with_ingress=True` attaches the request front door
        (dml_tpu_torch/ingress/) to every node — a RequestRouter (active
        while that node leads; client verbs anywhere) plus the
        streaming LM stub registered as a servable model, so ingress
        tests and the `request_serving` bench drive per-request
        traffic through the same invariant-checked chassis.
        `ingress_formation` picks the batch-formation mode
        ("continuous" product default | "fixed" naive baseline);
        `ingress_classes` overrides the SLO class table.

        `services` bounds the per-node stack so O(100)-node sims stay
        affordable: "full" (default) = node + store + jobs (+ingress),
        "store" = node + store (churn/metadata scenarios — no job
        stacks), "core" = membership/election/metrics only (the pure
        control-plane scale probe: one UDP socket + two coroutines
        per node). `gossip_protocol` overrides the spec's piggyback
        protocol ("delta" product default | "full" reference
        baseline) — the scale bench scores one against the other.

        `join_secret` (non-empty) turns the elastic join policy ON:
        every node joins through the authenticated JOIN_REQUEST path,
        `scale_out` can admit brand-new nodes mid-run, and `scale_in`
        retires them (or genesis workers) through graceful LEAVE.

        `autoscale=True` arms every node's AutoscaleController with
        REAL capacity: its decisions drive this cluster's `scale_out`
        / `scale_in` (every node gets the wiring because leadership
        moves — only the current leader's controller evaluates).
        `autoscale_policy` overrides the product-default knobs
        (chaos/bench envelopes install CHAOS_AUTOSCALE_POLICY).

        `train=True` marks the run as a training scenario: the chaos
        runner arms an elastic TrainJob (dataset PUTs + a paced run
        on the coordinator) and records its name in `train_runs`,
        which gates the invariant sweep's step-exact checks. The
        trainer backend itself is registered unconditionally (every
        JobService attaches a TrainCoordinator), so restarts and
        joiners can execute shards in any mode.

        `backend_per_file_s` sets the stub backend's per-file wall —
        the default 4ms keeps chaos runs snappy; the diurnal probe
        slows it so a realistic open-loop trace can genuinely
        saturate a small pool."""
        if services not in ("full", "store", "core"):
            raise ValueError(f"unknown services mode {services!r}")
        self.root = root
        self.seed = seed
        self.batch_size = batch_size
        self.services = services
        spec_kw: Dict[str, Any] = {}
        if gossip_protocol is not None:
            spec_kw["gossip_protocol"] = gossip_protocol
        if join_secret:
            spec_kw["join_secret"] = join_secret
        self.spec = ClusterSpec.localhost(
            n_nodes,
            base_port=base_port,
            introducer_port=base_port - 1,
            timing=timing,
            store=StoreConfig(
                root=os.path.join(root, "roots"),
                download_dir=os.path.join(root, "dl"),
            ),
            worker_groups=list(worker_groups or []),
            **spec_kw,
        )
        #: elastic bookkeeping: genesis identities (fixed at
        #: construction — the invariant sweep's phantom check needs
        #: the pre-churn truth), every identity LEGITIMATELY admitted
        #: via scale_out, and the live runtime joiners in join order
        self.genesis_unames = {n.unique_name for n in self.spec.nodes}
        self.joined_ever: List[str] = []
        self.joined_live: List[str] = []
        self._join_port = base_port + n_nodes + 100
        self.autoscale = autoscale
        self.autoscale_policy = autoscale_policy
        self.backend_per_file_s = backend_per_file_s
        #: names of TrainJob runs armed by the chaos runner (or a
        #: test); non-empty gates the invariant sweep's step-exact
        #: training checks (section 9)
        self.train = train
        self.train_runs: List[str] = []
        self._make_jobs = make_jobs or self._default_jobs
        self.with_ingress = with_ingress
        self.ingress_formation = ingress_formation
        self.ingress_classes = ingress_classes
        self.dns = IntroducerService(self.spec)
        self.nodes: Dict[str, SimNode] = {}
        #: files the replication check must account for — guards the
        #: check against passing vacuously on a leader whose global
        #: table lost entries (the runner registers every put)
        self.expect_files: set = set()
        # current fault state, re-applied to restarted nodes so a
        # node that returns mid-scenario lives in the same weather
        #: active partition: {"groups": [[uname]], "asym": bool}.
        #: asym means ONE direction is dead — group 0's datagrams to
        #: group 1 are dropped (at both the sender's outbound filter
        #: and the receiver's inbound filter) while group 1 -> group 0
        #: still delivers.
        self._partition: Optional[Dict[str, Any]] = None
        self._loss_pct: float = 0.0
        self._shape_args: Optional[Dict[str, float]] = None
        self._store_fault_args: Optional[Dict[str, float]] = None
        #: uname -> installed DiskFault kwargs (restart re-applies)
        self._disk_faults: Dict[str, Dict[str, float]] = {}
        #: uname -> SWIM clock offset seconds (restart re-applies)
        self._skews: Dict[str, float] = {}
        #: uname -> lying-metrics straggle seconds (restart re-applies)
        self._liars: Dict[str, float] = {}
        self._restart_counter = 0

    def _default_jobs(self, node: Node, store: StoreService):
        from ..jobs.groups import stub_group_backend
        from ..jobs.service import JobService

        uname = node.me.unique_name
        gb = None
        g = node.spec.group_of_unique(uname)
        if g is not None:
            members = node.spec.group_members_unique(g.name)
            if members and uname == members[0]:
                # group primary: stub group engine — capacity-scaled
                # latency, degrades when a member dies mid-batch.
                # Membership re-reads the spec per batch so elastic
                # joins/leaves re-shape the group under the engine.
                gb = stub_group_backend(
                    g.name,
                    lambda gname=g.name: node.spec.group_members_unique(
                        gname),
                    lambda: {
                        n.unique_name
                        for n in node.membership.alive_nodes()
                    },
                )
        js = JobService(
            node, store,
            infer_backend=stub_backend(self.backend_per_file_s),
            group_backend=gb,
        )
        js.scheduler.set_batch_size(STUB_MODEL, self.batch_size)
        if self.with_ingress:
            # streaming LM stub as a servable per-request model: the
            # front door's token-streaming path stays off the device (the
            # control plane + formation machinery is what's under test)
            from ..ingress.streaming import STUB_LM_MODEL, streaming_lm_stub
            from ..jobs.cost_model import ModelCost

            js.register_lm(
                STUB_LM_MODEL,
                backend=streaming_lm_stub(),
                cost=ModelCost(
                    load_time=0.0, first_query=0.01, per_query=0.004,
                    batch_size=self.batch_size,
                ),
                patterns=("*.prompt.txt", "ingress_*.req"),
            )
        return js

    # ---- lifecycle ----

    async def start(self) -> None:
        await self.dns.start()
        for nid in self.spec.nodes:
            await self.start_node(nid)

    async def start_node(
        self,
        nid: NodeId,
        spec: Optional[ClusterSpec] = None,
        join_group: Optional[str] = None,
    ) -> SimNode:
        node = Node(spec or self.spec, nid,
                    seed=_child_seed(self.seed, f"node/{nid.unique_name}"),
                    join_group=join_group)
        store = jobs = ingress = None
        if self.services != "core":
            store = StoreService(
                node, root=os.path.join(self.root, f"st_{nid.port}")
            )
        if self.services == "full":
            jobs = self._make_jobs(node, store)
            if self.autoscale:
                self._wire_autoscale(jobs)
            if self.with_ingress:
                from ..ingress.router import RequestRouter

                ingress = RequestRouter(
                    jobs,
                    classes=self.ingress_classes,
                    formation=self.ingress_formation,
                )
        started: List[Any] = []
        try:
            await node.start()
            started.append(node)
            if store is not None:
                await store.start()
                started.append(store)
            if jobs is not None:
                await jobs.start()
                started.append(jobs)
            if ingress is not None:
                await ingress.start()
        except Exception:
            # a partial bring-up (e.g. stale port) must not leak the
            # services that did come up
            for svc in reversed(started):
                await svc.stop()
            raise
        sn = SimNode(node=node, store=store, jobs=jobs, ingress=ingress)
        self.nodes[nid.unique_name] = sn
        self._apply_faults_to(sn)
        return sn

    async def crash_node(self, uname: str) -> None:
        """Abrupt kill: transports closed, no goodbye datagrams — the
        reference's pulled-VM case. The node's store root stays on
        disk (a crash does not wipe a disk), so a restart with the
        same identity reports its old inventory."""
        sn = self.nodes.pop(uname)
        self.joined_live = [u for u in self.joined_live if u != uname]
        if sn.ingress is not None:
            await sn.ingress.stop()
        if sn.jobs is not None:
            await sn.jobs.stop()
        if sn.store is not None:
            await sn.store.stop()
        await sn.node.stop()

    async def restart_node(self, uname: str) -> SimNode:
        """Restart with the SAME identity (host:port): rebind the UDP
        socket and rejoin through the introducer path, like a
        supervised process coming back after a crash. The rebind
        rides the shared retry (util.rebind_retry) — the previous
        incarnation's socket can take a few loop iterations to fully
        release the port."""
        nid = self.spec.node_by_unique_name(uname)
        if nid is None:
            raise ValueError(f"unknown node {uname}")
        self._restart_counter += 1
        return await rebind_retry(lambda: self.start_node(nid))

    async def stop(self) -> None:
        for uname in list(self.nodes):
            await self.crash_node(uname)
        await self.dns.stop()

    # ---- elastic capacity (authenticated runtime join/leave) ----

    def _wire_autoscale(self, jobs: Any) -> None:
        """Arm one node's AutoscaleController with this cluster's real
        capacity machinery. Applied to every started node — genesis,
        restarts, and runtime joiners alike — so whichever node leads
        after a failover actuates against the same environment."""
        ctl = getattr(jobs, "autoscale", None)
        if ctl is None:
            return
        if self.autoscale_policy is not None:
            ctl.configure(self.autoscale_policy)

        async def admit() -> None:
            try:
                await self.scale_out(group=None)
            except Exception:
                log.exception("autoscale scale_out actuation failed")

        async def retire(uname: str) -> None:
            try:
                await self.scale_in(uname)
            except ValueError:
                # already gone: the duplicate-LEAVE race (actuate
                # relayed, effect raced the failover) is benign — the
                # ledger settles by observing the universe, not this
                pass
            except Exception:
                log.exception("autoscale scale_in actuation failed")

        ctl.scale_out_fn = admit
        ctl.scale_in_fn = retire

    async def scale_out(
        self,
        name: Optional[str] = None,
        group: Optional[str] = None,
        wait_s: float = 15.0,
    ) -> SimNode:
        """Start a BRAND-NEW node (an identity outside the genesis
        table) that joins the running cluster through the
        authenticated JOIN_REQUEST path. The joiner gets its own
        PRIVATE spec copy — genesis view plus itself — so admission,
        the epoch handshake, and the JOIN_ACK universe catch-up are
        exercised for real, not short-circuited through the sim's
        shared spec object. Waits until the join completes."""
        if not self.spec.join_secret:
            raise RuntimeError("scale_out needs join_secret set")
        self._join_port += 1
        n = len(self.joined_ever) + 1
        nid = NodeId("127.0.0.1", self._join_port,
                     name=name or f"J{n}", rank=0)
        jspec = ClusterSpec.from_json(self.spec.to_json())
        jspec.add_node(nid, local=True)
        sn = await self.start_node(nid, spec=jspec, join_group=group)
        self.joined_ever.append(nid.unique_name)
        self.joined_live.append(nid.unique_name)
        await self.wait_for(
            lambda: sn.node.joined, wait_s,
            f"runtime join of {nid.unique_name}",
        )
        return sn

    async def scale_in(self, uname: str) -> bool:
        """Graceful departure: the node announces LEAVE (retired from
        the universe + membership immediately — a scale-in must never
        read as an outage), then its service stack stops. Returns
        whether the goodbye was actually sent (False = it degraded to
        a silent exit and SWIM will clean it up the crash way)."""
        sn = self.nodes.pop(uname, None)
        if sn is None:
            raise ValueError(f"unknown/dead node {uname}")
        self.joined_live = [u for u in self.joined_live if u != uname]
        sent = await sn.node.leave_cluster()
        if sent:
            # let the goodbye land + the leader's table-change gossip
            # start before silencing the stack
            await asyncio.sleep(2 * self.spec.timing.ping_interval)
        if sn.ingress is not None:
            await sn.ingress.stop()
        if sn.jobs is not None:
            await sn.jobs.stop()
        if sn.store is not None:
            await sn.store.stop()
        await sn.node.stop()
        return sent

    # ---- fault application ----

    def _apply_faults_to(self, sn: SimNode) -> None:
        t = sn.node.transport
        assert t is not None
        uname = sn.node.me.unique_name
        if self._loss_pct > 0:
            t.set_loss(self._loss_pct,
                       _child_seed(self.seed, f"loss/{uname}"))
        if self._shape_args:
            t.shaper = LinkShaper(
                seed=_child_seed(self.seed,
                                 f"shape/{uname}/{self._restart_counter}"),
                **self._shape_args,
            )
        if self._store_fault_args and sn.store is not None:
            sn.store.data_plane.fault = TunnelFault(
                seed=_child_seed(self.seed, f"tunnel/{uname}"),
                **self._store_fault_args,
            )
        if uname in self._disk_faults and sn.store is not None:
            sn.store.store.fault = DiskFault(
                seed=_child_seed(
                    self.seed, f"disk/{uname}/{self._restart_counter}"),
                **self._disk_faults[uname],
            )
        if uname in self._skews:
            sn.node.membership.clock_offset = self._skews[uname]
        if uname in self._liars and sn.jobs is not None:
            sn.jobs.liar_extra_s = self._liars[uname]
        if self._partition is not None:
            # a node restarting into an active partition must land on
            # ONE side, not silently bridge both — on BOTH directional
            # seams. Deterministic placement: the hearing side for an
            # asymmetric split (group 1), the majority otherwise.
            groups = self._partition["groups"]
            if not any(uname in g for g in groups):
                if self._partition["asym"]:
                    groups[-1].append(uname)
                else:
                    max(groups, key=len).append(uname)
            self._install_partition()

    def set_loss(self, pct: float) -> None:
        self._loss_pct = pct
        for uname, sn in self.nodes.items():
            sn.node.transport.set_loss(
                pct, _child_seed(self.seed, f"loss/{uname}")
            )

    def set_shape(self, **kw: float) -> None:
        self._shape_args = {k: v for k, v in kw.items() if v} or None
        for uname, sn in self.nodes.items():
            sn.node.transport.shaper = (
                LinkShaper(
                    seed=_child_seed(
                        self.seed, f"shape/{uname}/{self._restart_counter}"
                    ),
                    **self._shape_args,
                )
                if self._shape_args
                else None
            )

    def set_store_fault(self, **kw: float) -> None:
        self._store_fault_args = {k: v for k, v in kw.items() if v} or None
        for uname, sn in self.nodes.items():
            if sn.store is None:
                continue
            sn.store.data_plane.fault = (
                TunnelFault(
                    seed=_child_seed(self.seed, f"tunnel/{uname}"), **kw
                )
                if self._store_fault_args
                else None
            )

    def set_disk_fault(self, uname: Optional[str], **kw: float) -> None:
        """Install a DiskFault on one node's LocalStore (uname=None or
        empty kwargs clears every disk fault)."""
        kw = {k: v for k, v in kw.items() if v}
        if uname is None or not kw:
            self._disk_faults.clear()
            for sn in self.nodes.values():
                if sn.store is not None:
                    sn.store.store.fault = None
            return
        self._disk_faults[uname] = kw
        sn = self.nodes.get(uname)
        if sn is not None and sn.store is not None:
            sn.store.store.fault = DiskFault(
                seed=_child_seed(
                    self.seed, f"disk/{uname}/{self._restart_counter}"),
                **kw,
            )

    def set_skew(self, uname: str, offset_s: float) -> None:
        """Skew one node's SWIM clock (0 clears). Survives restarts —
        a rebooted machine's clock is just as wrong."""
        if offset_s:
            self._skews[uname] = float(offset_s)
        else:
            self._skews.pop(uname, None)
        sn = self.nodes.get(uname)
        if sn is not None:
            sn.node.membership.clock_offset = float(offset_s)

    def set_liar(self, uname: str, extra_s: float) -> None:
        """Make one node a lying-metrics straggler: its batches stall
        ``extra_s`` seconds AFTER the self-reported exec wall is
        measured (0 clears). Survives restarts — a rebooted liar is
        still a liar."""
        if extra_s:
            self._liars[uname] = float(extra_s)
        else:
            self._liars.pop(uname, None)
        sn = self.nodes.get(uname)
        if sn is not None and sn.jobs is not None:
            sn.jobs.liar_extra_s = float(extra_s)

    def corrupt_replica(self, name: str) -> Optional[str]:
        """Flip a byte of ONE live replica's newest on-disk copy of
        `name`, bypassing the checksum sidecar — bit rot, as the
        platter would deliver it. Returns the victim uname (None if
        nobody holds the file). Detection happens on the next read of
        that replica (a scrubbed GET guarantees one)."""
        for uname in sorted(self.nodes):
            if self.nodes[uname].store is None:
                continue
            st = self.nodes[uname].store.store
            if st.has(name):
                path = st.get_path(name)
                with open(path, "r+b") as f:
                    first = f.read(1)
                    f.seek(0)
                    f.write(bytes([(first[0] if first else 0) ^ 0xFF]))
                return uname
        return None

    async def crash_dns(self) -> None:
        """Kill the introducer DNS mid-flight: joiners and leader
        updates get silence until it returns."""
        await self.dns.stop()

    async def restart_dns(self) -> None:
        """The DNS comes back with STATE LOSS: a fresh process knows
        only its static default introducer (the full-table election
        winner — after a failover, typically the dead ex-leader). The
        live leader's re-register loop must overwrite it; until then
        the stale answer is exactly what a real recovering nameserver
        would serve."""
        self.dns = IntroducerService(self.spec)
        await self.dns.start()

    def partition(self, groups: List[List[str]]) -> None:
        """Bidirectional control-plane partition between groups (the
        introducer stays reachable — it is a rendezvous, not a
        router; the TCP data plane is gated separately via
        store_fault)."""
        self._partition = {"groups": [list(g) for g in groups],
                           "asym": False}
        self._install_partition()

    def partition_asym(self, groups: List[List[str]]) -> None:
        """One-way partition: ``groups[0]``'s datagrams toward
        ``groups[1]`` (and any later group) are lost; the reverse
        direction delivers. Group 0 still HEARS the cluster — its
        ACKs just never arrive — the classic half-dead link SWIM's
        bidirectional ping/ack assumption is worst at."""
        self._partition = {"groups": [list(g) for g in groups],
                           "asym": True}
        self._install_partition()

    def _install_partition(self) -> None:
        part = self._partition
        if part is None:
            return
        asym = part["asym"]
        port_group: Dict[int, int] = {}
        for gi, unames in enumerate(part["groups"]):
            for uname in unames:
                nid = self.spec.node_by_unique_name(uname)
                if nid is not None:
                    port_group[nid.port] = gi

        def lost(src: Optional[int], dst: Optional[int]) -> bool:
            """Is the src-group -> dst-group direction dead?"""
            if src is None or dst is None or src == dst:
                return False
            return src == 0 if asym else True

        for sn in self.nodes.values():
            mine = port_group.get(sn.node.me.port)

            def out_blocked(addr, mine=mine):
                return lost(mine, port_group.get(addr[1]))

            def in_blocked(addr, mine=mine):
                return lost(port_group.get(addr[1]), mine)

            # both directional seams carry the same truth: the sender
            # drops what the link would lose AND the receiver's ear is
            # deaf to it — either alone enforces the partition, and a
            # restart must land consistently on both
            sn.node.transport.partition_filter = out_blocked
            sn.node.transport.inbound_filter = in_blocked

    def heal(self) -> None:
        self._partition = None
        for sn in self.nodes.values():
            sn.node.transport.partition_filter = None
            sn.node.transport.inbound_filter = None

    # ---- views ----

    def leader_uname(self) -> Optional[str]:
        """The leader every live node agrees on, else None."""
        seen = {sn.node.leader_unique for sn in self.nodes.values()}
        if len(seen) == 1:
            (leader,) = seen
            if leader in self.nodes:
                return leader
        return None

    def any_leader_store(self) -> Optional[StoreService]:
        for sn in self.nodes.values():
            if sn.node.is_leader and sn.store is not None:
                return sn.store
        return None

    def client(self, avoid: Tuple[str, ...] = ()) -> SimNode:
        """A live node to drive client verbs from (prefers a
        non-leader so client traffic crosses the wire)."""
        for uname in sorted(self.nodes):
            sn = self.nodes[uname]
            if uname not in avoid and not sn.node.is_leader:
                return sn
        return self.nodes[sorted(self.nodes)[0]]

    def resolve_target(self, target: Optional[str]) -> Optional[str]:
        """Map a plan target to a live node's unique_name."""
        if target is None:
            return None
        if target == "leader":
            for uname, sn in sorted(self.nodes.items()):
                if sn.node.is_leader:
                    return uname
            return self.leader_uname()
        if target == "standby":
            # Node.standby_node: the one standby definition, shared
            # with the store's failover relays — and available in
            # membership-only "core" sims too
            for sn in self.nodes.values():
                if sn.node.is_leader:
                    sb = sn.node.standby_node()
                    return sb.unique_name if sb else None
            return None
        if target == "worker":
            leader = self.resolve_target("leader")
            standby = self.resolve_target("standby")
            for uname in sorted(self.nodes):
                if uname not in (leader, standby):
                    return uname
            return None
        if target == "joiner":
            # the most recent LIVE runtime joiner (elastic scale-in /
            # join-flap target)
            live = [u for u in self.joined_live if u in self.nodes]
            return live[-1] if live else None
        if target == "trainer":
            # the live worker currently executing a TrainJob shard
            # (an in-flight cluster-trainer batch on the coordinator's
            # board); falls back to a plain worker so the kill still
            # fires if the dispatch raced the schedule
            from ..jobs.train import TRAIN_MODEL

            leader = self.resolve_target("leader")
            sn = self.nodes.get(leader) if leader else None
            if sn is not None and getattr(sn, "jobs", None) is not None:
                for uname, b in sorted(
                    sn.jobs.scheduler.in_progress.items()
                ):
                    if getattr(b, "model", "") == TRAIN_MODEL \
                            and uname in self.nodes:
                        return uname
            return self.resolve_target("worker")
        if target == "skewed":
            # the live node whose SWIM clock runs furthest AHEAD (the
            # mask-a-real-failure victim of the skew scenario)
            live_skews = {
                u: off for u, off in self._skews.items()
                if u in self.nodes and off > 0
            }
            if not live_skews:
                return None
            return max(sorted(live_skews), key=lambda u: live_skews[u])
        if target == "liar":
            # the live lying-metrics straggler (heal target of the
            # liar scenario)
            live = sorted(u for u in self._liars if u in self.nodes)
            return live[0] if live else None
        nid = self.spec.node_by_name(target)
        if nid is not None:
            return nid.unique_name
        return target if target in self.nodes else None

    # ---- waiting ----

    async def wait_for(self, cond: Callable[[], bool], timeout: float,
                       what: str) -> float:
        loop = asyncio.get_running_loop()
        t0 = loop.time()
        deadline = t0 + timeout
        while loop.time() < deadline:
            if cond():
                return loop.time() - t0
            await asyncio.sleep(0.02)
        raise AssertionError(f"timed out waiting for {what}")

    def converged(self) -> bool:
        """Every live node joined, agreeing on one live leader, with
        identical live membership."""
        if not self.nodes:
            return False
        want = set(self.nodes)
        for sn in self.nodes.values():
            if not sn.node.joined or sn.node.leader_unique not in want:
                return False
            alive = {n.unique_name for n in sn.node.membership.alive_nodes()}
            if alive != want:
                return False
        return self.leader_uname() is not None

    def replication_satisfied(self) -> bool:
        """Every file the leader tracks has `replication_factor` live
        copies (capped by cluster size) — and the leader's table
        actually knows every expected file, so the check can't pass
        vacuously on a table that lost entries to churn."""
        if self.services == "core":
            # membership-only sim: no stores exist, so replication is
            # vacuously whatever convergence says
            return bool(self.converged())
        leader_store = self.any_leader_store()
        if leader_store is None or not self.converged():
            return False
        live = set(self.nodes)
        want = min(self.spec.store.replication_factor, len(live))
        md = leader_store.metadata
        files = md.all_files()
        if not self.expect_files <= set(files):
            return False
        for f in files:
            if len([r for r in md.replicas_of(f) if r in live]) < want:
                return False
        return True


# ----------------------------------------------------------------------
# invariants
# ----------------------------------------------------------------------


@dataclass
class InvariantReport:
    ok: bool
    failures: List[str] = field(default_factory=list)
    checks: Dict[str, Any] = field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def _malformed_dropped_total() -> float:
    snap = METRICS.snapshot()
    return float(
        snap["counters"].get("transport_malformed_dropped_total", 0.0)
    )


def _join_rejected_total() -> float:
    """Sum across the typed rejection reasons (labeled counter)."""
    snap = METRICS.snapshot()
    return float(sum(
        v for k, v in snap["counters"].items()
        if k.startswith("membership_join_rejected_total")
    ))


async def invariant_sweep(
    cluster: LocalCluster,
    acked_jobs: Dict[int, Dict[str, Any]],
    seed_files: Dict[str, bytes],
    timeout: float = 25.0,
    fuzz_malformed_sent: int = 0,
    malformed_baseline: float = 0.0,
    forged_joins_sent: int = 0,
    join_reject_baseline: float = 0.0,
) -> InvariantReport:
    """The machine-checked end state every plan run must reach."""
    failures: List[str] = []
    checks: Dict[str, Any] = {}

    # 1. exactly-one-leader convergence across the live nodes
    try:
        wall = await cluster.wait_for(
            cluster.converged, timeout, "single-leader convergence"
        )
        checks["leader"] = {"leader": cluster.leader_uname(),
                            "converged_in_s": round(wall, 2)}
    except AssertionError:
        views = {u: sn.node.leader_unique
                 for u, sn in cluster.nodes.items()}
        failures.append(f"no single-leader convergence: views={views}")

    # 1b. the introducer DNS (when up) must agree with the converged
    # leader — a healed DNS outage ends with the live leader
    # re-registered, so future joiners land on it, not on a corpse
    if cluster.dns.transport is not None and cluster.leader_uname():
        try:
            await cluster.wait_for(
                lambda: cluster.dns.current_introducer
                == cluster.leader_uname(),
                timeout, "introducer DNS pointing at the leader",
            )
            checks["dns"] = {"introducer": cluster.dns.current_introducer}
        except AssertionError:
            failures.append(
                f"introducer DNS points at "
                f"{cluster.dns.current_introducer!r} but the leader is "
                f"{cluster.leader_uname()!r}"
            )

    # 2. every acked job terminal, completions counted exactly once
    leader_sn = next(
        (sn for sn in cluster.nodes.values() if sn.node.is_leader), None
    )
    job_check: Dict[str, Any] = {"acked": len(acked_jobs)}
    for job_id, meta in sorted(acked_jobs.items()):
        outcome = meta.get("outcome")
        if outcome in ("lost", "client_crashed"):
            # 'lost': the coordinator lost the job across a failover
            # (relay datagram dropped); the client was TOLD to
            # resubmit and did — the fresh id is tracked separately.
            # 'client_crashed': the submitting node was itself the
            # crash victim, so nobody holds a completion promise.
            continue
        if outcome is None:
            failures.append(f"job {job_id} never reached a terminal state")
            continue
        if leader_sn is None or leader_sn.jobs is None:
            continue
        st = leader_sn.jobs.scheduler.job_state(job_id)
        if st is None:
            # retired past the done_jobs ring or submitted to a
            # since-crashed coordinator; the client-side outcome above
            # is the authority
            continue
        if not st.done:
            failures.append(f"job {job_id} not done on the coordinator")
        if st.pending_batches != 0:
            failures.append(
                f"job {job_id} pending_batches={st.pending_batches} "
                "(lost or duplicated completions)"
            )
    job_check["terminal"] = sum(
        1 for m in acked_jobs.values() if m.get("outcome") == "done"
    )
    job_check["resubmitted_after_loss"] = sum(
        1 for m in acked_jobs.values() if m.get("outcome") == "lost"
    )
    checks["jobs"] = job_check

    # 3. store repair: factor copies + seed-file content intact
    try:
        wall = await cluster.wait_for(
            cluster.replication_satisfied, timeout,
            "replication back to factor",
        )
        checks["replication"] = {"repaired_in_s": round(wall, 2)}
    except AssertionError:
        leader_store = cluster.any_leader_store()
        thin = {}
        if leader_store is not None:
            live = set(cluster.nodes)
            md = leader_store.metadata
            thin = {
                f: [r for r in md.replicas_of(f) if r in live]
                for f in md.all_files()
            }
        failures.append(
            f"files not back to replication_factor copies: {thin}"
        )
    client = cluster.client()
    for name, blob in sorted(seed_files.items()):
        if client.store is None:
            failures.append(
                f"seed file {name} expected but the cluster runs "
                "without store services"
            )
            continue
        try:
            got = await client.store.get_bytes(name, timeout=10.0)
        except Exception as e:
            failures.append(f"seed file {name} unreadable after chaos: {e}")
            continue
        if got != blob:
            failures.append(f"seed file {name} content corrupted")
    checks["seed_files"] = sorted(seed_files)

    # 3b. EVERY live replica's on-disk copy hashes to the seeded
    # content (checksum-verified reads): the corruption scenario must
    # end with the bad copy quarantined AND re-repaired, not merely
    # routed around — a client-side read can't see the difference
    bad_copies = []
    for name, blob in sorted(seed_files.items()):
        for uname in sorted(cluster.nodes):
            if cluster.nodes[uname].store is None:
                continue
            st = cluster.nodes[uname].store.store
            if not st.has(name):
                continue
            try:
                data, _ = st.get_bytes(name)
            except Exception as e:
                bad_copies.append(f"{uname}:{name} unreadable ({e})")
                continue
            if data != blob:
                bad_copies.append(f"{uname}:{name} content mismatch")
    if bad_copies:
        failures.append(f"replica copies corrupt on disk: {bad_copies}")

    # 4. no metrics gauge negative (an in-process sim shares one
    # registry, so this sweeps every node's gauges at once)
    snap = METRICS.snapshot()
    negative = {k: v for k, v in snap["gauges"].items() if v < 0}
    if negative:
        failures.append(f"negative gauges: {negative}")
    checks["gauges_scanned"] = len(snap["gauges"])

    # 5. no core coroutine died: byzantine input, injected faults, and
    # handler exceptions may be logged and dropped, but every live
    # node's dispatch/failure-detection/store loops must still be
    # running (a dead dispatcher serves nothing and says nothing)
    dead = []
    checked = 0
    for uname, sn in sorted(cluster.nodes.items()):
        for t in sn.node._tasks:
            tname = t.get_name()
            if (tname.endswith("-dispatch") or tname.endswith("-fd")) \
                    and t.done():
                dead.append(f"{uname}:{tname}")
        checked += 2
        if sn.store is not None:
            checked += 1
            rt = sn.store._resend_task
            if rt is not None and rt.done():
                dead.append(f"{uname}:store-resend")
    if dead:
        failures.append(f"core coroutines died: {dead}")
    checks["coroutines_checked"] = checked

    # 6. when the plan fuzzed the wire, every guaranteed-malformed
    # datagram must have died in Message.unpack, visibly: the
    # malformed-drop counter moved (silence would mean frames reached
    # dispatch — or the seam lost its instrumentation)
    if fuzz_malformed_sent:
        delta = _malformed_dropped_total() - malformed_baseline
        checks["fuzz"] = {"malformed_sent": fuzz_malformed_sent,
                          "malformed_dropped": int(delta)}
        if delta <= 0:
            failures.append(
                f"fuzz sent {fuzz_malformed_sent} malformed datagrams "
                "but transport_malformed_dropped_total never moved"
            )

    # 7. elastic universe integrity: every node in every live node's
    # table is either genesis or a LEGITIMATELY admitted joiner (no
    # phantom survived the forged-join pressure), and when the plan
    # blasted forged joins, the typed rejection counters moved
    if cluster.spec.join_secret:
        legit = cluster.genesis_unames | set(cluster.joined_ever)
        phantoms = sorted({
            n.unique_name
            for sn in cluster.nodes.values()
            for n in sn.node.spec.nodes
            if n.unique_name not in legit
        })
        checks["universe"] = {
            "epochs": {u: sn.node.spec.universe_epoch
                       for u, sn in sorted(cluster.nodes.items())},
            "joined_ever": list(cluster.joined_ever),
        }
        if phantoms:
            failures.append(
                f"phantom node(s) entered the universe: {phantoms}"
            )
        if forged_joins_sent:
            delta = _join_rejected_total() - join_reject_baseline
            checks["forged_joins"] = {
                "sent": forged_joins_sent, "rejected": int(delta)}
            if delta <= 0:
                failures.append(
                    f"join storm sent {forged_joins_sent} forged "
                    "JOIN_REQUESTs but membership_join_rejected_total "
                    "never moved"
                )

    # 8. closed-loop autoscaler integrity (plans that armed the
    # controller): across the UNION of every live node's decision
    # stream, no decision id was applied or actuated twice (the
    # exactly-once-across-failover contract — a promoted leader must
    # inherit the relayed ledger, not re-fire it); no scale-in was
    # ever DECIDED at or below the pool floor (a crash shrinking the
    # pool is not a decision); and no retired node still owns
    # in-flight or staged batches on the live leader's scheduler (a
    # LEAVE whose work was never requeued)
    if getattr(cluster, "autoscale", False):
        ev_counts: Dict[str, Dict[str, int]] = {}
        all_rows: Dict[str, List[Dict[str, Any]]] = {}
        floors: List[int] = []
        floor = None
        for uname, sn in sorted(cluster.nodes.items()):
            if sn.jobs is None:
                continue
            ctl = sn.jobs.autoscale
            floor = ctl.policy.floor if floor is None else floor
            if ctl.min_pool_seen is not None:
                floors.append(ctl.min_pool_seen)
            for e in ctl.ledger.stream():
                per = ev_counts.setdefault(e["id"], {})
                per[e["event"]] = per.get(e["event"], 0) + 1
            for r in ctl.ledger.rows():
                all_rows.setdefault(r["id"], []).append(r)
        kinds: Dict[str, int] = {}
        for rows in all_rows.values():
            k = rows[0]["kind"]
            kinds[k] = kinds.get(k, 0) + 1
        dup = sorted(
            f"{did}:{ev}" for did, per in ev_counts.items()
            for ev, c in per.items()
            if ev in ("apply", "actuate") and c > 1
        )
        if dup:
            failures.append(
                f"autoscale decision settled/actuated twice: {dup}"
            )
        below = sorted({
            r["id"] for rows in all_rows.values() for r in rows
            if r["kind"] == "scale_in" and floor is not None
            and int(r["detail"].get("pool_n", floor + 1)) <= floor
        })
        if below:
            failures.append(
                f"scale-in decided at/below the pool floor: {below}"
            )
        if leader_sn is not None and leader_sn.jobs is not None:
            live = set(cluster.nodes)
            orphaned = sorted(
                (set(leader_sn.jobs.scheduler.in_progress)
                 | set(leader_sn.jobs.scheduler.prefetch)) - live
            )
            if orphaned:
                failures.append(
                    "retired/dead nodes still hold in-flight batches "
                    f"on the leader: {orphaned}"
                )
        checks["autoscale"] = {
            "decision_rows": kinds,
            "distinct_ids": len(all_rows),
            "min_pool_seen": min(floors) if floors else None,
            "floor": floor,
        }

    # 9. TrainJob step-exact accounting (plans that armed a training
    # run): on the (possibly promoted) coordinator, every armed run
    # completed with a CONTIGUOUS exactly-once ledger — history is
    # exactly steps 0..N-1, each applied once — and the final
    # parameter state equals a from-scratch replay of that ledger.
    # Deterministic per-file gradients make the replay the oracle: a
    # lost step, a double-apply, or a wrong (world, lr) at any step
    # cannot reproduce the same floats. Worker-reported gradients
    # never drifted from the reference, and the final checkpoint blob
    # in the store agrees with the live state (the adoptable truth a
    # NEXT failover would restore).
    if getattr(cluster, "train_runs", None):
        from ..jobs.train import TRAIN_CKPT_PREFIX, replay_reference

        trains: Dict[str, Any] = {}
        for name in cluster.train_runs:
            run = None
            if leader_sn is not None and leader_sn.jobs is not None:
                run = leader_sn.jobs.train.runs.get(name)
            if run is None or not run.done:
                failures.append(
                    f"train run {name} missing or unfinished on the "
                    "coordinator"
                )
                continue
            led = run.ledger
            got = [e["step"] for e in led.history]
            if got != list(range(run.spec.steps)):
                failures.append(
                    f"train run {name} ledger is not contiguous "
                    f"exactly-once (applied={led.applied}, "
                    f"steps={run.spec.steps})"
                )
            if run.state != replay_reference(run.spec, led.history):
                failures.append(
                    f"train run {name} final state != ledger replay "
                    "(a step was lost or double-applied)"
                )
            if run.grad_mismatches:
                failures.append(
                    f"train run {name}: {run.grad_mismatches} worker "
                    "gradient(s) drifted from the deterministic "
                    "reference"
                )
            try:
                blob = await cluster.client().store.get_bytes(
                    TRAIN_CKPT_PREFIX + name
                )
                d = json.loads(blob.decode())
                if not d.get("done"):
                    failures.append(
                        f"train run {name} final checkpoint not "
                        "marked done"
                    )
                if [float(x) for x in d.get("state", [])] != run.state:
                    failures.append(
                        f"train run {name} checkpoint state != live "
                        "state"
                    )
            except Exception as e:
                failures.append(
                    f"train run {name} final checkpoint unreadable: "
                    f"{e!r}"
                )
            trains[name] = {
                "applied": led.applied,
                "steps": run.spec.steps,
                # every world size the run stepped at (from the ledger
                # itself, so re-shards on a PRE-failover coordinator
                # are visible too): >1 entry proves the run actually
                # re-sharded mid-flight
                "worlds": sorted({int(e["world"]) for e in led.history}),
                "final_world": run.world,
                "final_lr": run.lr,
                "resharding": dict(run.resharding),
                "duplicates_refused": led.duplicates_refused,
                "out_of_order_refused": led.out_of_order_refused,
                "redispatches": run.redispatches,
                "ckpt_puts": run.ckpt_puts,
            }
        checks["train"] = trains

    return InvariantReport(ok=not failures, failures=failures, checks=checks)


# ----------------------------------------------------------------------
# runner
# ----------------------------------------------------------------------


@dataclass
class ChaosReport:
    plan: ChaosPlan
    invariants: InvariantReport
    executed: List[Dict[str, Any]]
    failover_recovery_s: List[float]
    store_repair_s: List[float]
    jobs: Dict[int, Dict[str, Any]]
    wall_s: float

    @property
    def ok(self) -> bool:
        return self.invariants.ok

    def to_dict(self) -> Dict[str, Any]:
        return {
            "plan": self.plan.to_dict(),
            "ok": self.ok,
            "invariants": self.invariants.to_dict(),
            "executed": self.executed,
            "failover_recovery_s": [
                round(x, 3) for x in self.failover_recovery_s
            ],
            "store_repair_s": [round(x, 3) for x in self.store_repair_s],
            "jobs": {str(k): dict(v) for k, v in self.jobs.items()},
            "wall_s": round(self.wall_s, 2),
        }


class ChaosRunner:
    """Executes one ChaosPlan against a LocalCluster and sweeps the
    invariants. One runner per run."""

    def __init__(self, cluster: LocalCluster, plan: ChaosPlan):
        self.cluster = cluster
        self.plan = plan
        self.executed: List[Dict[str, Any]] = []
        self.failover_recovery_s: List[float] = []
        self.store_repair_s: List[float] = []
        #: job_id -> {model, n, client, outcome: done|failed|lost|None}
        self.jobs: Dict[int, Dict[str, Any]] = {}
        self.seed_files: Dict[str, bytes] = {}
        self._last_crashed: List[str] = []
        self._bg: List[asyncio.Task] = []
        self._workload: List[asyncio.Task] = []
        self._put_counter = 0
        self._fuzz_counter = 0
        self.fuzz_malformed_sent = 0
        self._malformed_baseline = _malformed_dropped_total()
        self.forged_joins_sent = 0
        self._join_reject_baseline = _join_rejected_total()

    # ---- workload ----

    def _seed_blob(self, name: str, size: int) -> bytes:
        rng = random.Random(_child_seed(self.plan.seed, f"blob/{name}"))
        return bytes(rng.getrandbits(8) for _ in range(size))

    def _client_crashed(self, client: SimNode) -> bool:
        """True when `client`'s service stack is no longer the live
        one — compared by OBJECT identity, not name: a crash victim
        that already restarted re-registers the same unique_name with
        a fresh stack, and the old handle is still dead."""
        return (
            self.cluster.nodes.get(client.node.me.unique_name)
            is not client
        )

    async def _do_put(self, name: str, size: int) -> None:
        blob = self._seed_blob(name, size)
        last: Optional[Exception] = None
        for _ in range(3):
            client = self.cluster.client()
            try:
                await client.store.put_bytes(name, blob, timeout=20.0)
                self.seed_files[name] = blob
                self.cluster.expect_files.add(name)
                return
            except Exception as e:
                if self._client_crashed(client):
                    last = e  # our client node was a crash victim
                    continue
                raise
        raise RuntimeError(f"put {name} failed on 3 clients") from last

    async def _do_get(self, name: str, scrub: bool) -> None:
        """Client GET verified against the seeded content. With
        ``scrub``, every live replica is also read DIRECTLY first —
        a corrupted copy only reveals itself when something reads it,
        and the normal GET may be served by a healthy replica."""
        blob = self.seed_files.get(name)
        last: Optional[Exception] = None
        for _ in range(3):
            client = self.cluster.client()
            try:
                if scrub:
                    for uname in await client.store.ls(name):
                        nid = client.node.spec.node_by_unique_name(uname)
                        if nid is None:
                            continue
                        try:
                            await client.store.data_plane.fetch_from_store(
                                data_addr(nid), name
                            )
                        except Exception as e:
                            # a corrupt/missing copy: its replica has
                            # now detected + quarantined it, which is
                            # the point of the scrub
                            log.debug("scrub pull of %s from %s: %r",
                                      name, uname, e)
                got = await client.store.get_bytes(name, timeout=15.0)
                if blob is not None and got != blob:
                    raise AssertionError(
                        f"get {name}: content mismatch after chaos"
                    )
                return
            except AssertionError:
                raise
            except Exception as e:
                if self._client_crashed(client):
                    last = e
                    continue
                raise
        raise RuntimeError(f"get {name} failed on 3 clients") from last

    # ---- training workload (plan.train) ----

    def _train_leader_run(self, name: str):
        """The current coordinator's view of a run (or None) — re-
        resolved per call because the leader moves under chaos."""
        leader = self.cluster.resolve_target("leader")
        sn = self.cluster.nodes.get(leader) if leader else None
        if sn is None or getattr(sn, "jobs", None) is None:
            return None
        return sn.jobs.train.runs.get(name)

    async def _arm_train(self) -> None:
        """Seed the sharded dataset into the store and start a paced
        elastic TrainJob on the coordinator BEFORE the event schedule
        — the scenario's kills and joins then land mid-run. Paced via
        ``min_step_s`` so the run spans the schedule instead of
        finishing before the first fault."""
        from ..jobs.train import TrainJobSpec

        dataset = []
        for i in range(8):
            fname = f"train_shard_{i:02d}.bin"
            await self._do_put(fname, 256)
            dataset.append(fname)
        spec = TrainJobSpec(
            name=f"chaos{self.plan.seed}",
            dataset=dataset,
            steps=60,
            shard_batch=2,
            base_lr=0.1,
            # checkpoint EVERY step: any leader kill lands inside the
            # checkpoint window, and the adopted blob is never more
            # than one step stale
            checkpoint_every=1,
            min_step_s=0.12,
            seed=self.plan.seed,
        )
        leader = self.cluster.resolve_target("leader")
        sn = self.cluster.nodes.get(leader) if leader else None
        if sn is None or getattr(sn, "jobs", None) is None:
            raise RuntimeError("no coordinator to start the train run")
        await sn.jobs.train.start_run(spec)
        self.cluster.train_runs.append(spec.name)

    async def _drain_train(self) -> List[str]:
        """Wait for every armed run to complete on the (possibly
        promoted) coordinator. A run that can't finish despite the
        re-dispatch + adoption machinery is a recovery failure."""
        errors: List[str] = []
        for name in self.cluster.train_runs:

            def _done(name: str = name) -> bool:
                run = self._train_leader_run(name)
                return run is not None and run.done

            try:
                await self.cluster.wait_for(
                    _done, 90.0, f"train run {name} completion"
                )
            except Exception as e:
                errors.append(f"train run {name} did not finish: {e!r}")
        return errors

    def _do_fuzz(self, n: int) -> Dict[str, int]:
        """Inject one seeded byzantine burst at every live transport
        (raw socket — below every product abstraction, like the
        network would)."""
        self._fuzz_counter += 1
        c = self.cluster
        senders = tuple(sorted(c.nodes))
        malformed, byzantine = fuzz_datagrams(
            _child_seed(self.plan.seed, f"fuzz/{self._fuzz_counter}"),
            n, senders,
        )
        targets = []
        for uname in sorted(c.nodes):
            nid = c.spec.node_by_unique_name(uname)
            if nid is not None:
                targets.append((nid.host, nid.port))
        if not targets:
            return {"malformed": 0, "byzantine": 0}
        sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        sent = {"malformed": 0, "byzantine": 0}
        try:
            for i, frame in enumerate(malformed + byzantine):
                pool = "malformed" if i < len(malformed) else "byzantine"
                try:
                    sock.sendto(frame, targets[i % len(targets)])
                    sent[pool] += 1
                except OSError:
                    # e.g. EMSGSIZE: non-Linux UDP stacks cap datagrams
                    # well under the ~60 KB oversize frame — a frame
                    # the OS refuses to emit is not a frame the node
                    # must survive, so it simply doesn't count
                    continue
        finally:
            sock.close()
        # only frames that actually left the socket count toward the
        # sweep's "the drop counter must have moved" obligation
        self.fuzz_malformed_sent += sent["malformed"]
        return sent

    def _do_join_storm(self, n: int) -> Dict[str, int]:
        """Blast forged JOIN_REQUESTs (bad HMAC / garbled / stale
        epoch / replayed nonce) at every live node. Crafted at the
        CURRENT universe epoch with the cluster's own secret, so the
        stale/replay forgeries carry VALID MACs and reach — and die
        at — their dedicated checks instead of all collapsing into
        bad_mac. The sweep asserts the rejection counters moved and
        no phantom entered any table."""
        self._fuzz_counter += 1
        c = self.cluster
        senders = tuple(sorted(c.nodes))
        _, frames = fuzz_datagrams(
            _child_seed(self.plan.seed,
                        f"join_storm/{self._fuzz_counter}"),
            n, senders,
            join_secret=c.spec.join_secret,
            universe_epoch=c.spec.universe_epoch,
            kinds=("join_bad_mac", "join_garbled", "join_stale",
                   "join_replay"),
        )
        # aim at the LEADER (the only node that admits): every forged
        # frame reaches the admission check. Non-leaders get a share
        # too — they must ignore JOIN_REQUESTs silently, not crash.
        targets = []
        leader = c.leader_uname()
        for uname in sorted(c.nodes):
            nid = c.spec.node_by_unique_name(uname)
            if nid is not None:
                targets.append((nid.host, nid.port))
                if uname == leader:
                    targets.extend([(nid.host, nid.port)] * 3)
        if not targets:
            return {"forged_joins": 0}
        sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        sent = 0
        try:
            for i, frame in enumerate(frames):
                try:
                    sock.sendto(frame, targets[i % len(targets)])
                    sent += 1
                except OSError:
                    continue
        finally:
            sock.close()
        self.forged_joins_sent += sent
        return {"forged_joins": sent}

    async def _do_job(self, n: int) -> None:
        """Submit + await one stub job, tracking its terminal state.
        A job the (possibly new) coordinator lost across a failover is
        recorded as 'lost' and resubmitted once — that is the client
        contract wait_job documents. A job whose CLIENT node was the
        crash victim is untrackable from that client; it is marked and
        resubmitted from a live node."""
        for attempt in range(3):
            client = self.cluster.client()
            meta = {"model": STUB_MODEL, "n": n,
                    "client": client.node.me.unique_name, "outcome": None}
            job_id = None
            try:
                job_id = await client.jobs.submit_job(
                    STUB_MODEL, n, timeout=15.0, retries=5
                )
                self.jobs[job_id] = meta
                # generous: the sandbox host can stall the whole
                # process for tens of seconds; the job completes the
                # moment the loop thaws
                done = await client.jobs.wait_job(job_id, timeout=100.0)
                if int(done.get("total_queries", 0)) != n:
                    meta["outcome"] = "failed"
                    raise AssertionError(
                        f"job {job_id} completed {done} != {n} queries"
                    )
                meta["outcome"] = "done"
                return
            except Exception as e:
                if self._client_crashed(client):
                    # the CLIENT was a crash victim (its sends raise):
                    # submit never acked -> meta was never tracked;
                    # acked -> mark it so the sweep skips this id
                    meta["outcome"] = "client_crashed"
                    continue
                if (isinstance(e, RuntimeError) and "lost" in str(e)
                        and attempt < 2):
                    meta["outcome"] = "lost"
                    continue  # resubmit under a fresh id
                meta["outcome"] = "failed"
                raise
        raise RuntimeError("job never reached a terminal state on 3 clients")

    def _spawn_workload(self, coro: Awaitable, what: str) -> asyncio.Task:
        t = asyncio.create_task(coro, name=f"chaos-{what}")
        self._workload.append(t)
        return t

    # ---- recovery measurement ----

    def _measure(self, kind: str, cond: Callable[[], bool],
                 sink: List[float], hist, timeout: float = 30.0) -> None:
        loop = asyncio.get_running_loop()
        t0 = loop.time()

        async def poll():
            while loop.time() - t0 < timeout:
                if cond():
                    wall = loop.time() - t0
                    sink.append(wall)
                    hist.observe(wall)
                    return
                await asyncio.sleep(0.02)
            log.warning("chaos: %s recovery not observed in %.0fs",
                        kind, timeout)

        self._bg.append(asyncio.create_task(poll(), name=f"chaos-{kind}"))

    # ---- event execution ----

    async def _apply(self, ev: ChaosEvent) -> None:
        c = self.cluster
        record: Dict[str, Any] = ev.to_dict()
        if ev.kind == "crash":
            uname = c.resolve_target(ev.target)
            if uname is None or uname not in c.nodes:
                record["skipped"] = "no live target"
                self.executed.append(record)
                return
            was_leader = c.nodes[uname].node.is_leader
            mid = ev.arg("mid", ())
            if "put" in mid:
                self._put_counter += 1
                self._spawn_workload(
                    self._do_put(f"mid_crash_{self._put_counter}.bin", 1024),
                    "mid-crash-put",
                )
            if "job" in mid:
                self._spawn_workload(self._do_job(24), "mid-crash-job")
            if mid:
                # let the workload's datagrams actually reach the wire
                await asyncio.sleep(3 * c.spec.timing.ping_interval)
            await c.crash_node(uname)
            self._last_crashed.append(uname)
            record["resolved"] = uname
            record["was_leader"] = was_leader
            if was_leader:
                self._measure("failover", c.converged,
                              self.failover_recovery_s, _M_FAILOVER)
            self._measure("repair", c.replication_satisfied,
                          self.store_repair_s, _M_REPAIR)
        elif ev.kind == "restart":
            uname = (
                self._last_crashed.pop()
                if ev.target in (None, "last") and self._last_crashed
                else c.resolve_target(ev.target)
            )
            if uname is None or uname in c.nodes:
                record["skipped"] = "nothing to restart"
            else:
                await c.restart_node(uname)
                record["resolved"] = uname
                self._measure("repair", c.replication_satisfied,
                              self.store_repair_s, _M_REPAIR)
        elif ev.kind in ("partition", "partition_asym"):
            frac = float(ev.arg("fraction", 0.4))
            unames = sorted(c.nodes)
            k = max(1, min(len(unames) - 1, int(round(frac * len(unames)))))
            groups = [unames[:k], unames[k:]]
            if ev.kind == "partition":
                c.partition(groups)
            else:
                # groups[0] is the mute side: it hears the majority,
                # the majority never hears it
                c.partition_asym(groups)
                record["mute"] = groups[0]
            record["groups"] = groups
        elif ev.kind == "heal":
            c.heal()
            self._measure("repair", c.replication_satisfied,
                          self.store_repair_s, _M_REPAIR)
        elif ev.kind == "loss":
            c.set_loss(float(ev.arg("pct", 0.0)))
        elif ev.kind == "shape":
            c.set_shape(**{k: float(v) for k, v in ev.args})
        elif ev.kind == "store_fault":
            c.set_store_fault(**{k: float(v) for k, v in ev.args})
        elif ev.kind == "store_heal":
            c.set_store_fault()
            self._measure("repair", c.replication_satisfied,
                          self.store_repair_s, _M_REPAIR)
        elif ev.kind == "disk_fault":
            uname = c.resolve_target(ev.target or "worker")
            if uname is None or uname not in c.nodes:
                record["skipped"] = "no live target"
            else:
                c.set_disk_fault(uname, **{k: float(v) for k, v in ev.args})
                record["resolved"] = uname
        elif ev.kind == "disk_heal":
            c.set_disk_fault(None)
            self._measure("repair", c.replication_satisfied,
                          self.store_repair_s, _M_REPAIR)
        elif ev.kind == "disk_corrupt":
            name = str(ev.arg("name", ""))
            victim = c.corrupt_replica(name)
            if victim is None:
                record["skipped"] = f"no live replica holds {name!r}"
            else:
                record["resolved"] = victim
        elif ev.kind == "dns_crash":
            await c.crash_dns()
        elif ev.kind == "dns_restart":
            await c.restart_dns()
        elif ev.kind == "skew":
            uname = c.resolve_target(ev.target or "worker")
            if uname is None or uname not in c.nodes:
                record["skipped"] = "no live target"
            else:
                c.set_skew(uname, float(ev.arg("offset_s", 0.0)))
                record["resolved"] = uname
        elif ev.kind == "liar":
            uname = c.resolve_target(ev.target or "worker")
            if uname is None or uname not in c.nodes:
                record["skipped"] = "no live target"
            else:
                c.set_liar(uname, float(ev.arg("extra_s", 0.0)))
                record["resolved"] = uname
        elif ev.kind == "fuzz":
            record["injected"] = self._do_fuzz(int(ev.arg("n", 36)))
        elif ev.kind == "put":
            self._spawn_workload(
                self._do_put(str(ev.arg("name", "chaos.bin")),
                             int(ev.arg("size", 1024))),
                "put",
            )
        elif ev.kind == "get":
            self._spawn_workload(
                self._do_get(str(ev.arg("name", "chaos.bin")),
                             bool(ev.arg("scrub", True))),
                "get",
            )
        elif ev.kind == "job":
            self._spawn_workload(self._do_job(int(ev.arg("n", 16))), "job")
        elif ev.kind == "scale_out":
            names = []
            for _ in range(int(ev.arg("n", 1))):
                sn = await c.scale_out(group=ev.arg("group"))
                names.append(sn.node.me.unique_name)
            record["resolved"] = names
        elif ev.kind == "scale_in":
            uname = c.resolve_target(ev.target or "joiner")
            if uname is None or uname not in c.nodes:
                record["skipped"] = "no live target"
            else:
                record["resolved"] = uname
                record["graceful"] = await c.scale_in(uname)
                self._measure("repair", c.replication_satisfied,
                              self.store_repair_s, _M_REPAIR)
        elif ev.kind == "join_storm":
            record["injected"] = self._do_join_storm(int(ev.arg("n", 24)))
        self.executed.append(record)

    async def run(self) -> ChaosReport:
        t_start = asyncio.get_running_loop().time()
        # headroom scales with N: the bench churn run drives this
        # with a 64-node cluster whose full convergence legitimately
        # takes longer than the 5-node plans' (same rule as
        # control_plane_probe)
        await self.cluster.wait_for(
            self.cluster.converged,
            15.0 + 0.3 * len(self.cluster.spec.nodes),
            "initial convergence",
        )
        # seed the job inputs (the intake samples *.jpeg names from
        # the store) BEFORE any fault fires; they double as the
        # content-integrity probes of the final sweep
        for i in range(4):
            await self._do_put(f"chaos_img_{i}.jpeg", 512)
        train_errors: List[str] = []
        if self.plan.train:
            try:
                await self._arm_train()
            except Exception as e:
                log.exception("chaos: train arming failed")
                train_errors.append(f"train arming failed: {e!r}")
        loop = asyncio.get_running_loop()
        t0 = loop.time()
        for ev in self.plan.events:
            delay = t0 + ev.t - loop.time()
            if delay > 0:
                await asyncio.sleep(delay)
            try:
                await self._apply(ev)
            except Exception as e:
                log.exception("chaos: event %s failed", ev)
                self.executed.append(dict(ev.to_dict(), error=repr(e)))
        await asyncio.sleep(self.plan.settle_s)
        # workload must drain: a put or job still hanging here is a
        # recovery failure in its own right
        workload_errors: List[str] = []
        if self._workload:
            done, pending = await asyncio.wait(
                self._workload, timeout=120.0
            )
            for t in pending:
                t.cancel()
                workload_errors.append(f"workload {t.get_name()} hung")
            for t in done:
                if not t.cancelled() and t.exception() is not None:
                    workload_errors.append(
                        f"workload {t.get_name()}: {t.exception()!r}"
                    )
        # an armed training run must finish before the sweep: the
        # step-exact checks compare a COMPLETE ledger against the
        # final state, and a run still limping here means recovery
        # (re-dispatch, adoption) failed — a failure in its own right
        train_errors += await self._drain_train()
        # recovery monitors get a bounded drain too
        if self._bg:
            await asyncio.wait(self._bg, timeout=30.0)
            for t in self._bg:
                if not t.done():
                    t.cancel()
        report = await invariant_sweep(
            self.cluster, self.jobs, self.seed_files,
            fuzz_malformed_sent=self.fuzz_malformed_sent,
            malformed_baseline=self._malformed_baseline,
            forged_joins_sent=self.forged_joins_sent,
            join_reject_baseline=self._join_reject_baseline,
        )
        # an event that ERRORED (failed restart, crash that threw)
        # means the plan did not actually run as scheduled — the
        # verdict must say so, not report a green sweep over a
        # scenario that silently lost its headline fault. (Resolution
        # skips — e.g. 'nothing to restart' in a random plan — are
        # legitimate outcomes and stay informational.)
        event_errors = [
            f"event t={r['t']} {r['kind']} failed: {r['error']}"
            for r in self.executed if "error" in r
        ]
        report.failures = (
            workload_errors + train_errors + event_errors
            + report.failures
        )
        report.ok = not report.failures
        return ChaosReport(
            plan=self.plan,
            invariants=report,
            executed=self.executed,
            failover_recovery_s=self.failover_recovery_s,
            store_repair_s=self.store_repair_s,
            jobs=self.jobs,
            wall_s=asyncio.get_running_loop().time() - t_start,
        )


async def run_plan(
    plan: ChaosPlan,
    base_port: int,
    root: Optional[str] = None,
    timing: Timing = FAST_TIMING,
    services: str = "full",
) -> ChaosReport:
    """Bring up a LocalCluster, run the plan, tear down. The one
    entry point tests, the CLI verb, and the bench section share.
    ``services`` bounds the per-node stack (see LocalCluster) — plans
    whose workload is store-only (e.g. big-N churn) run "store" so a
    64-node sim doesn't pay 64 job-service stacks."""
    own_root = root is None
    root = root or os.path.join(
        tempfile.gettempdir(), f"dml_tpu_torch_chaos_{os.getpid()}_{base_port}"
    )
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root, exist_ok=True)
    cluster = LocalCluster(
        plan.n_nodes, root, base_port, seed=plan.seed, timing=timing,
        services=services, join_secret=plan.join_secret,
        autoscale=plan.autoscale,
        autoscale_policy=(
            CHAOS_AUTOSCALE_POLICY if plan.autoscale else None
        ),
        train=plan.train,
    )
    try:
        await cluster.start()
        return await ChaosRunner(cluster, plan).run()
    finally:
        await cluster.stop()
        if own_root:
            shutil.rmtree(root, ignore_errors=True)


def run_plan_sync(plan: ChaosPlan, base_port: int,
                  root: Optional[str] = None,
                  timing: Timing = FAST_TIMING,
                  services: str = "full") -> ChaosReport:
    return asyncio.run(
        run_plan(plan, base_port, root=root, timing=timing,
                 services=services)
    )


# ----------------------------------------------------------------------
# diurnal provisioning probe (the autoscaler's headline measurement)
# ----------------------------------------------------------------------


async def diurnal_probe(
    seed: int,
    base_port: int,
    root: Optional[str] = None,
    mode: str = "autoscaled",
    n_nodes: Optional[int] = None,
    duration_s: float = 52.0,
    base_qps: float = 3.0,
    peak_qps: float = 90.0,
    deadline_s: float = 3.0,
    per_file_s: float = 0.04,
    policy: Optional[AutoscalePolicy] = None,
    timing: Timing = FAST_TIMING,
) -> Dict[str, Any]:
    """One arm of the diurnal provisioning comparison: drive a seeded
    ramp–plateau–trough open-loop trace (``loadgen.diurnal_trace``)
    through a stub ingress cluster and score it on the two integrals
    an operator actually pays for — SLO-violation-minutes and
    chip-idle-minutes.

    ``mode="static"`` runs the mid-provisioned baseline: a fixed pool
    of 3 schedulable slots (5 nodes minus leader + standby), sized
    between the diurnal trough and peak the way a capacity plan
    without elasticity has to be. ``mode="autoscaled"`` starts at the
    controller's floor (2 slots from 4 nodes) with the closed loop
    armed: the ramp's burn/backlog pressure admits standby capacity
    through the authenticated join path (ceiling 4), and the trough
    retires idle slots by graceful LEAVE back to the floor. The
    autoscaled arm must beat static on BOTH integrals — more capacity
    than the baseline exactly while the trace needs it, less while it
    doesn't — with zero restarts and a green invariant sweep.

    Both arms share the trace seed, the SLO class (a ``deadline_s``
    interactive class), the slowed stub backend (``per_file_s`` —
    sized so the plateau genuinely saturates a 3-slot pool: at 40ms a
    file an 8-wide batch holds a slot 0.32s, ~25 q/s per slot), and
    the timing envelope; only the provisioning policy differs."""
    from ..ingress import loadgen
    from ..ingress.slo import SLOClass

    if mode not in ("static", "autoscaled"):
        raise ValueError(f"unknown diurnal mode {mode!r}")
    autoscaled = mode == "autoscaled"
    pol = policy or DIURNAL_AUTOSCALE_POLICY
    n = n_nodes if n_nodes is not None else (4 if autoscaled else 5)
    own_root = root is None
    root = root or os.path.join(
        tempfile.gettempdir(), f"dml_tpu_torch_diurnal_{os.getpid()}_{base_port}"
    )
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root, exist_ok=True)
    cluster = LocalCluster(
        n, root, base_port, seed=seed, timing=timing,
        with_ingress=True,
        ingress_classes={
            "interactive": SLOClass(
                "interactive", deadline_s=deadline_s,
                queue_limit=64, linger_s=0.0),
        },
        join_secret=f"diurnal-{seed}" if autoscaled else "",
        autoscale=autoscaled,
        autoscale_policy=pol if autoscaled else None,
        backend_per_file_s=per_file_s,
    )
    trace = loadgen.diurnal_trace(
        seed, duration_s=duration_s, base_qps=base_qps,
        peak_qps=peak_qps, model=STUB_MODEL,
        ramp_frac=0.2, plateau_frac=0.3,
    )
    out: Dict[str, Any] = {
        "mode": mode, "seed": seed, "n_nodes": n,
        "trace": {
            "duration_s": duration_s, "base_qps": base_qps,
            "peak_qps": peak_qps, "deadline_s": deadline_s,
            "arrivals": len(trace.arrivals),
        },
    }
    loop = asyncio.get_running_loop()
    idle_slot_s = 0.0
    pool_lo = pool_hi = None
    stop_sampling = asyncio.Event()

    async def sample_idle() -> None:
        """Integrate idle capacity: every tick, schedulable slots the
        CURRENT leader sees minus the slots holding in-flight/staged
        batches. The same accounting runs in both arms, so the
        comparison is apples-to-apples even though the stub's 'chip'
        is a coroutine."""
        nonlocal idle_slot_s, pool_lo, pool_hi
        dt = 0.25
        while not stop_sampling.is_set():
            u = cluster.leader_uname()
            sn = cluster.nodes.get(u) if u else None
            if sn is not None and sn.jobs is not None:
                slots = len(sn.jobs.worker_pool())
                busy = len(
                    set(sn.jobs.scheduler.in_progress)
                    | set(sn.jobs.scheduler.prefetch)
                )
                idle_slot_s += max(0, slots - busy) * dt
                pool_lo = slots if pool_lo is None else min(pool_lo, slots)
                pool_hi = slots if pool_hi is None else max(pool_hi, slots)
            try:
                await asyncio.wait_for(stop_sampling.wait(), dt)
            except asyncio.TimeoutError:
                pass

    try:
        await cluster.start()
        await cluster.wait_for(cluster.converged, 20.0,
                               "diurnal probe convergence")
        client = cluster.client()
        # a pool of distinct pre-put inputs, round-robined across
        # requests: the dispatch path dedups a batch to its UNIQUE
        # files, so same-input arrivals would collapse to one decode
        # and no open-loop rate could ever saturate the pool
        n_inputs = 64
        for k in range(n_inputs):
            await client.store.put_bytes(
                f"diurnal_{k:03d}.jpg", b"stub-bytes", timeout=20.0
            )
        seq = {"i": 0}

        async def submit_one(a):
            # drive through the CURRENT leader's front door: the
            # leader is never a scale-in victim (not a pool slot), so
            # the client seat can't be retired out from under the
            # open loop mid-trace
            u = cluster.leader_uname()
            sn = cluster.nodes.get(u) if u else None
            if sn is None:
                sn = cluster.client()
            seq["i"] += 1
            return await loadgen.drive_one(
                sn.ingress, a,
                store_name=f"diurnal_{seq['i'] % n_inputs:03d}.jpg",
                submit_timeout=8.0, wait_timeout=45.0,
            )

        sampler = asyncio.create_task(sample_idle(), name="diurnal-idle")
        outcomes, wall = await loadgen.run_open_loop(submit_one, trace)
        stop_sampling.set()
        await sampler
        summ = loadgen.summarize(outcomes, wall)
        out["outcomes"] = {
            "n": summ["n"], "completed": summ["completed"],
            "shed": summ["shed"],
            "shed_ratio": summ["shed_ratio"],
            "wall_s": round(wall, 2),
        }
        out["slo_violation_min"] = slo_violation_minutes(trace, outcomes)
        out["chip_idle_min"] = round(idle_slot_s / 60.0, 4)
        out["pool"] = {"min": pool_lo, "max": pool_hi}
        out["restarts"] = cluster._restart_counter
        if autoscaled:
            u = cluster.leader_uname()
            ctl = cluster.nodes[u].jobs.autoscale if u else None
            if ctl is not None:
                kinds: Dict[str, int] = {}
                for r in ctl.ledger.rows():
                    if r["state"] == "applied":
                        kinds[r["kind"]] = kinds.get(r["kind"], 0) + 1
                out["decisions_applied"] = kinds
                out["min_pool_seen"] = ctl.min_pool_seen
        sweep = await invariant_sweep(cluster, {}, {}, timeout=30.0)
        out["sweep_ok"] = sweep.ok
        if not sweep.ok:
            out["sweep_failures"] = sweep.failures[:4]
    finally:
        await cluster.stop()
        if own_root:
            shutil.rmtree(root, ignore_errors=True)
    return out


# ----------------------------------------------------------------------
# control-plane scale probe (ROADMAP item 5): how do gossip
# convergence, failure detection, election, metrics aggregation, and
# control-plane traffic behave at N ∈ {16, 64, 128}?
# ----------------------------------------------------------------------


async def control_plane_probe(
    n_nodes: int,
    base_port: int,
    root: Optional[str] = None,
    seed: int = 0,
    protocol: str = "delta",
    services: str = "core",
    timing: Timing = SCALE_TIMING,
    measure_s: float = 4.0,
    metrics_relays: Optional[int] = None,
    converge_timeout: Optional[float] = None,
) -> Dict[str, Any]:
    """One scale measurement cycle on an N-node in-process cluster
    running the given gossip ``protocol`` ("delta" product default |
    "full" reference baseline):

    1. bring-up → full convergence wall (every node sees every node
       ALIVE and one agreed leader);
    2. a steady-state traffic window → control-plane bytes/node/s and
       packets/node/s (per-transport accounting, so the shared
       in-process metrics registry can't blur per-node attribution);
    3. leader metrics aggregation: bounded-concurrency direct pull vs
       two-level relay fan-out — wall and leader ingress bytes each;
    4. failure detection: a non-leader crash → wall until EVERY live
       node stops seeing the victim ALIVE;
    5. election: leader crash → wall until the survivors reconverge
       on the new leader.

    Runs ``services="core"`` by default: membership-only nodes (one
    UDP socket + two coroutines each) keep a 128-node bring-up
    affordable; the store/jobs planes are scored by the churn run and
    the small-N sections. All Ns share the same timing envelope, so
    walls are comparable across N."""
    own_root = root is None
    root = root or os.path.join(
        tempfile.gettempdir(), f"dml_tpu_torch_scale_{os.getpid()}_{base_port}"
    )
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root, exist_ok=True)
    cluster = LocalCluster(
        n_nodes, root, base_port, seed=seed, timing=timing,
        services=services, gossip_protocol=protocol,
    )
    loop = asyncio.get_running_loop()
    out: Dict[str, Any] = {
        "n_nodes": n_nodes,
        "protocol": protocol,
        "services": services,
        "timing": {
            "ping_interval": timing.ping_interval,
            "cleanup_time": timing.cleanup_time,
        },
    }

    async def wait(cond: Callable[[], bool], timeout: float,
                   what: str, interval: float = 0.1) -> float:
        # coarser poll than LocalCluster.wait_for: converged() is
        # O(N^2) per call and a 128-node probe polling at 20 Hz would
        # measure its own polling
        t0 = loop.time()
        deadline = t0 + timeout
        while loop.time() < deadline:
            if cond():
                return loop.time() - t0
            await asyncio.sleep(interval)
        raise AssertionError(f"timed out waiting for {what}")

    try:
        t_up0 = loop.time()
        await cluster.start()
        out["bringup_s"] = round(loop.time() - t_up0, 2)
        conv_to = (
            converge_timeout if converge_timeout is not None
            else 30.0 + 0.3 * n_nodes
        )
        await wait(cluster.converged, conv_to, "full convergence")
        out["converge_s"] = round(loop.time() - t_up0, 2)

        # 2. steady-state traffic window
        def traffic() -> Tuple[int, int]:
            b = p = 0
            for sn in cluster.nodes.values():
                t = sn.node.transport
                b += t.bytes_sent
                p += t.packets_sent
            return b, p

        b0, p0 = traffic()
        await asyncio.sleep(measure_s)
        b1, p1 = traffic()
        out["bytes_per_node_s"] = round(
            (b1 - b0) / max(1, n_nodes) / measure_s, 1)
        out["packets_per_node_s"] = round(
            (p1 - p0) / max(1, n_nodes) / measure_s, 1)

        # 3. metrics aggregation at the leader, healthy cluster:
        #    direct — bounded-concurrency fan-out;
        #    relay  — two-level pre-merged aggregation.
        # Walls are min-of-3 reps: in a one-core sim the per-pull wall
        # rides event-loop jitter and the background ping bursts, and
        # a single sample is noise, not protocol.
        relays = metrics_relays
        if relays is None:
            relays = max(2, int(round((n_nodes - 1) ** 0.5)))
        leader_uname = cluster.leader_uname()
        leader = cluster.nodes[leader_uname].node if leader_uname else None
        if leader is not None and leader.transport is not None:
            # the leader hears background gossip (ring + epidemic
            # pings) the whole time — sample its ingress rate first
            # and net it out, or the direct-vs-relay ingress
            # comparison silently includes whatever PING/ACK traffic
            # happened to land inside each pull's wall
            bg0 = leader.transport.bytes_received
            await asyncio.sleep(1.0)
            bg_rate = leader.transport.bytes_received - bg0  # bytes/s
            for label, reps, kw in (
                ("direct", 3, {"relays": 0, "concurrency": 8}),
                ("relay", 3, {"relays": relays, "concurrency": 8}),
            ):
                wall = None
                in0 = leader.transport.bytes_received
                for rep in range(reps):
                    t0 = loop.time()
                    view = await leader.pull_cluster_metrics(
                        timeout=5.0, **kw
                    )
                    w = loop.time() - t0
                    wall = w if wall is None else min(wall, w)
                    if rep == 0:
                        ingress = max(
                            0,
                            leader.transport.bytes_received - in0
                            - int(bg_rate * w),
                        )
                covered = len(view["nodes"]) + len(
                    view.get("relay", {}).get("covered", [])
                )
                out[f"metrics_{label}"] = {
                    "wall_s": round(wall, 3),
                    "leader_ingress_bytes": ingress,
                    "nodes_covered": covered,
                    "merged_from": view["cluster"].get("merged_from"),
                    **(
                        {"fallbacks": view["relay"]["fallbacks"],
                         "relays": view["relay"]["relays"]}
                        if "relay" in view else {}
                    ),
                }

        # 4. failure detection: non-leader victim, everyone must see it
        victim = cluster.resolve_target("worker")
        if victim is not None:
            await cluster.crash_node(victim)
            t0 = loop.time()

            def victim_gone() -> bool:
                return all(
                    not sn.node.membership.is_alive(victim)
                    for sn in cluster.nodes.values()
                )

            try:
                await wait(
                    victim_gone, 30.0 + timing.cleanup_time,
                    "cluster-wide failure detection", interval=0.05,
                )
                out["detect_s"] = round(loop.time() - t0, 2)
            except AssertionError:
                out["detect_s"] = None

        # 5. election: kill the leader, survivors reconverge
        leader_uname = cluster.leader_uname()
        if leader_uname is not None:
            await cluster.crash_node(leader_uname)
            t0 = loop.time()
            try:
                await wait(
                    cluster.converged, 45.0 + timing.cleanup_time,
                    "post-kill reconvergence",
                )
                out["election_s"] = round(loop.time() - t0, 2)
                out["new_leader"] = cluster.leader_uname()
            except AssertionError:
                out["election_s"] = None

        # 6. straggler metrics: THE melt case the metrics rework
        # exists for — kill several peers, then pull against a frozen
        # peer list that still includes them (a console on a
        # slightly-stale view). Serial pays one full timeout PER dead
        # peer; bounded/relay fan-out overlaps them into ~one timeout.
        # Victims come from the TAIL of the sorted peer list so the
        # deterministic relay choice (the head) stays alive.
        leader_uname = cluster.leader_uname()
        leader = (
            cluster.nodes[leader_uname].node if leader_uname else None
        )
        if leader is not None and len(cluster.nodes) >= 10:
            peers = sorted(
                (
                    n for n in leader.membership.alive_nodes()
                    if n.unique_name != leader.me.unique_name
                ),
                key=lambda n: n.unique_name,
            )
            victims = [
                p.unique_name for p in peers[-4:]
                if p.unique_name in cluster.nodes
            ]
            for v in victims:
                await cluster.crash_node(v)
            straggler_timeout = 1.0
            strag: Dict[str, Any] = {
                "dead_peers": len(victims),
                "timeout_s": straggler_timeout,
            }
            for label, kw in (
                ("serial", {"relays": 0, "concurrency": 1}),
                ("direct", {"relays": 0, "concurrency": 8}),
                ("relay", {"relays": relays, "concurrency": 8}),
            ):
                t0 = loop.time()
                await leader.pull_cluster_metrics(
                    timeout=straggler_timeout, peers=peers, **kw
                )
                strag[f"{label}_wall_s"] = round(loop.time() - t0, 3)
            out["metrics_straggler"] = strag
        return out
    finally:
        await cluster.stop()
        if own_root:
            shutil.rmtree(root, ignore_errors=True)


def control_plane_probe_sync(n_nodes: int, base_port: int,
                             **kw: Any) -> Dict[str, Any]:
    return asyncio.run(control_plane_probe(n_nodes, base_port, **kw))

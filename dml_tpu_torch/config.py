"""Cluster specification, node identity, and timing configuration: the
port's copy of dml_tpu/config.py (plain Python).

Replaces the reference's hand-edited static tables (config.py:4-89,
nodes.py:1-35) with a declarative, serializable spec: no hardcoded
hostnames, no credential files (the reference reads SSH passwords from
password.txt, config.py:29-37 — our data plane is credential-free TCP),
and the ring topology is computed from the node list instead of written
out by hand (reference GLOBAL_RING_TOPOLOGY, config.py:67-89). A spec
file and the join/leave/reply MACs are the JAX package's, byte for
byte, so a port node and a JAX node read the same spec.
"""

from __future__ import annotations

import dataclasses
import hashlib
import hmac as _hmac
import json
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple


@dataclass(frozen=True, order=True)
class NodeId:
    """Immutable node identity (reference: nodes.py Node).

    Ordering is (host, port) lexicographic; election rank uses
    `rank` when provided so operators can pin coordinator preference
    (the reference hardcoded H1 leader / H2 standby; we elect by
    highest rank with (host, port) as tiebreak).
    """

    host: str
    port: int
    name: str = ""
    rank: int = 0

    @property
    def unique_name(self) -> str:
        return f"{self.host}:{self.port}"

    @property
    def addr(self) -> Tuple[str, int]:
        return (self.host, self.port)

    def __str__(self) -> str:  # pragma: no cover - repr sugar
        return self.name or self.unique_name


@dataclass(frozen=True)
class Timing:
    """Failure-detector timing constants (reference config.py:4-10).

    Reference deployed values: ping every 12 s, ACK timeout 10 s,
    suspect cleanup 30 s, M=3 ring successors. Defaults here are the
    README's tuned example (README.md:68-78) scaled for tests; real
    deployments load their own.
    """

    ping_interval: float = 2.5
    ack_timeout: float = 2.0
    cleanup_time: float = 10.0
    missed_acks_to_suspect: int = 3
    leader_rpc_timeout: float = 20.0  # reference worker.py:1123-1135


@dataclass(frozen=True)
class StoreConfig:
    """Replicated-store knobs (reference leader.py:60, file_service.py:8-11)."""

    replication_factor: int = 4
    max_versions: int = 5
    root: str = "~/.dml_tpu/store"
    download_dir: str = "~/.dml_tpu/downloads"
    cleanup_on_startup: bool = False

    def store_path(self) -> str:
        return os.path.expanduser(self.root)

    def download_path(self) -> str:
        return os.path.expanduser(self.download_dir)


@dataclass(frozen=True)
class MeshSpec:
    """Axis sizes of a device mesh: `dp` shards the batch, `tp` the
    weights' output channels, `sp` the sequence, `pp` pipeline stages,
    `ep` experts. A size of -1 fills with the devices (ranks) left; only
    one axis may be -1 (`parallel.mesh` resolves it over the world)."""

    dp: int = -1
    tp: int = 1
    sp: int = 1
    pp: int = 1  # pipeline stages (parallel/pipeline.py)
    ep: int = 1  # expert shards (parallel/moe.py)

    def resolve(self, n_devices: int) -> Dict[str, int]:
        sizes = {
            "dp": self.dp, "tp": self.tp, "sp": self.sp,
            "pp": self.pp, "ep": self.ep,
        }
        fixed = 1
        free = None
        for ax, s in sizes.items():
            if s == -1:
                if free is not None:
                    raise ValueError("only one mesh axis may be -1")
                free = ax
            else:
                fixed *= s
        if free is not None:
            if n_devices % fixed != 0:
                raise ValueError(
                    f"{n_devices} devices not divisible by fixed axes {fixed}"
                )
            sizes[free] = n_devices // fixed
        elif fixed != n_devices:
            raise ValueError(f"mesh {sizes} != {n_devices} devices")
        return sizes


@dataclass(frozen=True)
class WorkerGroupSpec:
    """A tensor-parallel serving group: nodes that pool their chips
    into ONE dp×tp worker (Kumar et al.'s pod-slice serving unit; the
    reference has no notion of this — every VM is its own whole-model
    replica, models.py:26,51).

    `members` are node names (e.g. "H4") or unique names; they must
    exist in the node table and belong to at most one group. `mesh` is
    the group's device layout over the pooled chips: `dp` shards
    batches, `tp` shards weight storage. The group serves as a single
    scheduler-visible worker (the deterministic first member by
    unique name is its primary) only while EVERY member is alive and
    schedulable; losing any member degrades it back to the surviving
    single-chip engines (jobs/groups.py).

    `lm_models` names LM serving models (register_lm names) this
    group's engine serves with weights RESIDENT tp-sharded in HBM
    (inference/lm_sharded.py). Like the member list it is static
    config: the coordinator reads it to decide whether an LM round
    may keep the group collapsed to one weighted slot — a group that
    does not declare the round's LM model falls back to single-chip
    slots for that round, because collapsing
    would model throughput the primary's engine cannot deliver.

    `roles` optionally splits the group into PREFILL and DECODE
    serving roles for disaggregated LM serving (member name ->
    "prefill" | "decode"). Prefill-role members run the chunked
    prompt prefill and hand the serialized KV-cache slab to the
    decode-role primary over the TCP store data plane; decode streams
    tokens through the normal job completion path. Empty = no
    disaggregation (every chip does both). Role assignment living
    HERE (not in a runtime protocol) means degradation/reform and
    failover derive the same view from spec + liveness, exactly like
    membership itself.

    A `mesh` with ``pp > 1`` serves the group's `lm_models` PIPELINE-
    parallel (inference/lm_sharded.py PipelinedLMBackend): each
    member holds only ``n_layers/pp`` of the layer stack, opening
    models DEEPER than one member's HBM. `hbm_bytes` (optional, 0 =
    unchecked) declares a member's HBM budget in bytes; the LM group
    wiring refuses to start a layout whose per-member weight bytes
    (`pp_hbm_report`) exceed it — a model bigger than the budget must
    be served through a pp axis, never silently OOM-ed at first
    batch."""

    name: str
    members: Tuple[str, ...] = ()
    mesh: MeshSpec = field(default_factory=lambda: MeshSpec(dp=-1, tp=1))
    lm_models: Tuple[str, ...] = ()
    roles: Dict[str, str] = field(default_factory=dict)
    hbm_bytes: int = 0


# ----------------------------------------------------------------------
# speculative-decoding knobs (inference/lm_server.py, lm_backend.py)
# ----------------------------------------------------------------------

#: default draft lookahead: tokens proposed per slot per verify round.
#: The verify forward streams the target weights ONCE for k+1 tokens,
#: so round cost grows sub-linearly in k while expected commit length
#: is ~(1-p^(k+1))/(1-p) at per-token acceptance p — k=4 captures most
#: of the win at p≈0.8 without paying long rejected tails.
SPEC_K_DEFAULT = 4

#: default break-even acceptance floor for automatic draft disable
#: (`lm_spec["spec_min_accept"]`): below ~1/3 acceptance a verify
#: round's expected commit (~rate*k + 1) no longer beats the chunk
#: scan's per-token cost plus the draft's own forward, so the server
#: reverts to plain decode (lm_specdec_disabled_total{reason=
#: "acceptance"}) instead of taxing every dispatch.
SPEC_MIN_ACCEPT_DEFAULT = 0.35

#: proposals measured before the acceptance gate may fire (and the
#: sliding-window grain thereafter) — one cold request's unlucky
#: prefix must not kill speculation for the server's lifetime.
SPEC_MIN_SAMPLES_DEFAULT = 64


def draft_lm_spec(
    lm_spec: Dict[str, Any], **overrides: Any
) -> Dict[str, Any]:
    """Derive a DRAFT-model spec from a target `lm_spec`: same family
    (vocab/dtype/heads — the draft must emit the target's token space),
    roughly quarter the compute (half the layers, half d_model/d_ff),
    deterministic weights from ``seed + 1`` so draft and target never
    silently share a tree. Serving-only keys (max_slots, chunk,
    spec_*, kv_cache_mb, weights ...) are dropped — the draft is a
    bare model spec for `lm_spec_parts`. ``overrides`` pin any field
    (`lm_spec["spec_draft"]` passes operator overrides through here).

    d_model halves but is re-aligned UP to a multiple of n_heads so
    head_dim stays integral for any target geometry."""
    heads = int(lm_spec.get("n_heads", 8))
    d_model = int(lm_spec["d_model"])
    d_half = max(heads, ((d_model // 2 + heads - 1) // heads) * heads)
    d_ff = int(lm_spec.get("d_ff", 4 * d_model))
    spec: Dict[str, Any] = {
        "name": f"{lm_spec.get('name', 'LM')}-draft",
        "vocab_size": int(lm_spec["vocab_size"]),
        "d_model": d_half,
        "n_heads": heads,
        "n_layers": max(1, int(lm_spec.get("n_layers", 2)) // 2),
        "d_ff": max(d_half, d_ff // 2),
        "dtype": lm_spec.get("dtype", "bfloat16"),
        "seed": int(lm_spec.get("seed", 0)) + 1,
    }
    if lm_spec.get("n_kv_heads") is not None:
        spec["n_kv_heads"] = int(lm_spec["n_kv_heads"])
    spec.update(overrides)
    return spec


# ----------------------------------------------------------------------
# authenticated-membership MACs (cluster/node.py join/leave protocol)
# ----------------------------------------------------------------------

#: bound on the retained universe-change log. Gossip catch-up and
#: rejoin deltas can only reach back this many changes; a node further
#: behind falls back to the `full` table form (JOIN_ACK / INTRODUCE_ACK
#: paths), which is authenticated as a whole instead of per entry.
UNIVERSE_LOG_CAP = 256


def _mac(secret: str, *parts: Any) -> str:
    msg = "\x1f".join(str(p) for p in parts).encode("utf-8")
    return _hmac.new(secret.encode("utf-8"), msg, hashlib.sha256).hexdigest()


def join_mac(secret: str, node: Dict[str, Any], nonce: str, epoch: int,
             group: str = "") -> str:
    """HMAC a JOIN_REQUEST: binds the joiner's identity + addr (host,
    port, name, rank), a fresh nonce (replay armor), the universe
    epoch the joiner believes current (stale-capture armor), AND the
    worker group it asks to be absorbed into ("" = plain slot) to the
    shared cluster secret. Forged, replayed, and stale-epoch joins
    all fail one of the bindings — and an on-path rewrite of the
    group field (a universe-log-recorded topology change) invalidates
    the MAC rather than re-shaping a mesh."""
    return _mac(
        secret, "join", node.get("host"), node.get("port"),
        node.get("name"), node.get("rank"), nonce, int(epoch),
        group or "",
    )


def leave_mac(secret: str, unique_name: str, nonce: str, epoch: int) -> str:
    """HMAC a LEAVE: proves the departing node (and not a spoofed
    sender evicting someone else) is asking to be retired."""
    return _mac(secret, "leave", unique_name, nonce, int(epoch))


def reply_mac(secret: str, nonce: str, epoch: int,
              universe: Optional[Dict[str, Any]] = None) -> str:
    """HMAC a JOIN_ACK (echoing the request nonce): the joiner only
    trusts epoch hints and universe tables that carry this, so a
    forged ACK can neither steer the joiner's epoch claim nor feed it
    a phantom node table."""
    blob = json.dumps(universe or {}, sort_keys=True,
                      separators=(",", ":"), default=str)
    return _mac(secret, "join-ack", nonce, int(epoch),
                hashlib.sha256(blob.encode("utf-8")).hexdigest())


def universe_entry_mac(secret: str, entry: Dict[str, Any]) -> str:
    """HMAC one universe-log entry (minted by the admitting leader,
    verified by every node that applies the entry from gossip):
    deterministic over the entry content, so independently-derived
    copies of the same change are identical."""
    node = entry.get("node") or {}
    return _mac(
        secret, "universe", int(entry.get("e", -1)), entry.get("op"),
        node.get("host"), node.get("port"), node.get("name"),
        node.get("rank"), entry.get("group") or "",
    )


@dataclass
class ClusterSpec:
    """The whole-cluster config: node table + ring + timing + store.

    The reference's equivalent is the hand-maintained H1..H10 table and
    GLOBAL_RING_TOPOLOGY dict (config.py:54-89), duplicated into
    `introduce process/config.py`. Here there is one spec, serializable
    to JSON, shared by every role including the introducer.

    The node table is the cluster's **universe**: byzantine hardening
    drops datagrams from senders outside it. With ``join_secret`` set,
    the universe becomes DYNAMIC — a now-versioned table
    (``universe_epoch``) that the leader may extend at runtime through
    the authenticated JOIN_REQUEST/LEAVE protocol (cluster/node.py):
    every change is an HMAC-stamped log entry that rides the gossip
    piggyback, so peers converge on the same table without trusting
    unauthenticated datagrams. With ``join_secret`` empty the table is
    static, exactly the pre-elastic behavior.
    """

    nodes: List[NodeId] = field(default_factory=list)
    introducer: Optional[NodeId] = None
    #: tensor-parallel serving groups (jobs/groups.py); empty = every
    #: node serves alone (the reference's one-replica-per-VM shape)
    worker_groups: List[WorkerGroupSpec] = field(default_factory=list)
    ring_k: int = 3  # number of ping successors (reference M=3, config.py:4)
    timing: Timing = field(default_factory=Timing)
    store: StoreConfig = field(default_factory=StoreConfig)
    mesh: MeshSpec = field(default_factory=MeshSpec)
    testing: bool = False
    packet_drop_pct: float = 0.0  # loss-injection seam (reference protocol.py:10)
    # ---- gossip piggyback protocol (cluster/membership.py) ----
    # "delta": every PING/ACK carries a BOUNDED member subset — the
    # sender's own entry, the `gossip_delta_k` entries with the
    # highest recent-change priority (fewest piggybacks since their
    # status last changed, newest timestamp first), and a seeded
    # random tail of `gossip_delta_tail` others — with the FULL table
    # exchanged only at join (INTRODUCE_ACK), at the dead-peer
    # anti-entropy probe, and every `gossip_full_every`-th piggyback.
    # "full": the reference full-table piggyback (O(N) entries per
    # datagram — the measured baseline the scale bench scores
    # against). At small N (≤ 1 + k + tail members) delta mode emits
    # the full table anyway, so the protocols are bit-identical there.
    gossip_protocol: str = "delta"
    gossip_delta_k: int = 8
    gossip_delta_tail: int = 4
    gossip_full_every: int = 20
    # >0: the coordinator snapshots scheduler state into the store
    # every N seconds while jobs are in flight (full-restart survival
    # without operator-driven checkpoint-jobs); 0 disables
    jobs_checkpoint_interval: float = 0.0
    # ---- elastic membership (cluster/node.py join/leave protocol) ----
    # shared cluster secret authorizing runtime membership changes.
    # Empty (default) = joins disabled, the table is static and the
    # out-of-universe drops are final. Non-empty = nodes join through
    # JOIN_REQUEST (HMAC over identity+addr+nonce+epoch) and retire
    # through LEAVE; each admitted change bumps `universe_epoch` and
    # appends an HMAC-stamped log entry that gossip carries to peers.
    join_secret: str = ""
    #: version of the node table; bumps on every admitted join/leave
    universe_epoch: int = 0
    # ---- elastic cluster training (jobs/train.py) ----
    # fair-share weight of the `train` SLO class: below `batch` (1.0)
    # and far below `interactive` (3.0), so a TrainJob soaks idle
    # slots without queueing interactive work behind it
    train_class_weight: float = 0.5

    # ---- lookups (reference Config.get_node*, config.py:116-144) ----
    # Lookup tables and the ring order are recomputed by `_reindex`
    # whenever the universe changes (at construction, and on every
    # admitted join/leave).

    def __post_init__(self):
        #: HMAC-stamped change log: the catch-up payload gossip and
        #: JOIN_ACK/INTRODUCE_ACK ship to peers behind on the epoch
        self._universe_log: List[Dict[str, Any]] = []
        self._reindex()

    def _reindex(self) -> None:
        self._by_unique = {n.unique_name: n for n in self.nodes}
        self._ring = sorted(self.nodes, key=lambda n: (n.rank, n.host, n.port))
        # resolve group members (names or unique names) to unique
        # names once; membership must be known and disjoint — a chip
        # lent to two groups would double-count capacity
        self._group_members: Dict[str, Tuple[str, ...]] = {}
        self._group_by_member: Dict[str, WorkerGroupSpec] = {}
        self._group_roles: Dict[str, Dict[str, str]] = {}
        for g in self.worker_groups:
            resolved = []
            by_alias: Dict[str, str] = {}  # member-as-written -> unique
            for m in g.members:
                nid = self._by_unique.get(m) or self.node_by_name(m)
                if nid is None:
                    raise ValueError(
                        f"worker group {g.name!r}: unknown member {m!r}"
                    )
                resolved.append(nid.unique_name)
                by_alias[m] = nid.unique_name
            if len(set(resolved)) != len(resolved):
                raise ValueError(
                    f"worker group {g.name!r}: duplicate members"
                )
            for u in resolved:
                if u in self._group_by_member:
                    raise ValueError(
                        f"node {u} belongs to two worker groups "
                        f"({self._group_by_member[u].name!r}, {g.name!r})"
                    )
                self._group_by_member[u] = g
            self._group_members[g.name] = tuple(sorted(resolved))
            # disaggregation roles resolve to unique names too; a role
            # for a non-member (or an unknown role word) is a config
            # error, caught HERE like an unknown member — not at the
            # first mid-job prefill handoff
            roles: Dict[str, str] = {}
            for m, role in (g.roles or {}).items():
                u = by_alias.get(m)
                if u is None:
                    nid = self._by_unique.get(m) or self.node_by_name(m)
                    u = nid.unique_name if nid else None
                if u is None or u not in resolved:
                    raise ValueError(
                        f"worker group {g.name!r}: role for non-member "
                        f"{m!r}"
                    )
                if role not in ("prefill", "decode"):
                    raise ValueError(
                        f"worker group {g.name!r}: unknown role "
                        f"{role!r} for {m!r} (prefill|decode)"
                    )
                roles[u] = role
            self._group_roles[g.name] = roles

    def group_members_unique(self, name: str) -> Tuple[str, ...]:
        """A group's members as sorted unique names (the first is the
        group's deterministic primary)."""
        return self._group_members.get(name, ())

    def group_of_unique(self, unique_name: str) -> Optional[WorkerGroupSpec]:
        return self._group_by_member.get(unique_name)

    def group_roles_unique(self, name: str) -> Dict[str, str]:
        """A group's disaggregation roles keyed by unique name (empty
        when the group is not role-split)."""
        return dict(self._group_roles.get(name, {}))

    def node_by_unique_name(self, unique_name: str) -> Optional[NodeId]:
        return self._by_unique.get(unique_name)

    def ring(self) -> List[NodeId]:
        """The canonical ring order — the single definition consumed by
        both `ring_successors` and membership ping-target repair."""
        return self._ring

    def node_by_name(self, name: str) -> Optional[NodeId]:
        for n in self.nodes:
            if n.name == name:
                return n
        return None

    def ring_successors(self, node: NodeId) -> List[NodeId]:
        """The k ring successors this node pings.

        Reference hand-writes this per node (config.py:67-89); we
        compute it: each node pings the next k in `ring()` order.
        """
        ring = self.ring()
        if node not in ring:
            return []
        i = ring.index(node)
        k = min(self.ring_k, len(ring) - 1)
        return [ring[(i + j) % len(ring)] for j in range(1, k + 1)]

    def election_winner(self, alive: List[NodeId]) -> Optional[NodeId]:
        """Real bully winner: highest (rank, host, port) among the
        alive set. The reference *intended* this but hardcoded H2
        (election.py:24-32)."""
        if not alive:
            return None
        return max(alive, key=lambda n: (n.rank, n.host, n.port))

    # ---- dynamic universe (authenticated runtime join/leave) ----

    @staticmethod
    def _node_dict(node: NodeId) -> Dict[str, Any]:
        return {"host": node.host, "port": node.port,
                "name": node.name, "rank": node.rank}

    @staticmethod
    def node_from_dict(d: Any) -> Optional[NodeId]:
        """A NodeId from wire-supplied fields, or None when the
        payload is garbled/byzantine (wrong types, missing keys)."""
        if not isinstance(d, dict):
            return None
        try:
            host = d["host"]
            port = int(d["port"])
            name = str(d.get("name", "") or "")
            rank = int(d.get("rank", 0) or 0)
        except (KeyError, TypeError, ValueError):
            return None
        if not isinstance(host, str) or not host or not (0 < port < 65536):
            return None
        return NodeId(host, port, name=name, rank=rank)

    def _append_universe_entry(self, entry: Dict[str, Any]) -> None:
        self._universe_log.append(entry)
        if len(self._universe_log) > UNIVERSE_LOG_CAP:
            del self._universe_log[: len(self._universe_log)
                                   - UNIVERSE_LOG_CAP]

    def add_node(
        self,
        node: NodeId,
        group: Optional[str] = None,
        local: bool = False,
    ) -> bool:
        """Admit `node` into the universe (leader-side of an
        authenticated join). Already-known nodes are a no-op rejoin
        (False — no epoch bump). `group` absorbs the joiner into that
        worker group's member list (under-formed groups regain
        capacity through the reform ladder, jobs/groups.py).

        ``local=True`` records the node WITHOUT minting a change
        entry or bumping the epoch — a joiner pre-seeding its own
        table ("I know myself; the cluster assigns the epoch") and
        operator bookkeeping use this form."""
        if node.unique_name in self._by_unique:
            return False
        if group is not None:
            gi = next(
                (i for i, g in enumerate(self.worker_groups)
                 if g.name == group), None)
            if gi is None:
                raise ValueError(f"unknown worker group {group!r}")
            self.worker_groups[gi] = dataclasses.replace(
                self.worker_groups[gi],
                members=self.worker_groups[gi].members
                + (node.unique_name,),
            )
        self.nodes.append(node)
        if not local:
            self.universe_epoch += 1
            entry: Dict[str, Any] = {
                "e": self.universe_epoch, "op": "join",
                "node": self._node_dict(node),
            }
            if group:
                entry["group"] = group
            if self.join_secret:
                entry["mac"] = universe_entry_mac(self.join_secret, entry)
            self._append_universe_entry(entry)
        self._reindex()
        return True

    def _strip_from_groups(self, unique_name: str) -> None:
        def resolves_to(member: str) -> bool:
            nid = self._by_unique.get(member) or self.node_by_name(member)
            return nid is not None and nid.unique_name == unique_name

        for i, g in enumerate(self.worker_groups):
            if unique_name not in self._group_members.get(g.name, ()):
                continue
            keep = tuple(m for m in g.members if not resolves_to(m))
            roles = {m: r for m, r in (g.roles or {}).items()
                     if not resolves_to(m)}
            self.worker_groups[i] = dataclasses.replace(
                g, members=keep, roles=roles)

    def remove_node(self, unique_name: str, local: bool = False) -> bool:
        """Retire `unique_name` from the universe (graceful LEAVE, or
        applying a peer's leave entry). Strips the node from any
        worker group it lent chips to — the group's remaining members
        ARE its new full strength, which is how a scale-in re-shapes
        group topology instead of reading as a permanent degradation."""
        node = self._by_unique.get(unique_name)
        if node is None:
            return False
        self._strip_from_groups(unique_name)
        self.nodes = [n for n in self.nodes
                      if n.unique_name != unique_name]
        if not local:
            self.universe_epoch += 1
            entry: Dict[str, Any] = {
                "e": self.universe_epoch, "op": "leave",
                "node": self._node_dict(node),
            }
            if self.join_secret:
                entry["mac"] = universe_entry_mac(self.join_secret, entry)
            self._append_universe_entry(entry)
        self._reindex()
        return True

    def universe_delta(self, since: int, max_entries: int = 64) -> Dict[str, Any]:
        """The catch-up payload for a peer at epoch `since`: a
        contiguous WINDOW of up to `max_entries` HMAC-stamped change
        entries starting right past the peer's epoch. A peer far
        behind catches up incrementally — each exchange advances it
        `max_entries` epochs and the next exchange ships the next
        window — so the bounded gossip piggyback converges any gap
        the retained log covers. Only when the log no longer reaches
        back to ``since + 1`` (> UNIVERSE_LOG_CAP changes behind)
        does this fall to the FULL table form (nodes + worker groups
        — accepted only on authenticated reply paths, where the
        enclosing reply MAC covers it)."""
        since = max(int(since), 0)
        if since >= self.universe_epoch:
            return {"e": self.universe_epoch, "log": []}
        entries = [e for e in self._universe_log if e["e"] > since]
        if entries and entries[0]["e"] == since + 1:
            # the log is contiguous by construction (epochs increment
            # by one per entry; the cap trims only the FRONT), so any
            # prefix of this slice is applicable as-is
            return {"e": self.universe_epoch,
                    "log": list(entries[:max(1, max_entries)])}
        return {
            "e": self.universe_epoch,
            "full": {
                "nodes": [self._node_dict(n) for n in self.nodes],
                "worker_groups": [
                    {"name": g.name, "members": list(g.members)}
                    for g in self.worker_groups
                ],
            },
        }

    def _apply_entry(self, ent: Dict[str, Any]) -> None:
        node = self.node_from_dict(ent.get("node"))
        if node is None:
            return
        if ent.get("op") == "join":
            group = ent.get("group")
            if group is not None and not any(
                g.name == group for g in self.worker_groups
            ):
                group = None  # unknown group here: plain slot
            if node.unique_name not in self._by_unique:
                try:
                    self.add_node(node, group=group, local=True)
                except ValueError:
                    self.add_node(node, local=True)
            elif group is not None and node.unique_name not in \
                    self.group_members_unique(group):
                # already in the table (a joiner pre-seeds itself
                # locally) but the admission absorbed it into a
                # group: the membership must still land
                gi = next(i for i, g in enumerate(self.worker_groups)
                          if g.name == group)
                self.worker_groups[gi] = dataclasses.replace(
                    self.worker_groups[gi],
                    members=self.worker_groups[gi].members
                    + (node.unique_name,),
                )
                self._reindex()
        elif ent.get("op") == "leave":
            self.remove_node(node.unique_name, local=True)

    def apply_universe(
        self, delta: Any, verified: bool = False
    ) -> bool:
        """Fold a peer's universe catch-up into this spec. Log entries
        verify their own HMAC stamp (unless ``verified`` — the caller
        already authenticated the enclosing reply); a bad stamp or a
        gap stops the application (we stay behind and catch up from a
        healthier peer). The `full` form is accepted only when
        ``verified``. Returns True when the table or epoch changed."""
        if not isinstance(delta, dict):
            return False
        changed = False
        full = delta.get("full")
        if isinstance(full, dict):
            if not verified:
                return False  # full tables only ride authenticated paths
            try:
                e = int(delta.get("e", 0))
            except (TypeError, ValueError):
                return False
            if e <= self.universe_epoch:
                return False
            nodes = [
                n for n in (
                    self.node_from_dict(d)
                    for d in full.get("nodes", [])
                    if isinstance(d, dict)
                ) if n is not None
            ]
            if not nodes:
                return False
            members_by_group = {
                g.get("name"): list(g.get("members", []))
                for g in full.get("worker_groups", [])
                if isinstance(g, dict)
            }
            known = {n.unique_name for n in nodes}
            self.nodes = nodes
            self.worker_groups = [
                dataclasses.replace(
                    g,
                    members=tuple(
                        m for m in members_by_group.get(
                            g.name, list(g.members))
                        if m in known or m in {n.name for n in nodes}
                    ),
                    roles={m: r for m, r in (g.roles or {}).items()
                           if m in known},
                )
                for g in self.worker_groups
            ]
            self.universe_epoch = e
            self._universe_log = []  # history predating the snapshot
            self._reindex()
            return True
        log_entries = delta.get("log")
        if not isinstance(log_entries, list):
            return False
        for ent in sorted(
            (e for e in log_entries if isinstance(e, dict)),
            key=lambda e: e.get("e", 0)
            if isinstance(e.get("e"), int) else 0,
        ):
            e = ent.get("e")
            if not isinstance(e, int) or e <= self.universe_epoch:
                continue
            if e != self.universe_epoch + 1:
                break  # gap: stay behind, catch up from a longer log
            if self.join_secret and not verified:
                want = universe_entry_mac(self.join_secret, ent)
                got = ent.get("mac")
                if not isinstance(got, str) or not _hmac.compare_digest(
                    got, want
                ):
                    break  # unstamped/forged entry: refuse the tail too
            self._apply_entry(ent)
            self.universe_epoch = e
            self._append_universe_entry(dict(ent))
            changed = True
        return changed

    # ---- serialization ----

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, text: str) -> "ClusterSpec":
        raw = json.loads(text)
        raw["nodes"] = [NodeId(**n) for n in raw.get("nodes", [])]
        if raw.get("introducer"):
            raw["introducer"] = NodeId(**raw["introducer"])
        if raw.get("timing"):
            raw["timing"] = Timing(**raw["timing"])
        if raw.get("store"):
            raw["store"] = StoreConfig(**raw["store"])
        if raw.get("mesh"):
            raw["mesh"] = MeshSpec(**raw["mesh"])
        raw["worker_groups"] = [
            WorkerGroupSpec(
                name=g["name"],
                members=tuple(g.get("members", ())),
                mesh=MeshSpec(**g["mesh"]) if g.get("mesh") else MeshSpec(),
                lm_models=tuple(g.get("lm_models", ())),
                roles=dict(g.get("roles", {}) or {}),
                hbm_bytes=int(g.get("hbm_bytes", 0) or 0),
            )
            for g in raw.get("worker_groups", [])
        ]
        return cls(**raw)

    @classmethod
    def from_file(cls, path: str) -> "ClusterSpec":
        with open(path) as f:
            return cls.from_json(f.read())

    @classmethod
    def localhost(
        cls,
        n: int,
        base_port: int = 8001,
        introducer_port: int = 8888,
        **kw,
    ) -> "ClusterSpec":
        """A local multi-process cluster on 127.0.0.1 ports — the
        pattern the reference used for testing (config.py:41-50,
        README.md:16-25), formalized as a first-class constructor."""
        nodes = [
            NodeId("127.0.0.1", base_port + i, name=f"H{i + 1}", rank=n - i)
            for i in range(n)
        ]
        intro = NodeId("127.0.0.1", introducer_port, name="DNS")
        return cls(nodes=nodes, introducer=intro, **kw)

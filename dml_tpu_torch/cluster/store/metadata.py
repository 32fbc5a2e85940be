"""Leader-side store metadata: the global file table and placement.

Replaces the reference's Leader (leader.py:1-181): global file dict
mapping node -> {file -> [versions]}, deterministic sha256-based
placement onto `replication_factor` distinct live nodes, per-request
replica status tracking, wildcard search, and re-replication planning
after failures. Pure logic (no I/O) so placement and repair are
unit-testable; the coordinator role drives it.
"""

from __future__ import annotations

import fnmatch
import hashlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple


@dataclass
class RequestStatus:
    """In-flight PUT/DELETE tracking (reference leader.py:113-145)."""

    op: str  # "put" | "delete" | "replicate"
    file: str
    requester: str  # unique_name of the client
    replicas: Dict[str, str] = field(default_factory=dict)  # node -> pending|ok|fail
    #: nodes that already failed this request (write fault, dead mid-
    #: pull): reassignment must not hand the slot straight back
    tried: Set[str] = field(default_factory=set)
    version: int = 0
    client_rid: str = ""  # the requester's rid, echoed in the final reply
    # fan-out resend support (the control plane is at-most-once UDP):
    # the per-replica message payload, re-sent to still-pending
    # replicas until they ACK
    fanout_payload: Dict = field(default_factory=dict)
    last_sent: float = 0.0

    def set_status(self, node: str, status: str) -> None:
        if node in self.replicas:
            self.replicas[node] = status

    @property
    def completed(self) -> bool:
        # an empty replica map is a failed request, not a vacuous success
        # (every replica died mid-flight)
        return bool(self.replicas) and all(s == "ok" for s in self.replicas.values())

    @property
    def failed(self) -> bool:
        return any(s == "fail" for s in self.replicas.values())

    @property
    def pending_nodes(self) -> List[str]:
        return [n for n, s in self.replicas.items() if s == "pending"]


class StoreMetadata:
    def __init__(self, replication_factor: int = 4):
        self.replication_factor = replication_factor
        # node unique_name -> {file -> [versions]} (reference leader.py:19)
        self.files: Dict[str, Dict[str, List[int]]] = {}
        # request id -> status (reference status_dict, leader.py:25-27)
        self.requests: Dict[str, RequestStatus] = {}
        self._req_counter = 0
        # highest version ever assigned per file, including in-flight
        # PUTs — so concurrent PUTs of one file can't collide on the
        # same version number
        self._version_high: Dict[str, int] = {}

    # ---- node inventories ----

    def set_node_inventory(self, node: str, inventory: Dict[str, List[int]]) -> None:
        """Merge a node's reported local files (reference ALL_LOCAL_FILES
        handler, worker.py:598-614; COORDINATE_ACK rebuild,
        worker.py:639-649)."""
        self.files[node] = {f: sorted(int(v) for v in vs) for f, vs in inventory.items()}

    def drop_node(self, node: str) -> Dict[str, List[int]]:
        """A node died: forget its inventory, return what it held."""
        return self.files.pop(node, {})

    def record_replica(self, node: str, file: str, version: int) -> None:
        vs = self.files.setdefault(node, {}).setdefault(file, [])
        if version not in vs:
            vs.append(version)
            vs.sort()

    def remove_file(self, file: str) -> None:
        for inv in self.files.values():
            inv.pop(file, None)
        self._version_high.pop(file, None)

    def assign_version(self, file: str) -> int:
        """Next version for a PUT: strictly above both the replicated
        high-water mark and any in-flight assignment."""
        v = max(self.latest_version(file), self._version_high.get(file, 0)) + 1
        self._version_high[file] = v
        return v

    # ---- queries ----

    def replicas_of(self, file: str) -> List[str]:
        return sorted(n for n, inv in self.files.items() if file in inv)

    def latest_version(self, file: str) -> int:
        best = 0
        for inv in self.files.values():
            vs = inv.get(file)
            if vs:
                best = max(best, vs[-1])
        return best

    def all_files(self) -> List[str]:
        out: Set[str] = set()
        for inv in self.files.values():
            out.update(inv)
        return sorted(out)

    def matching(self, pattern: str) -> List[str]:
        """Wildcard ls (reference get_all_matching_files,
        leader.py:104-111)."""
        return sorted(f for f in self.all_files() if fnmatch.fnmatch(f, pattern))

    # ---- placement (reference find_nodes_to_put_file, leader.py:45-70) ----

    def place(self, file: str, live_nodes: List[str]) -> List[str]:
        """Choose replica nodes for `file`.

        Existing file -> its current live replica set topped up to
        `replication_factor`. New file -> deterministic probe from
        sha256(file) over the sorted live-node list — same intent as
        the reference's sha256+random probing but reproducible (no
        `random.choice`, which the reference misuses on possibly-empty
        lists, worker.py:1264-1265).
        """
        live = sorted(set(live_nodes))
        if not live:
            return []
        chosen = [n for n in self.replicas_of(file) if n in live]
        k = min(self.replication_factor, len(live))
        h = int.from_bytes(hashlib.sha256(file.encode()).digest()[:8], "big")
        i = h % len(live)
        while len(chosen) < k:
            cand = live[i % len(live)]
            if cand not in chosen:
                chosen.append(cand)
            i += 1
        return chosen[:k]

    # ---- request tracking ----

    def new_request(
        self, op: str, file: str, requester: str, replicas: List[str], version: int = 0
    ) -> str:
        self._req_counter += 1
        rid = f"{op}-{self._req_counter}"
        self.requests[rid] = RequestStatus(
            op=op,
            file=file,
            requester=requester,
            replicas={n: "pending" for n in replicas},
            version=version,
        )
        return rid

    def get_request(self, rid: str) -> Optional[RequestStatus]:
        return self.requests.get(rid)

    def finish_request(self, rid: str) -> None:
        self.requests.pop(rid, None)

    def requests_involving(self, node: str) -> List[Tuple[str, RequestStatus]]:
        """In-flight requests with a pending replica on `node` — used
        for failure-time repair (reference
        replace_files_downloading_by_node, worker.py:1247-1277)."""
        return [
            (rid, st)
            for rid, st in self.requests.items()
            if st.replicas.get(node) == "pending"
        ]

    # ---- re-replication planning (reference find_files_for_replication,
    #      leader.py:147-181) ----

    def replication_plan(
        self, live_nodes: List[str]
    ) -> List[Tuple[str, str, List[str]]]:
        """For every under-replicated file: (file, source_node,
        [target_nodes]). Deterministic placement; callers fan out
        REPLICATE_FILE to each target."""
        live = sorted(set(live_nodes))
        plan: List[Tuple[str, str, List[str]]] = []
        for file in self.all_files():
            holders = [n for n in self.replicas_of(file) if n in live]
            if not holders:
                continue  # data lost; nothing to copy from
            want = min(self.replication_factor, len(live))
            if len(holders) >= want:
                continue
            targets = [n for n in self.place(file, live) if n not in holders]
            targets = targets[: want - len(holders)]
            if targets:
                plan.append((file, holders[0], targets))
        return plan

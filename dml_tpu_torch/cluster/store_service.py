"""Replicated-store service: SDFS verbs over the control plane.

Replaces the reference's store request flows (worker.py:113-174,
651-883, 1201-1354, 1461-1570) — client verbs, leader fan-out and ACK
aggregation, replica-side executors, failure-time repair, and
re-replication — wired into the Node runtime's handler registry.

Flow shapes preserved from the reference (§3.3):
- PUT: client -> leader PUT_REQUEST; leader places `replication_factor`
  replicas (sha256 probe), fans DOWNLOAD_FILE to each; replicas pull
  the bytes from the *client* and ACK the leader; when all ACK the
  leader answers the client. The data plane is the credential-free TCP
  DataPlane (the reference pulls over scp with passwords from
  password.txt).
- GET: client -> leader GET_FILE_REQUEST -> replica list; client pulls
  from any live replica (reference get_file_locally, worker.py:1323).
- DELETE: leader fans DELETE_FILE, aggregates ACKs.
- re-replication: after failures the leader computes a repair plan and
  sends REPLICATE_FILE to new holders, which pull every version from a
  surviving replica (reference leader.py:147-181, worker.py:1308-1321).

Differences (intent over accident, SURVEY §7):
- the leader assigns the version number so replicas can't skew
  (the reference lets each replica pick its own next version)
- request/response correlation by rid futures, not single-slot events
- the standby's file table stays warm via ALL_LOCAL_FILES_RELAY, and
  COORDINATE_ACK reconciliation rebuilds it authoritatively on failover

Failover idempotency: resolved PUT tokens and completed deletes are
relayed to the hot standby (STORE_IDEMPOTENCY_RELAY), so a client
retry that crosses a leader failover re-fetches the recorded outcome
instead of minting a duplicate version / reporting "file not found"
for a delete that committed just before the failover. The relay is a
single best-effort datagram: losing it merely re-opens the benign
one-duplicate-version window for that one request.
"""

from __future__ import annotations

import asyncio
import logging
import os
import time
import uuid
import zlib
from typing import Any, Dict, List, Optional, Tuple

from ..config import ClusterSpec, NodeId, StoreConfig
from ..observability import METRICS
from .node import Node
from .store.data_plane import DataPlane
from .store.local_store import LocalStore
from .store.metadata import StoreMetadata
from .util import BoundedDict, leader_retry, reap_task
from .wire import Message, MsgType

log = logging.getLogger(__name__)

# Replicated-store client verbs + replica-side repair, as registry
# metrics (the store_* rows of the METRICS_PULL cluster view). Client
# histograms are END-TO-END walls: metadata RPC + data-plane transfer
# + replication fan-out, as the caller experiences them.
_M_PUTS = METRICS.counter(
    "store_puts_total", "client PUT verbs completed on this node")
_M_GETS = METRICS.counter(
    "store_gets_total", "client GET verbs completed on this node")
_M_DELETES = METRICS.counter(
    "store_deletes_total", "client DELETE verbs completed on this node")
_M_PUT_T = METRICS.histogram(
    "store_put_seconds", "client PUT wall (replicated upload end-to-end)")
_M_GET_T = METRICS.histogram(
    "store_get_seconds", "client GET wall (metadata RPC + replica fetch)")
_M_REPL = METRICS.counter(
    "store_replications_total", "repair pulls completed on this replica")
_M_REPL_FAIL = METRICS.counter(
    "store_replication_failures_total", "repair pulls that failed here")
_M_REPL_T = METRICS.histogram(
    "store_replication_seconds",
    "one repair pull (every version of one file from a survivor)")
# replica re-report accounting: the O(100)-node fan-in story — steady
# state sends small deltas (or nothing), full tables only at the
# periodic anti-entropy / after a leader change
_M_REPORT = METRICS.counter(
    "store_report_delta_total",
    "inventory re-reports sent to the leader, by kind (delta|full)")
_M_REPORT_ENTRIES = METRICS.counter(
    "store_report_delta_entries_total",
    "inventory entries carried by re-reports, by kind (delta|full)")
_M_REPORT_SKIP = METRICS.counter(
    "store_report_delta_skipped_total",
    "re-report ticks that sent nothing (inventory unchanged)")

#: every Nth re-report is a FULL table (anti-entropy): deltas assume
#: the leader still holds our last report, and a leader that silently
#: lost it (partition cleanup, table pressure) must re-learn within a
#: bounded number of report periods
REPORT_FULL_EVERY = 5
#: re-report period in resend-loop ticks; each node's phase within the
#: period is jittered by its identity so O(100) replicas don't
#: synchronize their fan-in at the leader
REPORT_EVERY_TICKS = 20

# the TCP data plane listens at udp_port + this offset on each node
DATA_PORT_OFFSET = 10_000


def data_addr(node: NodeId) -> Tuple[str, int]:
    return (node.host, node.port + DATA_PORT_OFFSET)


class StoreService:
    """Attach SDFS behavior to a Node. One instance per node; it acts
    as replica always, as metadata leader only while node.is_leader."""

    def __init__(self, node: Node, cfg: Optional[StoreConfig] = None, root: Optional[str] = None):
        self.node = node
        self.cfg = cfg or node.spec.store
        store_root = root or os.path.join(self.cfg.store_path(), node.me.unique_name.replace(":", "_"))
        self.store = LocalStore(
            store_root,
            max_versions=self.cfg.max_versions,
            cleanup_on_startup=self.cfg.cleanup_on_startup,
        )
        self.data_plane = DataPlane(self.store, host=node.me.host, port=data_addr(node.me)[1])
        self.metadata = StoreMetadata(self.cfg.replication_factor)
        self._register()
        node.local_inventory = self.store.inventory
        node.on_became_leader_cbs.append(self._on_became_leader)
        node.on_coordinate_ack_cbs.append(self._on_coordinate_ack)
        node.on_node_failed_cbs.append(self._on_node_failed)
        node.on_replication_needed_cbs.append(self._on_replication_needed)
        # loss tolerance over the at-most-once UDP control plane:
        # PUT idempotency tokens (client retries can't double-version)
        # and a leader-side resend tick for un-ACKed fan-outs
        # token -> in-flight req_id, or ("done", ok, reply) once resolved
        self._put_tokens: BoundedDict = BoundedDict(1000)
        # files whose delete completed recently: a retried DELETE whose
        # success reply was dropped must converge to success, not
        # "file not found"
        self._recent_deletes: BoundedDict = BoundedDict(200)
        self._resend_task: Optional[asyncio.Task] = None
        self.resend_after = max(1.0, 4 * node.spec.timing.ping_interval)
        # (file, target) -> ask time for outstanding REPLICATE_FILEs
        # (sweeps must not duplicate in-flight transfers)
        self._repairs_inflight: Dict[Tuple[str, str], float] = {}
        # replica re-report state: the last inventory we reported (and
        # to whom), so steady-state ticks send DELTAS — or nothing —
        # instead of the full table; identity-derived phase jitter
        # desynchronizes the cluster-wide fan-in
        self._report_phase = (
            zlib.crc32(node.me.unique_name.encode()) % REPORT_EVERY_TICKS
        )
        self._last_report: Optional[Dict[str, List[int]]] = None
        self._last_report_leader: Optional[str] = None
        self._reports_since_full = 0
        # a NEW leader's table is rebuilt from COORDINATE_ACKs (single
        # unacked datagrams) — our next report must be a full one, not
        # a delta against state the new leader never had
        node.on_new_leader_cbs.append(self._on_new_leader_force_full)

    async def start(self) -> None:
        await self.data_plane.start()
        self._resend_task = asyncio.create_task(
            self._resend_loop(), name=f"{self._me}-store-resend"
        )

    async def stop(self) -> None:
        await reap_task(self._resend_task, self._me, "resend loop")
        self._resend_task = None
        await self.data_plane.stop()

    async def _resend_loop(self) -> None:
        """Re-send fan-out messages to replicas that haven't ACKed
        (covers a dropped DOWNLOAD_FILE/DELETE_FILE or a dropped ACK;
        replica handlers are idempotent so re-delivery is safe).

        Non-leader side: periodically re-report the local inventory.
        Without this, the leader's global table learns a node's files
        ONLY from join-time ALL_LOCAL_FILES and election
        COORDINATE_ACKs — all single unacked datagrams — so a node
        resurrected after a partition (or whose election ACK was
        dropped) can hold bytes the leader never finds again: GETs
        report "file not found" and repair has no source. The chaos
        soak exposed exactly this as a permanent metadata hole."""
        interval = max(self.node.spec.timing.ping_interval, 0.05)
        tick = 0
        while True:
            await asyncio.sleep(interval)
            tick += 1
            if not self.node.is_leader:
                leader = self.node.leader_unique
                if (
                    (tick + self._report_phase) % REPORT_EVERY_TICKS == 0
                    and self.node.joined and leader
                ):
                    self._send_inventory_report(leader)
                continue
            if tick % 10 == 0:
                # periodic under-replication sweep: joins/deaths whose
                # event-time repair raced membership convergence heal
                # here (plan is cheap: one metadata scan, idempotent)
                try:
                    self._on_replication_needed([])
                except Exception:
                    log.exception("%s: replication sweep failed", self._me)
            now = time.monotonic()
            try:
                for req_id, st in list(self.metadata.requests.items()):
                    if not st.fanout_payload or now - st.last_sent <= self.resend_after:
                        continue
                    st.last_sent = now
                    mtype = (
                        MsgType.DOWNLOAD_FILE if st.op == "put" else MsgType.DELETE_FILE
                    )
                    for r in st.pending_nodes:
                        if self.node.membership.is_alive(r):
                            self.node.send_unique(r, mtype, st.fanout_payload)
            except Exception:
                log.exception("%s: store resend tick failed", self._me)

    def _on_new_leader_force_full(self, leader: str) -> None:
        self._last_report = None

    @staticmethod
    def _chunk_inventory(
        inv: Dict[str, List[int]]
    ) -> List[Dict[str, List[int]]]:
        """Split an inventory into datagram-sized chunks."""
        chunk: Dict[str, List[int]] = {}
        chunks = [chunk]
        budget = 0
        for f, vs in inv.items():
            cost = len(f) + 12 * len(vs) + 8  # rough JSON bytes
            if chunk and budget + cost > 40_000:
                chunk = {}
                chunks.append(chunk)
                budget = 0
            chunk[f] = vs
            budget += cost
        return chunks

    def _send_inventory_report(self, leader: str) -> None:
        """Report the local inventory, chunked to fit the datagram cap
        — a big store must not lose the metadata-hole protection the
        periodic re-report exists for.

        Steady state sends DELTAS: only entries that changed since the
        last report (plus explicit removals), or nothing at all when
        the inventory is unchanged — at O(100) nodes the synchronized
        full-table fan-in was the leader's single hottest ingress.
        Every ``REPORT_FULL_EVERY``-th report — and the first one to a
        NEW leader — is a full table (anti-entropy): deltas assume the
        leader still holds our previous report, and one that silently
        lost it must re-learn within a bounded number of periods.
        Full-report chunks carry ``partial`` so the leader MERGES them
        (an authoritative overwrite per chunk would erase the other
        chunks' entries); delta chunks are merges by construction."""
        inv = {f: sorted(vs) for f, vs in self.store.inventory().items()}
        full = (
            self._last_report is None
            or leader != self._last_report_leader
            or self._reports_since_full >= REPORT_FULL_EVERY - 1
        )
        if not full:
            last = self._last_report or {}
            adds = {f: vs for f, vs in inv.items() if last.get(f) != vs}
            removed = sorted(f for f in last if f not in inv)
            if not adds and not removed:
                self._reports_since_full += 1
                _M_REPORT_SKIP.inc()
                return
            ok = True
            for i, ch in enumerate(self._chunk_inventory(adds)):
                payload: Dict[str, Any] = {"files": ch, "delta": True}
                if i == 0 and removed:
                    payload["removed"] = removed
                try:
                    self.node.send_unique(
                        leader, MsgType.ALL_LOCAL_FILES, payload
                    )
                except ValueError:
                    ok = False
            if not ok:
                # an unsendable delta chunk means the leader's view of
                # us may now be stale in a way later deltas can't fix:
                # force the next report to be a full table
                self._last_report = None
                log.warning(
                    "%s: inventory delta exceeds the datagram cap; "
                    "forcing a full re-report", self._me,
                )
                return
            self._last_report = inv
            self._reports_since_full += 1
            _M_REPORT.inc(1, kind="delta")
            _M_REPORT_ENTRIES.inc(len(adds) + len(removed), kind="delta")
            return
        chunks = self._chunk_inventory(inv)
        partial = len(chunks) > 1
        sent_all = True
        if partial:
            # partial chunks MERGE at the leader (add-only), so a
            # removal whose delta datagram was lost would otherwise
            # never be repaired for an inventory too big for one
            # frame: a leading datagram carries the COMPLETE name
            # list (names alone are ~20 bytes each — thousands fit)
            # so the leader can prune entries we no longer hold
            try:
                self.node.send_unique(
                    leader, MsgType.ALL_LOCAL_FILES,
                    {"files": {}, "partial": True,
                     "all_names": sorted(inv)},
                )
            except ValueError:
                # absurd name count: anti-entropy degrades to
                # add-only for this report (logged, not fatal)
                log.warning(
                    "%s: inventory name list exceeds the datagram "
                    "cap; full report is add-only", self._me,
                )
        for ch in chunks:
            try:
                self.node.send_unique(
                    leader, MsgType.ALL_LOCAL_FILES,
                    {"files": ch, "partial": partial} if partial
                    else {"files": ch},
                )
            except ValueError:  # a single entry beyond the frame cap
                sent_all = False
                log.warning(
                    "%s: inventory chunk exceeds the datagram cap; "
                    "re-report incomplete", self._me,
                )
        # deltas may only build on a full report that actually went
        # out whole (best-effort UDP loss is covered by the periodic
        # full anti-entropy; a locally-failed send is not) — and the
        # counters/anti-entropy clock only advance for a full report
        # that actually left whole, or the fan-in accounting would
        # record deliveries the leader never got
        self._last_report = inv if sent_all else None
        self._last_report_leader = leader
        if sent_all:
            self._reports_since_full = 0
            _M_REPORT.inc(1, kind="full")
            _M_REPORT_ENTRIES.inc(len(inv), kind="full")

    # ------------------------------------------------------------------
    # helpers
    # ------------------------------------------------------------------

    @property
    def _me(self) -> str:
        return self.node.me.unique_name

    def _live_node_names(self) -> List[str]:
        return [n.unique_name for n in self.node.membership.alive_nodes()]

    def standby_node(self) -> Optional[NodeId]:
        """The hot standby (delegates to Node.standby_node — one
        definition of the would-be election winner)."""
        return self.node.standby_node()

    def _relay_to_standby(self, mtype: MsgType, data: Dict[str, Any]) -> None:
        sb = self.standby_node()
        if sb is not None:
            self.node.send(sb, mtype, data)

    # ------------------------------------------------------------------
    # client verbs (reference CLI file commands, worker.py:1810-1958)
    # ------------------------------------------------------------------

    async def _leader_retry(
        self, mtype: MsgType, data: Dict[str, Any], timeout: float, retries: int = 3
    ) -> Dict[str, Any]:
        return await leader_retry(self.node, mtype, data, timeout, retries)

    async def put(self, local_path: str, sdfs_name: str, timeout: float = 60.0) -> Dict[str, Any]:
        """`put <local> <sdfs>` — upload with `replication_factor`-way
        replication (§3.3). Retried with an idempotency token: a
        duplicate PUT_REQUEST joins the in-flight request (or re-fetches
        the completed reply) instead of minting a second version."""
        from ..observability import span

        local_path = os.path.abspath(os.path.expanduser(local_path))
        if not os.path.isfile(local_path):
            raise FileNotFoundError(local_path)
        token = self.data_plane.expose(local_path)
        t0 = time.monotonic()
        t0_wall = time.time()
        try:
            with span("store.put"):
                reply = await self._leader_retry(
                    MsgType.PUT_REQUEST,
                    {
                        "file": sdfs_name,
                        "token": token,
                        "data_addr": list(data_addr(self.node.me)),
                    },
                    timeout=timeout,
                )
        finally:
            self.data_plane.unexpose(token)
            self._trace_store_span("store_put", sdfs_name, t0_wall)
        if not reply.get("ok"):
            raise RuntimeError(f"put {sdfs_name} failed: {reply.get('error')}")
        _M_PUTS.inc()
        _M_PUT_T.observe(time.monotonic() - t0)
        return reply

    async def get(
        self,
        sdfs_name: str,
        local_path: str,
        version: Optional[int] = None,
        timeout: float = 60.0,
    ) -> int:
        """`get <sdfs> <local>` — download one version (latest default)
        from any live replica (reference get_file_locally,
        worker.py:1323-1354). Returns the version fetched."""
        from ..observability import span

        t0 = time.monotonic()
        t0_wall = time.time()
        try:
            with span("store.get"):
                got = await self._get_impl(
                    sdfs_name, local_path, version, timeout
                )
        finally:
            self._trace_store_span("store_get", sdfs_name, t0_wall)
        _M_GETS.inc()
        _M_GET_T.observe(time.monotonic() - t0)
        return got

    def _trace_store_span(
        self, name: str, sdfs_name: str, t0_wall: float
    ) -> None:
        """Replicated-store detail span under the calling request's
        propagated trace (dml_tpu/tracing.py CURRENT_CTXS): recorded
        once per operation under the FIRST sampled context — store ops
        are batch-level, and N copies of the same interval would only
        inflate the span budget, not the information."""
        from ..tracing import TRACER, current_ctxs

        ctxs = current_ctxs()
        if not ctxs:
            return
        kw = dict(
            ctx=ctxs[0], node=self.node.me.unique_name, t0=t0_wall,
            labels={"file": sdfs_name, "shared": len(ctxs)},
        )
        # literal names per branch: dmllint's drift-span-names rule
        # checks start_span call sites against the SPAN_NAMES registry
        if name == "store_put":
            TRACER.start_span("store_put", **kw).end(time.time())
        else:
            TRACER.start_span("store_get", **kw).end(time.time())

    async def _get_impl(
        self,
        sdfs_name: str,
        local_path: str,
        version: Optional[int],
        timeout: float,
    ) -> int:
        reply = await self._leader_retry(
            MsgType.GET_FILE_REQUEST, {"file": sdfs_name}, timeout=timeout
        )
        if not reply.get("ok"):
            raise FileNotFoundError(f"{sdfs_name}: {reply.get('error')}")
        # the ACK echoes which file it answers for — validate it
        # (drift-wire-payloads flagged the echo as dead bytes: unread,
        # a mis-correlated or byzantine reply would fetch the wrong
        # file's replica set without anyone noticing)
        echo = reply.get("file")
        if echo is not None and echo != sdfs_name:
            raise RuntimeError(
                f"GET {sdfs_name}: leader answered for {echo!r} — "
                "mis-correlated reply dropped"
            )
        want = version if version is not None else int(reply["version"])
        last_err: Optional[Exception] = None
        for uname in reply.get("replicas", []):
            node = self.node.spec.node_by_unique_name(uname)
            if node is None:
                continue
            try:
                data, got = await self.data_plane.fetch_from_store(
                    data_addr(node), sdfs_name, want
                )
                local_path = os.path.abspath(os.path.expanduser(local_path))
                os.makedirs(os.path.dirname(local_path) or ".", exist_ok=True)
                with open(local_path, "wb") as f:
                    f.write(data)
                return got
            except Exception as e:  # try the next replica
                last_err = e
        raise FileNotFoundError(f"{sdfs_name}: no replica served it ({last_err})")

    async def put_bytes(
        self, sdfs_name: str, data: bytes, timeout: float = 60.0
    ) -> Dict[str, Any]:
        """PUT an in-memory blob: spill to a unique temp file under the
        download dir, upload, clean up. The one canonical home for the
        tmp-file + put + unlink pattern (weights publishing, scheduler
        checkpoints)."""
        tmp = os.path.join(
            self.cfg.download_path(), f".putbytes_{uuid.uuid4().hex}"
        )
        os.makedirs(os.path.dirname(tmp), exist_ok=True)
        with open(tmp, "wb") as f:
            f.write(data)
        try:
            return await self.put(tmp, sdfs_name, timeout=timeout)
        finally:
            try:
                os.unlink(tmp)
            except OSError:
                pass

    async def get_bytes(
        self,
        sdfs_name: str,
        version: Optional[int] = None,
        timeout: float = 60.0,
    ) -> bytes:
        """GET a file's contents into memory (inverse of put_bytes)."""
        dest = os.path.join(
            self.cfg.download_path(), f".getbytes_{uuid.uuid4().hex}"
        )
        os.makedirs(os.path.dirname(dest), exist_ok=True)
        await self.get(sdfs_name, dest, version=version, timeout=timeout)
        try:
            with open(dest, "rb") as f:
                return f.read()
        finally:
            try:
                os.unlink(dest)
            except OSError:
                pass

    async def get_versions(
        self, sdfs_name: str, count: int, local_path: str, timeout: float = 60.0
    ) -> List[int]:
        """`get-versions <sdfs> <n> <local>` — latest n versions,
        concatenated with version markers (reference worker.py:1833-1880
        writes them into one output file)."""
        reply = await self._leader_retry(
            MsgType.GET_FILE_REQUEST, {"file": sdfs_name}, timeout=timeout
        )
        if not reply.get("ok"):
            raise FileNotFoundError(f"{sdfs_name}: {reply.get('error')}")
        versions = sorted(int(v) for v in reply.get("versions", []))[-count:]
        replicas = reply.get("replicas", [])
        local_path = os.path.abspath(os.path.expanduser(local_path))
        os.makedirs(os.path.dirname(local_path) or ".", exist_ok=True)
        got: List[int] = []
        with open(local_path, "wb") as f:
            for v in versions:
                for uname in replicas:
                    node = self.node.spec.node_by_unique_name(uname)
                    if node is None:
                        continue
                    try:
                        data, _ = await self.data_plane.fetch_from_store(
                            data_addr(node), sdfs_name, v
                        )
                        f.write(f"---- version {v} ----\n".encode())
                        f.write(data)
                        f.write(b"\n")
                        got.append(v)
                        break
                    except Exception:
                        continue
        return got

    async def delete(self, sdfs_name: str, timeout: float = 60.0) -> Dict[str, Any]:
        reply = await self._leader_retry(
            MsgType.DELETE_FILE_REQUEST, {"file": sdfs_name}, timeout=timeout
        )
        if not reply.get("ok"):
            raise RuntimeError(f"delete {sdfs_name} failed: {reply.get('error')}")
        _M_DELETES.inc()
        return reply

    async def ls(self, sdfs_name: str) -> List[str]:
        """`ls <sdfs>` — replica nodes currently holding the file."""
        reply = await self._leader_retry(
            MsgType.LIST_FILE_REQUEST, {"file": sdfs_name}, timeout=15.0
        )
        # ok gates the read (drift-wire-payloads: the flag was shipped
        # but never checked, so a garbled rid-resolved reply was
        # indistinguishable from "no replicas")
        if not reply.get("ok"):
            raise RuntimeError(f"ls {sdfs_name} failed: {reply.get('error')}")
        return reply.get("replicas", [])

    async def ls_all(self, pattern: str = "*") -> Dict[str, List[int]]:
        """`ls-all <pattern>` — wildcard search over the global table
        (reference get_all_matching_files, leader.py:104-111)."""
        reply = await self._leader_retry(
            MsgType.GET_ALL_MATCHING_FILES, {"pattern": pattern}, timeout=15.0
        )
        if not reply.get("ok"):
            # callers treat a failed listing as an exception, never as
            # an empty store (the staged-weights mirror prune depends
            # on that distinction)
            raise RuntimeError(f"ls-all {pattern} failed: {reply.get('error')}")
        return {f: [int(v) for v in vs] for f, vs in reply.get("files", {}).items()}

    def local_files(self) -> Dict[str, List[int]]:
        """`store` — files replicated on this node (reference CLI)."""
        return self.store.inventory()

    async def files_per_node(self) -> Dict[str, Dict[str, List[int]]]:
        """`files-per-node` — the leader's whole global table, node ->
        {file: versions} (reference CLI option 6, worker.py:1711-1714,
        which prints the leader's global_file_dict)."""
        reply = await self._leader_retry(
            MsgType.FILES_PER_NODE_REQUEST, {}, timeout=15.0
        )
        if not reply.get("ok"):
            raise RuntimeError(f"files-per-node failed: {reply.get('error')}")
        return {
            node: {f: [int(v) for v in vs] for f, vs in inv.items()}
            for node, inv in reply.get("nodes", {}).items()
        }

    async def get_all(
        self, pattern: str, local_dir: str, timeout: float = 60.0
    ) -> Dict[str, int]:
        """`get-all <pattern> <dir>` — download the latest version of
        every matching file into `local_dir` (reference
        download_all_files, worker.py:1496-1511, CLI worker.py:1939-1954).
        Returns {file: version fetched}."""
        local_dir = os.path.abspath(os.path.expanduser(local_dir))
        os.makedirs(local_dir, exist_ok=True)
        out: Dict[str, int] = {}
        for f in sorted(await self.ls_all(pattern)):
            out[f] = await self.get(
                f, os.path.join(local_dir, f), timeout=timeout
            )
        return out

    # ------------------------------------------------------------------
    # handler registration
    # ------------------------------------------------------------------

    def _register(self) -> None:
        n = self.node
        # leader side
        n.register(MsgType.PUT_REQUEST, self._h_put_request)
        n.register(MsgType.GET_FILE_REQUEST, self._h_get_file_request)
        n.register(MsgType.DELETE_FILE_REQUEST, self._h_delete_file_request)
        n.register(MsgType.LIST_FILE_REQUEST, self._h_list_file_request)
        n.register(MsgType.GET_ALL_MATCHING_FILES, self._h_matching_request)
        n.register(MsgType.FILES_PER_NODE_REQUEST, self._h_files_per_node)
        n.register(MsgType.DOWNLOAD_FILE_SUCCESS, self._h_download_result)
        n.register(MsgType.DOWNLOAD_FILE_FAIL, self._h_download_result)
        n.register(MsgType.DELETE_FILE_ACK, self._h_delete_result)
        n.register(MsgType.DELETE_FILE_NAK, self._h_delete_result)
        n.register(MsgType.REPLICATE_FILE_SUCCESS, self._h_replicate_result)
        n.register(MsgType.REPLICATE_FILE_FAIL, self._h_replicate_result)
        n.register(MsgType.ALL_LOCAL_FILES, self._h_all_local_files)
        # standby side
        n.register(MsgType.ALL_LOCAL_FILES_RELAY, self._h_all_local_files_relay)
        n.register(MsgType.STORE_IDEMPOTENCY_RELAY, self._h_idempotency_relay)
        # replica side
        n.register(MsgType.DOWNLOAD_FILE, self._h_download_file)
        n.register(MsgType.DELETE_FILE, self._h_delete_file)
        n.register(MsgType.REPLICATE_FILE, self._h_replicate_file)

    # ------------------------------------------------------------------
    # leader-side handlers
    # ------------------------------------------------------------------

    def _on_became_leader(self) -> None:
        """Seed the global table with our own inventory (reference
        worker.py:577-588 seeds from local files + temporary dict)."""
        self.metadata.set_node_inventory(self._me, self.store.inventory())

    def _on_coordinate_ack(self, sender: str, files: Dict[str, Any]) -> None:
        """Failover reconciliation: every node reports its inventory to
        the new leader (reference worker.py:639-649)."""
        self.metadata.set_node_inventory(
            sender, {f: [int(v) for v in vs] for f, vs in files.items()}
        )

    async def _h_all_local_files(self, msg: Message, addr) -> None:
        """A joining node (or a replica's periodic re-report) reported
        its files (reference worker.py:598-614); merge and keep the
        standby's copy warm.

        Reports are snapshots riding unordered UDP: one taken before a
        DELETE committed can arrive after it. Recording such a file
        would resurrect it (and the repair sweep would re-replicate it
        cluster-wide), so recently-deleted names are filtered out and
        the stale holder is told to drop its bytes instead. A no-op
        report (inventory already matches the table) skips the standby
        relay and the repair sweep — the steady-state re-report must
        not cost O(files) work per tick."""
        if not self.node.is_leader:
            return
        files = {f: [int(v) for v in vs] for f, vs in msg.data.get("files", {}).items()}
        for f in [f for f in files if f in self._recent_deletes]:
            del files[f]
            self.node.send_unique(
                msg.sender, MsgType.DELETE_FILE,
                {"file": f, "rid": self.node.new_rid()},
            )
        cur = self.metadata.files.get(msg.sender)
        if msg.data.get("delta"):
            # delta re-report: changed entries + explicit removals,
            # applied over whatever we hold for the sender. A delta
            # landing on a leader with NO base (e.g. the table entry
            # was dropped) still merges its adds; the sender's
            # periodic full anti-entropy closes any remaining gap.
            base = dict(cur or {})
            changed = False
            removed = msg.data.get("removed") or []
            for f in removed:
                if isinstance(f, str) and base.pop(f, None) is not None:
                    changed = True
            for f, vs in files.items():
                svs = sorted(vs)
                if base.get(f) != svs:
                    base[f] = svs
                    changed = True
            if not changed:
                return  # duplicate/out-of-date delta: nothing new
            files = base
        elif msg.data.get("partial"):
            # one chunk of a multi-datagram report: merge, never
            # overwrite (the other chunks' entries must survive).
            # Chunks only ADD/refresh; removals arrive via the
            # leading all_names datagram (the sender's complete name
            # list — anything we hold beyond it is stale) or the
            # delete fan-out and failure paths.
            names = msg.data.get("all_names")
            if isinstance(names, list):
                keep = {n for n in names if isinstance(n, str)}
                pruned = {
                    f: vs for f, vs in (cur or {}).items() if f in keep
                }
                if pruned == (cur or {}) and not files:
                    return  # nothing stale, nothing new
                files = {**pruned, **files}
            else:
                if cur is not None and all(
                    cur.get(f) == sorted(vs) for f, vs in files.items()
                ):
                    return  # chunk already reflected
                files = {**(cur or {}), **files}
        elif files == cur:
            return  # steady-state re-report: nothing changed
        self.metadata.set_node_inventory(msg.sender, files)
        try:
            self._relay_to_standby(
                MsgType.ALL_LOCAL_FILES_RELAY,
                {"node": msg.sender, "files": files},
            )
        except ValueError:
            # merged inventory over the frame cap: the standby falls
            # back to its COORDINATE_ACK rebuild on failover
            log.warning(
                "%s: inventory relay for %s exceeds the datagram cap",
                self._me, msg.sender,
            )
        # a JOIN can also end under-replication: files PUT while the
        # cluster was smaller than replication_factor gain copies the
        # moment capacity exists (the reference repairs only on deaths,
        # worker.py:1308-1321, so its early files stay thin forever)
        self._on_replication_needed([msg.sender])

    async def _h_all_local_files_relay(self, msg: Message, addr) -> None:
        if msg.sender != self.node.leader_unique:
            return
        files = {f: [int(v) for v in vs] for f, vs in msg.data.get("files", {}).items()}
        self.metadata.set_node_inventory(msg.data.get("node", msg.sender), files)

    async def _h_put_request(self, msg: Message, addr) -> None:
        """Leader PUT flow (reference worker.py:760-773): place
        replicas, assign the version, fan out DOWNLOAD_FILE."""
        if not self.node.is_leader:
            return
        file = msg.data["file"]
        rid = msg.data.get("rid", "")
        token = msg.data.get("token", "")
        # idempotency: a client retry of an in-flight PUT re-targets the
        # final reply at the new rid; a retry of a resolved PUT gets the
        # recorded outcome (success OR failure) — never a second version
        if token in self._put_tokens:
            prior = self._put_tokens[token]
            if isinstance(prior, tuple) and prior[0] == "done":
                _, ok, reply = prior
                self.node.send_unique(
                    msg.sender,
                    MsgType.PUT_REQUEST_SUCCESS if ok else MsgType.PUT_REQUEST_FAIL,
                    {**reply, "rid": rid},
                )
                return
            st = self.metadata.get_request(prior)
            if st is not None:
                st.client_rid = rid
                return
            # request vanished without a recorded outcome (shouldn't
            # happen): fall through and treat as a fresh PUT
            del self._put_tokens[token]
        live = self._live_node_names()
        replicas = self.metadata.place(file, live)
        if not replicas:
            self.node.send_unique(
                msg.sender, MsgType.PUT_REQUEST_FAIL,
                {"rid": rid, "ok": False, "error": "no live replicas"},
            )
            return
        version = self.metadata.assign_version(file)
        self._recent_deletes.pop(file, None)  # the file exists again
        req_id = self.metadata.new_request("put", file, msg.sender, replicas, version)
        st = self.metadata.requests[req_id]
        st.client_rid = rid
        st.fanout_payload = {
            "req": req_id,
            "file": file,
            "version": version,
            "token": msg.data["token"],
            "data_addr": msg.data["data_addr"],
        }
        st.last_sent = time.monotonic()
        if token:
            self._put_tokens[token] = req_id
        for r in replicas:
            self.node.send_unique(r, MsgType.DOWNLOAD_FILE, st.fanout_payload)

    def _resolve_put(self, req_id: str, st, ok: bool, reply: Dict[str, Any]) -> None:
        """Single resolution point for a PUT request: finish it, record
        the outcome against its idempotency token (so a retried
        PUT_REQUEST re-fetches the verdict no matter which path
        resolved it), and answer the client."""
        self.metadata.finish_request(req_id)
        token = st.fanout_payload.get("token", "")
        if token:
            self._put_tokens[token] = ("done", ok, reply)
            self._relay_to_standby(
                MsgType.STORE_IDEMPOTENCY_RELAY,
                {"kind": "put", "token": token, "ok": ok, "reply": reply},
            )
        self.node.send_unique(
            st.requester,
            MsgType.PUT_REQUEST_SUCCESS if ok else MsgType.PUT_REQUEST_FAIL,
            reply,
        )

    def _reassign_failed_put(self, st) -> int:
        """A replica NAKed its PUT pull (full disk, dying data plane):
        move every failed slot to a live node not yet tried, so one
        bad disk degrades placement instead of failing the client's
        whole PUT. Returns how many replacement slots were fanned out
        (0 = no candidates left)."""
        failed = [n for n, s in st.replicas.items() if s == "fail"]
        for n in failed:
            st.replicas.pop(n, None)
            st.tried.add(n)
        candidates = [
            n for n in self._live_node_names()
            if n not in st.tried and n not in st.replicas
        ]
        moved = 0
        for n in candidates[: len(failed)]:
            st.replicas[n] = "pending"
            st.last_sent = time.monotonic()
            self.node.send_unique(n, MsgType.DOWNLOAD_FILE, st.fanout_payload)
            moved += 1
        if moved:
            log.info(
                "%s: PUT %s reassigned %d failed replica slot(s) -> %s",
                self._me, st.file, moved, candidates[:moved],
            )
        return moved

    async def _h_download_result(self, msg: Message, addr) -> None:
        """Replica finished (or failed) pulling a PUT (reference
        worker.py:702-730). All ok -> answer the client; any fail ->
        reassign the slot to another live node, or resolve with what
        actually landed."""
        if not self.node.is_leader:
            return
        req_id = msg.data.get("req", "")
        st = self.metadata.get_request(req_id)
        if st is None:
            return
        # the ACK echoes file (+ version on success) — cross-check them
        # against the request they claim to resolve (drift-wire-payloads
        # flagged the echo as dead bytes: un-validated, a garbled or
        # byzantine ACK carrying a real req id could flip a replica
        # slot for the WRONG file/version)
        echo_file = msg.data.get("file")
        if echo_file is not None and echo_file != st.file:
            log.warning(
                "%s: PUT result for req %s echoes file %r but the "
                "request is for %r — dropped",
                self._me, req_id, echo_file, st.file,
            )
            return
        echo_version = msg.data.get("version")
        if echo_version is not None and int(echo_version) != st.version:
            log.warning(
                "%s: PUT result for req %s echoes version %s but the "
                "request pinned v%s — dropped",
                self._me, req_id, echo_version, st.version,
            )
            return
        ok = msg.type == MsgType.DOWNLOAD_FILE_SUCCESS
        st.set_status(msg.sender, "ok" if ok else "fail")
        if ok:
            self.metadata.record_replica(msg.sender, st.file, st.version)
        if st.failed:
            if self._reassign_failed_put(st):
                return  # fresh pending slots; their results resolve us
            # no candidates left: the request resolves on whatever
            # actually lands — wait out any stragglers, then succeed
            # degraded-but-durable if at least one replica holds the
            # bytes (the periodic under-replication sweep tops it back
            # up as capacity heals), or fail honestly if none do
            if st.pending_nodes:
                return
            if not any(s == "ok" for s in st.replicas.values()):
                self._resolve_put(req_id, st, False, {
                    "rid": st.client_rid,
                    "ok": False,
                    "error": f"no replica could store it "
                             f"(last: {msg.sender}: {msg.data.get('error')})",
                })
                return
        if st.completed:
            self._resolve_put(req_id, st, True, {
                "rid": st.client_rid,
                "ok": True,
                "file": st.file,
                "version": st.version,
                "replicas": self.metadata.replicas_of(st.file),
            })

    async def _h_get_file_request(self, msg: Message, addr) -> None:
        """Leader GET: reply replica set + versions; the client pulls
        the bytes itself over the data plane."""
        if not self.node.is_leader:
            return
        file = msg.data["file"]
        replicas = [r for r in self.metadata.replicas_of(file) if self.node.membership.is_alive(r)]
        if not replicas:
            self.node.send_unique(
                msg.sender,
                MsgType.GET_FILE_REQUEST_FAIL,
                {"rid": msg.data.get("rid"), "ok": False, "error": "file not found"},
            )
            return
        versions = sorted(
            {v for r in replicas for v in self.metadata.files.get(r, {}).get(file, [])}
        )
        self.node.send_unique(
            msg.sender,
            MsgType.GET_FILE_REQUEST_ACK,
            {
                "rid": msg.data.get("rid"),
                "ok": True,
                "file": file,
                "replicas": replicas,
                "version": versions[-1] if versions else 0,
                "versions": versions,
            },
        )

    async def _h_delete_file_request(self, msg: Message, addr) -> None:
        """Leader DELETE: fan out to holders, aggregate ACKs."""
        if not self.node.is_leader:
            return
        file = msg.data["file"]
        rid = msg.data.get("rid", "")
        holders = [r for r in self.metadata.replicas_of(file) if self.node.membership.is_alive(r)]
        if not holders:
            if file in self._recent_deletes:
                # retry of a completed delete whose reply was dropped:
                # converge to success, not "file not found"
                self.node.send_unique(
                    msg.sender,
                    MsgType.DELETE_FILE_REQUEST_SUCCESS,
                    {"rid": rid, "ok": True, "file": file},
                )
            else:
                self.node.send_unique(
                    msg.sender,
                    MsgType.DELETE_FILE_REQUEST_FAIL,
                    {"rid": rid, "ok": False, "error": "file not found"},
                )
            return
        req_id = self.metadata.new_request("delete", file, msg.sender, holders)
        st = self.metadata.requests[req_id]
        st.client_rid = rid
        st.fanout_payload = {"req": req_id, "file": file}
        st.last_sent = time.monotonic()
        for r in holders:
            self.node.send_unique(r, MsgType.DELETE_FILE, st.fanout_payload)

    async def _h_delete_result(self, msg: Message, addr) -> None:
        if not self.node.is_leader:
            return
        req_id = msg.data.get("req", "")
        st = self.metadata.get_request(req_id)
        if st is None:
            return
        # same echo cross-check as the PUT path: the carried file must
        # name the request's file or the ACK resolves nothing
        echo_file = msg.data.get("file")
        if echo_file is not None and echo_file != st.file:
            log.warning(
                "%s: DELETE result for req %s echoes file %r but the "
                "request is for %r — dropped",
                self._me, req_id, echo_file, st.file,
            )
            return
        ok = msg.type == MsgType.DELETE_FILE_ACK
        st.set_status(msg.sender, "ok" if ok else "fail")
        if not (st.completed or st.failed):
            return
        done_ok = st.completed
        self.metadata.finish_request(req_id)
        if done_ok:
            self.metadata.remove_file(st.file)
            self._record_delete_done(st.file)
        self.node.send_unique(
            st.requester,
            MsgType.DELETE_FILE_REQUEST_SUCCESS if done_ok else MsgType.DELETE_FILE_REQUEST_FAIL,
            {"rid": st.client_rid, "ok": done_ok, "file": st.file},
        )

    async def _h_list_file_request(self, msg: Message, addr) -> None:
        if not self.node.is_leader:
            return
        file = msg.data["file"]
        self.node.send_unique(
            msg.sender,
            MsgType.LIST_FILE_REQUEST_ACK,
            {
                "rid": msg.data.get("rid"),
                "ok": True,
                "replicas": self.metadata.replicas_of(file),
            },
        )

    async def _h_matching_request(self, msg: Message, addr) -> None:
        if not self.node.is_leader:
            return
        pattern = msg.data.get("pattern", "*")
        files = {
            f: sorted({
                v
                for inv in self.metadata.files.values()
                for v in inv.get(f, [])
            })
            for f in self.metadata.matching(pattern)
        }
        self.node.send_unique(
            msg.sender,
            MsgType.GET_ALL_MATCHING_FILES_ACK,
            {"rid": msg.data.get("rid"), "ok": True, "files": files},
        )

    def _record_delete_done(self, file: str) -> None:
        """A delete committed: remember it (retries converge to
        success) and keep the standby's memory warm across failover."""
        self._recent_deletes[file] = True
        self._relay_to_standby(
            MsgType.STORE_IDEMPOTENCY_RELAY, {"kind": "delete", "file": file}
        )

    async def _h_idempotency_relay(self, msg: Message, addr) -> None:
        """Standby side: mirror the leader's resolved PUT tokens and
        completed deletes, so a client retry that lands on US after a
        failover re-fetches the recorded outcome instead of re-running
        the operation (closing the duplicate-version window the
        round-1 build documented as open)."""
        if msg.sender != self.node.leader_unique or self.node.is_leader:
            return
        d = msg.data
        if d.get("kind") == "put" and d.get("token"):
            self._put_tokens[d["token"]] = (
                "done", bool(d.get("ok")), dict(d.get("reply", {}))
            )
        elif d.get("kind") == "delete" and d.get("file"):
            self._recent_deletes[d["file"]] = True

    async def _h_files_per_node(self, msg: Message, addr) -> None:
        if not self.node.is_leader:
            return
        self.node.send_unique(
            msg.sender,
            MsgType.FILES_PER_NODE_ACK,
            {
                "rid": msg.data.get("rid"),
                "ok": True,
                "nodes": {
                    node: dict(inv)
                    for node, inv in self.metadata.files.items()
                },
            },
        )

    # ------------------------------------------------------------------
    # replica-side handlers (reference worker.py:113-174)
    # ------------------------------------------------------------------

    async def _h_download_file(self, msg: Message, addr) -> None:
        """Pull the client's exposed file into the local store at the
        leader-assigned version, then ACK the leader."""
        try:
            await self.data_plane.fetch_token_to_store(
                tuple(msg.data["data_addr"]),
                msg.data["token"],
                msg.data["file"],
                int(msg.data["version"]),
            )
            self.node.send_unique(
                msg.sender,
                MsgType.DOWNLOAD_FILE_SUCCESS,
                {"req": msg.data.get("req"), "file": msg.data["file"],
                 "version": int(msg.data["version"])},
            )
        except Exception as e:
            log.warning("%s: PUT pull failed: %s", self._me, e)
            # .get: a byzantine DOWNLOAD_FILE with missing keys must
            # fail into THIS reply, not crash the error path itself
            self.node.send_unique(
                msg.sender,
                MsgType.DOWNLOAD_FILE_FAIL,
                {"req": msg.data.get("req"), "file": msg.data.get("file"),
                 "error": str(e)},
            )

    async def _h_delete_file(self, msg: Message, addr) -> None:
        # idempotent: deleting an already-absent file ACKs success, so
        # a re-sent DELETE (after a dropped ACK) converges instead of
        # NAKing and failing the request
        self.store.delete(msg.data["file"])
        self.node.send_unique(
            msg.sender,
            MsgType.DELETE_FILE_ACK,
            {"req": msg.data.get("req"), "file": msg.data["file"]},
        )

    async def _h_replicate_file(self, msg: Message, addr) -> None:
        """Pull every version of a file from a surviving replica
        (reference replicate_file, file_service.py:52-61)."""
        file = msg.data["file"]
        source = self.node.spec.node_by_unique_name(msg.data["source"])
        t0 = time.monotonic()
        try:
            if source is None:
                raise RuntimeError(f"unknown source {msg.data['source']}")
            versions = await self.data_plane.replicate_from(data_addr(source), file)
            _M_REPL.inc()
            _M_REPL_T.observe(time.monotonic() - t0)
            self.node.send_unique(
                msg.sender,
                MsgType.REPLICATE_FILE_SUCCESS,
                {"file": file, "versions": versions},
            )
        except Exception as e:
            log.warning("%s: replicate %s failed: %s", self._me, file, e)
            _M_REPL_FAIL.inc()
            self.node.send_unique(
                msg.sender, MsgType.REPLICATE_FILE_FAIL, {"file": file, "error": str(e)}
            )

    async def _h_replicate_result(self, msg: Message, addr) -> None:
        if not self.node.is_leader:
            return
        file = msg.data.get("file", "")
        self._repairs_inflight.pop((file, msg.sender), None)
        if msg.type == MsgType.REPLICATE_FILE_FAIL:
            # the holder ships WHY it failed; until drift-wire-payloads
            # flagged the key as sent-never-read, a failed repair was
            # invisible at the leader (the holder logged locally, the
            # repair sweep just retried blind)
            log.warning(
                "%s: repair of %s on %s failed: %s",
                self._me, file, msg.sender,
                msg.data.get("error", "unknown"),
            )
        if msg.type == MsgType.REPLICATE_FILE_SUCCESS:
            if file not in self.metadata.all_files():
                # the file was DELETEd while the repair was in flight:
                # recording the replica would resurrect it (and a later
                # re-PUT's version counter would collide with the stale
                # copy) — instead tell the holder to drop the bytes
                self.node.send_unique(
                    msg.sender, MsgType.DELETE_FILE,
                    {"file": file, "rid": self.node.new_rid()},
                )
                return
            for v in msg.data.get("versions", []):
                self.metadata.record_replica(msg.sender, file, int(v))

    # ------------------------------------------------------------------
    # failure handling (reference worker.py:1247-1321, leader.py:147-181)
    # ------------------------------------------------------------------

    def _on_node_failed(self, uname: str) -> None:
        """A node was cleaned up: drop its inventory and repair
        in-flight requests that were waiting on it (reference
        replace_files_downloading_by_node, worker.py:1247-1277)."""
        if not self.node.is_leader:
            return
        self.metadata.drop_node(uname)
        # prompt repair: the reference batches re-replication until >=M
        # nodes died (membershipList.py:49-52), leaving files
        # under-replicated in the meantime; the plan is cheap and
        # idempotent, so run it on every death
        self._on_replication_needed([uname])
        for req_id, st in self.metadata.requests_involving(uname):
            # mark the dead replica failed; if that completes/fails the
            # request the next result handler pass would miss it, so
            # resolve inline
            st.replicas.pop(uname, None)
            if not st.replicas:
                # every replica died mid-flight: fail loudly, never
                # report a vacuous success
                fail_reply = {
                    "rid": st.client_rid,
                    "ok": False,
                    "file": st.file,
                    "error": "all replicas failed during the request",
                }
                if st.op == "put":
                    self._resolve_put(req_id, st, False, fail_reply)
                else:
                    self.metadata.finish_request(req_id)
                    self.node.send_unique(
                        st.requester, MsgType.DELETE_FILE_REQUEST_FAIL, fail_reply
                    )
            elif st.completed:
                ok_reply = {
                    "rid": st.client_rid,
                    "ok": True,
                    "file": st.file,
                    "version": st.version,
                    "replicas": self.metadata.replicas_of(st.file),
                }
                if st.op == "put":
                    self._resolve_put(req_id, st, True, ok_reply)
                else:
                    self.metadata.finish_request(req_id)
                    self.metadata.remove_file(st.file)
                    self._record_delete_done(st.file)
                    self.node.send_unique(
                        st.requester, MsgType.DELETE_FILE_REQUEST_SUCCESS, ok_reply
                    )

    def _on_replication_needed(self, cleaned: List[str]) -> None:
        """Bring every under-replicated file back to
        `replication_factor` copies (reference worker.py:1308-1321).
        Runs on deaths, joins, and a periodic sweep, so it must not
        fight in-flight work: files with an active PUT/DELETE are
        skipped (their fan-out will finish or repair on its own), and
        (file, target) pairs already asked to replicate are not
        re-asked until the prior ask resolves or times out."""
        if not self.node.is_leader:
            return
        live = self._live_node_names()
        busy = {st.file for st in self.metadata.requests.values()}
        now = time.monotonic()
        ttl = max(30.0, 10 * self.resend_after)
        self._repairs_inflight = {
            k: t for k, t in self._repairs_inflight.items() if now - t < ttl
        }
        plan = self.metadata.replication_plan(live)
        sent = 0
        for file, source, targets in plan:
            if file in busy:
                continue
            for t in targets:
                if (file, t) in self._repairs_inflight:
                    continue
                self._repairs_inflight[(file, t)] = now
                self.node.send_unique(
                    t, MsgType.REPLICATE_FILE, {"file": file, "source": source}
                )
                sent += 1
        if sent:
            log.info("%s: re-replication: %d transfers asked", self._me, sent)

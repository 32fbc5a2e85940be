"""Wire format for the UDP control plane.

Replaces the reference's fixed 33 KB struct frame
(`struct.pack("i255s6si32768s")`, packets.py:70-92) — which sends a
~33 KB datagram even for an empty ping and is the reason its measured
bandwidth numbers are what they are — with a compact, variable-length
frame: a 10-byte header + UTF-8 JSON payload. Message taxonomy mirrors
the reference's 50-value PacketType enum (packets.py:9-60), organized
by subsystem (types that existed only for dead code paths are folded
into their live equivalents).

Payload map (lint-enforced)
---------------------------

One line per MsgType member: the JAX package's map, which its
tools/dmlflow.py (rule ``drift-wire-payloads``) holds to that package's
send sites and handler/await-site reads on every tier-1 run; this copy
packs the same bytes (tests/test_torch_cluster.py). A key listed here
that nothing sends or reads, and a key on the wire this map doesn't
declare, are findings. Grammar: a bare ``key`` is REQUIRED (the
owning reader indexes it unconditionally — every sender must ship
it); ``key?`` is OPTIONAL (shipped by some senders or read via
``.get``/presence probe); ``-`` declares an empty payload; ``*``
marks an OPEN payload (a sender or reader the inference cannot fully
resolve — tiered/composed frames); ``<- REQUEST`` marks a reply type
whose payload is read at the await site of that request (rid-fallback
types). The ``rid`` correlation key is universal and implicit.

    PING: leader? members? ue? uni? *
    ACK: leader? members? ue? uni? *
    INTRODUCE: -
    INTRODUCE_ACK: leader? members? <- INTRODUCE
    FETCH_INTRODUCER: -
    FETCH_INTRODUCER_ACK: introducer? <- FETCH_INTRODUCER
    UPDATE_INTRODUCER: introducer? uni? *
    UPDATE_INTRODUCER_ACK: - <- UPDATE_INTRODUCER
    ELECTION: -
    COORDINATE: -
    COORDINATE_ACK: files?
    ALL_LOCAL_FILES: all_names? delta? files? partial? removed? *
    ALL_LOCAL_FILES_RELAY: files? node?
    PUT_REQUEST: data_addr file token?
    PUT_REQUEST_SUCCESS: error? ok? * <- PUT_REQUEST
    PUT_REQUEST_FAIL: error? ok? * <- PUT_REQUEST
    DOWNLOAD_FILE: data_addr token version file? req? *
    DOWNLOAD_FILE_SUCCESS: error? file? req? version?
    DOWNLOAD_FILE_FAIL: error? file? req? version?
    GET_FILE_REQUEST: file
    GET_FILE_REQUEST_ACK: error? file? ok? replicas? version? versions? <- GET_FILE_REQUEST
    GET_FILE_REQUEST_FAIL: error? file? ok? replicas? version? versions? <- GET_FILE_REQUEST
    DELETE_FILE_REQUEST: file
    DELETE_FILE_REQUEST_SUCCESS: error? file? ok? replicas? version? * <- DELETE_FILE_REQUEST
    DELETE_FILE_REQUEST_FAIL: error? file? ok? * <- DELETE_FILE_REQUEST
    DELETE_FILE: file req? *
    DELETE_FILE_ACK: file? req?
    DELETE_FILE_NAK: file? req? *
    REPLICATE_FILE: file source
    REPLICATE_FILE_SUCCESS: error? file? versions?
    REPLICATE_FILE_FAIL: error? file? versions?
    LIST_FILE_REQUEST: file
    LIST_FILE_REQUEST_ACK: error? ok? replicas? <- LIST_FILE_REQUEST
    GET_ALL_MATCHING_FILES: pattern?
    GET_ALL_MATCHING_FILES_ACK: error? files? ok? <- GET_ALL_MATCHING_FILES
    FILES_PER_NODE_REQUEST: -
    FILES_PER_NODE_ACK: error? nodes? ok? <- FILES_PER_NODE_REQUEST
    STORE_IDEMPOTENCY_RELAY: file? kind? ok? reply? token?
    SUBMIT_JOB_REQUEST: model? n? token?
    SUBMIT_JOB_REQUEST_ACK: error? job_id? ok? <- SUBMIT_JOB_REQUEST
    SUBMIT_JOB_REQUEST_SUCCESS: error? job_id? model? total_queries? *
    SUBMIT_JOB_RELAY: files job model n requester affinity? batch_size? gen? inline? slo? streams? traces? *
    WORKER_TASK_REQUEST: batch files job model inc? inline? replicas? seq? staged? streams? traces? versions?
    WORKER_TASK_REQUEST_ACK: batch job backend_time? cost? exec_time? fetch_time? infer_time? model? n_images? put_time? results? stage_wait_time? *
    WORKER_TASK_ACK_RELAY: batch job gen? n_images? *
    SET_BATCH_SIZE: batch_size model fanout?
    GET_C2_COMMAND: model?
    GET_C2_COMMAND_ACK: ok? stats? <- GET_C2_COMMAND
    SET_BATCH_SIZE_ACK: ok? <- SET_BATCH_SIZE
    WORKER_TASK_FAIL: batch job error?
    JOB_STATUS_REQUEST: job?
    JOB_STATUS_ACK: done? error? job_id? model? ok? total_queries? * <- JOB_STATUS_REQUEST
    JOBS_RESTORE_RELAY: version gen?
    JOBS_RESTORE_RELAY_ACK: ok? <- JOBS_RESTORE_RELAY
    JOB_FAILED_RELAY: job error? gen? *
    WORKER_STAGE_CANCEL: batch job inc? seq?
    LM_PREFILL_REQUEST: budgets? draft_k? model? prompts? stream? traces? *
    LM_PREFILL_ACK: error? n? ok? size? stream? token? * <- LM_PREFILL_REQUEST
    METRICS_PULL: -
    METRICS_PULL_ACK: metrics? * <- METRICS_PULL
    METRICS_RELAY_PULL: peers? timeout?
    METRICS_RELAY_ACK: covered? failed? metrics? ok? * <- METRICS_RELAY_PULL
    REQUEST_SUBMIT: id? model? payload? session? slo? store_name? stream?
    REQUEST_SUBMIT_ACK: accepted? id? reason? shed? * <- REQUEST_SUBMIT
    REQUEST_DONE: id? ok? reason? *
    REQUEST_STATUS: id?
    REQUEST_STATUS_ACK: done? known? terminal? * <- REQUEST_STATUS
    REQUEST_STREAM_READY: host? id? port? token?
    INGRESS_RELAY: job? reqs? sessions?
    TRACE_PULL: max_spans? peers? timeout? trace_ids? *
    TRACE_PULL_ACK: degraded? error? failed? held? ok? spans? stripped? truncated? * <- TRACE_PULL
    JOIN_REQUEST: epoch? group? have? mac? node? nonce? *
    JOIN_ACK: epoch? leader? mac? members? ok? reason? universe? <- JOIN_REQUEST
    LEAVE: epoch? mac? nonce?
    ALERT: event? row?
    ALERT_PULL: alerts? error? events? health? max_events? node? ok? truncated? * <- ALERT_PULL
    AUTOSCALE: cooldowns? event? row?
"""

from __future__ import annotations

import enum
import json
import struct
from dataclasses import dataclass
from typing import Any, Dict, Optional

_MAGIC = 0xD31  # 12-bit magic, "Dml"
_HEADER = struct.Struct("!HHHI")  # magic, version|type, sender_len, payload_len
_VERSION = 1
MAX_DATAGRAM = 60_000  # stay under typical 64 KB UDP limit


class MsgType(enum.IntEnum):
    """Control-plane message taxonomy (reference packets.py:9-60)."""

    # membership / failure detection (L4)
    PING = 1
    ACK = 2
    INTRODUCE = 3
    INTRODUCE_ACK = 4
    FETCH_INTRODUCER = 5
    FETCH_INTRODUCER_ACK = 6
    UPDATE_INTRODUCER = 7
    UPDATE_INTRODUCER_ACK = 8
    # election (L5)
    ELECTION = 10
    COORDINATE = 11
    COORDINATE_ACK = 12
    # replicated store (L6)
    ALL_LOCAL_FILES = 20
    ALL_LOCAL_FILES_RELAY = 21
    PUT_REQUEST = 22
    # 23 reserved: PUT_REQUEST_ACK existed in the reference taxonomy
    # but nothing here ever sent or awaited it (the leader replies
    # PUT_REQUEST_SUCCESS/FAIL directly); dmllint's dead-member rule
    # keeps such stubs from accreting again
    PUT_REQUEST_SUCCESS = 24
    PUT_REQUEST_FAIL = 25
    DOWNLOAD_FILE = 26
    DOWNLOAD_FILE_SUCCESS = 27
    DOWNLOAD_FILE_FAIL = 28
    GET_FILE_REQUEST = 29
    GET_FILE_REQUEST_ACK = 30
    GET_FILE_REQUEST_FAIL = 31
    DELETE_FILE_REQUEST = 32
    # 33 reserved: DELETE_FILE_REQUEST_ACK, dead for the same reason
    # as 23 — the leader replies DELETE_FILE_REQUEST_SUCCESS/FAIL
    DELETE_FILE_REQUEST_SUCCESS = 34
    DELETE_FILE_REQUEST_FAIL = 35
    DELETE_FILE = 36
    DELETE_FILE_ACK = 37
    DELETE_FILE_NAK = 38
    REPLICATE_FILE = 39
    REPLICATE_FILE_SUCCESS = 40
    REPLICATE_FILE_FAIL = 41
    LIST_FILE_REQUEST = 42
    LIST_FILE_REQUEST_ACK = 43
    GET_ALL_MATCHING_FILES = 44
    GET_ALL_MATCHING_FILES_ACK = 45
    # global files-per-node view (reference CLI option 6,
    # worker.py:1711-1714, reads the leader's global_file_dict)
    FILES_PER_NODE_REQUEST = 46
    FILES_PER_NODE_ACK = 47
    # leader -> standby: resolved PUT idempotency tokens + completed
    # deletes, so client retries crossing a failover stay idempotent
    STORE_IDEMPOTENCY_RELAY = 48
    # ML job pipeline (L7)
    SUBMIT_JOB_REQUEST = 60
    SUBMIT_JOB_REQUEST_ACK = 61
    SUBMIT_JOB_REQUEST_SUCCESS = 62
    SUBMIT_JOB_RELAY = 63
    WORKER_TASK_REQUEST = 64
    WORKER_TASK_REQUEST_ACK = 65
    WORKER_TASK_ACK_RELAY = 66
    SET_BATCH_SIZE = 67  # C3 (reference worker.py:1028-1037)
    GET_C2_COMMAND = 68
    GET_C2_COMMAND_ACK = 69
    SET_BATCH_SIZE_ACK = 70
    WORKER_TASK_FAIL = 71
    JOB_STATUS_REQUEST = 72
    JOB_STATUS_ACK = 73
    # coordinator restored a scheduler snapshot: tells the standby to
    # pull the same pinned version from the store so its shadow matches
    JOBS_RESTORE_RELAY = 74
    # standby ack (echoes rid) once its shadow restore completed;
    # unregistered on purpose: the dispatcher's rid fallback resolves it
    JOBS_RESTORE_RELAY_ACK = 75
    # coordinator -> standby: a job hit the batch-failure cap and was
    # retired with an error; the shadow must drop it too or a failover
    # resurrects work the client was already told failed
    JOB_FAILED_RELAY = 76
    # coordinator -> worker: revoke a STAGED (pipeline) batch that was
    # pulled back into the queue when a second model's work arrived —
    # the fair split must see it as schedulable, not pinned to a worker
    WORKER_STAGE_CANCEL = 77
    # disaggregated LM serving (inference/lm_sharded.py): the decode-
    # role group primary asks a prefill-role member to run the chunked
    # prompt prefill for a batch. The ACK carries a data-plane token
    # for the serialized KV-cache slab, which the decode node pulls
    # over the TCP data plane (bulk bytes never ride UDP). The ACK is
    # deliberately unregistered: the dispatcher's rid fallback resolves
    # the awaiting request future, like SET_BATCH_SIZE_ACK.
    LM_PREFILL_REQUEST = 78
    LM_PREFILL_ACK = 79
    # observability (L8): any node (in practice the leader's console)
    # pulls a peer's metrics-registry snapshot; the ACK carries the
    # JSON snapshot (sparse histogram buckets), degrading tier by tier
    # to fit the datagram cap: full -> bucket-stripped -> counters+
    # gauges only -> explicit error reply. Aggregation =
    # observability.merge_snapshots.
    METRICS_PULL = 80
    METRICS_PULL_ACK = 81
    # two-level metrics aggregation (the O(100)-node form of the
    # cluster view): the leader asks R relay nodes to each pull a
    # SHARD of peers and pre-merge the snapshots with
    # observability.merge_snapshots before replying, so leader
    # ingress drops from O(N·snapshot) to O(R·merged) and a straggler
    # costs one relay timeout, not a serial wall. The ACK carries the
    # pre-merged blob (same tier-by-tier degradation as
    # METRICS_PULL_ACK) + which peers it covers; it is deliberately
    # unregistered — the dispatcher's rid fallback resolves the
    # leader's awaiting request future.
    METRICS_RELAY_PULL = 82
    METRICS_RELAY_ACK = 83
    # request front door (L9, dml_tpu/ingress/): per-request ingress
    # with SLO classes. SUBMIT carries one request (model, slo class,
    # optional inline payload / store input / session id / stream
    # flag); the ACK is the admission decision — accepted, or a TYPED
    # rejection (shed) that the client gets immediately instead of a
    # timeout. DONE is the router's terminal push to the client
    # (result or typed failure); STATUS/STATUS_ACK is the client's
    # re-poll fallback for a dropped DONE push (the wait_job
    # discipline applied per request). STREAM_READY is pushed by the
    # WORKER executing a streaming LM batch: it tells the client where
    # on the worker's TCP data plane to pull the request's token
    # stream as it decodes (bulk tokens never ride UDP). SUBMIT_ACK /
    # STATUS_ACK are deliberately unregistered — the dispatcher's rid
    # fallback resolves the awaiting request future, like
    # SET_BATCH_SIZE_ACK.
    REQUEST_SUBMIT = 90
    REQUEST_SUBMIT_ACK = 91
    REQUEST_DONE = 92
    REQUEST_STATUS = 93
    REQUEST_STATUS_ACK = 94
    REQUEST_STREAM_READY = 95
    # router -> standby: which request ids ride which dispatched job,
    # so a promoted router can fan completions back out to clients —
    # in-flight requests either complete or are explicitly rejected
    # across a failover, never silently lost
    INGRESS_RELAY = 96
    # distributed request tracing (dml_tpu/tracing.py): pull a peer's
    # flight-recorder span dump (bounded ring + slowest-K + tail
    # exemplars). The ACK carries the span list, degrading tier by
    # tier to fit the datagram cap exactly like METRICS_PULL_ACK
    # (full -> labels/events stripped -> halved newest-half counts ->
    # count-only -> explicit error); a request carrying "peers" makes
    # the receiver a RELAY that pre-merges its shard (the
    # two-level fan-out shape, folded into the same type). The ACK is
    # deliberately unregistered — the dispatcher's rid fallback
    # resolves the awaiting request future, like METRICS_PULL_ACK.
    TRACE_PULL = 100
    TRACE_PULL_ACK = 101
    # elastic membership (config.ClusterSpec join policy): a node
    # outside the current universe asks the leader for admission.
    # JOIN_REQUEST carries the joiner's identity/addr, a fresh nonce,
    # the universe epoch the joiner believes current, and an HMAC
    # over all of it under the shared cluster secret — forged,
    # replayed, and stale-epoch joins are rejected and counted while
    # everything unauthenticated keeps dying at the existing
    # out-of-universe drops. JOIN_ACK (rid fallback, like
    # INTRODUCE_ACK) is MAC-stamped too and ships the membership
    # snapshot + the universe catch-up (epoch + HMAC-stamped change
    # entries, or the full table for a joiner too far behind).
    # LEAVE is the graceful-departure announcement: the departing
    # node proves its own identity with the same MAC scheme and the
    # leader retires it from the table + membership IMMEDIATELY —
    # scale-in must not linger through SWIM suspicion as a false
    # failure. No ACK: the leaver is already gone; loss degrades to
    # the ordinary failure-detection path.
    JOIN_REQUEST = 110
    JOIN_ACK = 111
    LEAVE = 112
    # SLO signal plane (dml_tpu/signal.py): the typed alert lifecycle's
    # wire surface. ALERT is the leader's fire-and-forget transition
    # relay to the hot standby (the STORE_IDEMPOTENCY_RELAY /
    # INGRESS_RELAY discipline applied to the alert ledger): every
    # firing→resolved transition ships its row so a promoted leader
    # inherits the firing set and can still resolve it. ALERT_PULL is
    # request/reply on ONE type (the DOWNLOAD_FILE_SUCCESS discipline):
    # a leg carrying a rid we minted resolves our awaiting future; any
    # other leg is a request for the ledger + recent events + health
    # rollup, degrading tier by tier through the shared send_tiered cap
    # machinery (full -> truncated events -> rows-only -> explicit
    # error). The CLI `health` / `alerts` verbs ride it.
    ALERT = 120
    ALERT_PULL = 121
    # closed-loop autoscaler (dml_tpu/autoscale.py): the leader's
    # fire-and-forget decision-ledger relay to the hot standby (the
    # ALERT discipline applied to autoscale decisions): every
    # propose/apply/cancel transition ships its row plus the per-kind
    # cooldown ledger, so a promoted leader inherits in-flight
    # decisions and cooldowns and settles each decision id exactly
    # once across the failover. No pull type: the CLI `autoscale`
    # verb runs a local diurnal probe rather than querying a cluster.
    AUTOSCALE = 130


# ----------------------------------------------------------------------
# handler-ownership registry (lint-enforced)
# ----------------------------------------------------------------------
#
# Every MsgType member is claimed by exactly one of:
#
# - a service class name ("Node", "StoreService", "JobService",
#   "RequestRouter"): that class — and only that class — registers an
#   ``_h_*`` handler for the type via ``Node.register``;
# - "IntroducerService": handled by the introducer's inline dispatch
#   loop (it is not a cluster node and has no handler table);
# - RID_FALLBACK: deliberately unregistered — the type is a reply
#   whose ``rid`` resolves an awaiting request future through the
#   dispatcher's fallback (see Node._dispatch), like SET_BATCH_SIZE_ACK.
#
# tools/dmllint.py (rule drift-wire-handlers) cross-checks this table
# against the actual ``.register(MsgType.X, self._h_y)`` calls in the
# tree on every tier-1 run: a new MsgType without an owner, a handler
# registered by a class that doesn't own the type, a registered type
# claimed as RID_FALLBACK, or a member no code references at all are
# all findings. Keep this table in the same order as the enum.

RID_FALLBACK = "rid-fallback"

HANDLER_OWNERS: Dict["MsgType", str] = {
    # membership / failure detection
    MsgType.PING: "Node",
    MsgType.ACK: "Node",
    MsgType.INTRODUCE: "Node",
    MsgType.INTRODUCE_ACK: RID_FALLBACK,
    MsgType.FETCH_INTRODUCER: "IntroducerService",
    MsgType.FETCH_INTRODUCER_ACK: RID_FALLBACK,
    MsgType.UPDATE_INTRODUCER: "IntroducerService",
    MsgType.UPDATE_INTRODUCER_ACK: RID_FALLBACK,
    # election
    MsgType.ELECTION: "Node",
    MsgType.COORDINATE: "Node",
    MsgType.COORDINATE_ACK: "Node",
    # replicated store
    MsgType.ALL_LOCAL_FILES: "StoreService",
    MsgType.ALL_LOCAL_FILES_RELAY: "StoreService",
    MsgType.PUT_REQUEST: "StoreService",
    MsgType.PUT_REQUEST_SUCCESS: RID_FALLBACK,
    MsgType.PUT_REQUEST_FAIL: RID_FALLBACK,
    MsgType.DOWNLOAD_FILE: "StoreService",
    MsgType.DOWNLOAD_FILE_SUCCESS: "StoreService",
    MsgType.DOWNLOAD_FILE_FAIL: "StoreService",
    MsgType.GET_FILE_REQUEST: "StoreService",
    MsgType.GET_FILE_REQUEST_ACK: RID_FALLBACK,
    MsgType.GET_FILE_REQUEST_FAIL: RID_FALLBACK,
    MsgType.DELETE_FILE_REQUEST: "StoreService",
    MsgType.DELETE_FILE_REQUEST_SUCCESS: RID_FALLBACK,
    MsgType.DELETE_FILE_REQUEST_FAIL: RID_FALLBACK,
    MsgType.DELETE_FILE: "StoreService",
    MsgType.DELETE_FILE_ACK: "StoreService",
    MsgType.DELETE_FILE_NAK: "StoreService",
    MsgType.REPLICATE_FILE: "StoreService",
    MsgType.REPLICATE_FILE_SUCCESS: "StoreService",
    MsgType.REPLICATE_FILE_FAIL: "StoreService",
    MsgType.LIST_FILE_REQUEST: "StoreService",
    MsgType.LIST_FILE_REQUEST_ACK: RID_FALLBACK,
    MsgType.GET_ALL_MATCHING_FILES: "StoreService",
    MsgType.GET_ALL_MATCHING_FILES_ACK: RID_FALLBACK,
    MsgType.FILES_PER_NODE_REQUEST: "StoreService",
    MsgType.FILES_PER_NODE_ACK: RID_FALLBACK,
    MsgType.STORE_IDEMPOTENCY_RELAY: "StoreService",
    # ML job pipeline
    MsgType.SUBMIT_JOB_REQUEST: "JobService",
    MsgType.SUBMIT_JOB_REQUEST_ACK: RID_FALLBACK,
    MsgType.SUBMIT_JOB_REQUEST_SUCCESS: "JobService",
    MsgType.SUBMIT_JOB_RELAY: "JobService",
    MsgType.WORKER_TASK_REQUEST: "JobService",
    MsgType.WORKER_TASK_REQUEST_ACK: "JobService",
    MsgType.WORKER_TASK_ACK_RELAY: "JobService",
    MsgType.SET_BATCH_SIZE: "JobService",
    MsgType.GET_C2_COMMAND: "JobService",
    MsgType.GET_C2_COMMAND_ACK: RID_FALLBACK,
    MsgType.SET_BATCH_SIZE_ACK: RID_FALLBACK,
    MsgType.WORKER_TASK_FAIL: "JobService",
    MsgType.JOB_STATUS_REQUEST: "JobService",
    MsgType.JOB_STATUS_ACK: RID_FALLBACK,
    MsgType.JOBS_RESTORE_RELAY: "JobService",
    MsgType.JOBS_RESTORE_RELAY_ACK: RID_FALLBACK,
    MsgType.JOB_FAILED_RELAY: "JobService",
    MsgType.WORKER_STAGE_CANCEL: "JobService",
    MsgType.LM_PREFILL_REQUEST: "JobService",
    MsgType.LM_PREFILL_ACK: RID_FALLBACK,
    # observability
    MsgType.METRICS_PULL: "Node",
    MsgType.METRICS_PULL_ACK: RID_FALLBACK,
    MsgType.METRICS_RELAY_PULL: "Node",
    MsgType.METRICS_RELAY_ACK: RID_FALLBACK,
    # request front door (90-96): the full ingress range audited —
    # SUBMIT/STATUS/DONE/STREAM_READY/RELAY are RequestRouter
    # handlers on every node (the role activates with leadership but
    # registration is unconditional so clients receive DONE pushes
    # and stream-ready notifications), the two ACKs ride the rid
    # fallback
    MsgType.REQUEST_SUBMIT: "RequestRouter",
    MsgType.REQUEST_SUBMIT_ACK: RID_FALLBACK,
    MsgType.REQUEST_DONE: "RequestRouter",
    MsgType.REQUEST_STATUS: "RequestRouter",
    MsgType.REQUEST_STATUS_ACK: RID_FALLBACK,
    MsgType.REQUEST_STREAM_READY: "RequestRouter",
    MsgType.INGRESS_RELAY: "RequestRouter",
    # distributed tracing
    MsgType.TRACE_PULL: "Node",
    MsgType.TRACE_PULL_ACK: RID_FALLBACK,
    # elastic membership
    MsgType.JOIN_REQUEST: "Node",
    MsgType.JOIN_ACK: RID_FALLBACK,
    MsgType.LEAVE: "Node",
    # SLO signal plane: ALERT_PULL is registered even though replies
    # share the type — the handler calls resolve_rid first and falls
    # through to request handling (the DOWNLOAD_FILE_SUCCESS shape)
    MsgType.ALERT: "SignalPlane",
    MsgType.ALERT_PULL: "SignalPlane",
    # closed-loop autoscaler
    MsgType.AUTOSCALE: "AutoscaleController",
}


@dataclass(frozen=True)
class Message:
    """One control-plane message (reference packets.py Packet)."""

    sender: str  # unique_name "host:port" of the sending node
    type: MsgType
    data: Dict[str, Any]

    def pack(self) -> bytes:
        sender_b = self.sender.encode("utf-8")
        payload = json.dumps(self.data, separators=(",", ":")).encode("utf-8")
        head = _HEADER.pack(
            (_MAGIC << 4) | _VERSION, int(self.type), len(sender_b), len(payload)
        )
        frame = head + sender_b + payload
        if len(frame) > MAX_DATAGRAM:
            raise ValueError(f"frame too large: {len(frame)} bytes")
        return frame

    @staticmethod
    def unpack(raw: bytes) -> Optional["Message"]:
        """Tolerant unpack: returns None on any malformed input
        (reference packets.py:83-92 behaves the same)."""
        try:
            if len(raw) < _HEADER.size:
                return None
            magic_ver, mtype, slen, plen = _HEADER.unpack_from(raw)
            if magic_ver >> 4 != _MAGIC or (magic_ver & 0xF) != _VERSION:
                return None
            off = _HEADER.size
            if len(raw) != off + slen + plen:
                return None
            sender = raw[off : off + slen].decode("utf-8")
            payload = raw[off + slen :]
            data = json.loads(payload) if plen else {}
            if not isinstance(data, dict):
                return None
            return Message(sender=sender, type=MsgType(mtype), data=data)
        except Exception:
            return None

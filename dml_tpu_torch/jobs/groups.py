"""Worker groups: tensor-parallel multi-chip serving wired into the
cluster pipeline.

The reference serves one whole model replica per VM (reference
models.py:26,51); pod-scale TPU serving shards a model over the ICI
domain of a *group* of chips and schedules the group as one worker
(Kumar et al., "Scale MLPerf-0.6 models on Google TPU-v3 Pods" — the
serving unit is the pod slice, not the host). This module teaches the
cluster scheduler that shape:

- **Topology** lives in the spec (`config.WorkerGroupSpec`): which
  nodes pool their chips into one dp×tp serving group. It is static
  configuration, like the node table itself — so every role
  (coordinator, promoted standby, worker) derives the identical group
  view from spec + SWIM liveness, and the view trivially survives
  leader failover with no relay protocol.
- **GroupDirectory** is that derivation: a formed group (every member
  alive and schedulable) collapses to ONE scheduler pool slot — the
  deterministic primary (first member by unique name) — carrying the
  group's aggregate capacity as a fair-share weight
  (`cost_model.fair_split_weighted`). Losing any member DEGRADES the
  group: the survivors return to the pool as ordinary single-chip
  workers, and the coordinator requeues the primary's in-flight
  batches (the ICI mesh those batches were running on no longer
  exists). A member coming back re-forms the group automatically.
- **Execution**: the group primary serves batches on a
  `parallel.inference.ShardedInference` built for the group mesh
  with ``param_gather=True`` — weights stay tp-sharded at rest but are
  all-gathered at forward entry, so group outputs are the one-device
  engine's, bit for bit. The port's mesh is one process per rank
  (`parallel.mesh`): a group mesh resolves over the ranks of the
  primary's group world (`parallel.group_world`: the primary is rank
  0, follower processes run its device calls; a world of 1 when none
  is open), where the JAX primary takes the host's devices. A mesh
  that needs more ranks than the world has raises at the first batch,
  never serving on one device in silence; a world that loses a rank
  makes the backend refuse its batches (`GroupDegraded`). Degradation mid-batch
  surfaces as `GroupDegraded`, riding the existing
  WORKER_TASK_FAIL -> requeue-at-front machinery; completion dedup in
  the scheduler keeps every acked batch counted exactly once no
  matter how the group reshuffles mid-job.
- **Observability**: ``jobs_group_*`` metrics (formed gauge, member
  liveness, degradation/reform counters, group-served batch counter),
  `JobService.group_stats()` in the CLI ``breakdown`` verb, and the
  ``cluster_sharded_serving`` bench section (`bench_sharded_serving`).

The port's copy of dml_tpu/jobs/groups.py. The module stays free of
torch at import time (the chaos/CLI stub paths build directories and
stub group backends without touching a device); the sharded backends
import it lazily.
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Any, Awaitable, Callable, Dict, Iterable, List, Optional, Set, Tuple

from ..config import ClusterSpec, WorkerGroupSpec
from ..observability import METRICS

log = logging.getLogger(__name__)

_M_FORMED = METRICS.gauge(
    "jobs_group_formed",
    "1 while every member of the group is alive and schedulable")
_M_ALIVE = METRICS.gauge(
    "jobs_group_members_alive", "live members of the group")
_M_DEGRADATIONS = METRICS.counter(
    "jobs_group_degradations_total",
    "times a formed group lost a member and fell back to single chips")
_M_REFORMS = METRICS.counter(
    "jobs_group_reforms_total",
    "times a degraded group re-formed (every member back alive)")
_M_GROUP_BATCHES = METRICS.counter(
    "jobs_group_batches_total",
    "batches served by a group's sharded engine, per group")
_M_GROUP_REQUEUES = METRICS.counter(
    "jobs_group_requeues_total",
    "primary in-flight batches requeued because the group degraded")
_M_GROUP_RESHAPES = METRICS.counter(
    "jobs_group_reshapes_total",
    "collapsed group re-formed to a different mesh shape "
    "(member loss, graceful leave, or absorbed joiner), per group")
_M_GROUP_RESHAPE_CHIPS = METRICS.gauge(
    "jobs_group_reshape_chips",
    "chips in the mesh a group is currently collapsed to "
    "(0 while not collapsed)")


def note_group_requeue(group: str) -> None:
    """Tick the degradation-requeue counter (called by the service
    when it requeues a degraded group primary's in-flight batch)."""
    _M_GROUP_REQUEUES.inc(group=group)


class GroupDegraded(RuntimeError):
    """A group member died out from under a sharded batch: the ICI
    mesh the batch was executing on no longer exists. Routed through
    the ordinary WORKER_TASK_FAIL -> requeue path."""


def reform_ladder(
    mesh, n_members: int, n_active: int
) -> Optional[Dict[str, int]]:
    """The best dp×tp(×pp) mesh `n_active` of `n_members` members
    still support — the adaptive re-formation rung a degraded group
    steps down to instead of collapsing all the way to single chips
    (MLPerf TPU-pod practice: re-forming to a different slice shape
    is an operation, not a failure mode).

    Chips-per-member comes from the configured mesh's total extent
    spread over the configured membership (a -1 axis fills to the
    member count). The ladder prefers, in order: the most usable
    chips, the widest surviving ``tp`` (weight shards stay as thin as
    the original layout budgeted per-chip HBM for), then the deepest
    surviving ``pp`` — with tp'/pp' restricted to divisors of the
    configured axes so re-sharding stays a pure re-grouping of the
    same parameter tree (which is what keeps outputs token/bitwise
    identical through ``param_gather`` re-sharding). Returns None
    when fewer than two members survive (single-chip fallback) or the
    group was never degraded."""
    if n_members <= 0 or n_active < 2 or n_active >= n_members:
        return None
    total = 1
    free = False
    for v in (mesh.dp, mesh.tp, mesh.pp):
        if v == -1:
            free = True
        else:
            total *= max(1, v)
    if free:
        total = max(total, n_members)
    cpm = max(1, total // n_members)
    usable = cpm * n_active
    tp0 = max(1, mesh.tp)
    pp0 = max(1, mesh.pp)
    tp_divs = [d for d in range(tp0, 0, -1) if tp0 % d == 0]
    pp_divs = [d for d in range(pp0, 0, -1) if pp0 % d == 0]
    for use in range(usable, 1, -1):
        for tp_ in tp_divs:
            for pp_ in pp_divs:
                if use % (tp_ * pp_) == 0:
                    return {"dp": use // (tp_ * pp_), "tp": tp_,
                            "pp": pp_}
    return None


class GroupDirectory:
    """The runtime group view every role derives from spec + liveness.

    Pure bookkeeping — no sockets, no devices. `collapse` is the one
    entry the scheduler path uses per round; `on_node_failed` is the
    SWIM-callback fast path (degrade NOW, don't wait a round);
    `observe_ack` folds worker-advertised capacity from task ACKs so
    a coordinator promoted mid-job still learns measured capacities.
    """

    def __init__(self, spec: ClusterSpec):
        self.spec = spec
        #: operator/bench kill switch: disabled => every node serves
        #: as its own single-chip worker (the reference shape)
        self.enabled = True
        # group -> capacity advertised in task ACKs (None until heard)
        self._observed: Dict[str, Dict[str, Any]] = {}
        self._formed_last: Dict[str, bool] = {
            g.name: False for g in spec.worker_groups
        }
        self.degradations: Dict[str, int] = {}
        self.reforms: Dict[str, int] = {}
        #: reform ladder kill switch: off => member loss falls all
        #: the way back to single chips (the pre-elastic behavior)
        self.reform_enabled = True
        self.reshapes: Dict[str, int] = {}
        # group -> the mesh shape it is currently collapsed to:
        # "full" (configured mesh, all members), a reform-ladder dict
        # {dp,tp,pp}, or None (not collapsed — degraded/withheld)
        self._shape_last: Dict[str, Any] = {}
        # group -> members serving the current collapsed shape
        self._active_last: Dict[str, Tuple[str, ...]] = {}
        # collapse memo: the collapse is a pure function of (pool,
        # active LM models, enabled-flag, ACK-observed capacities) —
        # all captured by the caller-provided cache key (the service
        # keys on the SWIM view epoch + election roles). Without it a
        # large cluster pays the O(groups×members) re-derivation every
        # scheduling tick even when nothing changed.
        self._collapse_key: Optional[Tuple] = None
        self._collapse_cached: Optional[
            Tuple[List[str], Dict[str, float]]
        ] = None

    # -- static topology ----------------------------------------------

    def has_groups(self) -> bool:
        return self.enabled and bool(self.spec.worker_groups)

    def members(self, name: str) -> Tuple[str, ...]:
        return self.spec.group_members_unique(name)

    def primary(self, name: str) -> Optional[str]:
        mem = self.members(name)
        return mem[0] if mem else None

    def group_of(self, uname: str) -> Optional[WorkerGroupSpec]:
        if not self.enabled:
            return None
        return self.spec.group_of_unique(uname)

    def capacity(self, name: str) -> float:
        """Fair-share weight of the formed group: the capacity its
        primary advertised in task ACKs when heard, else the chip-count
        prior (one chip per member)."""
        obs = self._observed.get(name, {}).get("capacity")
        if obs:
            return float(obs)
        return float(max(len(self.members(name)), 1))

    def lm_serves(self, name: str, model: str) -> bool:
        """True when group `name` declares `model` in its
        ``lm_models`` — its engine serves that LM weight-resident
        tp-sharded, so LM rounds may keep it collapsed."""
        g = next(
            (g for g in self.spec.worker_groups if g.name == name), None
        )
        return g is not None and model in g.lm_models

    def roles_of(self, name: str) -> Dict[str, str]:
        """Disaggregation role per member (unique name ->
        "prefill"|"decode"); empty when the group is not role-split."""
        return self.spec.group_roles_unique(name)

    # -- scheduler-facing view ----------------------------------------

    def collapse(
        self,
        pool: Iterable[str],
        lm_active: Iterable[str] = (),
        cache_key: Optional[Tuple] = None,
    ) -> Tuple[List[str], Dict[str, float]]:
        """Collapse formed groups inside an eligible worker pool.

        Returns ``(pool', weights)``: members of a FORMED group (all
        members present in `pool`) are replaced by their primary alone,
        weighted by the group capacity; members of a degraded group
        stay as individual weight-1 workers. Order of survivors is
        preserved. Also drives the formed/degraded edge metrics.

        `lm_active` names the round's active LM serving models (the
        register_lm set). A group collapses for the round only if it
        declares EVERY one of them in ``WorkerGroupSpec.lm_models`` —
        its engine serves them weight-resident tp-sharded
        (inference/lm_sharded.py). A group that does not withholds
        its members as single-chip slots for the round:
        collapsing would withdraw the lender and weight
        the primary at a capacity its engine never delivers for that
        model. Formed-state tracking (edges, gauges) is unaffected —
        LM-servability is a routing decision, not a liveness one.

        `cache_key` memoizes the derivation: when provided and equal
        to the previous call's key, the cached result returns without
        re-deriving (the service keys on the SWIM view epoch +
        election roles + the active-LM set, so large clusters stop
        paying O(groups×members) per scheduling tick). ACK-observed
        capacity changes invalidate the memo internally."""
        if cache_key is not None:
            full_key = (cache_key, self.enabled, tuple(sorted(lm_active)))
            if (
                self._collapse_key == full_key
                and self._collapse_cached is not None
            ):
                cached_pool, cached_w = self._collapse_cached
                return list(cached_pool), dict(cached_w)
        else:
            full_key = None
        pool = list(pool)
        if not self.has_groups():
            if full_key is not None:
                self._collapse_key = full_key
                self._collapse_cached = (list(pool), {})
            return pool, {}
        lm_set = set(lm_active)
        pool_set = set(pool)
        # formed-state of EVERY configured group, not just those with
        # a member in the pool: a group whose members are all alive
        # but ineligible (promoted to leader/standby) must show — and
        # count — a degradation edge, or breakdown/gauges report a
        # serving group that nothing can serve on
        formed_now: Dict[str, bool] = {}
        collapses: Dict[str, bool] = {}
        active_now: Dict[str, Tuple[str, ...]] = {}
        shape_now: Dict[str, Any] = {}
        for g in self.spec.worker_groups:
            mem = self.members(g.name)
            present = tuple(m for m in mem if m in pool_set)
            formed_now[g.name] = bool(mem) and len(present) == len(mem)
            # the shape is a pure function of spec + LIVENESS — never
            # of the round's LM set — so the bookkeeping (reshape
            # edges, active members, on_node_failed's requeue latch)
            # is identical no matter which caller derives it (the
            # lm-aware scheduling tick vs group_stats' lm-blind live
            # refresh); the LM gate applies only to the POOL output
            # below
            shape = None
            if formed_now[g.name]:
                shape = "full"
            elif (
                self.reform_enabled
                and mem
                and mem[0] in present  # the group engine lives on the
                # primary; losing it IS the single-chip fallback
            ):
                shape = reform_ladder(g.mesh, len(mem), len(present))
            if shape is not None:
                active_now[g.name] = present
            # pool gating: a FULL group collapses when it serves every
            # active LM model (the round-aware rule); a REFORMED
            # group serves image rounds only — resident-sharded LM
            # engines are fixed-mesh, so LM rounds keep the
            # single-chip slots
            if shape == "full":
                collapses[g.name] = (
                    not lm_set or lm_set <= set(g.lm_models)
                )
            else:
                collapses[g.name] = shape is not None and not lm_set
            shape_now[g.name] = shape
            _M_ALIVE.set(len(present), group=g.name)
        out: List[str] = []
        weights: Dict[str, float] = {}
        for w in pool:
            g = self.spec.group_of_unique(w)
            if g is None or not collapses[g.name]:
                out.append(w)  # ungrouped, degraded, or LM-withheld
            elif w == self.members(g.name)[0]:
                out.append(w)  # the group's one pool slot
                shape = shape_now[g.name]
                if shape == "full":
                    weights[w] = self.capacity(g.name)
                else:
                    # reformed: weight by the reform mesh's chip
                    # count — the survivors' actual strength, not the
                    # full group's ACK-advertised capacity
                    weights[w] = float(
                        shape["dp"] * shape["tp"] * shape["pp"]
                    )
            # collapsed lenders are pooled under the primary: no slot
        for name, formed in formed_now.items():
            self._note_edge(name, formed)
            self._note_shape(name, shape_now.get(name),
                             active_now.get(name, ()))
        if full_key is not None:
            # un-keyed calls (group_stats' live refresh) must not
            # clobber the scheduling tick's memo — they would force a
            # full re-derivation every tick whenever breakdown polls
            self._collapse_key = full_key
            self._collapse_cached = (list(out), dict(weights))
        return out, weights

    def role_in(self, pool: Iterable[str], uname: str) -> Optional[str]:
        """This node's serving role given an eligible pool: "primary"
        (serves on the group engine — at full strength or on a
        reform-ladder mesh), "lender" (chips pooled under the
        primary), "degraded" (group configured but neither formed nor
        reformable), or None (not in any group)."""
        g = self.group_of(uname)
        if g is None:
            return None
        mem = self.members(g.name)
        pool_set = set(pool)
        present = tuple(m for m in mem if m in pool_set)
        collapsed = bool(mem) and (
            len(present) == len(mem)
            or (
                self.reform_enabled
                and mem[0] in present
                and reform_ladder(g.mesh, len(mem), len(present))
                is not None
            )
        )
        if not collapsed or uname not in present:
            return "degraded"
        return "primary" if uname == mem[0] else "lender"

    def is_reformed(self, name: str) -> bool:
        """True while the group's last derived shape is a
        reform-ladder mesh rather than its full configured one.
        Observability surface (group_stats, tests): the memo behind
        it refreshes only on nodes that run the collapse, so ROUTING
        decisions must not read it — the service's per-batch LM gate
        (service._group_serves) derives full-strength liveness
        directly from spec + alive instead."""
        shape = self._shape_last.get(name)
        return shape is not None and shape != "full"

    def active_members(self, name: str) -> Tuple[str, ...]:
        """The members serving the group's current collapsed shape
        (empty while not collapsed)."""
        return self._active_last.get(name, ())

    # -- liveness edges -----------------------------------------------

    def _note_edge(self, name: str, formed: bool) -> None:
        last = self._formed_last.get(name)
        if formed and not last:
            if self.degradations.get(name):
                self.reforms[name] = self.reforms.get(name, 0) + 1
                _M_REFORMS.inc(group=name)
                log.info("group %s re-formed", name)
        elif last and not formed:
            self.degradations[name] = self.degradations.get(name, 0) + 1
            _M_DEGRADATIONS.inc(group=name)
            log.warning(
                "group %s lost full strength: the reform ladder "
                "re-shapes onto the survivors where it can, else "
                "serving falls back to single-chip engines", name,
            )
        self._formed_last[name] = formed
        _M_FORMED.set(1.0 if formed else 0.0, group=name)

    def _note_shape(self, name: str, shape: Any,
                    active: Tuple[str, ...]) -> None:
        """Track the mesh a group is collapsed to; a transition
        between two DIFFERENT collapsed shapes (full -> reformed,
        reformed -> smaller, reformed -> full) is a RESHAPE — the
        observable edge of adaptive re-formation."""
        last = self._shape_last.get(name)
        if shape is not None and last is not None and shape != last:
            self.reshapes[name] = self.reshapes.get(name, 0) + 1
            _M_GROUP_RESHAPES.inc(group=name)
            log.info(
                "group %s RESHAPED %s -> %s on members %s",
                name, last, shape, list(active),
            )
        self._shape_last[name] = shape
        self._active_last[name] = tuple(active)
        if shape == "full":
            g = next(
                (g for g in self.spec.worker_groups if g.name == name),
                None)
            chips = float(len(active)) if g is None else float(
                max(1, g.mesh.dp) * max(1, g.mesh.tp)
                * max(1, g.mesh.pp)
                if -1 not in (g.mesh.dp, g.mesh.tp, g.mesh.pp)
                else len(active))
        elif shape is not None:
            chips = float(shape["dp"] * shape["tp"] * shape["pp"])
        else:
            chips = 0.0
        _M_GROUP_RESHAPE_CHIPS.set(chips, group=name)

    def on_node_failed(self, uname: str) -> Optional[Tuple[str, str]]:
        """SWIM failure fast path: if the dead node belonged to a
        currently-collapsed group (full or reformed), note the edge
        NOW and return ``(group_name, primary)`` so the coordinator
        can requeue the primary's in-flight batches without waiting
        for the next scheduling round to notice — whatever mesh those
        batches were running on no longer exists either way."""
        g = self.group_of(uname)
        if g is None:
            return None
        active = self._active_last.get(g.name, ())
        was_formed = bool(self._formed_last.get(g.name))
        if was_formed:
            self._note_edge(g.name, False)
        if not was_formed and uname not in active:
            return None  # not serving a collapsed mesh: nothing to requeue
        if uname in active:
            # latch the death out of the active set so a repeated
            # callback for the same corpse doesn't requeue twice; the
            # next collapse derives the new shape (reform or fallback)
            self._active_last[g.name] = tuple(
                m for m in active if m != uname
            )
        return g.name, self.primary(g.name) or uname

    # -- ACK-advertised capacity --------------------------------------

    def observe_ack(self, sender: str, data: Dict[str, Any]) -> None:
        """Fold a worker task ACK's group advertisement (group name +
        capacity) into the directory. This is how a coordinator —
        including one promoted mid-job by a failover — learns measured
        group capacity without any dedicated protocol."""
        name = data.get("group")
        if not name:
            return
        try:
            cap = float(data.get("group_capacity") or 0.0)
        except (TypeError, ValueError):
            cap = 0.0
        prev = self._observed.get(name, {}).get("capacity")
        self._observed[name] = {
            "capacity": cap if cap > 0 else None,
            "size": data.get("group_size"),
            "sender": sender,
            "at": time.time(),
        }
        if self._observed[name]["capacity"] != prev:
            # capacity feeds the collapse weights: a changed advert
            # must invalidate the memoized collapse, whose cache key
            # (SWIM epoch + roles) cannot see it
            self._collapse_key = None

    # -- operator surface ---------------------------------------------

    def stats(self) -> Dict[str, Any]:
        """CLI `breakdown` topology line: per group, the configured
        members + mesh, the primary, formed-state, capacity in force,
        and the degradation/reform history."""
        out: Dict[str, Any] = {}
        for g in self.spec.worker_groups:
            mem = self.members(g.name)
            out[g.name] = {
                "members": list(mem),
                "primary": mem[0] if mem else None,
                "mesh": {"dp": g.mesh.dp, "tp": g.mesh.tp,
                         "pp": g.mesh.pp},
                "lm_models": list(g.lm_models),
                "roles": self.spec.group_roles_unique(g.name),
                "formed": bool(self._formed_last.get(g.name)),
                "capacity": self.capacity(g.name),
                "capacity_source": (
                    "ack" if self._observed.get(g.name, {}).get("capacity")
                    else "chip-count prior"
                ),
                "degradations": self.degradations.get(g.name, 0),
                "reforms": self.reforms.get(g.name, 0),
                # adaptive re-formation surface: the mesh the group is
                # collapsed to right now ("full" | {dp,tp,pp} | None),
                # who serves it, and how often the shape has changed
                "mesh_in_force": self._shape_last.get(g.name),
                "active_members": list(self._active_last.get(g.name, ())),
                "reshapes": self.reshapes.get(g.name, 0),
            }
        if not self.enabled and self.spec.worker_groups:
            out["_disabled"] = True
        return out


# ----------------------------------------------------------------------
# group inference backends
# ----------------------------------------------------------------------

#: (files_dict, exec_time_s, cost_constants_or_None) — the JobService
#: InferBackend contract (service.py)
_Backend = Callable[..., Awaitable[Tuple[Dict[str, Any], float, Optional[Dict[str, float]]]]]


def _check_members(
    group_name: str, members: Tuple[str, ...],
    alive_fn: Callable[[], Set[str]],
) -> None:
    alive = alive_fn()  # one snapshot: atomic view, not N rebuilds
    dead = [m for m in members if m not in alive]
    if dead:
        raise GroupDegraded(
            f"group {group_name} lost member(s) {dead}: the sharded "
            "mesh is gone; batch requeues onto the degraded pool"
        )


def stub_group_backend(
    group_name: str,
    members,
    alive_fn: Callable[[], Set[str]],
    per_file_s: float = 0.004,
    capacity: Optional[float] = None,
):
    """Deterministic group-engine stand-in for chaos/sim runs: the
    single-chip stub's latency divided by the group capacity
    (aggregate throughput), with member liveness checked before AND
    after the simulated device time — a member dying mid-batch breaks
    the mesh exactly like real ICI loss, surfacing `GroupDegraded`.

    Reform-aware: the batch serves on the ACTIVE member set (members
    ∩ alive — the same spec+liveness derivation the coordinator's
    reform ladder uses), scaling throughput to the survivors; the set
    CHANGING across the batch raises `GroupDegraded` (the mesh the
    batch was running on is gone, whichever direction it changed).
    Fewer than two live members = no sharded mesh at all. `members`
    may be a callable so elastic membership (leave strips members,
    joins absorb) is re-read per batch, matching the spec-derived
    coordinator view."""
    members_fn = members if callable(members) else (lambda: members)

    def _active() -> Tuple[str, ...]:
        alive = alive_fn()
        return tuple(m for m in members_fn() if m in alive)

    async def backend(model: str, paths: List[str]):
        mem = members_fn()
        active = _active()
        if len(active) < min(2, len(mem)):
            dead = [m for m in mem if m not in active]
            raise GroupDegraded(
                f"group {group_name} lost member(s) {dead}: "
                f"{len(active)} left — no sharded mesh; batch "
                "requeues onto the pool"
            )
        cap = float(
            capacity if capacity is not None else max(len(active), 1)
        )
        backend.capacity = cap
        exec_time = per_file_s * max(1, len(paths)) / cap
        await asyncio.sleep(exec_time)
        if _active() != active:
            raise GroupDegraded(
                f"group {group_name} membership changed mid-batch "
                f"({list(active)} -> {list(_active())}): the mesh the "
                "batch ran on is gone; batch requeues"
            )
        results = {p: [{"label": model, "score": 1.0}] for p in paths}
        _M_GROUP_BATCHES.inc(group=group_name)
        return results, exec_time, None

    backend.capacity = float(
        capacity if capacity is not None
        else max(len(members_fn()), 1)
    )
    backend.group_name = group_name
    # the stub echoes whatever model it is asked for, so it serves any
    # (the real sharded_backend pins `model` to its compiled engine)
    backend.model = None
    return backend


def _sharded_run(si, paths: List[str], size: Tuple[int, int]):
    """Decode -> sharded forward -> engine-shaped top-5 rows: the one
    execution body both group backends share (thread context). The
    result-dict shape is the service's re-key contract — keep it in
    exactly one place."""
    from ..models.labels import decode_predictions
    from ..models.preprocess import load_images

    t0 = time.monotonic()
    imgs = load_images(list(paths), size)
    probs = si(imgs)
    infer_time = time.monotonic() - t0
    top5 = decode_predictions(probs)
    return {
        p: [
            {"wnid": w, "label": lbl, "score": s}
            for (w, lbl, s) in t
        ]
        for p, t in zip(paths, top5)
    }, infer_time


def sharded_backend(
    si,  # parallel.inference.ShardedInference
    *,
    group_name: Optional[str] = None,
    members: Tuple[str, ...] = (),
    alive_fn: Optional[Callable[[], Set[str]]] = None,
    input_size: Optional[Tuple[int, int]] = None,
):
    """JobService `InferBackend` over a `ShardedInference`: decode the
    batch's images, run the mesh-sharded forward, emit the engine-shaped
    top-5 result rows. With ``param_gather=True`` meshes the rows are
    bitwise-identical to the single-device path (same decode, same
    program, same float serialization).

    `input_size` overrides the model's native decode size (tiny shapes
    for dryruns/tests). When `members`/`alive_fn` are given, member
    liveness is checked around the device call so a mid-batch group
    degradation raises `GroupDegraded` instead of acking a result the
    broken mesh could not actually have produced."""
    # a one-rank mesh resolves to None (the one-device program)
    mesh_shape = dict(si.mesh.shape) if si.mesh is not None else {}
    cap = float(mesh_shape.get("dp", 1) * mesh_shape.get("tp", 1))
    size = tuple(input_size or si.spec.input_size)

    def _check() -> None:
        if members and alive_fn is not None:
            _check_members(group_name or "?", members, alive_fn)

    async def backend(model: str, paths: List[str]):
        from ..parallel import group_world

        _check()
        group_world.refuse(backend, si)
        try:
            results, infer_time = await asyncio.to_thread(
                _sharded_run, si, paths, size
            )
        except Exception as e:
            group_world.refuse(backend, si, e)  # a lost rank: GroupDegraded
            raise
        _check()
        if group_name:
            _M_GROUP_BATCHES.inc(group=group_name)
        return results, infer_time, None

    backend.capacity = cap
    backend.group_name = group_name
    # one ShardedInference serves exactly one model: the service must
    # route only this model's batches here (anything else would run
    # the wrong forward and ack wrong predictions under the job)
    backend.model = si.spec.name
    return backend


def group_ranks(group_name: str, use_mesh) -> Optional[range]:
    """The ranks a group mesh takes: a fully-specified mesh takes its
    size off the front of the process's torch.distributed world
    (``range(want)``, the counterpart of the JAX primary's
    ``jax.devices()[:want]``): a group primary's world when one is open
    (`parallel.group_world`: rank 0 and its followers), 1 without one;
    a -1 axis fills with the whole world (None). Raises RuntimeError when the world is smaller than the mesh
    — a group that served on fewer chips while the pool weighted it at
    group capacity would be slower than no groups at all."""
    from ..parallel.mesh import _world

    world = _world()
    sizes = (use_mesh.dp, use_mesh.tp, use_mesh.sp,
             use_mesh.pp, use_mesh.ep)
    if -1 in sizes:
        return None
    want = 1
    for s in sizes:
        want *= s
    if world < want:
        raise RuntimeError(
            f"group {group_name} mesh needs {want} "
            f"ranks, host sees {world}"
        )
    return range(want)


def group_engine_backend(
    group_name: str,
    members,
    alive_fn: Callable[[], Set[str]],
    mesh_spec,  # config.MeshSpec — the group's dp×tp layout
    batch_size: int = 32,
    seed: int = 0,
    device=None,
):
    """The production group engine for CLI/NodeApp primaries: a lazy
    MULTI-model sharded backend. On the first batch of each model it
    builds (and caches) a ``param_gather=True`` `ShardedInference`
    over the group mesh resolved from the group world (`group_ranks`;
    built through the primary's world when one is open, so its
    follower ranks serve each batch with it), on `device` (`cuda` when None; it raises where
    there is none), so any registry CNN serves sharded without
    per-model wiring (``backend.model = None`` — the service routes
    every non-LM model here). Weights init seed-deterministically (like
    `LMBackend.from_spec`), so a rebuilt/restarted primary serves the
    identical function until explicit weights arrive; published
    weights flow through the ordinary load-model path — the service
    calls ``backend.set_variables(model, tree)`` after a
    `load_model_weights`, which rebuilds that model's group engine on
    the fetched tree (group-served and single-chip answers must come
    from the same weights, or formation state would change what a
    query returns). `backend.capacity` starts at the chip-count prior
    and updates to the resolved mesh size after the first build —
    task ACKs read it per batch, so the fair-share weight
    self-corrects.

    Without this, a spec-configured group on a plain CLI node would
    COLLAPSE the pool (lenders withdrawn, primary weighted at group
    capacity) while the primary still served single-chip — less
    throughput than no groups at all.

    Reform-aware: each batch derives the ACTIVE member set (members ∩
    alive, same derivation as the coordinator's reform ladder) and
    builds/caches one engine per (model, reformed mesh). The
    variables tree is identical across shapes (seed-deterministic, or
    the one operator-loaded tree), so ``param_gather`` keeps reformed
    outputs bitwise-equal to the full-mesh — and single-device — path;
    re-sharding changes WHERE weight shards live, never the math."""
    from ..config import MeshSpec

    members_fn = members if callable(members) else (lambda: members)
    cache: Dict[Tuple[str, Tuple[int, int, int]], Any] = {}
    explicit: Dict[str, Any] = {}  # model -> operator-loaded tree
    retired: List[Any] = []  # engines replaced by set_variables

    def _mesh_for(n_active: int, n_members: int):
        """The mesh to serve on at this strength: the configured
        layout at full membership, the reform-ladder rung otherwise
        (None = no viable sharded mesh)."""
        if n_active >= n_members:
            return mesh_spec
        rung = reform_ladder(mesh_spec, n_members, n_active)
        if rung is None:
            return None
        return MeshSpec(dp=rung["dp"], tp=rung["tp"], pp=rung["pp"])

    def _build(model: str, use_mesh):
        from ..parallel import group_world
        from ..parallel.inference import ShardedInference
        from ..parallel.mesh import make_mesh

        # through the primary's group world when one is open: every
        # rank builds the mesh (collective) and its copy of the engine
        mesh = group_world.build(
            make_mesh, use_mesh, ranks=group_ranks(group_name, use_mesh))
        si = group_world.build(
            ShardedInference, model, mesh, batch_size=batch_size,
            seed=seed, variables=explicit.get(model), param_gather=True,
            device=device,
        )
        cache[(model, (use_mesh.dp, use_mesh.tp, use_mesh.pp))] = si
        backend.capacity = float(
            mesh.shape.get("dp", 1) * mesh.shape.get("tp", 1)
        )
        return si

    async def backend(model: str, paths: List[str]):
        from ..parallel import group_world

        group_world.refuse(backend)
        mem = members_fn()
        alive = alive_fn()
        active = tuple(m for m in mem if m in alive)
        use_mesh = _mesh_for(len(active), max(len(mem), 1))
        if use_mesh is None:
            raise GroupDegraded(
                f"group {group_name} has {len(active)} live "
                "member(s): no sharded mesh; batch requeues"
            )

        def run():
            from ..parallel import group_world

            while retired:
                group_world.drop(retired.pop())
            key = (model, (use_mesh.dp, use_mesh.tp, use_mesh.pp))
            si = cache.get(key) or _build(model, use_mesh)
            return _sharded_run(si, paths, si.spec.input_size)

        try:
            results, infer_time = await asyncio.to_thread(run)
        except Exception as e:
            group_world.refuse(backend, cause=e)  # a lost rank: GroupDegraded
            raise
        now_active = tuple(m for m in members_fn() if m in alive_fn())
        if now_active != active:
            raise GroupDegraded(
                f"group {group_name} membership changed mid-batch: "
                "the mesh the batch ran on is gone; batch requeues"
            )
        _M_GROUP_BATCHES.inc(group=group_name)
        return results, infer_time, None

    def set_variables(model: str, variables: Any) -> None:
        """Adopt operator-loaded weights (load-model): drop the cached
        engines (every shape) so the next batch rebuilds on this tree."""
        explicit[model] = variables
        for key in [k for k in cache if k[0] == model]:
            # forgotten on every rank by the next batch's thread (a
            # world call can wait for a running batch: not on the loop)
            retired.append(cache.pop(key))

    backend.capacity = float(max(len(members_fn()), 1))
    backend.group_name = group_name
    backend.model = None  # lazy per-model engines: serves any CNN
    backend.set_variables = set_variables
    backend.engines = cache  # (model, (dp, tp, pp)) -> ShardedInference
    return backend


def wire_group_backend(node, device=None) -> Optional[Any]:
    """Give a production node its group engine IF it is the primary
    of a configured worker group (CLI/NodeApp path): lenders and
    ungrouped nodes get None and serve single-chip. Membership is
    re-read from the spec per batch — elastic joins/leaves re-shape
    the group under a running engine. The engine runs on `device`
    (`cuda` when None)."""
    spec = node.spec
    uname = node.me.unique_name
    g = spec.group_of_unique(uname)
    if g is None:
        return None
    members = spec.group_members_unique(g.name)
    if not members or uname != members[0]:
        return None
    return group_engine_backend(
        g.name,
        lambda: spec.group_members_unique(g.name),
        lambda: {n.unique_name for n in node.membership.alive_nodes()},
        g.mesh,
        device=device,
    )


# ----------------------------------------------------------------------
# bench: sharded cluster serving on a group world
# (`python -m dml_tpu_torch.jobs.groups`: this process runs the cluster
# and is rank 0 of the group's world; its follower rank is a `node
# --follow` process)
# ----------------------------------------------------------------------


def bench_sharded_serving(
    n_queries: int = 64,
    n_files: int = 16,
    base_port: int = 28941,
    image_size: Tuple[int, int] = (64, 64),
    batch: int = 8,
    model: str = "ResNet50",
    tmp: Optional[str] = None,
    device=None,
    stats: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    """End-to-end sharded cluster serving vs the single-chip pipeline.

    Stands up the SAME `chaos.LocalCluster` chassis the soaks
    validate — 5 nodes, H4+H5 pooled into one dp=1×tp=2 group whose
    primary serves on a ``param_gather`` ShardedInference — serves an
    image job through the full store/scheduler/ACK pipeline, then
    disables grouping and serves the identical job on single chips.
    Records q/s both ways, the group topology in force, and the
    output-equality flag (merged job outputs must match KEY FOR KEY,
    BIT FOR BIT — the param_gather contract). float32 so the equality
    claim is about reduction order, not dtype noise.

    The port's tp-2 group is a group world (`parallel.group_world`):
    this process, which runs the cluster, is rank 0 and H4's engine
    runs on it and on one follower rank, a `node --follow 1` process
    this bench starts, with the rendezvous under `tmp` (a fresh
    directory under the system's temporary root when None). Engines run
    on `device` (cuda when None; it raises where there is none); two
    ranks on one card exchange through the host (gloo). `stats`, when
    given, receives the world's (`World.stats()`: calls, bytes, host
    seconds of its broadcasts and of the calls they carried)."""
    import os
    import shutil
    import tempfile

    import numpy as np
    import torch

    from ..cluster.chaos import LocalCluster
    from ..config import ClusterSpec, MeshSpec, Timing, WorkerGroupSpec
    from ..models.lm_params import resolve_device
    from ..parallel import group_world
    from ..parallel.inference import ShardedInference
    from ..parallel.mesh import make_mesh
    from .service import JobService

    dev = resolve_device(device)
    tmp = tmp or os.path.join(tempfile.gettempdir(), "dml_tpu_torch_bench_sharded")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp, exist_ok=True)
    group = WorkerGroupSpec("tp0", ("H4", "H5"), MeshSpec(dp=1, tp=2))
    spec = ClusterSpec.localhost(5, base_port=base_port, worker_groups=[group])
    with group_world.local_world(spec, "H4", os.path.join(tmp, "world"), device=dev) as world:
        mesh_group = group_world.build(make_mesh, MeshSpec(dp=1, tp=2), ranks=range(2))
        # every rank inits the same seeded tree; the one-device engine
        # (no mesh: this process alone) takes it too
        si_group = group_world.build(
            ShardedInference, model, mesh_group, batch_size=batch, seed=0,
            dtype=torch.float32, param_gather=True, device=dev,
        )
        si_one = ShardedInference(
            model, None, batch_size=batch, seed=0, dtype=torch.float32, device=dev,
        )
        # pay both first calls BEFORE the timed serves: the q/s ratio must
        # compare serving, not who ate the warmup (cuDNN's algorithm
        # choice, the gloo pairs' first exchange)
        warm = np.zeros((1, *image_size, 3), np.uint8)
        si_group(warm)
        si_one(warm)

        async def run() -> Dict[str, Any]:
            root = os.path.join(tmp, "cluster")
            os.makedirs(root, exist_ok=True)
            cluster = LocalCluster(
                5, root, base_port,
                timing=Timing(ping_interval=0.2, ack_timeout=0.3,
                              cleanup_time=1.0, leader_rpc_timeout=10.0),
                worker_groups=[group],
                make_jobs=lambda node, store: _make_sharded_jobs(
                    node, store, JobService, si_group, si_one, group,
                    image_size, model, batch,
                ),
            )
            try:
                await cluster.start()
                await cluster.wait_for(
                    cluster.converged, 20.0, "sharded bench convergence"
                )
                stack = [sn for _, sn in sorted(cluster.nodes.items())]
                client = stack[-1]
                from PIL import Image

                rng = np.random.RandomState(0)
                for i in range(n_files):
                    p = os.path.join(root, f"img_{i}.jpeg")
                    Image.fromarray(
                        rng.randint(0, 255, (96, 96, 3), np.uint8)
                    ).save(p)
                    await client.store.put(p, f"img_{i}.jpeg")

                async def timed_job() -> Tuple[float, Dict[str, Any]]:
                    t0 = time.monotonic()
                    job_id = await client.jobs.submit_job(model, n_queries)
                    done = await client.jobs.wait_job(job_id, timeout=600.0)
                    wall = time.monotonic() - t0
                    assert done["total_queries"] == n_queries
                    merged = await client.jobs.get_output(
                        job_id, os.path.join(root, f"out_{job_id}.json")
                    )
                    return wall, merged

                wall_g, merged_g = await timed_job()
                leader = next(sn for sn in stack if sn.node.is_leader)
                group_stats = leader.jobs.group_stats()
                for sn in stack:
                    sn.jobs.groups.enabled = False
                wall_s, merged_s = await timed_job()
                equal = merged_g == merged_s and bool(merged_g)
                return {
                    "nodes": 5,
                    "queries": n_queries,
                    "model": model,
                    "image_size": list(image_size),
                    "groups": {
                        name: g for name, g in group_stats.items()
                        if isinstance(g, dict)
                    },
                    "qps_sharded": round(n_queries / wall_g, 1),
                    "qps_single_chip": round(n_queries / wall_s, 1),
                    "sharded_vs_single": round(wall_s / wall_g, 2),
                    "equal_outputs": equal,
                    "outputs_compared": len(merged_g),
                    "note": "a group world of two ranks on one host: the "
                            "equality flag is the product claim — "
                            "param_gather tp keeps group outputs "
                            "bit-identical to single-chip — while the q/s "
                            "ratio times the world's host-staged gloo "
                            "exchange, not an interconnect",
                }
            finally:
                await cluster.stop()

        result = asyncio.run(run())
        if stats is not None:
            stats.update(world.stats(), device=str(dev))
    return result


def _make_sharded_jobs(
    node, store, JobService, si_group, si_one, group: WorkerGroupSpec,
    image_size, model: str, batch: int,
):
    """Per-node JobService for the sharded bench/dryrun cluster: every
    node can serve single-chip batches on the 1-device engine; the
    group primary additionally carries the group's sharded engine."""
    uname = node.me.unique_name
    alive = lambda: {  # noqa: E731
        n.unique_name for n in node.membership.alive_nodes()
    }
    members = node.spec.group_members_unique(group.name)
    single = sharded_backend(si_one, input_size=image_size)
    gb = None
    if members and uname == members[0]:
        gb = sharded_backend(
            si_group, group_name=group.name, members=members,
            alive_fn=alive, input_size=image_size,
        )
    js = JobService(node, store, infer_backend=single, group_backend=gb)
    js.scheduler.set_batch_size(model, batch)
    return js


def _main(argv: Optional[List[str]] = None) -> None:  # pragma: no cover - bench entry
    """`python -m dml_tpu_torch.jobs.groups [options]`: one JSON line,
    `bench_sharded_serving` at JAX's defaults unless the options say
    otherwise (cuda unless --device cpu)."""
    import argparse
    import json

    p = argparse.ArgumentParser(prog="python -m dml_tpu_torch.jobs.groups")
    p.add_argument("--n-queries", type=int, default=64)
    p.add_argument("--n-files", type=int, default=16)
    p.add_argument("--base-port", type=int, default=28941)
    p.add_argument("--image-size", type=int, nargs=2, default=(64, 64))
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--tmp", default=None)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--world-stats", default=None, metavar="PATH",
                   help="write the group world's stats there (JSON)")
    a = p.parse_args(argv)
    stats: Dict[str, Any] = {}
    print(json.dumps(bench_sharded_serving(
        n_queries=a.n_queries, n_files=a.n_files, base_port=a.base_port,
        image_size=tuple(a.image_size), batch=a.batch, tmp=a.tmp,
        device=a.device, stats=stats), default=str), flush=True)
    if a.world_stats:
        with open(a.world_stats, "w") as f:
            json.dump(stats, f)


if __name__ == "__main__":  # pragma: no cover
    _main()

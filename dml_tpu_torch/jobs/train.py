"""TrainJob: elastic data-parallel training as a first-class cluster
workload (ROADMAP item 3).

The cluster's scheduler so far moved inference batches only; the
`parallel/` package had the dp/tp step machinery, atomic checkpoints,
and a data loader but ran single-node, outside the cluster. This
module closes the gap: a **TrainJob** is a leader-coordinated training
run whose every *global step* is one scheduler job — `world` batches
of `shard_batch` input files each, fanned across the worker pool by
the same fair-share machinery that serves inference (SLO class
``train``, weight below ``batch``, so interactive p99 stays protected
while the trainer soaks idle slots).

The replicated store is both substrates at once:

- **dataset substrate** — each step's shard files are ordinary store
  objects the executing workers fetch over the data plane (replica
  fallback, version pinning, the works);
- **checkpoint substrate** — the coordinator PUTs a versioned
  checkpoint blob (`train_ckpt_<run>`) through the atomic PUT path,
  so a promoted leader adopts unfinished runs from the store exactly
  like `restore-jobs` adopts queues.

Step-exact accounting: the leader keeps a **monotone step ledger**;
a step is applied exactly once, in order. Duplicate completions (a
replayed ACK, a shadow job double-completed across a failover) are
*refused* by the ledger — the training analog of the batch-completion
dedup in `_h_task_ack`. The gradient math is deterministic (each
shard file's gradient is derived from its sdfs name), so
`replay_reference` can recompute the final parameter state from the
ledger history alone; the chaos invariant sweep uses that as its
no-step-lost / no-step-double-applied oracle.

Elasticity (MLPerf TPU-pod scaling, arxiv 1909.09756: reshape as a
first-class operation): at every step boundary the coordinator
compares the live worker pool and universe epoch against the run's
current world size. A change (join, graceful LEAVE, failure) triggers
checkpoint → restore → re-shard: the next step is dispatched at the
new world size with the learning rate rescaled linearly to the new
effective global batch (arxiv 1711.04325), and the reason is recorded
both in the ledger history and the `train_resharding_total{reason=}`
counter.
"""

from __future__ import annotations

import asyncio
import hashlib
import json
import logging
import os
import re
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from ..observability import METRICS
from .cost_model import ModelCost

log = logging.getLogger("dml_tpu_torch.jobs.train")

# The trainer is registered as a model like any other servable: the
# scheduler, relay, requeue, and completion-dedup paths need nothing
# new to move its batches.
TRAIN_MODEL = "cluster-trainer"
TRAIN_SLO_CLASS = "train"
TRAIN_CKPT_PREFIX = "train_ckpt_"
TRAIN_GRAD_DIM = 4
# requester-string tag: survives the submit relay, so a coordinator
# promoted mid-step can still attribute the shadow job's completion
# to (run, step, world, lr) without any new wire type
_REQ_TAG = "train:"

_M_STEPS = METRICS.counter(
    "train_steps_total", "global training steps applied exactly once"
)
_M_RESHARD = METRICS.counter(
    "train_resharding_total",
    "checkpoint-restore re-shards of a training run, per reason= "
    "(join / leave / failure / adopt)",
)
_M_STEP_WALL = METRICS.histogram(
    "train_step_wall_seconds",
    "dispatch-to-applied wall time of one global training step",
)
_M_EFF_BATCH = METRICS.gauge(
    "train_effective_batch",
    "current effective global batch (shard_batch x world) per run=",
)


# ----------------------------------------------------------------------
# spec + deterministic training math
# ----------------------------------------------------------------------


@dataclass
class TrainJobSpec:
    """Everything a run needs, serializable into the checkpoint blob
    so an adopting coordinator reconstructs the run bit-for-bit."""

    name: str
    dataset: List[str]  # sdfs names of the sharded input files
    steps: int = 16
    shard_batch: int = 2  # files per dp shard per step (fixed)
    base_lr: float = 0.1  # LR at world == base_world
    base_world: int = 1
    grad_dim: int = TRAIN_GRAD_DIM
    seed: int = 0
    checkpoint_every: int = 5  # periodic checkpoint cadence (steps)
    # floor on per-step wall (coordinator paces dispatch): chaos runs
    # use it so a run reliably spans the event schedule
    min_step_s: float = 0.0

    def to_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name, "dataset": list(self.dataset),
            "steps": self.steps, "shard_batch": self.shard_batch,
            "base_lr": self.base_lr, "base_world": self.base_world,
            "grad_dim": self.grad_dim, "seed": self.seed,
            "checkpoint_every": self.checkpoint_every,
            "min_step_s": self.min_step_s,
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "TrainJobSpec":
        return cls(
            name=str(d["name"]), dataset=[str(f) for f in d["dataset"]],
            steps=int(d["steps"]), shard_batch=int(d["shard_batch"]),
            base_lr=float(d["base_lr"]),
            base_world=int(d.get("base_world", 1)),
            grad_dim=int(d.get("grad_dim", TRAIN_GRAD_DIM)),
            seed=int(d.get("seed", 0)),
            checkpoint_every=int(d.get("checkpoint_every", 5)),
            min_step_s=float(d.get("min_step_s", 0.0)),
        )


def lr_for(spec: TrainJobSpec, world: int) -> float:
    """Linear LR scaling with the effective global batch
    (arxiv 1711.04325): per-shard batch is fixed, so scaling is by
    world size relative to the spec's base world."""
    return spec.base_lr * (max(1, world) / max(1, spec.base_world))


def shard_files(spec: TrainJobSpec, step: int, world: int) -> List[str]:
    """The step's global batch: ``shard_batch * world`` dataset files,
    drawn deterministically from (spec.seed, step) via a per-step
    shuffled permutation cycle — every re-dispatch, shadow replay, and
    `replay_reference` pass sees the identical ordered list."""
    import random

    n = len(spec.dataset)
    if n == 0:
        raise ValueError(f"train run {spec.name}: empty dataset")
    need = spec.shard_batch * max(1, world)
    rng = random.Random((spec.seed * 1_000_003 + step) & 0x7FFFFFFF)
    perm = list(range(n))
    rng.shuffle(perm)
    return [spec.dataset[perm[i % n]] for i in range(need)]


def grad_for(sdfs_name: str, dim: int = TRAIN_GRAD_DIM) -> List[float]:
    """Deterministic per-file gradient, derived from the sdfs name's
    sha256 — the property the exactly-once oracle rests on: any node,
    any time, recomputes the same vector."""
    h = hashlib.sha256(sdfs_name.encode()).digest()
    return [
        int.from_bytes(h[4 * i: 4 * i + 4], "big") / 2.0**31 - 1.0
        for i in range(dim)
    ]


def apply_step(
    state: List[float], files: List[str], lr: float,
    dim: int = TRAIN_GRAD_DIM,
) -> List[float]:
    """SGD on the toy objective: subtract lr * mean(per-file grads),
    in the files' listed order — fixed op order means bitwise-equal
    floats between the live run and `replay_reference`."""
    acc = [0.0] * dim
    for f in files:
        g = grad_for(f, dim)
        for j in range(dim):
            acc[j] += g[j]
    n = max(1, len(files))
    return [state[j] - lr * (acc[j] / n) for j in range(dim)]


def replay_reference(
    spec: TrainJobSpec, history: List[Dict[str, Any]]
) -> List[float]:
    """Recompute the final parameter state from the ledger history
    alone. Equality with the live run's state proves every recorded
    step was applied exactly once with the recorded (world, lr)."""
    state = [0.0] * spec.grad_dim
    for e in history:
        files = shard_files(spec, int(e["step"]), int(e["world"]))
        state = apply_step(state, files, float(e["lr"]), spec.grad_dim)
    return state


def recover_sdfs_name(local_path: str) -> str:
    """Invert the worker's fetch-cache naming. Both fetch paths'
    version suffixes are handled (replica pre-fetch names the local
    copy ``name_versionN``, the data-plane download ``name.vN`` —
    service.py's to_sdfs re-key comment). Train file names carry no
    '/', so the replace in those schemes is a no-op for them."""
    base = os.path.basename(local_path)
    return re.sub(r"(\.v|_version)(\d+|latest)$", "", base)


def train_backend(
    dim: int = TRAIN_GRAD_DIM, per_file_s: float = 0.02
) -> Any:
    """The worker-side shard executor, registered as an ordinary
    inference backend: computes each fetched file's gradient and
    returns it as that file's inline result. Deterministic, jax-free
    (the cluster machinery is what's under test), with a real per-file
    cost so data-parallel speedup is measurable end-to-end."""

    async def backend(model: str, paths: List[str]):
        t0 = time.monotonic()
        await asyncio.sleep(per_file_s * max(1, len(paths)))
        results = {
            p: grad_for(recover_sdfs_name(p), dim) for p in paths
        }
        return results, time.monotonic() - t0, None

    return backend


# ----------------------------------------------------------------------
# step ledger
# ----------------------------------------------------------------------


class StepLedger:
    """Monotone exactly-once accounting for global steps. ``applied``
    is the count of applied steps (== the next expected step id);
    `record` accepts only that step, `refuse` counts everything else —
    duplicates from replayed ACKs / shadow double-completions, and
    out-of-order completions racing an adoption from an older
    checkpoint."""

    def __init__(self) -> None:
        self.applied = 0
        self.history: List[Dict[str, Any]] = []
        self.duplicates_refused = 0
        self.out_of_order_refused = 0

    def next_step(self) -> int:
        return self.applied

    def record(self, step: int, world: int, lr: float, reason: str) -> None:
        if step != self.applied:
            raise ValueError(
                f"ledger: step {step} is not next (applied={self.applied})"
            )
        self.history.append(
            {"step": step, "world": world, "lr": lr, "reason": reason}
        )
        self.applied += 1

    def refuse(self, step: int) -> str:
        """Classify + count a non-next completion. Returns the kind."""
        if step < self.applied:
            self.duplicates_refused += 1
            return "duplicate"
        self.out_of_order_refused += 1
        return "out_of_order"

    def snapshot(self) -> Dict[str, Any]:
        return {
            "applied": self.applied,
            "history": [dict(e) for e in self.history],
            "duplicates_refused": self.duplicates_refused,
            "out_of_order_refused": self.out_of_order_refused,
        }

    @classmethod
    def restore(cls, d: Dict[str, Any]) -> "StepLedger":
        led = cls()
        led.applied = int(d["applied"])
        led.history = [dict(e) for e in d.get("history", [])]
        led.duplicates_refused = int(d.get("duplicates_refused", 0))
        led.out_of_order_refused = int(d.get("out_of_order_refused", 0))
        if len(led.history) != led.applied:
            raise ValueError(
                f"ledger restore: applied={led.applied} but "
                f"history has {len(led.history)} entries"
            )
        return led


@dataclass
class TrainRun:
    """Coordinator-side state of one training run."""

    spec: TrainJobSpec
    state: List[float]
    ledger: StepLedger
    world: int
    lr: float
    done: bool = False
    # in-flight step job dispatched by THIS coordinator incarnation
    # (an adopted run starts with none; a shadow job completing for it
    # is attributed via the requester tag instead)
    inflight_job: Optional[int] = None
    dispatch_t0: float = 0.0
    epoch_seen: int = -1  # universe epoch at the last dispatch
    resharding: Dict[str, int] = field(default_factory=dict)
    grad_mismatches: int = 0
    redispatches: int = 0
    ckpt_puts: int = 0
    lock: asyncio.Lock = field(default_factory=asyncio.Lock)
    done_event: asyncio.Event = field(default_factory=asyncio.Event)

    def effective_batch(self) -> int:
        return self.spec.shard_batch * self.world

    def status(self) -> Dict[str, Any]:
        return {
            "name": self.spec.name,
            "done": self.done,
            "applied": self.ledger.applied,
            "steps": self.spec.steps,
            "world": self.world,
            "lr": self.lr,
            "effective_batch": self.effective_batch(),
            "resharding": dict(self.resharding),
            "duplicates_refused": self.ledger.duplicates_refused,
            "out_of_order_refused": self.ledger.out_of_order_refused,
            "grad_mismatches": self.grad_mismatches,
            "redispatches": self.redispatches,
            "ckpt_puts": self.ckpt_puts,
        }


# ----------------------------------------------------------------------
# coordinator
# ----------------------------------------------------------------------


class TrainCoordinator:
    """Leader-resident driver for training runs, attached to the
    JobService like the signal plane and the autoscaler: constructed
    on every node (so the trainer backend is registered everywhere —
    restarts and joiners can execute shards immediately), but it
    *drives* runs only while this node leads. Adoption of unfinished
    runs after a failover happens from the store's checkpoint blobs,
    scanned by the tick loop."""

    def __init__(self, node: Any, jobs: Any) -> None:
        self.node = node
        self.jobs = jobs
        self.runs: Dict[str, TrainRun] = {}
        self._tick_task: Optional[asyncio.Task] = None
        self._last_scan = 0.0
        jobs.register_lm(
            TRAIN_MODEL,
            backend=train_backend(),
            cost=ModelCost(
                load_time=0.0, first_query=0.02, per_query=0.02,
                batch_size=4,
            ),
            patterns=("train_shard_*",),
        )
        # fair-share weight for the train class: below batch (1.0),
        # far below interactive (3.0) — the trainer soaks idle slots
        jobs.scheduler.class_weights[TRAIN_SLO_CLASS] = float(
            getattr(node.spec, "train_class_weight", 0.5)
        )
        jobs.on_job_done_cbs.append(self._on_job_done)

    # -- lifecycle ------------------------------------------------------

    def start(self) -> None:
        if self._tick_task is None:
            self._tick_task = asyncio.create_task(
                self._tick_loop(), name=f"{self._me}-train-tick"
            )

    async def stop(self) -> None:
        from ..cluster.util import reap_task

        t = self._tick_task
        self._tick_task = None
        await reap_task(t, self.node.me, "train tick loop")

    @property
    def _me(self) -> str:
        return self.node.me.unique_name

    # -- run intake -----------------------------------------------------

    async def start_run(self, spec: TrainJobSpec) -> TrainRun:
        """Begin a run on the current coordinator. Checkpoints the
        step-0 state BEFORE the first dispatch so a leader lost at any
        point afterward leaves an adoptable blob in the store."""
        if not self.node.is_leader:
            raise RuntimeError("start_run runs on the coordinator")
        if spec.name in self.runs:
            raise ValueError(f"train run {spec.name} already exists")
        world = self._pool_world()
        run = TrainRun(
            spec=spec,
            state=[0.0] * spec.grad_dim,
            ledger=StepLedger(),
            world=world,
            lr=lr_for(spec, world),
        )
        run.epoch_seen = int(getattr(self.node.spec, "universe_epoch", 0))
        self.runs[spec.name] = run
        await self._checkpoint(run)
        async with run.lock:
            await self._dispatch(run)
        log.info(
            "%s: train run %s started (steps=%d world=%d lr=%.4g)",
            self._me, spec.name, spec.steps, world, run.lr,
        )
        return run

    async def wait(self, name: str, timeout: float = 60.0) -> Dict[str, Any]:
        """Await a run's completion (coordinator-local)."""
        run = self.runs[name]
        await asyncio.wait_for(run.done_event.wait(), timeout)
        return run.status()

    def status(self) -> Dict[str, Any]:
        return {name: r.status() for name, r in self.runs.items()}

    # -- the step engine ------------------------------------------------

    def _pool_world(self) -> int:
        return max(1, len(self.jobs.worker_pool()))

    async def _dispatch(self, run: TrainRun) -> None:
        """Dispatch the next global step as one scheduler job. Called
        with run.lock held. The step boundary is also the re-shard
        point: a pool/universe change since the last dispatch
        checkpoint-restores the run onto the new world first."""
        if run.done or run.inflight_job is not None:
            return
        spec = run.spec
        epoch = int(getattr(self.node.spec, "universe_epoch", 0))
        world = self._pool_world()
        if world != run.world:
            reason = self._reshard_reason(run, world, epoch)
            await self._reshard(run, world, epoch, reason)
        run.epoch_seen = epoch
        step = run.ledger.next_step()
        files = shard_files(spec, step, run.world)
        job_id = self.jobs.scheduler.next_job_id()
        requester = (
            f"{_REQ_TAG}{spec.name}:{step}:{run.world}:{run.lr!r}"
        )
        replicas = {
            f: self.jobs.store.metadata.replicas_of(f)
            for f in set(files)
        }
        self.jobs.scheduler.submit_job(
            job_id, TRAIN_MODEL, files, len(files), requester, replicas,
            batch_size=spec.shard_batch, inline_results=True,
            slo_class=TRAIN_SLO_CLASS,
        )
        self.jobs._relay_submit(
            job_id,
            {"job": job_id, "model": TRAIN_MODEL, "n": len(files),
             "files": list(files), "batch_size": spec.shard_batch,
             "requester": requester, "gen": self.jobs._relay_gen,
             "inline": True, "slo": TRAIN_SLO_CLASS},
        )
        run.inflight_job = job_id
        run.dispatch_t0 = time.monotonic()
        _M_EFF_BATCH.set(run.effective_batch(), run=spec.name)
        self.jobs._run_schedule()

    def _reshard_reason(
        self, run: TrainRun, new_world: int, epoch: int
    ) -> str:
        if new_world > run.world:
            return "join"
        # shrink: a graceful LEAVE bumps the universe epoch; a crash
        # shrinks the live pool without touching the universe
        return "leave" if epoch != run.epoch_seen else "failure"

    async def _reshard(
        self, run: TrainRun, new_world: int, epoch: int, reason: str
    ) -> None:
        """Checkpoint-restore re-shard at a step boundary: persist the
        current state, read it back through the store path (the same
        bytes an adopting coordinator would see), and come back up at
        the new world size with the LR rescaled to the new effective
        global batch."""
        spec = run.spec
        await self._checkpoint(run)
        blob = await self.jobs.store.get_bytes(
            TRAIN_CKPT_PREFIX + spec.name
        )
        d = json.loads(blob.decode())
        run.state = [float(x) for x in d["state"]]
        run.ledger = StepLedger.restore(d["ledger"])
        run.world = new_world
        run.lr = lr_for(spec, new_world)
        run.epoch_seen = epoch
        run.resharding[reason] = run.resharding.get(reason, 0) + 1
        _M_RESHARD.inc(reason=reason)
        _M_EFF_BATCH.set(run.effective_batch(), run=spec.name)
        log.info(
            "%s: train run %s re-sharded (%s) -> world=%d lr=%.4g "
            "at step %d", self._me, spec.name, reason, new_world,
            run.lr, run.ledger.next_step(),
        )

    async def _checkpoint(self, run: TrainRun) -> None:
        blob = json.dumps({
            "v": 1,
            "spec": run.spec.to_dict(),
            "state": run.state,
            "ledger": run.ledger.snapshot(),
            "world": run.world,
            "lr": run.lr,
            "done": run.done,
        }).encode()
        await self.jobs.store.put_bytes(
            TRAIN_CKPT_PREFIX + run.spec.name, blob
        )
        run.ckpt_puts += 1

    # -- completion (the exactly-once seam) -----------------------------

    def _on_job_done(self, st: Any, worker: Optional[str]) -> None:
        """Job-terminal observer (sync, must not block): attribute the
        job to (run, step, world, lr) via the requester tag and hand
        off to the async applier."""
        req = getattr(st, "requester", "") or ""
        if not isinstance(req, str) or not req.startswith(_REQ_TAG):
            return
        try:
            name, step_s, world_s, lr_s = req[len(_REQ_TAG):].rsplit(
                ":", 3
            )
            step, world, lr = int(step_s), int(world_s), float(lr_s)
        except ValueError:
            log.warning("%s: unparseable train requester %r", self._me, req)
            return
        self.jobs._spawn_bg(
            self._complete(st, name, step, world, lr),
            f"train-complete-{name}-{step}",
        )

    async def _complete(
        self, st: Any, name: str, step: int, world: int, lr: float
    ) -> None:
        run = self.runs.get(name)
        if run is None or run.done:
            return
        async with run.lock:
            if run.done:
                return
            spec = run.spec
            if getattr(st, "error", None):
                # the step job failed (batch retry cap under chaos):
                # the ledger did not advance, so re-dispatching the
                # same step is safe — and the boundary re-shards first
                # if the failure changed the pool
                if run.inflight_job == st.job_id:
                    run.inflight_job = None
                run.redispatches += 1
                log.info(
                    "%s: train run %s step %d job %d failed (%s); "
                    "re-dispatching", self._me, name, step, st.job_id,
                    st.error,
                )
                await self._dispatch(run)
                return
            if step != run.ledger.next_step():
                kind = run.ledger.refuse(step)
                log.info(
                    "%s: train run %s refused %s completion of step %d "
                    "(next=%d)", self._me, name, kind, step,
                    run.ledger.next_step(),
                )
                if run.inflight_job == st.job_id:
                    run.inflight_job = None
                    await self._dispatch(run)
                return
            files = shard_files(spec, step, world)
            # cross-check the workers' ACK-carried gradients against
            # the deterministic reference before applying it — the
            # applied math is the reference (identical by
            # construction), so a mismatch is execution evidence
            # drift, not a training divergence
            inline = getattr(st, "inline_results", None) or {}
            for f in set(files):
                got = inline.get(f)
                if got is not None and [float(x) for x in got] != \
                        grad_for(f, spec.grad_dim):
                    run.grad_mismatches += 1
            run.state = apply_step(run.state, files, lr, spec.grad_dim)
            reason = "steady" if step else "start"
            run.ledger.record(step, world, lr, reason)
            _M_STEPS.inc(run=name)
            if run.inflight_job == st.job_id:
                wall = time.monotonic() - run.dispatch_t0
                _M_STEP_WALL.observe(wall)
                if spec.min_step_s > 0 and wall < spec.min_step_s:
                    await asyncio.sleep(spec.min_step_s - wall)
            run.inflight_job = None
            if run.ledger.applied >= spec.steps:
                run.done = True
                await self._checkpoint(run)
                run.done_event.set()
                log.info(
                    "%s: train run %s complete (%d steps, final "
                    "world=%d)", self._me, name, spec.steps, run.world,
                )
                return
            if spec.checkpoint_every > 0 and \
                    run.ledger.applied % spec.checkpoint_every == 0:
                await self._checkpoint(run)
            await self._dispatch(run)

    # -- tick loop: adoption + stall recovery ---------------------------

    async def _tick_loop(self) -> None:
        interval = 0.25
        while True:
            await asyncio.sleep(interval)
            if not self.node.is_leader:
                continue
            try:
                now = time.monotonic()
                if now - self._last_scan >= 1.0:
                    self._last_scan = now
                    await self._adopt_scan()
                for run in list(self.runs.values()):
                    await self._unstall(run)
            except Exception:
                log.exception("%s: train tick failed", self._me)

    async def _adopt_scan(self) -> None:
        """Adopt unfinished runs this coordinator doesn't know — the
        failover path. The restored monotone ledger absorbs any shadow
        job still in flight from the previous leader: whichever side
        completes a step first advances it, the other is refused, and
        deterministic gradients make either apply identical."""
        try:
            listing = await self.jobs.store.ls_all(
                TRAIN_CKPT_PREFIX + "*"
            )
        except Exception:
            return
        for sdfs_name in sorted(listing):
            name = sdfs_name[len(TRAIN_CKPT_PREFIX):]
            if not name or name in self.runs:
                continue
            try:
                blob = await self.jobs.store.get_bytes(sdfs_name)
                d = json.loads(blob.decode())
                spec = TrainJobSpec.from_dict(d["spec"])
                run = TrainRun(
                    spec=spec,
                    state=[float(x) for x in d["state"]],
                    ledger=StepLedger.restore(d["ledger"]),
                    world=int(d["world"]),
                    lr=float(d["lr"]),
                    done=bool(d.get("done")),
                )
                run.epoch_seen = int(
                    getattr(self.node.spec, "universe_epoch", 0)
                )
                if name in self.runs:
                    # start_run registered it while the blob fetch
                    # was in flight; the live run wins
                    continue
                self.runs[name] = run
                if run.done:
                    run.done_event.set()
                    continue
                run.resharding["adopt"] = (
                    run.resharding.get("adopt", 0) + 1
                )
                _M_RESHARD.inc(reason="adopt")
                log.info(
                    "%s: adopted train run %s at step %d/%d",
                    self._me, name, run.ledger.applied, spec.steps,
                )
                async with run.lock:
                    await self._dispatch(run)
            except Exception:
                log.exception(
                    "%s: failed to adopt train run %s", self._me, name
                )

    async def _unstall(self, run: TrainRun) -> None:
        """Stall recovery: an active run must always have a step in
        flight. Covers a dispatched job lost to a scheduler snapshot
        restore, and the idle gap right after adoption."""
        if run.done:
            return
        if run.inflight_job is not None and \
                self.jobs.scheduler.jobs.get(run.inflight_job) is None:
            # the coordinator no longer tracks the job (restored
            # snapshot predates it); the ledger makes re-dispatch safe
            run.inflight_job = None
            run.redispatches += 1
        if run.inflight_job is None and not run.lock.locked():
            async with run.lock:
                await self._dispatch(run)

"""Process entry points + interactive operator CLI.

Replaces the reference's `main.py` (bootstrap: main.py:15-77) and the
2,000-line stdin menu `check_user_input` (worker.py:1629-2034). Same
verb set, structured into a command table; plus `introducer` and
`localspec` subcommands so a whole local cluster can be stood up
without hand-editing config files (the reference requires editing
config.py in two places per deployment, README STEP-1).

Run:
    python -m dml_tpu_torch localspec -n 4 -o cluster.json
    python -m dml_tpu_torch introducer --spec cluster.json
    python -m dml_tpu_torch node --spec cluster.json --name H1
    python -m dml_tpu_torch node --spec cluster.json --name H2 --device cpu
    python -m dml_tpu_torch node --spec cluster.json --name H3 --follow 1
    python -m dml_tpu_torch chaos run --seed 7 --soak   # seeded fault plan
    python -m dml_tpu_torch chaos run --seed 1 --scenario fuzz  # one family
    python -m dml_tpu_torch chaos run --seed 1 --scenario churn  # join/leave
    python -m dml_tpu_torch scale --nodes 128           # control-plane probe

A node serves on the CUDA device unless `--device cpu` is given; with
no CUDA device it refuses to start, before it joins the cluster. A
worker group's primary whose mesh takes more than one rank opens its
group world at start (`parallel.group_world`: itself rank 0) and waits
for its followers, each started as `node --name <the primary> --follow
RANK`, one process a rank, which joins the world at the primary's port +
`GROUP_PORT_OFFSET` and runs the primary's device calls (no SWIM node,
store or scheduler) until the primary closes it; there `profile trace
start [dir]` traces every rank (rank r under dir/rank<r>). The
async-hazard/drift linter stays with the JAX package (`python -m
dml_tpu lint`).
"""

from __future__ import annotations

import argparse
import asyncio
import json
import logging
import os
import signal
import sys
import tempfile
import time
from typing import List, Optional

import torch

from .config import ClusterSpec
from .cluster.introducer import IntroducerService
from .cluster.node import Node
from .cluster.store_service import StoreService
from .jobs.service import JobService

log = logging.getLogger(__name__)

MENU = """\
membership commands:
  1 | list_mem                      print the membership list
  2 | self_id                       print this node's id
  3 | join                          (re)join the cluster via the introducer
  4 | leave                         voluntarily leave the cluster
  6 | files-per-node                global view: every node's files
  7 | all-files                     every file in the store
  8 | file-count                    distinct files in the store
  9 | bps                           bytes/sec sent by the control plane
 10 | fp-rate                       failure-detector false-positive stats
file commands (replicated store):
  put <local> <sdfs>                upload (replicated, versioned)
  get <sdfs> <local>                download latest version
  get-versions <sdfs> <n> <local>   download last n versions, concatenated
  delete <sdfs>                     delete everywhere
  ls <sdfs>                         replicas holding the file
  ls-all [pattern]                  files in the store (wildcard ok)
  get-all <pattern> <local_dir>     download every matching file
  store                             files replicated on THIS node
  load-testfiles <dir> [n]          bulk-put *.jpeg from a directory
job commands (ML inference):
  submit-job <model> <N>            run N queries (any registered model:
                                    ResNet50 | InceptionV3 | ... | an
                                    --lm-spec LM serving prompt files)
  get-output <jobid>                collect + merge a job's results
  predict-locally <model> <f...>    single-node inference on local files
  save-model <model>                publish weights into the store
  load-model <model> [version]      load published weights for serving
  models                            resident models + HBM footprint
  unload-model <model>              evict a model's weights from HBM
  checkpoint-jobs                   snapshot scheduler state into the store
  restore-jobs [version] [force]    restore scheduler state (coordinator)
  C1                                per-model query counts + rates
  C2 <model>                        processing-time stats (mean/percentiles)
  C3 <model> <batch_size>           set batch size cluster-wide
  C5                                current worker->batch assignments
                                    (incl. staged pipeline batches)
  breakdown                         coordinator per-batch wall-time split +
                                    adaptive pipeline-depth verdict (chosen
                                    depth + why) + decode-cache stats +
                                    worker-group topology (formed/degraded
                                    sharded serving groups)
  parity-store                      imagenet parity report consuming weights
                                    (.npz/.h5 + class index) from the
                                    replicated store (operator `put`s them)
request commands (SLO-aware per-request front door, dml_tpu_torch/ingress/):
  request <model> [slo] [text...]   submit ONE request (interactive|batch
                                    class; optional inline text payload,
                                    else a store input is sampled) and
                                    wait for its terminal — a shed
                                    request gets a typed rejection
                                    immediately, never a timeout
  request-load <seed> <qps> <dur_s> [model] [slo_mix e.g. interactive:0.8,batch:0.2]
                                    seeded OPEN-LOOP load run from this
                                    node: deterministic Poisson arrivals,
                                    p50/p95/p99 + goodput + shed scorecard
  ingress                           front-door state: classes, forming
                                    batches, in-flight counts, shed totals
observability:
  profile metrics [prom|json]       this node's metrics registry — summary
                                    roll-up (default), Prometheus exposition
                                    text, or the raw JSON snapshot
  profile metrics cluster           leader-aggregated cluster view via
                                    METRICS_PULL: per-model C1-C5 rates,
                                    counts, latency mean + p50/p95/p99
  profile spans                     wall-clock span stats (store/job hot paths)
  profile trace start [dir]         capture a torch.profiler trace
  profile trace stop                stop + write the trace
  trace [dump]                      this node's flight recorder: finished
                                    request spans (bounded ring) + slowest-K
                                    + deadline-miss/shed/requeue/fallback
                                    exemplars (dml_tpu_torch/tracing.py)
  trace pull [relays]               leader-aggregated cluster traces via
                                    TRACE_PULL (optionally relay-fanned)
  trace chrome [path]               export cluster traces as Chrome
                                    chrome://tracing / Perfetto JSON
  health                            signal-plane rollup: per-node stage-
                                    wall scores, burn-rate monitor state,
                                    firing count (served locally on the
                                    leader, via ALERT_PULL elsewhere)
  alerts [n]                        typed alert ledger + last n lifecycle
                                    events (default 16): name{labels},
                                    severity, dedup count, exemplar
                                    trace id per row
other: help, quit
"""


class NodeApp:
    """One running cluster node: Node + StoreService + JobService +
    the interactive prompt."""

    def __init__(self, spec: ClusterSpec, name: str, lm_specs=(), device=None,
                 world_join_s: Optional[float] = None):
        me = spec.node_by_name(name) or spec.node_by_unique_name(name)
        if me is None:
            raise SystemExit(f"unknown node {name!r}; spec has {[n.name for n in spec.nodes]}")
        self.spec = spec
        # every model this node serves lives on `device` (cuda unless
        # the caller asks for another; `start` refuses a missing card)
        self.device = torch.device("cuda" if device is None else device)
        self.node = Node(spec, me)
        self.store = StoreService(self.node)
        # group PRIMARIES get the lazy multi-model sharded engine
        # (jobs/groups.py) — without it a spec-configured group would
        # collapse the scheduler pool while serving single-chip
        from .jobs.groups import wire_group_backend

        self.jobs = JobService(
            self.node, self.store,
            group_backend=wire_group_backend(self.node, device=self.device),
            device=self.device,
        )
        # request front door (dml_tpu_torch/ingress/): router role activates
        # with leadership, the client verbs work from any node
        from .ingress.router import RequestRouter

        self.ingress = RequestRouter(self.jobs)
        self._lm_specs = list(lm_specs)
        self.world = None  # the group world this node opens as a primary
        self._world_join_s = world_join_s

    def _open_group_world(self) -> None:
        """A group primary whose mesh takes more than one rank opens its
        group world as rank 0 and waits for its followers
        (`group_world.FollowersMissing` when they do not come): it never
        serves on one rank in place of several."""
        from .parallel import group_world

        spec, me = self.spec, self.node.me
        g = spec.group_of_unique(me.unique_name)
        members = spec.group_members_unique(g.name) if g is not None else ()
        if not members or members[0] != me.unique_name:
            return
        want = group_world.mesh_ranks(g.mesh)
        if want < 2:
            return
        join_s = getattr(self, "_world_join_s", None) or group_world.JOIN_TIMEOUT_S
        print(f"group {g.name}: opening its world of {want} ranks at "
              f"{group_world.rendezvous_of(spec, me)}, waiting up to {join_s:g} s "
              f"for {want - 1} follower(s)", flush=True)
        self.world = group_world.open_primary(group_world.rendezvous_of(spec, me), want,
                                              device=self.device, join_timeout_s=join_s)
        print(f"group {g.name}: world of {want} ranks up ({self.world.backend})", flush=True)

    async def start(self) -> None:
        # a node without its card must never join: it would take
        # scheduled batches and fail each one (getattr: tests construct
        # NodeApp via __new__ without __init__, and pick their backends)
        device = getattr(self, "device", None)
        if device is not None and device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: this node would join and fail every batch "
                "(pass --device cpu to run the plain PyTorch path)"
            )
        # a group primary of several ranks: its world before any model
        # (the group engines are built through it)
        if getattr(self, "spec", None) is not None and getattr(self, "node", None) is not None:
            await asyncio.to_thread(self._open_group_world)
        # LM serving models from --lm-spec files: built BEFORE the
        # node joins (model init can take seconds; a joined-but-
        # unready worker would eat scheduled batches). Deterministic
        # seed => every node loading the same spec serves the
        # identical weights (see LMBackend.from_spec).
        # getattr: tests construct NodeApp via __new__ without __init__
        for lm_spec in getattr(self, "_lm_specs", []):
            from .inference.lm_backend import LMBackend
            from .inference.lm_sharded import wire_lm_group

            be = await asyncio.to_thread(LMBackend.from_spec, lm_spec, device)
            name = str(lm_spec.get("name", "LM"))
            # sharded LM serving role (inference/lm_sharded.py): a
            # group primary whose group declares this model gets the
            # weight-resident (or disaggregated-decode) group engine,
            # prefill-role members get the slab prefill backend
            gb, prefill = await asyncio.to_thread(
                wire_lm_group, self.node, self.store, lm_spec, device
            )
            self.jobs.register_lm(
                name, backend=be.backend, cost=be.cost(),
                group_backend=gb, prefill=prefill,
            )
            role = (
                "group decode primary" if gb is not None
                else "prefill role" if prefill is not None
                else "single-chip"
            )
            print(f"registered LM serving model {name!r} "
                  f"({be.cfg.n_layers}L {be.cfg.d_model}d, "
                  f"max_new_tokens={be.max_new_tokens}, {role})")
        await self.node.start()
        await self.store.start()
        await self.jobs.start()
        if getattr(self, "ingress", None) is not None:
            await self.ingress.start()

    async def stop(self) -> None:
        if getattr(self, "ingress", None) is not None:
            await self.ingress.stop()
        await self.jobs.stop()
        await self.store.stop()
        await self.node.stop()
        world = getattr(self, "world", None)
        if world is not None:
            await asyncio.to_thread(world.close)
            self.world = None

    # ---- command dispatch ----

    async def handle(self, line: str) -> bool:
        """Run one command; returns False when the app should exit."""
        parts = line.split()
        if not parts:
            return True
        cmd, args = parts[0], parts[1:]
        try:
            return await self._dispatch(cmd, args)
        except (TimeoutError, asyncio.TimeoutError):
            print("!! timed out (no leader reachable?)")
        except asyncio.CancelledError:
            raise
        except Exception as e:
            # a typo'd path or bad argument must never take the node
            # out of the ring — report and keep the REPL alive
            print(f"!! {type(e).__name__}: {e}")
        return True

    async def _dispatch(self, cmd: str, a: List[str]) -> bool:
        n, s, j = self.node, self.store, self.jobs
        t0 = time.monotonic()
        if cmd in ("q", "quit", "exit"):
            return False
        elif cmd in ("h", "help", "?"):
            print(MENU)
        elif cmd in ("1", "list_mem"):
            print(n.membership.format())
        elif cmd in ("2", "self_id"):
            print(n.me.unique_name, f"(leader={n.leader_unique})")
        elif cmd in ("3", "join"):
            n.rejoin()
            print("rejoining via introducer...")
        elif cmd in ("4", "leave"):
            n.leave()
            print("left the cluster (use 'join' to come back)")
        elif cmd in ("9", "bps"):
            st = n.stats()
            print(f"bytes_sent={st['bytes_sent']} bps={st['bps']:.1f} "
                  f"dropped={st['packets_dropped']}")
        elif cmd in ("10", "fp-rate"):
            st = n.stats()
            print(f"false_positives={st['false_positives']} "
                  f"indirect_failures={st['indirect_failures']}")
        elif cmd == "put" and len(a) == 2:
            r = await s.put(a[0], a[1])
            print(f"ok version={r['version']} replicas={r['replicas']} "
                  f"({time.monotonic() - t0:.2f}s)")
        elif cmd == "get" and len(a) == 2:
            v = await s.get(a[0], a[1])
            print(f"ok version={v} -> {a[1]} ({time.monotonic() - t0:.2f}s)")
        elif cmd == "get-versions" and len(a) == 3:
            vs = await s.get_versions(a[0], int(a[1]), a[2])
            print(f"ok versions={vs} -> {a[2]}")
        elif cmd == "delete" and len(a) == 1:
            await s.delete(a[0])
            print("ok deleted")
        elif cmd == "ls" and len(a) == 1:
            print("\n".join(await s.ls(a[0])) or "(no replicas)")
        elif cmd == "ls-all":
            files = await s.ls_all(a[0] if a else "*")
            for f, vs in sorted(files.items()):
                print(f"{f}  versions={vs}")
            print(f"({len(files)} files)")
        elif cmd == "get-all" and len(a) == 2:
            got = await s.get_all(a[0], a[1])
            for f, v in sorted(got.items()):
                print(f"  {f} v{v} -> {a[1]}")
            print(f"ok {len(got)} files ({time.monotonic() - t0:.2f}s)")
        elif cmd in ("6", "files-per-node"):
            nodes = await s.files_per_node()
            for node, inv in sorted(nodes.items()):
                print(f"{node}: {len(inv)} files")
                for f, vs in sorted(inv.items()):
                    print(f"    {f}  versions={vs}")
        elif cmd in ("7", "all-files"):
            files = await s.ls_all("*")
            print("\n".join(sorted(files)) or "(empty store)")
        elif cmd in ("8", "file-count"):
            print(len(await s.ls_all("*")))
        elif cmd == "store":
            for f, vs in sorted(s.local_files().items()):
                print(f"{f}  versions={vs}")
        elif cmd == "load-testfiles" and a:
            await self._load_testfiles(a[0], int(a[1]) if len(a) > 1 else None)
        elif cmd == "submit-job" and len(a) == 2:
            job_id = await j.submit_job(a[0], int(a[1]))
            print(f"job {job_id} submitted; waiting...")
            r = await j.wait_job(job_id)
            print(f"job {job_id} DONE: {r['total_queries']} queries "
                  f"({time.monotonic() - t0:.2f}s)")
        elif cmd == "get-output" and len(a) == 1:
            dest = f"final_{a[0]}.json"
            merged = await j.get_output(int(a[0]), dest)
            print(f"ok {len(merged)} results -> {dest}")
        elif cmd == "predict-locally" and len(a) >= 2:
            r = await j.predict_locally(a[0], a[1:])
            print(json.dumps(r["results"], indent=2))
            print(f"exec_time={r['exec_time']:.3f}s")
        elif cmd == "save-model" and len(a) == 1:
            r = await j.publish_model(a[0])
            print(f"ok version={r['version']} replicas={r['replicas']}")
        elif cmd == "load-model" and a:
            await j.load_model_weights(a[0], int(a[1]) if len(a) > 1 else None)
            print("ok loaded")
        elif cmd == "models":
            stats = j.engine_memory_stats()
            for m, st in sorted(stats.items()):
                print(f"{m}: {st['param_mb']} MB in HBM, "
                      f"batch_size={st['batch_size']:.0f}")
            if not stats:
                print("(no models resident)")
        elif cmd == "unload-model" and len(a) == 1:
            print("ok evicted" if j.unload_model(a[0]) else "not resident")
        elif cmd == "parity-store":
            from .tools.imagenet_parity import run_parity_from_store

            rep = await run_parity_from_store(s)
            print(json.dumps(rep, indent=2, default=str))
        elif cmd == "checkpoint-jobs":
            r = await j.checkpoint_jobs()
            print(f"ok version={r['version']} replicas={r['replicas']}")
        elif cmd == "restore-jobs":
            ver = next((int(x) for x in a if x.isdigit()), None)
            r = await j.restore_jobs(ver, force="force" in a)
            print(f"ok jobs={r['jobs']} queued_batches={r['queued_batches']}")
        elif cmd == "profile" and a:
            from .observability import METRICS, SPANS, summarize_snapshot

            if a[0] == "metrics":
                sub = a[1] if len(a) > 1 else "summary"
                if sub == "prom":
                    # Prometheus exposition text (scrape-ready; pipe to
                    # a file and point a file_sd/textfile collector at it)
                    print(METRICS.to_prometheus_text(), end="")
                elif sub == "json":
                    print(json.dumps(
                        METRICS.snapshot(node=n.me.unique_name), indent=2
                    ))
                elif sub == "cluster":
                    view = await n.pull_cluster_metrics()
                    print(json.dumps({
                        "nodes_reporting": sorted(view["nodes"]),
                        "merged_from": view["cluster"]["merged_from"],
                        "summary": view["summary"],
                    }, indent=2))
                else:
                    print(json.dumps(
                        summarize_snapshot(METRICS.snapshot()), indent=2
                    ))
            elif a[0] == "spans":
                print(json.dumps(SPANS.summary(), indent=2))
            elif a[0] == "trace" and len(a) >= 2 and a[1] == "start":
                from .observability import profile

                if getattr(self, "_trace", None) is not None:
                    raise RuntimeError("a trace is already running")
                logdir = a[2] if len(a) > 2 else os.path.join(
                    tempfile.gettempdir(), "dml_tpu_torch_trace")
                world = getattr(self, "world", None)
                if world is not None:
                    # a group primary traces every rank of its world
                    # (rank r under <logdir>/rank<r>)
                    from .parallel import group_world

                    trace = group_world.build(group_world.RankTrace, logdir)
                else:
                    # the start half of observability.profile; `stop`
                    # runs its end half, which writes the trace
                    trace = profile(logdir)
                    trace.__enter__()
                self._trace = trace
                print(f"tracing torch.profiler to {logdir} "
                      "('profile trace stop' to end)")
            elif a[0] == "trace" and len(a) >= 2 and a[1] == "stop":
                trace = getattr(self, "_trace", None)
                if trace is None:
                    raise RuntimeError("no trace is running")
                self._trace = None
                trace.__exit__(None, None, None)
                if getattr(self, "world", None) is not None:
                    from .parallel import group_world

                    group_world.drop(trace)
                print("trace written (view with TensorBoard profile/Perfetto)")
            else:
                print("usage: profile metrics [prom|json|cluster] | "
                      "profile spans | profile trace start [dir] | "
                      "profile trace stop")
        elif cmd == "trace":
            from . import tracing as trc

            sub = a[0] if a else "dump"
            if sub == "dump":
                # this node's flight recorder: ring + slowest-K +
                # pinned exemplars, newest-last
                spans = trc.TRACER.dump()
                print(json.dumps({
                    "recorder": trc.TRACER.stats(),
                    "exemplar_traces": trc.TRACER.exemplar_trace_ids(),
                    "spans": spans,
                }, indent=2))
            elif sub == "pull":
                relays = next(
                    (int(x) for x in a[1:] if x.isdigit()), 0
                )
                view = await n.pull_cluster_traces(relays=relays)
                print(json.dumps({
                    "nodes": view["nodes"],
                    "unreachable": view["unreachable"],
                    "traces": {
                        tid: [
                            {k: sp.get(k) for k in
                             ("name", "node", "t0", "t1")}
                            for sp in spans
                        ]
                        for tid, spans in sorted(
                            view["traces"].items()
                        )
                    },
                }, indent=2))
            elif sub == "chrome":
                path = a[1] if len(a) > 1 else os.path.join(
                    tempfile.gettempdir(), "dml_tpu_torch_trace.json")
                view = await n.pull_cluster_traces()
                doc = trc.chrome_trace(view["spans"])
                with open(path, "w") as f:
                    json.dump(doc, f)
                print(f"wrote {len(doc['traceEvents'])} events from "
                      f"{len(view['traces'])} trace(s) to {path} — "
                      "load in chrome://tracing or Perfetto")
            else:
                print("usage: trace [dump|pull [relays]|chrome [path]]")
        elif cmd == "C1":
            for m, stats in j.c1_stats().items():
                print(f"{m}: total={stats['total_queries']:.0f} "
                      f"rate={stats['rate_per_sec']:.2f}/s")
        elif cmd == "C2" and len(a) == 1:
            print(json.dumps(await j.c2_stats(a[0]), indent=2))
        elif cmd == "C3" and len(a) == 2:
            await j.set_batch_size(a[0], int(a[1]))
            print("ok")
        elif cmd == "C5":
            print(json.dumps(j.c5_assignments(), indent=2))
        elif cmd == "request" and a:
            from .ingress.router import RequestRejected

            slo, rest = "interactive", a[1:]
            if rest and rest[0] in self.ingress.classes:
                slo, rest = rest[0], rest[1:]
            payload = " ".join(rest) or None
            try:
                term = await self.ingress.request(
                    a[0], slo=slo, payload=payload, timeout=60.0
                )
                print(json.dumps(term, indent=2, default=str))
                print(f"({time.monotonic() - t0:.2f}s)")
            except RequestRejected as e:
                kind = "SHED" if e.shed else "REJECTED"
                print(f"!! {kind}: {e.reason} "
                      f"({time.monotonic() - t0:.3f}s — typed rejection, "
                      "not a timeout)")
        elif cmd == "request-load" and len(a) >= 3:
            from .ingress import loadgen

            model = a[3] if len(a) > 3 else "ResNet50"
            mix = {"interactive": 1.0}
            if len(a) > 4:
                mix = {
                    part.split(":")[0]: float(part.split(":")[1])
                    for part in a[4].split(",")
                }
            trace = loadgen.open_loop_trace(
                int(a[0]), duration_s=float(a[2]), rate_qps=float(a[1]),
                model=model, slo_mix=mix,
            )

            async def one(arr):
                # the shared runner the bench's phases use — LOST,
                # shed, and rejected classify identically everywhere
                return await loadgen.drive_one(
                    self.ingress, arr, submit_timeout=8.0,
                    wait_timeout=60.0,
                )

            print(f"open-loop: {len(trace.arrivals)} arrivals over "
                  f"{trace.duration_s:g}s (seed {trace.seed})")
            outcomes, wall = await loadgen.run_open_loop(one, trace)
            print(json.dumps(
                loadgen.summarize(outcomes, wall), indent=2
            ))
        elif cmd == "ingress":
            print(json.dumps(self.ingress.stats(), indent=2))
        elif cmd in ("health", "alerts"):
            from .cluster.wire import MsgType

            max_events = (
                int(a[0]) if cmd == "alerts" and a and a[0].isdigit()
                else 16
            )
            # the leader answers from its own ledger (a self-addressed
            # ALERT_PULL would resolve its own rid with the request
            # leg); everyone else pulls over the wire
            if n.is_leader:
                ledger = {
                    "ok": True,
                    "node": n.me.unique_name,
                    "alerts": j.signal.alerts.rows(),
                    "events": j.signal.alerts.stream()[-max_events:],
                    "health": j.signal.health_summary(),
                }
            else:
                ledger = await n.leader_request(
                    MsgType.ALERT_PULL,
                    {"max_events": max_events}, timeout=5.0,
                )
            if not ledger.get("ok"):
                print(f"!! alert pull failed: {ledger.get('error')}")
            elif cmd == "health":
                print(json.dumps(ledger.get("health") or {}, indent=2))
                firing = [
                    r for r in ledger.get("alerts") or []
                    if r.get("state") == "firing"
                ]
                print(f"({len(firing)} firing alert(s) on "
                      f"{ledger.get('node', '?')} — 'alerts' for the "
                      "ledger)")
            else:
                rows = ledger.get("alerts") or []
                for r in rows:
                    labels = ",".join(
                        f"{k}={v}" for k, v in
                        sorted((r.get("labels") or {}).items())
                    )
                    print(f"[{r.get('state', '?')}] "
                          f"{r.get('severity', '?')} "
                          f"{r.get('name', '?')}{{{labels}}} "
                          f"x{r.get('count', 0)} "
                          f"exemplar={r.get('exemplar')}")
                    if r.get("summary"):
                        print(f"    {r['summary']}")
                for ev in ledger.get("events") or []:
                    print(f"  {ev.get('t', 0):.1f} {ev.get('event', '?')} "
                          f"{ev.get('name', '?')} {ev.get('labels')}")
                trunc = ledger.get("truncated")
                print(f"({len(rows)} ledger row(s) from "
                      f"{ledger.get('node', '?')}"
                      + (f"; degraded: {trunc}" if trunc else "") + ")")
        elif cmd == "breakdown":
            print(json.dumps({
                "per_batch_ms": j.breakdown_stats(),
                "pipeline_depth": j.pipeline_depth,
                # adaptive controller: the chosen depth AND why (probe
                # rates, trigger, drift signature) — or the static pin
                "depth_controller": j.depth_controller_stats(),
                "decode_cache": j.decode_cache_stats(),
                # worker-group topology: configured groups, formed
                # state, capacity in force, degradations/reforms
                # (jobs/groups.py; empty dict = no groups configured)
                "groups": j.group_stats(),
            }, indent=2))
        else:
            print(f"unknown command {cmd!r} (try 'help')")
        return True

    async def _load_testfiles(self, directory: str, limit: Optional[int]) -> None:
        """Bulk-put a directory of images (reference CLI option 5,
        worker.py:1696-1708)."""
        directory = os.path.expanduser(directory)
        names = sorted(
            f for f in os.listdir(directory)
            if f.lower().endswith((".jpeg", ".jpg"))
        )[: limit or None]
        for i, f in enumerate(names):
            await self.store.put(os.path.join(directory, f), f)
            print(f"  put {f} ({i + 1}/{len(names)})")
        print(f"loaded {len(names)} files")

    async def repl(self) -> None:
        print(f"dml_tpu_torch node {self.node.me} — 'help' for commands")
        loop = asyncio.get_running_loop()
        while True:
            try:
                line = await loop.run_in_executor(None, sys.stdin.readline)
            except (EOFError, KeyboardInterrupt):
                break
            if not line:  # EOF
                break
            if not await self.handle(line.strip()):
                break


def default_log_path() -> str:
    """Where CLI file logging lands: ``DML_TPU_LOG_FILE`` when set,
    else a per-process file inside a PRIVATE (0700, owner-verified)
    per-user directory under the system tempdir. NEVER the working
    directory — `main()` runs from tests/benches/operator shells, and
    a ``debug.log`` materializing in whatever directory the process
    happened to start from (the repo root) is a litter bug, not a
    logging feature. The private dir (rather
    than a bare predictable ``<tmp>/dml_tpu_torch_user.log``) means another
    user on a shared host cannot pre-create the path or plant a
    symlink under it (CWE-377); the pid suffix keeps two concurrent
    nodes run by the same operator from interleaving one file."""
    env = os.environ.get("DML_TPU_LOG_FILE")
    if env:
        return os.path.expanduser(env)
    import getpass
    import stat as _stat

    try:
        user = getpass.getuser()
    except Exception:  # pragma: no cover - no passwd entry
        user = "user"
    d = os.path.join(tempfile.gettempdir(), f"dml_tpu_torch_{user}")
    try:
        os.makedirs(d, mode=0o700, exist_ok=True)
        st = os.lstat(d)
        if not _stat.S_ISDIR(st.st_mode) or (
            hasattr(os, "geteuid") and st.st_uid != os.geteuid()
        ):
            raise OSError(f"unsafe log dir {d}")
        if _stat.S_IMODE(st.st_mode) != 0o700:
            os.chmod(d, 0o700)  # re-tighten a pre-existing dir
    except OSError:
        # pre-planted file/symlink or foreign-owned dir: a fresh
        # private dir instead of logging through someone else's path
        d = tempfile.mkdtemp(prefix=f"dml_tpu_torch_{user}_")
    return os.path.join(d, f"node_{os.getpid()}.log")


def _setup_logging(verbose: bool, logfile: Optional[str] = None) -> None:
    """File + stdout logging (reference main.py:66-73). The file
    handler is best-effort: an unwritable log path must not kill the
    node."""
    logfile = logfile or default_log_path()
    handlers: List[logging.Handler] = []
    try:
        handlers.append(logging.FileHandler(logfile))
    except OSError:
        pass
    if verbose or not handlers:
        handlers.append(logging.StreamHandler())
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
        handlers=handlers,
    )


async def _run_node(args) -> None:
    spec = ClusterSpec.from_file(args.spec)
    if args.testing:
        spec.testing = True
        if args.drop_pct is not None:
            spec.packet_drop_pct = args.drop_pct
    lm_specs = []
    for path in getattr(args, "lm_spec", []):
        with open(path) as f:
            lm_specs.append(json.load(f))
    app = NodeApp(spec, args.name, lm_specs=lm_specs, device=args.device,
                  world_join_s=args.join_timeout)
    await app.start()
    stop = asyncio.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        asyncio.get_running_loop().add_signal_handler(sig, stop.set)
    if args.no_repl:
        await stop.wait()
    else:
        repl_task = asyncio.create_task(app.repl())
        stop_task = asyncio.create_task(stop.wait())
        await asyncio.wait({repl_task, stop_task}, return_when=asyncio.FIRST_COMPLETED)
    await app.stop()


async def _run_chaos(args) -> int:
    """`chaos run --seed N`: generate the seeded plan, drive it
    against an in-process cluster, print the schedule + invariant
    report. Exit 0 iff every invariant held."""
    from .cluster import chaos

    if args.plan:
        with open(args.plan) as f:
            plan = chaos.ChaosPlan.from_dict(json.load(f))
    elif args.scenario:
        plan = chaos.scenario_plan(
            args.scenario, args.seed, n_nodes=args.nodes
        )
    elif args.soak:
        plan = chaos.soak_plan(args.seed, n_nodes=args.nodes)
    else:
        plan = chaos.random_plan(
            args.seed, n_nodes=args.nodes, n_disturbances=args.events
        )
    print(plan.describe())
    if args.dump:
        with open(args.dump, "w") as f:
            json.dump(plan.to_dict(), f, indent=2)
        print(f"plan written to {args.dump}")
    if args.dry_run:
        return 0
    report = await chaos.run_plan(plan, base_port=args.base_port)
    print(json.dumps(report.to_dict(), indent=2))
    print("invariants:", "PASS" if report.ok else "FAIL")
    for f in report.invariants.failures:
        print(f"  !! {f}")
    return 0 if report.ok else 1


async def _run_introducer(args) -> None:
    spec = ClusterSpec.from_file(args.spec)
    svc = IntroducerService(spec)
    await svc.start()
    stop = asyncio.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        asyncio.get_running_loop().add_signal_handler(sig, stop.set)
    await stop.wait()
    await svc.stop()


def main(argv: Optional[List[str]] = None) -> None:
    p = argparse.ArgumentParser(prog="dml_tpu_torch", description=__doc__)
    p.add_argument(
        "--log-file", default=None, metavar="PATH",
        help="log file path (default: $DML_TPU_LOG_FILE, else a "
             "per-process file in a private per-user tempdir — never the "
             "working directory)",
    )
    sub = p.add_subparsers(dest="command", required=True)

    pn = sub.add_parser("node", help="run a cluster node")
    pn.add_argument("--spec", required=True, help="cluster spec JSON")
    pn.add_argument("--name", required=True, help="node name (e.g. H1) or host:port")
    pn.add_argument("-t", "--testing", action="store_true",
                    help="test mode: enable loss injection + accounting")
    pn.add_argument("--drop-pct", type=float, default=None,
                    help="packet drop %% in test mode")
    pn.add_argument("--no-repl", action="store_true",
                    help="headless: no interactive prompt")
    pn.add_argument("--lm-spec", action="append", default=[],
                    metavar="FILE",
                    help="register an LM serving model from a JSON "
                         "spec (repeatable; load the SAME file on "
                         "every node — see LMBackend.from_spec)")
    pn.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where this node's models run (default cuda; "
                         "without a CUDA device the node refuses to "
                         "start; cpu runs the plain PyTorch path)")
    pn.add_argument("--follow", type=int, default=None, metavar="RANK",
                    help="run as follower RANK of the group world of the "
                         "primary --name (no SWIM node, store or "
                         "scheduler): join it, run its device calls "
                         "until it closes the world")
    pn.add_argument("--rendezvous", default=None, metavar="URL",
                    help="a follower's init method (default: tcp at the "
                         "primary's host, its port + GROUP_PORT_OFFSET)")
    pn.add_argument("--join-timeout", type=float, default=None, metavar="S",
                    help="seconds a group primary waits for its "
                         "followers, or a follower for its primary "
                         "(default group_world.JOIN_TIMEOUT_S)")
    pn.add_argument("-v", "--verbose", action="store_true")

    pi = sub.add_parser("introducer", help="run the introducer DNS")
    pi.add_argument("--spec", required=True)
    pi.add_argument("-v", "--verbose", action="store_true")

    ps = sub.add_parser("localspec", help="emit a localhost cluster spec")
    ps.add_argument("-n", type=int, default=4, help="number of nodes")
    ps.add_argument("-o", "--out", default="-", help="output path (default stdout)")
    ps.add_argument("--base-port", type=int, default=8001)

    pc = sub.add_parser(
        "chaos",
        help="run a seeded chaos plan against an in-process cluster "
             "and sweep the recovery invariants",
    )
    pc.add_argument("verb", choices=["run"], help="chaos subcommand")
    pc.add_argument("--seed", type=int, default=0,
                    help="plan seed (same seed = identical schedule)")
    pc.add_argument("--nodes", type=int, default=5)
    pc.add_argument("--events", type=int, default=4,
                    help="disturbance count for the random plan")
    pc.add_argument("--soak", action="store_true",
                    help="use the canonical soak composition "
                         "(leader-kill-mid-put/job + partition heal + "
                         "2%% loss + duplicate delivery)")
    pc.add_argument("--scenario", default=None,
                    choices=["asym", "disk", "dns", "skew", "fuzz",
                             "churn", "elastic", "liar", "autoscale",
                             "train"],
                    help="run one adversarial scenario family: "
                         "asym(metric partition), disk(-full + "
                         "corruption), dns (introducer outage during "
                         "failover), (clock) skew, fuzz (byzantine "
                         "datagrams), churn (sustained seeded "
                         "join/leave), elastic (authenticated "
                         "scale-out mid-load + graceful LEAVE + "
                         "forged-join storm), liar (a worker whose "
                         "self-reported batch walls understate its "
                         "real walls — the signal plane's ACK-wall "
                         "cross-check must catch it), autoscale "
                         "(controller-aimed chaos: thrashing load, "
                         "liar-fed policy, scale-in racing a spike, "
                         "leader kill mid-decision), train "
                         "(trainer-aimed chaos: trainer kill "
                         "mid-epoch, leader kill mid-checkpoint, "
                         "capacity join racing a step boundary — the "
                         "sweep replays the step ledger against the "
                         "exactly-once oracle)")
    pc.add_argument("--plan", default=None, metavar="FILE",
                    help="replay a saved plan JSON instead of generating")
    pc.add_argument("--dump", default=None, metavar="FILE",
                    help="write the generated plan JSON here")
    pc.add_argument("--dry-run", action="store_true",
                    help="print/dump the schedule without running it")
    pc.add_argument("--base-port", type=int, default=24001)
    pc.add_argument("-v", "--verbose", action="store_true")

    pscale = sub.add_parser(
        "scale",
        help="control-plane scale probe: bring up an N-node "
             "membership-level in-process cluster under the chosen "
             "gossip protocol and print convergence / traffic / "
             "metrics-aggregation / detection / election measurements "
             "as JSON (the bench control_plane_scale section runs the "
             "full 16/64/128 x full-vs-delta matrix)",
    )
    pscale.add_argument("--nodes", type=int, default=64)
    pscale.add_argument("--protocol", choices=["delta", "full"],
                        default="delta",
                        help="gossip piggyback protocol (delta = "
                             "bounded product default, full = "
                             "reference full-table baseline)")
    pscale.add_argument("--services", choices=["core", "store", "full"],
                        default="core",
                        help="per-node service stack (core = "
                             "membership only, the affordable 128-node "
                             "form)")
    pscale.add_argument("--seed", type=int, default=1)
    pscale.add_argument("--measure-s", type=float, default=4.0,
                        help="steady-state traffic window seconds")
    pscale.add_argument("--relays", type=int, default=None,
                        help="metrics relay count (default ~sqrt(N))")
    pscale.add_argument("--base-port", type=int, default=26001)
    pscale.add_argument("-v", "--verbose", action="store_true")

    pas = sub.add_parser(
        "autoscale",
        help="diurnal autoscale probe: replay a seeded "
             "ramp-plateau-trough open-loop trace against an "
             "in-process cluster (autoscaled or statically "
             "provisioned) and print SLO-violation-minutes / "
             "chip-idle-minutes / decision counts as JSON (the bench "
             "autoscale section runs both arms and compares)",
    )
    pas.add_argument("--seed", type=int, default=5,
                     help="trace seed (same seed = byte-identical "
                          "arrival schedule)")
    pas.add_argument("--mode", choices=["autoscaled", "static"],
                     default="autoscaled",
                     help="autoscaled = floor-sized pool plus the "
                          "closed-loop controller; static = fixed "
                          "mid-provisioned pool, no controller")
    pas.add_argument("--duration", type=float, default=52.0,
                     help="trace duration seconds")
    pas.add_argument("--base-qps", type=float, default=3.0)
    pas.add_argument("--peak-qps", type=float, default=90.0)
    pas.add_argument("--base-port", type=int, default=27001)
    pas.add_argument("-v", "--verbose", action="store_true")

    args = p.parse_args(argv)
    if args.command == "localspec":
        spec = ClusterSpec.localhost(args.n, base_port=args.base_port)
        text = spec.to_json()
        if args.out == "-":
            print(text)
        else:
            with open(args.out, "w") as f:
                f.write(text)
        return
    _setup_logging(
        getattr(args, "verbose", False),
        logfile=getattr(args, "log_file", None),
    )
    if args.command == "node" and args.follow is not None:
        from .parallel import group_world

        calls = group_world.follow_from_spec(
            ClusterSpec.from_file(args.spec), args.name, args.follow, device=args.device,
            init_method=args.rendezvous,
            join_timeout_s=args.join_timeout or group_world.JOIN_TIMEOUT_S)
        from .ops import decode_attention, flash_attention, preprocess

        # what this rank ran: the serving kernels it launched on its card,
        # and the flash launches by the kernels they ran
        launches = {"normalize": preprocess.normalize_launches,
                    "flash_attention": flash_attention.flash_launches,
                    "decode_attention": decode_attention.decode_launches}
        routes = {" ".join(map(str, k)): n for k, n in sorted(flash_attention.route_launches.items())}
        print(f"follower {args.follow} of {args.name}: world closed after {calls} calls; "
              f"kernel launches {json.dumps(launches)}; flash launches by route {json.dumps(routes)}",
              flush=True)
    elif args.command == "node":
        asyncio.run(_run_node(args))
    elif args.command == "introducer":
        asyncio.run(_run_introducer(args))
    elif args.command == "chaos":
        raise SystemExit(asyncio.run(_run_chaos(args)))
    elif args.command == "scale":
        from .cluster.chaos import control_plane_probe_sync

        print(json.dumps(control_plane_probe_sync(
            args.nodes,
            args.base_port,
            seed=args.seed,
            protocol=args.protocol,
            services=args.services,
            measure_s=args.measure_s,
            metrics_relays=args.relays,
        ), indent=2))
    elif args.command == "autoscale":
        from .cluster.chaos import diurnal_probe

        print(json.dumps(asyncio.run(diurnal_probe(
            args.seed,
            args.base_port,
            mode=args.mode,
            duration_s=args.duration,
            base_qps=args.base_qps,
            peak_qps=args.peak_qps,
        )), indent=2, sort_keys=True))


if __name__ == "__main__":  # pragma: no cover
    main()

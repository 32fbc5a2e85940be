"""The port's scheduler side of the job layer (`jobs/scheduler`,
`cost_model`, `train`, `groups`), `signal`, `autoscale`, `tracing` and
`observability`, held to the JAX package's own test cases
(`test_torch_cluster.port_cases`), and the two packages' Scheduler and
DepthController held to each other on one seeded event script.

The cases that drive the chaos harness (`cluster.chaos.LocalCluster`),
the request router or the load generator run on probed ports like the
rest. Left out: the cases that need the tools (`dml_tpu.tools`, ROADMAP
A8), which `port_cases` drops by itself, and the cases named in
`EXCLUDE`, which build a JAX mesh over several devices (each has a
counterpart on the port's world-1 group mesh or its gloo ranks).
"""

from __future__ import annotations

import os
import re

import numpy as np
import pytest

from test_torch_cluster import TESTS, port_cases

JOB_FILES = (("test_scheduler", "scheduler"), ("test_train_job", "train_job"),
             ("test_signal", "signal"), ("test_autoscale", "autoscale"),
             ("test_tracing", "tracing"), ("test_observability", "observability"),
             ("test_groups", "groups"), ("test_depth_adaptive", "depth_adaptive"))
#: cases that build a JAX mesh over two or four devices
#: (`make_mesh(..., devices=jax.devices()[:n])`); the port resolves a
#: group mesh over its own world, and each has a counterpart:
#: - test_group_engine_backend_lazy_models_and_equality:
#:   test_torch_groups.test_group_engine_backend_lazy_models_and_set_variables
#:   (and ..._reform_rung_and_degraded, ..._larger_than_the_world_...);
#: - test_param_gather_bitwise_equality: test_torch_parallel's
#:   param_gather cases over four gloo ranks;
#: - test_disagg_ingress_request_yields_full_stitched_trace:
#:   test_torch_groups' case of the same name, at dp 1 x tp 1
EXCLUDE = {"test_groups": ("test_group_engine_backend_lazy_models_and_equality",
                           "test_param_gather_bitwise_equality"),
           "test_tracing": ("test_disagg_ingress_request_yields_full_stitched_trace",)}
for _name, _prefix in JOB_FILES:
    globals().update(port_cases(_name, _prefix, exclude=EXCLUDE.get(_name, ()),
                                probe_ports=True))

#: cases each file contributes at least (the rest need a module the port
#: lacks or are in EXCLUDE); None: every case
MIN_CASES = {"scheduler": None, "train_job": 14, "signal": None, "autoscale": 27,
             "tracing": 17, "observability": 18, "groups": 18, "depth_adaptive": 16}


@pytest.mark.parametrize("name,prefix", JOB_FILES)
def test_port_cases_cover_each_file(name, prefix):
    with open(os.path.join(TESTS, f"{name}.py"), encoding="utf-8") as f:
        want = set(re.findall(r"^(?:async )?def test_(\w+)", f.read(), re.M))
    got = {k[len(prefix) + 6:] for k in globals() if k.startswith(f"test_{prefix}_")}
    assert got <= want
    floor = MIN_CASES[prefix]
    assert got == want if floor is None else len(got) >= floor, sorted(want - got)


# ----------------------------------------------------------------------
# one seeded event script through both packages
# ----------------------------------------------------------------------


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _script(pkg, seed: int, steps: int = 300):
    """Drive `pkg`'s Scheduler and DepthController through a seeded mix
    of submits, scheduling rounds, ACKs, batch failures and worker
    deaths; returns every observable decision in order."""
    if pkg == "jax":
        from dml_tpu.jobs.cost_model import ModelCost
        from dml_tpu.jobs.scheduler import DepthController, Scheduler
    else:
        from dml_tpu_torch.jobs.cost_model import ModelCost
        from dml_tpu_torch.jobs.scheduler import DepthController, Scheduler
    rng = np.random.RandomState(seed)
    clock = _Clock()
    costs = {"ResNet50": ModelCost(load_time=0, first_query=0.05, per_query=0.01,
                                   download_time=0.0, batch_size=8),
             "InceptionV3": ModelCost(load_time=0, first_query=0.08, per_query=0.03,
                                      download_time=0.0, batch_size=8)}
    s = Scheduler(costs, now=clock)
    dc = DepthController(probe_batches=3, now=clock)
    workers = [f"w{i}" for i in range(6)]
    alive = set(workers)
    log = []
    job = 0
    for _ in range(steps):
        clock.t += float(rng.uniform(0.01, 0.2))
        ev = rng.randint(0, 10)
        if ev == 0 or not s.jobs:
            job += 1
            model = ("ResNet50", "InceptionV3")[rng.randint(0, 2)]
            s.submit_job(job, model, [f"f{i}" for i in range(5)], int(rng.randint(8, 80)), "c")
            log.append(("submit", job, model))
        elif ev <= 3:
            s.pipeline_depth = dc.tick(sum(len(q) for q in s.queues.values()))
            dc.on_pool_size(len(alive))
            out = s.schedule(sorted(alive))
            log.append(("round", s.pipeline_depth, [
                (a.worker, a.batch.key, a.batch.model,
                 None if a.preempted is None else a.preempted.key) for a in out]))
        elif ev <= 7 and s.in_progress:
            w = sorted(s.in_progress)[rng.randint(0, len(s.in_progress))]
            b = s.in_progress[w]
            ex = float(rng.uniform(0.05, 0.5))
            done = s.on_batch_done(w, b.job_id, b.batch_id, ex, len(b.files))
            depth = dc.on_ack(len(b.files), fetch=ex / 5, infer=ex / 2, put=ex / 5, worker=w)
            log.append(("ack", w, b.key, None if done is None else done.job_id, depth))
        elif ev == 8 and s.in_progress:
            w = sorted(s.in_progress)[rng.randint(0, len(s.in_progress))]
            b = s.in_progress[w]
            back = s.on_batch_failed(w, b.job_id, b.batch_id)
            log.append(("fail", w, None if back is None else back.key))
        elif ev == 9 and len(alive) > 2:
            w = sorted(alive)[rng.randint(0, len(alive))]
            alive.discard(w)
            back = s.on_worker_failed(w)
            log.append(("dead", w, None if back is None else back.key))
        elif ev == 9:
            alive = set(workers)
            log.append(("rejoin",))
    log.append(("end", s.query_counts, {m: len(q) for m, q in s.queues.items()},
                s.requeue_count, dc.state, dc.depth, dc.probes))
    return log


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_seeded_event_script_gives_identical_assignments(seed):
    j, t = _script("jax", seed), _script("port", seed)
    assert sum(e[0] == "round" and bool(e[2]) for e in j) > 20
    assert j == t

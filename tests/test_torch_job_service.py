"""The port's job pipeline: `jobs/service.JobService` on port nodes.

- The `FakeBackend` cases of test_jobs_sim and test_cluster_sim, run on
  port nodes (`test_torch_cluster.port_cases`, every cluster on a probed
  free port block). Left out: the sharded worker-group case, which
  builds a JAX mesh over two devices (its counterpart is
  `test_torch_groups.test_group_sharded_serving_outputs_equal_single_chip`).
- The slice as a whole, on the CPU: a 4-node JAX cluster serving
  ResNet50 float32 on the JAX engine and a 4-node port cluster on
  `InferenceEngine(device="cpu")`, the same weights (`jax_init` +
  `perturb_bn`), a 12-query job on the same seeded 64x64 JPEGs: the
  merged outputs have the same keys and top-5 wnids, scores within
  atol 1e-4 (test_torch_engine's bar).
- Weights both ways through the store: the JAX node's published file is
  served by a port node, and the port node's `publish_model` bytes are
  read by the JAX package leaf for leaf.
- An LM job through `register_lm` on port nodes gives the JAX
  `LMBackend`'s greedy tokens for the same tiny LM.

The `flow` fixture runs these in named stages, each under its own time
limit, so a failure names its stage; the weights are a fixture of their
own, so the pure parity test does not depend on a cluster.
"""

from __future__ import annotations

import asyncio
import errno
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dml_tpu.models.resnet import ResNet50 as JaxResNet50
from test_torch_cluster import TESTS, free_port_block, port_cases, release_ports
from test_torch_models import jax_init, perturb_bn

SIM_FILES = (("test_jobs_sim", "jobs_sim", ("test_group_sharded_serving_outputs_equal_single_chip",)),
             ("test_cluster_sim", "cluster_sim", ()))
for _name, _prefix, _exclude in SIM_FILES:
    globals().update(port_cases(_name, _prefix, exclude=_exclude, probe_ports=True))


@pytest.mark.parametrize("name,prefix,exclude", SIM_FILES)
def test_port_cases_cover_each_file(name, prefix, exclude):
    """Every case of these files but the excluded ones runs on the port
    (the chaos-harness case of test_jobs_sim included)."""
    with open(os.path.join(TESTS, f"{name}.py"), encoding="utf-8") as f:
        want = set(re.findall(r"^(?:async )?def test_(\w+)", f.read(), re.M))
    got = {k[len(prefix) + 6:] for k in globals() if k.startswith(f"test_{prefix}_")}
    assert got == want - {k[5:] for k in exclude}, sorted(want - got)

N_NODES = 4
N_FILES = 8
N_QUERIES = 12
ENGINE_BS = 4
LM_SHAPE = dict(vocab_size=61, d_model=32, n_heads=4, n_layers=2, d_ff=64, n_kv_heads=2)
LM_NEW = 6
LM_PROMPTS = (4, 9, 13, 16, 5, 7, 11, 3)
#: the clusters' failure detector: a node is suspected after 3 missed
#: acks of 1 s and dead 5 s later. The four nodes share one event loop,
#: which a ~100 MB weights file stalls for 1.5 s when it is serialized,
#: decoded or copied in the loop (more under load); at an ack timeout of
#: 0.3 s and a cleanup of 1 s every node then declared the others dead
#: and elected itself, and the leader RPCs of the weights round trip
#: timed out. Failure detection is not under test here.
FLOW_TIMING = dict(ping_interval=0.2, ack_timeout=1.0, cleanup_time=5.0, leader_rpc_timeout=10.0)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _pkg(name):
    """The cluster and job modules of one package, by the same names."""
    if name == "jax":
        from dml_tpu import config
        from dml_tpu.cluster.introducer import IntroducerService
        from dml_tpu.cluster.node import Node
        from dml_tpu.cluster.store_service import StoreService
        from dml_tpu.inference.weights import weights_name
        from dml_tpu.jobs.service import JobService
    else:
        from dml_tpu_torch import config
        from dml_tpu_torch.cluster.introducer import IntroducerService
        from dml_tpu_torch.cluster.node import Node
        from dml_tpu_torch.cluster.store_service import StoreService
        from dml_tpu_torch.inference.weights import weights_name
        from dml_tpu_torch.jobs.service import JobService
    return config, IntroducerService, Node, StoreService, JobService, weights_name


class _Cluster:
    """An in-process cluster of one package: the introducer and N nodes,
    each Node + StoreService + JobService sharing `engine`; `lm()` makes
    each node's LM backend when given. Its ports are a probed block,
    given back when it stops."""

    def __init__(self, pkg, tmp, engine, lm=None):
        self.pkg, self.tmp, self.engine, self.lm = pkg, tmp, engine, lm
        self.stack, self.dns, self.backends, self.base = [], None, [], None

    async def start(self):
        for attempt in range(3):
            try:
                return await self._start()
            except OSError as e:
                await self.stop()
                if e.errno != errno.EADDRINUSE or attempt == 2:
                    raise

    async def _start(self):
        config, Intro, Node, Store, Jobs, _ = _pkg(self.pkg)
        self.base = base = free_port_block(N_NODES)
        spec = config.ClusterSpec.localhost(
            N_NODES, base_port=base, introducer_port=base - 1,
            timing=config.Timing(**FLOW_TIMING),
            store=config.StoreConfig(root=os.path.join(self.tmp, "roots"),
                                     download_dir=os.path.join(self.tmp, "dl")))
        self.dns = Intro(spec)
        await self.dns.start()
        for n in spec.nodes:
            node = Node(spec, n)
            store = Store(node, root=os.path.join(self.tmp, f"st_{n.port}"))
            jobs = Jobs(node, store, engine=self.engine)
            if self.lm is not None:
                be = self.lm()
                self.backends.append(be)
                jobs.register_lm("TinyLM", backend=be.backend, cost=be.cost())
            self.stack.append((node, store, jobs))
            await node.start()
            await store.start()
            await jobs.start()
        for _ in range(150):
            if all(n.joined and n.leader_unique and len(n.membership.alive_nodes()) == N_NODES
                   for n, _, _ in self.stack):
                return
            await asyncio.sleep(0.1)
        views = {n.me.unique_name: (n.joined, n.leader_unique,
                                    sorted(m.unique_name for m in n.membership.alive_nodes()))
                 for n, _, _ in self.stack}
        raise AssertionError(f"{self.pkg} cluster did not converge: {views}")

    async def stop(self):
        """Stop every part that started (a failed start leaves some that
        did not), then give the ports back."""
        errors = []
        for node, store, jobs in reversed(self.stack):
            for part in (jobs, store, node):
                try:
                    await part.stop()
                except Exception as e:  # keep stopping the rest
                    errors.append(e)
        self.stack = []
        if self.dns is not None:
            await self.dns.stop()
            self.dns = None
        for be in self.backends:
            be.close()
        self.backends = []
        if self.base is not None:
            release_ports(self.base, N_NODES)
            self.base = None
        if errors:
            raise errors[0]

    @property
    def client(self):
        return self.stack[-1]

    async def put_files(self, paths):
        store = self.client[1]
        for p in paths:
            await store.put(p, os.path.basename(p))

    async def run_job(self, model, n):
        jobs = self.client[2]
        job = await jobs.submit_job(model, n)
        done = await jobs.wait_job(job, timeout=240.0)
        assert done["total_queries"] == n
        return await jobs.get_output(job, os.path.join(self.tmp, f"out_{model}_{job}.json"))


def _jpegs(tmp):
    from PIL import Image

    rng = np.random.RandomState(11)
    paths = []
    for i in range(N_FILES):
        p = os.path.join(tmp, f"img_{i}.jpeg")
        base = rng.randint(0, 256, (1, 1, 3))
        img = np.clip(rng.randint(0, 128, (64, 64, 3)) + base // 2, 0, 255).astype(np.uint8)
        Image.fromarray(img).save(p, quality=90)
        paths.append(p)
    return paths


def _prompts(tmp):
    from dml_tpu_torch.inference.lm_backend import write_prompt_file

    rng = np.random.RandomState(3)
    paths = []
    for i, n in enumerate(LM_PROMPTS):
        p = os.path.join(tmp, f"p{i}.tokens.txt")
        write_prompt_file(p, rng.randint(0, LM_SHAPE["vocab_size"], n),
                          max_new_tokens=3 if i == 2 else None)
        paths.append(p)
    return paths


async def _stage(name, aw, timeout):
    """One stage of `_flow`, under its own time limit; a failure names
    the stage (the module fixture's error then says which one)."""
    try:
        return await asyncio.wait_for(aw, timeout)
    except Exception as e:
        raise AssertionError(f"flow stage {name!r} failed: {e!r}") from e


@pytest.fixture(scope="module")
def weights():
    """ResNet50's seeded weights from the JAX package (float32, BN
    statistics perturbed)."""
    return perturb_bn(jax_init(JaxResNet50(dtype=jnp.float32), 64), seed=5)


async def _flow(tmp, weights):
    """The slice end to end, in named stages: "JAX cluster up", "JAX
    job" (ResNet50, then the node publishes its weights), "port cluster
    up", "port image job", "LM job", "weights round trip" (the port
    node publishes; the JAX node's file served by the port nodes) and
    "JAX LM backend"."""
    from dml_tpu.inference.engine import InferenceEngine as JaxEngine
    from dml_tpu.inference.generate import LMConfig as JaxLMConfig
    from dml_tpu.inference.lm_backend import LMBackend as JaxLMBackend
    from dml_tpu.models.transformer import TransformerLM
    from dml_tpu_torch.inference import InferenceEngine
    from dml_tpu_torch.inference.generate import LMConfig
    from dml_tpu_torch.inference.lm_backend import LMBackend
    from dml_tpu_torch.models.lm_params import lm_params_from_flax

    out = {}
    images = _jpegs(tmp)
    prompts = _prompts(tmp)
    lm_jax = TransformerLM(dtype=jnp.float32, **LM_SHAPE).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    lm_port = lm_params_from_flax(jax.tree_util.tree_map(np.asarray, lm_jax), device="cpu")
    serve = dict(max_new_tokens=LM_NEW, max_slots=2, max_len=64, chunk=3)

    jeng = JaxEngine(dtype=jnp.float32)
    jeng.load_model("ResNet50", variables=weights, batch_size=ENGINE_BS)
    jc = _Cluster("jax", os.path.join(tmp, "jax"), jeng)
    try:
        await _stage("JAX cluster up", jc.start(), 60.0)

        async def jax_job():
            await jc.put_files(images)
            out["jax_job"] = await jc.run_job("ResNet50", N_QUERIES)
            await jc.client[2].publish_model("ResNet50")
            name = _pkg("jax")[5]("ResNet50")
            out["jax_published"] = await jc.client[1].get_bytes(name)

        await _stage("JAX job", jax_job(), 300.0)
    finally:
        await jc.stop()

    teng = InferenceEngine(dtype=torch.float32, device="cpu")
    teng.load_model("ResNet50", variables=weights, batch_size=ENGINE_BS)
    tc = _Cluster("port", os.path.join(tmp, "port"), teng,
                  lm=lambda: LMBackend(lm_port, LMConfig(dtype=torch.float32, **LM_SHAPE), **serve))
    try:
        await _stage("port cluster up", tc.start(), 60.0)

        async def port_job():
            await tc.put_files(images + prompts)
            out["port_job"] = await tc.run_job("ResNet50", N_QUERIES)

        await _stage("port image job", port_job(), 300.0)

        async def lm_job():
            out["lm_job"] = await tc.run_job("TinyLM", len(prompts))

        await _stage("LM job", lm_job(), 300.0)

        async def round_trip():
            node, store, jobs = tc.client
            await jobs.publish_model("ResNet50")
            name = _pkg("port")[5]("ResNet50")
            out["port_published"] = await store.get_bytes(name)
            # the JAX node's file, published into the port cluster's store
            # as the newest version, then served by the port nodes
            await store.put_bytes(name, out["jax_published"])
            await jobs.load_model_weights("ResNet50")
            out["port_job_jax_weights"] = await tc.run_job("ResNet50", N_QUERIES)

        await _stage("weights round trip", round_trip(), 300.0)
    finally:
        await tc.stop()

    jbe = JaxLMBackend(lm_jax, JaxLMConfig(dtype=jnp.float32, **LM_SHAPE), **serve)
    try:
        out["lm_jax"] = (await _stage("JAX LM backend",
                                      asyncio.to_thread(jbe.serve_files, prompts), 300.0))[0]
    finally:
        jbe.close()
    return out


@pytest.fixture(scope="module")
def flow(tmp_path_factory, weights):
    tmp = str(tmp_path_factory.mktemp("slice"))
    return asyncio.run(_flow(tmp, weights))


def _assert_close_outputs(got, want):
    assert set(got) == set(want) and len(got) == N_FILES
    for k in want:
        assert [r["wnid"] for r in got[k]] == [r["wnid"] for r in want[k]], k
        np.testing.assert_allclose([r["score"] for r in got[k]],
                                   [r["score"] for r in want[k]], atol=1e-4, rtol=0, err_msg=k)


def test_resnet50_job_matches_the_jax_cluster(flow):
    _assert_close_outputs(flow["port_job"], flow["jax_job"])


def test_jax_published_weights_served_by_port_nodes(flow):
    """The same weights through the JAX node's file: the port serves the
    same bits as from the weights given directly."""
    assert flow["port_job_jax_weights"] == flow["port_job"]
    _assert_close_outputs(flow["port_job_jax_weights"], flow["jax_job"])


def test_port_published_weights_read_by_jax_leaf_for_leaf(flow, weights):
    from dml_tpu.models.params_io import variables_from_bytes

    w = weights
    back = variables_from_bytes(flow["port_published"], w)
    want = jax.tree_util.tree_leaves_with_path(w)
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(got) == len(want)
    for path, leaf in want:
        np.testing.assert_array_equal(np.asarray(got[path]), leaf, err_msg=str(path))


def test_lm_job_tokens_equal_the_jax_backend(flow):
    merged = flow["lm_job"]
    want = {os.path.basename(k): v for k, v in flow["lm_jax"].items()}
    assert set(merged) == set(want) and len(merged) == len(LM_PROMPTS)
    for k, v in merged.items():
        assert list(v["tokens"]) == list(want[k]["tokens"]), k
    assert len(merged["p2.tokens.txt"]["tokens"]) == 3


@pytest.mark.parametrize("model", ["ResNet50", "InceptionV3"])
def test_to_flax_variables_inverts_from_flax(model, weights):
    """`params_io.to_flax_variables` gives back the JAX package's tree,
    leaf for leaf (InceptionV3's BN layers have no scale), and JAX's
    `variables_from_bytes` reads the port's bytes of it."""
    from dml_tpu.models.inception import InceptionV3 as JaxInceptionV3
    from dml_tpu.models.params_io import variables_from_bytes
    from dml_tpu_torch.models import params_io
    from dml_tpu_torch.models.registry import get_model

    w = weights if model == "ResNet50" else perturb_bn(
        jax_init(JaxInceptionV3(dtype=jnp.float32), 75), seed=6)
    module = get_model(model).build(dtype=torch.float32)
    back = params_io.to_flax_variables(params_io.from_flax_variables(w, module), module)
    read = variables_from_bytes(params_io.variables_to_bytes(back), w)
    want = jax.tree_util.tree_leaves_with_path(w)
    for tree in (back, read):
        got = dict(jax.tree_util.tree_leaves_with_path(
            jax.tree_util.tree_map(np.asarray, tree)))
        assert len(got) == len(want)
        for path, leaf in want:
            np.testing.assert_array_equal(got[path], leaf, err_msg=str(path))


def test_default_engine_is_cuda(tmp_path):
    """A JobService given no engine builds the port's InferenceEngine on
    cuda, which raises where there is no CUDA device."""
    config, _, Node, Store, Jobs, _ = _pkg("port")
    spec = config.ClusterSpec.localhost(1, base_port=free_port_block(1))
    node = Node(spec, spec.nodes[0])
    jobs = Jobs(node, Store(node, root=str(tmp_path / "st")))
    assert jobs.engine_memory_stats() == {}
    if torch.cuda.is_available():
        assert jobs._ensure_engine().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            jobs._ensure_engine()


async def test_no_batch_starts_while_the_service_stops(tmp_path):
    """A task request that lands while `stop()` reaps its tasks (a
    datagram the node still receives) starts no batch: none outlives the
    stopped service to fail on its stopped node."""
    from dml_tpu_torch.cluster.wire import Message, MsgType

    config, _, Node, Store, Jobs, _ = _pkg("port")
    spec = config.ClusterSpec.localhost(1, base_port=free_port_block(1))
    node = Node(spec, spec.nodes[0])

    async def backend(model, paths):
        return {p: [] for p in paths}, 0.0, None

    jobs = Jobs(node, Store(node, root=str(tmp_path / "st")), infer_backend=backend)
    request = Message("127.0.0.1:1", MsgType.WORKER_TASK_REQUEST,
                      {"job": 1, "batch": 0, "model": "ResNet50", "files": ["a.jpeg"]})

    async def sched_loop():
        try:
            await asyncio.sleep(3600)
        except asyncio.CancelledError:
            await jobs._h_task_request(request, None)
            raise

    from dml_tpu_torch.observability import METRICS

    fails = METRICS.counter("worker_batch_failures_total")
    before = sum(v for _, v in fails.items())
    jobs._sched_task = asyncio.create_task(sched_loop())
    await asyncio.sleep(0)
    await jobs.stop()
    await asyncio.sleep(0.2)  # a batch started during stop() would run and fail by now
    assert not jobs._running
    assert not [t for t in asyncio.all_tasks() if "-task-" in t.get_name() and not t.done()]
    assert sum(v for _, v in fails.items()) == before

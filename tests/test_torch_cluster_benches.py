"""The port's two cluster benches through their `python -m` entries, at
small sizes on the CPU: `jobs.groups.bench_sharded_serving` (ResNet50 at
32x32, 8 queries over 4 files) and `inference.lm_sharded.
bench_lm_sharded_serving` (ShardLM at d 32, 2 prompts a job, 4 tokens,
no steady window). Each holds its tp-2 (and pp-2) group on a group world
of the bench process and one follower rank that it starts (`node
--follow 1`). Both run at once, in subprocesses, once for the module.

Each section holds its product claims (`equal_outputs`; every token
flag, the chaos case's exactly-once tokens, the arms' equality), and its
keys are the JAX function's: the keys of the dict JAX's `run` returns
and of the entries JAX's function adds to it afterwards, read from the
JAX package's source.
"""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys

import pytest

from dml_tpu.inference import lm_sharded as jls
from dml_tpu.jobs import groups as jg
from test_torch_cluster import free_port_block, release_ports

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH_S = 240.0  # each bench process's own limit
N_FILES = 4


def _jax_keys(module, fn_name):
    """(top-level keys, {nested dict name: keys}) of the section JAX's
    `fn_name` returns: its `run`'s returned dict, the `result[...]`
    entries it adds after, and the dicts `run` builds by name."""
    with open(module.__file__) as f:
        tree = ast.parse(f.read())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == fn_name)
    run = next(n for n in ast.walk(fn) if isinstance(n, ast.AsyncFunctionDef) and n.name == "run")
    top, named = set(), {}
    for n in ast.walk(run):
        if isinstance(n, ast.Return) and isinstance(n.value, ast.Dict):
            keys = {k.value for k in n.value.keys if isinstance(k, ast.Constant)}
            if "nodes" in keys:
                top |= keys
        if (isinstance(n, ast.Assign) and isinstance(n.value, ast.Dict)
                and len(n.targets) == 1 and isinstance(n.targets[0], ast.Name)):
            named[n.targets[0].id] = {k.value for k in n.value.keys
                                      if isinstance(k, ast.Constant)}
    for n in fn.body:
        if isinstance(n, ast.Assign):
            for t in n.targets:
                if (isinstance(t, ast.Subscript) and isinstance(t.value, ast.Name)
                        and t.value.id == "result" and isinstance(t.slice, ast.Constant)):
                    top.add(t.slice.value)
    return top, named


class Benches:
    """Both benches' sections and world stats."""

    def __init__(self, out_dir):
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [REPO] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]),
            OMP_NUM_THREADS="2")
        self.bases = [free_port_block(8), free_port_block(8)]
        img, lm = self.bases
        runs = {
            "image": ["-m", "dml_tpu_torch.jobs.groups", "--device", "cpu", "--n-queries", "8",
                      "--n-files", str(N_FILES), "--image-size", "32", "32", "--batch", "4",
                      "--base-port", str(img)],
            "lm": ["-m", "dml_tpu_torch.inference.lm_sharded", "--device", "cpu",
                   "--n-prompts", "2", "--new-tokens", "4", "--steady-s", "0",
                   "--base-port", str(lm), "--lm-spec-json", json.dumps({"d_model": 32, "d_ff": 64})],
        }
        procs = {}
        try:
            for name, argv in runs.items():
                argv = argv + ["--tmp", str(out_dir / name),
                               "--world-stats", str(out_dir / f"{name}_world.json")]
                procs[name] = subprocess.Popen([sys.executable, *argv], cwd=str(out_dir),
                                               stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                               env=env, text=True)
            self.sections, self.world = {}, {}
            for name, p in procs.items():
                out, err = p.communicate(timeout=BENCH_S)
                assert p.returncode == 0, f"{name} bench rc {p.returncode}:\n{err[-4000:]}"
                self.sections[name] = json.loads(out.strip().splitlines()[-1])
                with open(out_dir / f"{name}_world.json") as f:
                    self.world[name] = json.load(f)
        finally:
            for p in procs.values():
                if p.poll() is None:
                    p.kill()
                    p.communicate()
            for b in self.bases:
                release_ports(b, 8)


@pytest.fixture(scope="module")
def benches(tmp_path_factory):
    return Benches(tmp_path_factory.mktemp("cluster_benches"))


def test_sharded_serving_bench_outputs_equal(benches):
    """The tp-2 group over the world serves the job's every file bit for
    bit as the single-chip pass does; the group formed at capacity 2."""
    s = benches.sections["image"]
    assert s["equal_outputs"] is True and s["outputs_compared"] == N_FILES
    assert s["nodes"] == 5 and s["queries"] == 8 and s["image_size"] == [32, 32]
    g = s["groups"]["tp0"]
    assert g["formed"] and g["capacity"] == 2.0 and g["mesh"] == {"dp": 1, "tp": 2, "pp": 1}
    assert s["qps_sharded"] > 0 and s["qps_single_chip"] > 0


def test_sharded_serving_bench_keys_are_jaxs(benches):
    top, _ = _jax_keys(jg, "bench_sharded_serving")
    assert set(benches.sections["image"]) == top


def test_lm_sharded_serving_bench_token_flags(benches):
    """Every form's merged outputs equal the isolated `generate`, the chaos
    case's job completes once with unchanged tokens, the handoff ladder
    adopts every slab, and both arms' outputs equal theirs."""
    s = benches.sections["lm"]
    assert s["tokens_equal_single_chip"] is True
    assert all(m["outputs_equal"] for m in s["modes"].values())
    assert set(s["modes"]) == {"gather", "resident", "pp", "disagg"}
    assert s["modes"]["disagg"]["handoffs"] > 0 and s["kv_handoff_bytes"] > 0
    for form in ("slab_f1", "stream_f1", "stream_f2"):
        assert s["handoff"][form]["fallbacks"] == 0 and s["handoff"][form]["handoffs"] > 0
    assert s["handoff"]["stream_f2"]["peer_slabs"]["H5"] > 0
    c = s["chaos"]
    assert c["completed"] and c["exactly_once_tokens"] and c["verdict_green"]
    assert s["hbm"]["fits_only_pipelined"] is True
    assert s["specdec"]["outputs_equal"] and s["specdec"]["auto_disable"]["outputs_equal"]
    assert s["specdec"]["auto_disable"]["disabled"] is True
    assert s["cb"]["outputs_equal"] is True


def test_lm_sharded_serving_bench_keys_are_jaxs(benches):
    top, named = _jax_keys(jls, "bench_lm_sharded_serving")
    s = benches.sections["lm"]
    assert set(s) == top
    assert set(s["chaos"]) == named["chaos"]
    assert set(s["modes"]["disagg"]) == named["entry"] | {"handoffs", "fallbacks", "handoff_bytes"}


def test_benches_ran_on_a_two_rank_world(benches):
    """Each bench's group world: two gloo ranks on the CPU, whole to the
    end, its engines built through it and its calls carried by it."""
    for name, w in benches.world.items():
        assert (w["size"], w["backend"], w["device"], w["broken"]) == (2, "gloo", "cpu", None), name
        assert w["calls"] > 0 and w["builds"] >= 2 and w["send_s"] >= 0, name
    assert benches.world["lm"]["builds"] == 6  # two meshes, four backends

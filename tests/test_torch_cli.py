"""The port's operator entry points: `cli` (`NodeApp`, every REPL verb,
the subcommands) and `python -m dml_tpu_torch`.

- The JAX package's own cases of test_cli, run against the port
  (`test_torch_cluster.port_cases`, every cluster on a probed block in
  50000-54999). Left out by name: `test_nodeapp_lm_spec_serving`, which
  builds its LM backend through `NodeApp` without a device and so on
  `cuda`; its counterpart here runs the same verbs through
  `NodeApp(..., device="cpu")` and holds the job's tokens to the JAX
  package's `LMBackend` on the same weights file.
- Both packages' CLIs print the same `localspec` JSON and the same chaos
  plans, and have the same menu but for the profiler's name.
- A node on `cuda` with no CUDA device refuses to start before it joins.
- Real processes: `python -m dml_tpu_torch` as an introducer and two
  nodes on the CPU, one REPL driven over stdin through `put`, `ls-all`,
  `submit-job ResNet50 4`, `get-output` and `quit`.
- The new modules import nothing of JAX or the JAX package.
"""

from __future__ import annotations

import ast
import asyncio
import json
import os
import re
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from dml_tpu import cli as jcli
from dml_tpu_torch import cli as tcli
from dml_tpu_torch import config as tconfig

from test_torch_cluster import TESTS, free_port_block, port_cases, release_ports

ROOT = os.path.dirname(TESTS)
if ROOT not in sys.path:  # chip_smoke.py, at the root, has the REPL pipe driver
    sys.path.insert(0, ROOT)
from chip_smoke import ReplPipe  # noqa: E402

#: builds its LM backend on `cuda` (NodeApp via __new__ has no device);
#: counterpart: test_nodeapp_lm_spec_serving_on_cpu below
EXCLUDE = ("test_nodeapp_lm_spec_serving",)
globals().update(port_cases("test_cli", "cli", exclude=EXCLUDE, probe_ports=True))

#: cases test_cli contributes at least
MIN_CASES = {"cli": 5}
#: timing of the clusters started here: a node loading a model in a
#: thread must not miss acks (each process or loop runs one node or two)
TIMING = dict(ping_interval=0.2, ack_timeout=1.0, cleanup_time=5.0, leader_rpc_timeout=10.0)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_port_cases_cover_each_file():
    with open(os.path.join(TESTS, "test_cli.py"), encoding="utf-8") as f:
        want = set(re.findall(r"^(?:async )?def test_(\w+)", f.read(), re.M))
    got = {k[len("cli") + 6:] for k in globals() if k.startswith("test_cli_")}
    assert got == want - {k[5:] for k in EXCLUDE}, sorted(want - got)
    assert len(got) >= MIN_CASES["cli"]


# ----------------------------------------------------------------------
# the two packages' CLIs side by side
# ----------------------------------------------------------------------


def _printed(main, argv, capsys):
    try:
        main(argv)
        code = 0
    except SystemExit as e:
        code = e.code
    return code, capsys.readouterr().out


@pytest.mark.parametrize("argv", [
    ["localspec", "-n", "4"],
    ["localspec", "-n", "3", "--base-port", "23001"],
    ["chaos", "run", "--seed", "7", "--dry-run"],
    ["chaos", "run", "--seed", "7", "--soak", "--dry-run"],
    ["chaos", "run", "--seed", "3", "--scenario", "churn", "--dry-run"],
], ids=["localspec-4", "localspec-3-base", "chaos-7", "chaos-7-soak", "chaos-3-churn"])
def test_subcommand_prints_what_the_jax_cli_prints(argv, capsys):
    want = _printed(jcli.main, argv, capsys)
    got = _printed(tcli.main, argv, capsys)
    assert want[0] == 0 and want[1].strip()
    assert got == want


def test_menu_equal_but_the_profiler():
    """The same verbs and text once the package names are made equal;
    the one difference is the trace verb's profiler."""
    jl = jcli.MENU.splitlines()
    tl = tcli.MENU.replace("dml_tpu_torch", "dml_tpu").splitlines()
    assert len(jl) == len(tl)
    assert [(a, b) for a, b in zip(jl, tl) if a != b] == [
        ("  profile trace start [dir]         capture a jax.profiler (XLA) trace",
         "  profile trace start [dir]         capture a torch.profiler trace")]


def test_module_entry_lists_the_subcommands_and_imports_no_jax():
    """`python -m dml_tpu_torch --help` names every subcommand but
    `lint`, which stays with the JAX package; importing the CLI, the
    tools and params_io loads neither JAX nor the JAX package."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-m", "dml_tpu_torch", "--help"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    verbs = re.search(r"\{([a-z,]+)\}", out.stdout).group(1).split(",")
    assert verbs == ["node", "introducer", "localspec", "chaos", "scale", "autoscale"]
    node = subprocess.run([sys.executable, "-m", "dml_tpu_torch", "node", "--help"], cwd=ROOT,
                          env=env, capture_output=True, text=True, timeout=120)
    assert "--device {cuda,cpu}" in node.stdout and "default cuda" in node.stdout
    probe = ("import sys, dml_tpu_torch.cli, dml_tpu_torch.tools.imagenet_parity, "
             "dml_tpu_torch.models.params_io\n"
             "print(sorted(m for m in sys.modules if m.split('.')[0] in "
             "('jax', 'jaxlib', 'flax', 'dml_tpu', 'tensorflow')))")
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "[]", (out.stdout, out.stderr)


@pytest.mark.parametrize("rel", ["dml_tpu_torch/cli.py", "dml_tpu_torch/__main__.py",
                                 "dml_tpu_torch/tools/__init__.py",
                                 "dml_tpu_torch/tools/imagenet_parity.py",
                                 "dml_tpu_torch/models/params_io.py"])
def test_new_modules_import_no_jax(rel):
    """No import of jax, flax, orbax or the JAX package anywhere in the
    file, at module level or inside a function (TensorFlow only inside
    functions: the Keras fallback of the parity tool)."""
    with open(os.path.join(ROOT, rel), encoding="utf-8") as f:
        tree = ast.parse(f.read())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.append(node.module)
    bad = [n for n in names if n.split(".")[0] in ("jax", "jaxlib", "flax", "orbax", "dml_tpu")]
    assert not bad, bad
    top = [a.name for n in tree.body if isinstance(n, ast.Import) for a in n.names]
    top += [n.module or "" for n in tree.body if isinstance(n, ast.ImportFrom)]
    assert not [t for t in top if t.split(".")[0] in ("tensorflow", "keras", "h5py")]


# ----------------------------------------------------------------------
# NodeApp on the port's device seam
# ----------------------------------------------------------------------


def _spec(tmp_path, n):
    base = free_port_block(n)
    return base, tconfig.ClusterSpec.localhost(
        n, base_port=base, introducer_port=base - 1, timing=tconfig.Timing(**TIMING),
        store=tconfig.StoreConfig(root=str(tmp_path / "roots"), download_dir=str(tmp_path / "dl")))


async def test_nodeapp_without_a_card_refuses_before_it_joins(tmp_path, monkeypatch):
    """`NodeApp(..., device=None)` asks for cuda; with no CUDA device its
    `start` raises "no CUDA device" before the node binds its port, so the
    cluster never sees it; `--device cpu` on the same spec joins."""
    from dml_tpu_torch.cluster.introducer import IntroducerService

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    base, spec = _spec(tmp_path, 2)
    dns = IntroducerService(spec)
    await dns.start()
    other = tcli.NodeApp(spec, "H2", device="cpu")
    try:
        await other.start()
        app = tcli.NodeApp(spec, "H1", device=None)
        assert app.device.type == "cuda"
        with pytest.raises(RuntimeError, match="no CUDA device"):
            await app.start()
        assert app.node.transport is None and not app.node.joined
        await asyncio.sleep(1.0)
        assert [n.name for n in other.node.membership.alive_nodes()] == ["H2"]
        cpu = tcli.NodeApp(spec, "H1", device="cpu")
        await cpu.start()
        try:
            for _ in range(100):
                if len(other.node.membership.alive_nodes()) == 2:
                    break
                await asyncio.sleep(0.1)
            assert sorted(n.name for n in other.node.membership.alive_nodes()) == ["H1", "H2"]
            assert cpu.jobs._ensure_engine().device.type == "cpu"
        finally:
            await cpu.stop()
    finally:
        await other.stop()
        await dns.stop()
        release_ports(base, 2)


def _write(tmp_path, spec):
    path = tmp_path / "spec.json"
    path.write_text(spec.to_json())
    return str(path)


def test_node_subcommand_asks_for_cuda_by_default(tmp_path, monkeypatch):
    """`node` without `--device` builds its NodeApp on cuda, which with
    no CUDA device raises before anything binds a port."""
    async def joined(self):
        raise AssertionError("the node started without its card")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(tcli.Node, "start", joined)
    spec = tconfig.ClusterSpec.localhost(1, base_port=50001, introducer_port=50000)
    argv = ["--log-file", str(tmp_path / "h1.log"), "node", "--spec", _write(tmp_path, spec),
            "--name", "H1", "--no-repl"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(argv)


async def test_nodeapp_lm_spec_serving_on_cpu(tmp_path, capsys, monkeypatch):
    """test_cli's `test_nodeapp_lm_spec_serving` through the port's
    seam: nodes built by `NodeApp(spec, name, lm_specs, device="cpu")`
    boot with an LM spec naming a weights file the JAX package wrote;
    `put`, `submit-job` (case-insensitive model name) and `get-output`
    give the JAX package's `LMBackend` tokens on the same file; the
    trace verbs write a torch.profiler trace."""
    from dml_tpu.inference.lm_backend import LMBackend as JaxLMBackend
    from dml_tpu.inference.lm_backend import lm_spec_parts
    from dml_tpu.models import params_io as jpio
    from dml_tpu_torch.cluster.introducer import IntroducerService
    from dml_tpu_torch.inference.lm_backend import write_prompt_file

    lm_spec = {
        "name": "CliLM", "vocab_size": 61, "d_model": 32,
        "n_heads": 4, "n_kv_heads": 2, "n_layers": 2, "d_ff": 64,
        "dtype": "float32", "max_new_tokens": 6, "max_slots": 2,
        "max_len": 64, "chunk": 4, "seed": 3,
    }
    weights = tmp_path / "clilm.msgpack"
    weights.write_bytes(jpio.variables_to_bytes({"params": lm_spec_parts(lm_spec)[0]}))
    lm_spec["weights"] = str(weights)
    monkeypatch.chdir(tmp_path)  # get-output writes final_<job>.json here
    base, spec = _spec(tmp_path, 2)
    dns = IntroducerService(spec)
    await dns.start()
    apps = []
    try:
        for n in spec.nodes:
            app = tcli.NodeApp(spec, n.name, lm_specs=[dict(lm_spec)], device="cpu")
            await app.start()
            apps.append(app)
        for _ in range(100):
            if all(a.node.joined and a.node.leader_unique for a in apps):
                break
            await asyncio.sleep(0.05)
        out = capsys.readouterr().out
        assert out.count("registered LM serving model 'CliLM' (2L 32d") == 2

        app = apps[-1]
        p = tmp_path / "p0.tokens.txt"
        write_prompt_file(str(p), [3, 1, 4, 1, 5])
        assert await app.handle(f"put {p} p0.tokens.txt")
        assert await app.handle(f"profile trace start {tmp_path / 'trace'}")
        assert await app.handle("submit-job clilm 3")
        assert await app.handle("profile trace stop")
        out = capsys.readouterr().out
        assert "DONE: 3 queries" in out and "trace written" in out
        assert os.listdir(tmp_path / "trace")
        assert await app.handle("profile trace stop")
        assert "!! RuntimeError: no trace is running" in capsys.readouterr().out
        assert await app.handle("get-output 1")
        assert "ok 1 results" in capsys.readouterr().out
        with open("final_1.json") as f:
            merged = json.load(f)
        jbe = JaxLMBackend.from_spec(lm_spec)
        try:
            want, _, _ = jbe.serve_files([str(p)])
        finally:
            jbe.close()
        assert list(merged) == ["p0.tokens.txt"]
        assert merged["p0.tokens.txt"]["tokens"] == list(want[str(p)]["tokens"])
        assert len(merged["p0.tokens.txt"]["tokens"]) == 6
    finally:
        for app in reversed(apps):
            await app.stop()
        await dns.stop()
        release_ports(base, 2)


# ----------------------------------------------------------------------
# python -m dml_tpu_torch as processes
# ----------------------------------------------------------------------


def test_node_processes_serve_a_job_through_the_repl(tmp_path):
    from PIL import Image

    base, spec = _spec(tmp_path, 2)
    path = _write(tmp_path, spec)
    env = dict(os.environ, PYTHONPATH=ROOT, PYTHONUNBUFFERED="1", OMP_NUM_THREADS="2",
               JAX_PLATFORMS="cpu")

    def start(*argv, **kw):
        log = ["--log-file", str(tmp_path / f"{argv[0]}{len(procs)}.log")]
        return subprocess.Popen([sys.executable, "-m", "dml_tpu_torch", *log, *argv], cwd=tmp_path,
                                env=env, text=True, **kw)

    procs = []
    t0 = time.monotonic()
    try:
        procs.append(start("introducer", "--spec", path))
        procs.append(start("node", "--spec", path, "--name", "H1", "--device", "cpu", "--no-repl"))
        procs.append(start("node", "--spec", path, "--name", "H2", "--device", "cpu",
                           stdin=subprocess.PIPE, stdout=subprocess.PIPE))
        repl = ReplPipe(procs[-1], "H2")
        for _ in range(100):
            alive = [ln for ln in repl.run("list_mem", 30) if "ALIVE" in ln]
            if len(alive) == 2 and any("*leader*" in ln for ln in alive):
                break
            time.sleep(0.2)
        else:
            raise AssertionError(f"the node processes did not converge: {alive}")
        rng = np.random.RandomState(5)
        for i in range(4):
            Image.fromarray(rng.randint(0, 256, (64, 64, 3)).astype(np.uint8)).save(
                tmp_path / f"img{i}.jpeg", quality=90)
            out = repl.run(f"put {tmp_path / f'img{i}.jpeg'} img{i}.jpeg", 30)
            assert any(ln.startswith("ok version=1") for ln in out), out
        out = repl.run("ls-all", 30)
        assert out[-1] == "(4 files)" and all(f"img{i}.jpeg  versions=[1]" in out for i in range(4))
        out = repl.run("submit-job ResNet50 4", 120)
        done = [ln for ln in out if "DONE: 4 queries" in ln]
        assert done, out
        jid = re.match(r"job (\d+) DONE", done[0]).group(1)
        out = repl.run(f"get-output {jid}", 30)
        assert out == [f"ok 4 results -> final_{jid}.json"], out
        with open(tmp_path / f"final_{jid}.json") as f:
            merged = json.load(f)
        assert sorted(merged) == [f"img{i}.jpeg" for i in range(4)]
        assert all(len(rows) == 5 for rows in merged.values())
        procs[-1].stdin.write("quit\n")
        procs[-1].stdin.close()
        assert procs[-1].wait(timeout=30) == 0
        for p in procs[:-1]:
            p.send_signal(signal.SIGTERM)
        assert [p.wait(timeout=30) for p in procs[:-1]] == [0, 0]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        release_ports(base, 2)
    assert time.monotonic() - t0 < 90

"""The port's pipeline form (`dml_tpu_torch.parallel.pipeline`) against the
JAX package's (`dml_tpu/parallel/pipeline.py`) on the CPU.

One module-scoped session of four gloo ranks (real processes, rendezvous
through a `file://` under the test's temporary directory) runs
`pipeline_apply` over three meshes of the four ranks, (pp 4), (dp 2, pp
2) (each dp row pipelines its slice of the batch) and (tp 2, pp 2), and
writes its results; the test functions read them. The JAX side runs in
this process on the first four of the tests' 8 virtual CPU devices with
the same meshes and the same seeded numpy stage params.

Tolerances (`tests/test_pipeline.py`'s): outputs within 1e-5 of
sequential apply and of JAX's `pipeline_apply`, gradients (each rank's
stage row, the input's) within 1e-5, `remat=True` within 1e-6 of the
plain run; this rank's slice of the stack and the whole stack give
bit-equal outputs.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dml_tpu.config import MeshSpec as JaxMeshSpec
from dml_tpu.parallel.mesh import make_mesh as jax_make_mesh
from dml_tpu.parallel.pipeline import pipeline_apply as jax_pipeline_apply
from dml_tpu.parallel.pipeline import stack_stage_params as jax_stack
from dml_tpu_torch.parallel.pipeline import pipeline_apply, stack_stage_params, stage_sharding
from dml_tpu_torch.parallel.sharding import P

WORLD, D = 4, 8
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {"pp4": dict(dp=1, pp=4), "dp2_pp2": dict(dp=2, pp=2), "tp2_pp2": dict(dp=1, tp=2, pp=2)}

CHILD = r'''
import os, sys
import numpy as np
import torch

torch.set_num_threads(1)
import torch.distributed as dist

out_dir, rank, world = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
dist.init_process_group("gloo", init_method="file://" + os.path.join(out_dir, "rendezvous"),
                        world_size=world, rank=rank)

from dml_tpu_torch.config import MeshSpec
from dml_tpu_torch.parallel.mesh import make_mesh
from dml_tpu_torch.parallel.pipeline import pipeline_apply, stack_stage_params, stage_slice

inp = dict(np.load(os.path.join(out_dir, "inputs.npz")))
meshes = torch.load(os.path.join(out_dir, "meshes.pt"))


def stage_fn(params, x):
    return torch.tanh(x @ params["w"] + params["b"])


def stacked(name, grad=False):
    s = meshes[name]["pp"]
    st = stack_stage_params([{"w": torch.from_numpy(inp[f"{name}/w{i}"]),
                              "b": torch.from_numpy(inp[f"{name}/b{i}"])} for i in range(s)])
    return {k: v.clone().requires_grad_(grad) for k, v in st.items()}


R = {}
for name, shape in meshes.items():
    mesh = make_mesh(MeshSpec(**shape))
    x = torch.from_numpy(inp["x"])
    r = {"coords": mesh.coords}
    for m in (2, 4):
        r[f"y_m{m}"] = pipeline_apply(stage_fn, stacked(name), x, mesh=mesh, num_microbatches=m)
    r["y_remat"] = pipeline_apply(stage_fn, stacked(name), x, mesh=mesh, num_microbatches=4,
                                  remat=True)
    r["y_slice"] = pipeline_apply(stage_fn, stage_slice(stacked(name), mesh), x, mesh=mesh,
                                  num_microbatches=2)
    for remat in (False, True):
        st = stacked(name, grad=True)
        xg = torch.from_numpy(inp["xg"]).requires_grad_(True)
        y = pipeline_apply(stage_fn, st, xg, mesh=mesh, num_microbatches=2, remat=remat)
        loss = torch.mean((y - torch.from_numpy(inp["tgt"])) ** 2)
        loss.backward()
        r[f"grad{'_remat' if remat else ''}"] = {
            "w": st["w"].grad, "b": st["b"].grad, "x": xg.grad, "loss": float(loss)}
    R[name] = r
torch.save(R, os.path.join(out_dir, f"rank{rank}.pt"))
dist.barrier()
print(f"RANK_OK {rank}", flush=True)
'''


def stage_fn(params, x):
    return jnp.tanh(x @ params["w"] + params["b"])


def make_params(seed, s):
    rng = np.random.RandomState(seed)
    return [{"w": (rng.randn(D, D) * 0.3).astype(np.float32),
             "b": (rng.randn(D) * 0.1).astype(np.float32)} for _ in range(s)]


class Session:
    def __init__(self, out_dir):
        self.dir = out_dir
        inp = {"x": np.random.RandomState(1).randn(8, D).astype(np.float32),
               "xg": np.random.RandomState(3).randn(4, D).astype(np.float32),
               "tgt": np.random.RandomState(4).randn(4, D).astype(np.float32)}
        self.params = {}
        for seed, (name, shape) in enumerate(MESHES.items()):
            per = make_params(seed, shape["pp"])
            self.params[name] = per
            for i, p in enumerate(per):
                inp[f"{name}/w{i}"], inp[f"{name}/b{i}"] = p["w"], p["b"]
        self.inputs = inp
        np.savez(out_dir / "inputs.npz", **inp)
        torch.save(MESHES, out_dir / "meshes.pt")
        (out_dir / "child.py").write_text(CHILD)
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join([REPO] + env.get("PYTHONPATH", "").split(os.pathsep))
        self.procs = [subprocess.Popen(
            [sys.executable, str(out_dir / "child.py"), str(out_dir), str(r), str(WORLD)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, text=True)
            for r in range(WORLD)]
        self._results = None

    def results(self):
        if self._results is None:
            outs = []
            try:
                for p in self.procs:
                    outs.append(p.communicate(timeout=180)[0])
            except subprocess.TimeoutExpired:
                for p in self.procs:
                    p.kill()
                pytest.fail("the gloo ranks hung:\n" + "\n---\n".join(outs))
            for r, (p, out) in enumerate(zip(self.procs, outs)):
                assert p.returncode == 0 and f"RANK_OK {r}" in out, f"rank {r} failed:\n{out}"
            self._results = [torch.load(self.dir / f"rank{r}.pt", weights_only=False)
                             for r in range(WORLD)]
        return self._results


@pytest.fixture(scope="module")
def session(tmp_path_factory):
    s = Session(tmp_path_factory.mktemp("pp_ranks"))
    yield s
    for p in s.procs:
        if p.poll() is None:
            p.kill()
            p.wait()


def _jax_mesh(name):
    return jax_make_mesh(JaxMeshSpec(**MESHES[name]), devices=jax.devices()[:WORLD])


def _sequential(per, x):
    for p in per:
        x = stage_fn(p, x)
    return np.asarray(x)


def _jax_stacked(per):
    return jax_stack([{k: jnp.asarray(v) for k, v in p.items()} for p in per])


@pytest.mark.pp
@pytest.mark.parametrize("num_microbatches", [2, 4])
@pytest.mark.parametrize("name", list(MESHES))
def test_pipeline_matches_sequential_and_jax(session, name, num_microbatches):
    per = session.params[name]
    x = jnp.asarray(session.inputs["x"])
    want = jax.jit(lambda p, x: jax_pipeline_apply(
        stage_fn, p, x, mesh=_jax_mesh(name), num_microbatches=num_microbatches))(
        _jax_stacked(per), x)
    ref = _sequential(per, x)
    for r, res in enumerate(session.results()):
        got = res[name][f"y_m{num_microbatches}"].numpy()
        np.testing.assert_allclose(got, ref, atol=1e-5, err_msg=f"rank {r}")
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, err_msg=f"rank {r}")


@pytest.mark.pp
@pytest.mark.parametrize("name", list(MESHES))
def test_pipeline_gradients_match_sequential_and_jax(session, name):
    """Each rank's stage row of the stack's gradient is JAX's row (the
    other rows stay zero: a rank holds one stage), and the input's
    gradient comes back whole on every rank."""
    per = session.params[name]
    xg = jnp.asarray(session.inputs["xg"])
    tgt = jnp.asarray(session.inputs["tgt"])
    s = MESHES[name]["pp"]

    def loss_pipe(p, x):
        y = jax_pipeline_apply(stage_fn, p, x, mesh=_jax_mesh(name), num_microbatches=2)
        return jnp.mean((y - tgt) ** 2)

    def loss_seq(stacked, x):
        rows = [jax.tree_util.tree_map(lambda l: l[i], stacked) for i in range(s)]
        return jnp.mean((_seq_jnp(rows, x) - tgt) ** 2)

    g_pipe = jax.jit(jax.grad(loss_pipe, argnums=(0, 1)))(_jax_stacked(per), xg)
    g_seq = jax.jit(jax.grad(loss_seq, argnums=(0, 1)))(_jax_stacked(per), xg)
    for r, res in enumerate(session.results()):
        stage = res[name]["coords"]["pp"]
        for key in ("grad", "grad_remat"):
            got = res[name][key]
            for leaf in ("w", "b"):
                g = got[leaf].numpy()
                for want in (g_pipe, g_seq):
                    np.testing.assert_allclose(g[stage], np.asarray(want[0][leaf][stage]),
                                               atol=1e-5, err_msg=f"rank {r} {key} {leaf}")
                others = [i for i in range(s) if i != stage]
                assert not g[others].any(), f"rank {r} {key}: gradient outside its stage"
            for want in (g_pipe, g_seq):
                np.testing.assert_allclose(got["x"].numpy(), np.asarray(want[1]), atol=1e-5,
                                           err_msg=f"rank {r} {key} x")


def _seq_jnp(rows, x):
    for p in rows:
        x = stage_fn(p, x)
    return x


@pytest.mark.pp
@pytest.mark.parametrize("name", list(MESHES))
def test_pipeline_remat_and_stage_slice_match(session, name):
    """`remat=True` gives the plain run's output (1e-6; the gradients are
    checked against JAX above), and a rank's `stage_slice` the whole
    stack's, bit for bit."""
    for r, res in enumerate(session.results()):
        np.testing.assert_allclose(res[name]["y_remat"].numpy(), res[name]["y_m4"].numpy(),
                                   atol=1e-6, err_msg=f"rank {r}")
        assert torch.equal(res[name]["y_slice"], res[name]["y_m2"]), f"rank {r}"
        assert res[name]["grad"]["loss"] == res[name]["grad_remat"]["loss"]


def test_pipeline_rejects_ragged_microbatches():
    per = [{k: torch.from_numpy(v) for k, v in p.items()} for p in make_params(0, 4)]
    with pytest.raises(ValueError, match="divisible"):
        pipeline_apply(lambda p, x: x, stack_stage_params(per), torch.zeros(6, D),
                       mesh={"dp": 2, "pp": 4}, num_microbatches=4)


def test_stack_and_stage_sharding_match_jax():
    """The stack is JAX's, bit for bit, and every leaf's spec puts its
    stage axis over pp; on one device (S = 1) `pipeline_apply` is the
    stage applied microbatch by microbatch."""
    per = make_params(5, 4)
    got = stack_stage_params([{k: torch.from_numpy(v) for k, v in p.items()} for p in per])
    want = _jax_stacked(per)
    for k in ("w", "b"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    assert stage_sharding(None, got) == {"w": P("pp", None, None), "b": P("pp", None)}
    one = {k: v[:1] for k, v in got.items()}
    x = torch.from_numpy(np.random.RandomState(6).randn(4, D).astype(np.float32))
    y = pipeline_apply(lambda p, x: torch.tanh(x @ p["w"] + p["b"]), one, x, mesh=None,
                       num_microbatches=2)
    np.testing.assert_allclose(y.numpy(), np.asarray(stage_fn(
        {k: jnp.asarray(v) for k, v in per[0].items()}, jnp.asarray(x.numpy()))), atol=1e-6)

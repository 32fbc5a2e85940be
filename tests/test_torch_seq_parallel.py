"""The port's sequence- and expert-parallel forms (`dml_tpu_torch.parallel.
mesh.all_to_all` and `ring_shift`, `ring_attention`, `ulysses`, `moe` over
ep, and `long_context.LongContextLM` over a dp x sp x tp x ep mesh)
against the JAX package's, on the CPU.

As in tests/test_torch_parallel.py, one module-scoped session of four
gloo ranks (real processes, rendezvous through a `file://` under the
test's temporary directory) runs every check and writes its results
there; the test functions read them. The ranks import torch and the
port only. The JAX side runs in this process on the first four of the
tests' 8 virtual CPU devices, on the same meshes, with the same seeded
numpy inputs and the same weights (the JAX modules' init, converted by
`models.lm_params` and handed to the ranks as torch tensors). A rank
passes its own shard (dp rows, sp slice); the test puts the ranks'
shards together by their mesh coordinates.

Tolerances:
- ring attention, dense and flash bodies, causal and full, and Ulysses
  against the JAX function and against the ring, GQA included: rtol and
  atol 2e-5 (tests/test_ring_attention.py:20-50, tests/test_ulysses.py);
- the ring's flash gradients: atol 5e-5, rtol 5e-4 (tests/
  test_ring_attention.py:53-75); Ulysses' gradients: rtol and atol 5e-5
  (tests/test_ulysses.py:67-81); token 0 of a causal ring: 1e-5;
- MoE over ep: the output within atol 1e-4 of JAX's (tests/test_moe.py:
  106-150), the pieces of `partition_params` bitwise JAX's device shards;
- LongContextLM against JAX's on the same mesh from the same initial
  state, float32: losses within 1e-5 relative over 4 steps (2 at tp 2);
  the router's and the embedding's gradients at ep 2 within 1e-6 of ep
  1's; greedy tokens equal (float32 against JAX's, int8 KV cache against
  the port's one device); a checkpoint written at dp 2 x sp 2 restores at
  one device bitwise;
- the collectives: exact.
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
from dml_tpu.parallel.long_context import LongContextLM as JaxLCLM
from dml_tpu.parallel.long_context import lm_loss as jax_lm_loss
from dml_tpu.parallel.mesh import make_mesh as jax_make_mesh
from dml_tpu.parallel.moe import MoEMLP as JaxMoE
from dml_tpu.parallel.ring_attention import reference_attention as jax_reference
from dml_tpu.parallel.ring_attention import ring_attention as jax_ring
from dml_tpu.parallel.sharding import partition_params as jax_partition_params
from dml_tpu.parallel.ulysses import ulysses_attention as jax_ulysses
from dml_tpu_torch.models.lm_params import lm_params_from_flax, state_dict_of
from dml_tpu_torch.parallel.long_context import LongContextLM, make_lm

WORLD = 4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AXES = ("dp", "tp", "sp", "pp", "ep")
MESHES = {"dp1_sp4": dict(dp=1, sp=4), "dp2_sp2": dict(dp=2, sp=2), "dp2_ep2": dict(dp=2, ep=2),
          "sp2_ep2": dict(dp=1, sp=2, ep=2), "tp2_sp2": dict(dp=1, tp=2, sp=2)}
SMALL = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64)
LM_CASES = {  # name: (mesh, config, tokens, steps)
    "ring_gqa": ("dp2_sp2", dict(SMALL, seq_len=64, n_kv_heads=2, learning_rate=1e-2), "periodic", 4),
    "ulysses": ("dp2_sp2", dict(SMALL, seq_len=64, learning_rate=1e-2, seq_parallel="ulysses"),
                "periodic", 4),
    "moe_ep": ("sp2_ep2", dict(seq_len=32, vocab_size=16, d_model=16, n_heads=2, n_layers=2,
                               d_ff=32, num_experts=4, moe_every=2), "moe", 4),
    "tp_sp": ("tp2_sp2", dict(SMALL, seq_len=64, n_kv_heads=2), "random", 2),
}
PROMPT = np.array([[5, 9, 2, 7, 1]], np.int32)

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
from dml_tpu_torch.parallel.long_context import LongContextLM
from dml_tpu_torch.parallel.mesh import all_to_all, make_mesh, ring_shift
from dml_tpu_torch.parallel.moe import MoEMLP
from dml_tpu_torch.parallel.ring_attention import ring_attention
from dml_tpu_torch.parallel.sharding import partition_params, shard
from dml_tpu_torch.parallel.ulysses import ulysses_attention

inp = {k: torch.from_numpy(v) for k, v in np.load(os.path.join(out_dir, "inputs.npz")).items()}
weights = torch.load(os.path.join(out_dir, "weights.pt"), weights_only=True)
spec = torch.load(os.path.join(out_dir, "spec.pt"), weights_only=False)
f32 = torch.float32
# every rank makes every mesh, in one order (make_mesh is collective)
meshes = {k: make_mesh(MeshSpec(**v)) for k, v in spec["meshes"].items()}
m01 = make_mesh(MeshSpec(dp=1, sp=2), ranks=[0, 1])  # ep 1 beside sp2_ep2
R = {"coords": {k: m.coords for k, m in meshes.items()}}


def block(x, mesh):
    """This rank's dp rows and sp slice of a global [B, T, ...]."""
    dp, sp, i, s = mesh.shape["dp"], mesh.shape["sp"], mesh.coords["dp"], mesh.coords["sp"]
    b, t = x.shape[0] // dp, x.shape[1] // sp
    return x[i * b:(i + 1) * b, s * t:(s + 1) * t].contiguous()


def raises(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


# ---- collectives ----
m = meshes["dp2_sp2"]
x = block(inp["coll"], m).requires_grad_()
y = all_to_all(x, m, "sp", split_dim=2, concat_dim=1)
z = ring_shift(x, m, "sp")
(y * inp["coll_w"][:, :, :2]).sum().backward()
R["coll"] = {"a2a": y.detach(), "a2a_back": all_to_all(y.detach(), m, "sp", 1, 2),
             "a2a_grad": x.grad.clone(), "shift": z.detach()}
x.grad = None
(z * 3).sum().backward()
R["coll"]["shift_grad"] = x.grad

# ---- ring attention ----
q, k, v = inp["q"], inp["k"], inp["v"]
for name in ("dp1_sp4", "dp2_sp2"):
    mesh = meshes[name]
    for body in ("dense", "flash"):
        for causal in (True, False):
            R[f"ring/{name}/{body}/{causal}"] = ring_attention(
                block(q, mesh), block(k, mesh), block(v, mesh), mesh, causal=causal,
                use_flash=body == "flash")
mesh = meshes["dp2_sp2"]
gq, gk, gv = (block(inp[n], mesh).requires_grad_() for n in ("gq", "gk", "gv"))
out = ring_attention(gq, gk, gv, mesh, causal=True, use_flash=True)
torch.sin(out).sum().backward()
R["ring_grads"] = [t.grad for t in (gq, gk, gv)]
mesh = meshes["dp1_sp4"]
R["tok0"] = ring_attention(block(q[:1], mesh), block(k[:1], mesh), block(v[:1], mesh), mesh,
                           causal=True)[0, 0]

# ---- Ulysses ----
for name in ("dp1_sp4", "dp2_sp2"):
    mesh = meshes[name]
    for causal in (True, False):
        for flash in (False, True):
            R[f"uly/{name}/{causal}/{flash}"] = ulysses_attention(
                block(q, mesh), block(k, mesh), block(v, mesh), mesh, causal=causal,
                use_flash=flash or None)
mesh = meshes["dp1_sp4"]
q8 = block(inp["q8"], mesh)
R["uly_h8"] = ulysses_attention(q8, block(inp["k8"], mesh), block(inp["v8"], mesh), mesh)
R["ring_h8"] = ring_attention(q8, block(inp["k8"], mesh), block(inp["v8"], mesh), mesh)
for kv in (2, 4):
    R[f"uly_gqa{kv}"] = ulysses_attention(q8, block(inp[f"k_kv{kv}"], mesh),
                                          block(inp[f"v_kv{kv}"], mesh), mesh)
R["uly_err_heads"] = raises(lambda: ulysses_attention(
    block(inp["q3"], mesh), block(inp["q3"], mesh), block(inp["q3"], mesh), mesh))
R["uly_err_kv"] = raises(lambda: ulysses_attention(
    q8, block(inp["q3"], mesh), block(inp["q3"], mesh), mesh))
R["lm_err_seq"] = raises(lambda: LongContextLM(mesh, seq_len=30, device="cpu", **spec["small"]))
mesh = meshes["dp2_sp2"]
for flash in (False, True):
    gq, gk, gv = (block(inp[n], mesh).requires_grad_() for n in ("gq", "gk", "gv"))
    (ulysses_attention(gq, gk, gv, mesh, use_flash=flash or None) ** 2).sum().backward()
    R[f"uly_grads/{flash}"] = [t.grad for t in (gq, gk, gv)]
mesh = meshes["dp2_ep2"]  # sp 1: one local call
R["uly_sp1"] = ulysses_attention(*(block(inp[f"sp1_{n}"], mesh) for n in "qkv"), mesh)
R["uly_sp1_gqa"] = ulysses_attention(*(block(inp[f"sp1_{n}"], mesh) for n in ("q8", "k2", "v2")),
                                     mesh)

# ---- MoE over ep ----
mesh = meshes["dp2_ep2"]
specs = partition_params(weights["moe"], mesh)
pieces = {n: shard(t, specs[n], mesh) for n, t in weights["moe"].items()}
moe = MoEMLP(8, 4, 16, capacity_factor=8.0, mesh=mesh, dtype=f32)
moe.load_state_dict(pieces)
R["moe"] = {"specs": {n: tuple(s) for n, s in specs.items()}, "pieces": pieces,
            "y": moe(block(inp["moe_x"], mesh))[0].detach(), "local": tuple(moe.w_up.shape)}
for name in ("dp2_ep2", "sp2_ep2"):  # E 3 over ep 2, B 3 over dp 2, T 5 over sp 2: replicated
    fb = MoEMLP(8, 3, 16, capacity_factor=8.0, mesh=meshes[name], dtype=f32)
    fb.load_state_dict(weights["moe_fb"])
    R[f"moe_fb/{name}"] = fb(inp["moe_fb_x"])[0].detach()

# ---- LongContextLM ----


def set_params(lm, params):
    state = lm.state
    state["params"] = params
    lm.state = state


for case, (mesh_name, cfg, tok_name, steps) in spec["lm"].items():
    mesh = meshes[mesh_name]
    toks = inp[f"tok_{tok_name}"].numpy()
    lm = LongContextLM(mesh, dtype=f32, device="cpu", **cfg)
    set_params(lm, weights[f"lm/{case}"])
    res = R[f"lm/{case}"] = {"shard_shapes": {n: tuple(p.shape)
                                              for n, p in lm.model.named_parameters()}}
    if case == "tp_sp":
        res["gen"] = lm.generate(inp["prompt"].numpy(), 6)
        res["gen_kvq"] = lm.generate(inp["prompt"].numpy(), 6, kv_quant=True)
    if case == "moe_ep":
        res["logits"] = lm.forward(toks)
    res["losses"] = [lm.train_step(toks)]
    if case == "moe_ep":
        res["grads"] = {n: p.grad.clone() for n, p in lm.model.named_parameters()
                        if n in ("embed.embedding", "block_1.moe.router.kernel")}
    res["losses"] += [lm.train_step(toks) for _ in range(steps - 1)]
    if case == "ring_gqa":
        lm.save_checkpoint(os.path.join(out_dir, "ck"))
        state = lm.state
        if rank == 0:
            torch.save(state, os.path.join(out_dir, "ck_state.pt"))
    del lm
if m01.rank is not None:  # the MoE LM at ep 1 on the same dp x sp, one step
    mesh_name, cfg, tok_name, _ = spec["lm"]["moe_ep"]
    lm = LongContextLM(m01, dtype=f32, device="cpu", **cfg)
    set_params(lm, weights["lm/moe_ep"])
    R["moe_ep1_loss"] = lm.train_step(inp["tok_moe"].numpy())
    R["moe_ep1_grads"] = {n: p.grad.clone() for n, p in lm.model.named_parameters()
                          if n in ("embed.embedding", "block_1.moe.router.kernel")}

torch.save(R, os.path.join(out_dir, f"rank{rank}.pt"))
dist.barrier()
dist.destroy_process_group()
print(f"RANK_OK {rank}", flush=True)
'''


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _jax_mesh(name):
    return jax_make_mesh(JaxMeshSpec(**MESHES[name]), devices=jax.devices()[:WORLD])


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _moe_flat(params):
    """A JAX MoEMLP's params as the port's state_dict (the same layouts)."""
    return {"router.kernel": torch.from_numpy(np.array(params["router"]["kernel"])),
            "w_up": torch.from_numpy(np.array(params["w_up"])),
            "w_down": torch.from_numpy(np.array(params["w_down"]))}


def _tokens():
    rng = np.random.RandomState(0)
    return {"periodic": np.tile(np.tile(np.arange(8), 8)[None, :64], (2, 1)).astype(np.int32),
            "moe": rng.randint(0, 16, (2, 32)).astype(np.int32),
            "random": rng.randint(0, 64, (2, 64)).astype(np.int32)}


class Session:
    def __init__(self, out_dir):
        self.dir = out_dir
        rng = np.random.RandomState(0)

        def normal(*shape):
            return rng.standard_normal(shape).astype(np.float32)

        inp = {"coll": np.arange(2 * 8 * 4 * 3, dtype=np.float32).reshape(2, 8, 4, 3),
               "coll_w": normal(1, 8, 4, 3),
               "q": normal(2, 64, 4, 16), "k": normal(2, 64, 4, 16), "v": normal(2, 64, 4, 16),
               "gq": normal(2, 32, 4, 16), "gk": normal(2, 32, 4, 16), "gv": normal(2, 32, 4, 16),
               "q8": normal(2, 64, 8, 16), "k8": normal(2, 64, 8, 16), "v8": normal(2, 64, 8, 16),
               "k_kv2": normal(2, 64, 2, 16), "v_kv2": normal(2, 64, 2, 16),
               "k_kv4": normal(2, 64, 4, 16), "v_kv4": normal(2, 64, 4, 16),
               "q3": normal(2, 64, 3, 16),
               "sp1_q": normal(4, 64, 4, 16), "sp1_k": normal(4, 64, 4, 16),
               "sp1_v": normal(4, 64, 4, 16), "sp1_q8": normal(4, 64, 8, 16),
               "sp1_k2": normal(4, 64, 2, 16), "sp1_v2": normal(4, 64, 2, 16),
               "moe_x": np.random.RandomState(2).randn(4, 8, 8).astype(np.float32),
               "moe_fb_x": np.random.RandomState(5).randn(3, 5, 8).astype(np.float32),
               "prompt": PROMPT}
        inp.update({f"tok_{k}": v for k, v in _tokens().items()})
        self.inputs = inp
        # weights: the JAX modules' init, in the port's names
        self.jax_moe = {
            "params": JaxMoE(num_experts=4, d_ff=16, capacity_factor=8.0, dtype=jnp.float32).init(
                jax.random.PRNGKey(0), jnp.asarray(inp["moe_x"]))["params"],
            "fb_params": JaxMoE(num_experts=3, d_ff=16, capacity_factor=8.0, dtype=jnp.float32).init(
                jax.random.PRNGKey(0), jnp.asarray(inp["moe_fb_x"]))["params"]}
        weights = {"moe": _moe_flat(self.jax_moe["params"]),
                   "moe_fb": _moe_flat(self.jax_moe["fb_params"])}
        self.jax_lm = {}
        for case, (mesh_name, cfg, _, _) in LM_CASES.items():
            jlm = JaxLCLM(_jax_mesh(mesh_name), dtype=jnp.float32, **cfg)
            self.jax_lm[case] = jlm
            weights[f"lm/{case}"] = state_dict_of(
                lm_params_from_flax(_host(jlm.state["params"]), device="cpu"))
        self.weights = weights
        np.savez(out_dir / "inputs.npz", **inp)
        torch.save(weights, out_dir / "weights.pt")
        torch.save({"meshes": MESHES, "lm": LM_CASES, "small": SMALL}, out_dir / "spec.pt")
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

    def assemble(self, mesh_name, get):
        """The global array from the ranks' shards `get(R)` (dp rows, sp
        slice), by each rank's coordinates (tp and ep ranks repeat)."""
        shape = MESHES[mesh_name]
        pieces = {}
        for R in self.results():
            c = R["coords"][mesh_name]
            pieces[(c["dp"], c["sp"])] = get(R).detach().numpy()
        return np.concatenate([
            np.concatenate([pieces[(i, s)] for s in range(shape.get("sp", 1))], axis=1)
            for i in range(shape.get("dp", 1))], axis=0)


@pytest.fixture(scope="module")
def session(tmp_path_factory):
    s = Session(tmp_path_factory.mktemp("sp_ranks"))
    yield s
    for p in s.procs:
        if p.poll() is None:
            p.kill()
            p.wait()


def _j(session, *names):
    return [jnp.asarray(session.inputs[n]) for n in names]


def _key(key):
    return lambda R: R[key]


# ---- collectives ----

def test_all_to_all_and_ring_shift_with_their_gradients(session):
    x, w = session.inputs["coll"], session.inputs["coll_w"][0]
    for R in session.results():
        c = R["coords"]["dp2_sp2"]
        dp, s = c["dp"], c["sp"]
        mine = x[dp:dp + 1, 4 * s:4 * s + 4]
        got = R["coll"]
        # tiled all_to_all: heads split over sp, the sequence gathered; and back
        np.testing.assert_array_equal(got["a2a"].numpy(), x[dp:dp + 1, :, 2 * s:2 * s + 2])
        np.testing.assert_array_equal(got["a2a_back"].numpy(), mine)
        # its gradient, the inverse all_to_all of the cotangent w[:, :, :2]:
        # each sp rank j sends back rows 4s..4s+4 for heads 2j..2j+2
        want = np.concatenate([w[None, 4 * s:4 * s + 4, :2]] * 2, axis=2)
        np.testing.assert_array_equal(got["a2a_grad"].numpy(), want)
        # ring shift: the previous rank's shard; its gradient comes back
        np.testing.assert_array_equal(got["shift"].numpy(), x[dp:dp + 1, 4 * (1 - s):4 * (2 - s)])
        np.testing.assert_array_equal(got["shift_grad"].numpy(), np.full_like(mine, 3.0))


# ---- ring attention ----

@pytest.mark.parametrize("mesh_name", ["dp1_sp4", "dp2_sp2"])
@pytest.mark.parametrize("body", ["dense", "flash"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_ring_attention_matches_jax(session, mesh_name, body, causal):
    q, k, v = _j(session, "q", "k", "v")
    want = jax_ring(q, k, v, _jax_mesh(mesh_name), causal=causal, use_flash=body == "flash")
    got = session.assemble(mesh_name, _key(f"ring/{mesh_name}/{body}/{causal}"))
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, np.asarray(jax_reference(q, k, v, causal=causal)),
                               rtol=2e-5, atol=2e-5)


def test_ring_flash_gradients_match_jax(session):
    q, k, v = _j(session, "gq", "gk", "gv")
    mesh = _jax_mesh("dp2_sp2")

    def loss(q, k, v):
        out = jax_ring(q, k, v, mesh, causal=True, use_flash=True)
        return jnp.sum(jnp.sin(out.astype(jnp.float32)))

    want = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
    for i, name in enumerate("qkv"):
        got = session.assemble("dp2_sp2", lambda R, i=i: R["ring_grads"][i])
        np.testing.assert_allclose(got, np.asarray(want[i]), atol=5e-5, rtol=5e-4,
                                   err_msg=f"d{name}")


def test_ring_first_token_attends_only_itself(session):
    v = session.inputs["v"]
    first = next(R for R in session.results() if R["coords"]["dp1_sp4"]["sp"] == 0)
    np.testing.assert_allclose(first["tok0"].numpy(), v[0, 0], rtol=1e-5, atol=1e-5)


# ---- Ulysses ----

@pytest.mark.parametrize("mesh_name", ["dp1_sp4", "dp2_sp2"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_ulysses_matches_jax(session, mesh_name, causal):
    q, k, v = _j(session, "q", "k", "v")
    want = np.asarray(jax_ulysses(q, k, v, _jax_mesh(mesh_name), causal=causal))
    for flash in (False, True):  # the reference on the CPU, and the flash kernel's plain version
        got = session.assemble(mesh_name, _key(f"uly/{mesh_name}/{causal}/{flash}"))
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5, err_msg=f"flash={flash}")


def test_ulysses_matches_ring(session):
    q, k, v = _j(session, "q8", "k8", "v8")
    got = session.assemble("dp1_sp4", _key("uly_h8"))
    np.testing.assert_allclose(got, session.assemble("dp1_sp4", _key("ring_h8")),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, np.asarray(jax_ulysses(q, k, v, _jax_mesh("dp1_sp4"))),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("kv_h", [2, 4])
def test_ulysses_gqa_matches_jax(session, kv_h):
    """kv_h 4 divides sp 4 and rides the all_to_all at its own head count;
    kv_h 2 does not, and is repeated to 8 heads before it."""
    q, k, v = _j(session, "q8", f"k_kv{kv_h}", f"v_kv{kv_h}")
    want = np.asarray(jax_ulysses(q, k, v, _jax_mesh("dp1_sp4"), causal=True))
    np.testing.assert_allclose(session.assemble("dp1_sp4", _key(f"uly_gqa{kv_h}")), want,
                               rtol=2e-5, atol=2e-5)
    ref = jax_reference(q, jnp.repeat(k, 8 // kv_h, axis=2), jnp.repeat(v, 8 // kv_h, axis=2))
    np.testing.assert_allclose(want, np.asarray(ref), rtol=2e-5, atol=2e-5)


def test_ulysses_gradients_match_jax(session):
    q, k, v = _j(session, "gq", "gk", "gv")
    mesh = _jax_mesh("dp2_sp2")
    want = jax.grad(lambda q, k, v: jnp.sum(jax_ulysses(q, k, v, mesh, causal=True) ** 2),
                    argnums=(0, 1, 2))(q, k, v)
    for flash in (False, True):
        for i, name in enumerate("qkv"):
            got = session.assemble("dp2_sp2", lambda R, i=i: R[f"uly_grads/{flash}"][i])
            np.testing.assert_allclose(got, np.asarray(want[i]), rtol=5e-5, atol=5e-5,
                                       err_msg=f"d{name} flash={flash}")


def test_ulysses_errors_and_the_sp1_path(session):
    for R in session.results():
        assert "divisible" in R["uly_err_heads"]
        assert "not a multiple of kv heads" in R["uly_err_kv"]
        # the LM checks the sequence: T must split over sp, as JAX's does
        assert "seq_len 30 not divisible by sp=4" in R["lm_err_seq"]
    with pytest.raises(ValueError, match="not divisible"):
        JaxLCLM(_jax_mesh("dp1_sp4"), seq_len=30, **SMALL)
    q, k, v, q8, k2, v2 = _j(session, *(f"sp1_{n}" for n in ("q", "k", "v", "q8", "k2", "v2")))
    np.testing.assert_allclose(session.assemble("dp2_ep2", _key("uly_sp1")),
                               np.asarray(jax_reference(q, k, v, causal=True)),
                               rtol=2e-5, atol=2e-5)
    # GQA at sp 1: the kv heads are repeated before the one local call
    want = np.asarray(jax_ulysses(q8, k2, v2, _jax_mesh("dp2_ep2"), causal=True))
    np.testing.assert_allclose(session.assemble("dp2_ep2", _key("uly_sp1_gqa")), want,
                               rtol=2e-5, atol=2e-5)
    ref = jax_reference(q8, jnp.repeat(k2, 4, axis=2), jnp.repeat(v2, 4, axis=2))
    np.testing.assert_allclose(want, np.asarray(ref), rtol=2e-5, atol=2e-5)


# ---- MoE over ep ----

def _jax_coords(mesh, device):
    ids = np.vectorize(lambda d: d.id)(mesh.devices)
    return dict(zip(AXES, (int(i) for i in np.argwhere(ids == device.id)[0])))


def test_moe_over_ep_matches_jax_and_its_pieces_are_jax_shards(session):
    from jax.sharding import NamedSharding, PartitionSpec as P

    mesh = _jax_mesh("dp2_ep2")
    params = session.jax_moe["params"]
    x = jnp.asarray(session.inputs["moe_x"])
    model = JaxMoE(num_experts=4, d_ff=16, capacity_factor=8.0, mesh=mesh, dtype=jnp.float32)
    shardings = jax_partition_params(params, mesh)
    placed = jax.device_put(params, shardings)
    want = jax.jit(model.apply, in_shardings=(None, NamedSharding(mesh, P("dp"))))(
        {"params": placed}, x)
    ref = JaxMoE(num_experts=4, d_ff=16, capacity_factor=8.0, dtype=jnp.float32).apply(
        {"params": params}, x)
    np.testing.assert_allclose(np.asarray(want), np.asarray(ref), atol=1e-4)
    res = session.results()
    np.testing.assert_allclose(session.assemble("dp2_ep2", lambda R: R["moe"]["y"]),
                               np.asarray(want), atol=1e-4)
    for R in res:
        assert R["moe"]["specs"] == {"router.kernel": (), "w_up": ("ep", None, None),
                                     "w_down": ("ep", None, None)}
        assert R["moe"]["local"] == (2, 8, 16)  # two of four experts a rank
    assert "ep" not in str(shardings["router"]["kernel"].spec)
    for name in ("w_up", "w_down"):
        assert "ep" in str(shardings[name].spec)
        for piece in placed[name].addressable_shards:
            c = _jax_coords(mesh, piece.device)
            R = next(R for R in res if R["coords"]["dp2_ep2"] == c)
            np.testing.assert_array_equal(R["moe"]["pieces"][name].numpy(),
                                          np.asarray(piece.data), err_msg=name)


@pytest.mark.parametrize("mesh_name", ["dp2_ep2", "sp2_ep2"])
def test_moe_unshardable_dims_fall_back_to_replicated(session, mesh_name):
    """E 3 over ep 2 (and B 3 over dp 2, T 5 over sp 2): every rank holds
    and runs every expert on the whole input, JAX's result."""
    mesh = _jax_mesh(mesh_name)
    x = jnp.asarray(session.inputs["moe_fb_x"])
    model = JaxMoE(num_experts=3, d_ff=16, capacity_factor=8.0, mesh=mesh, dtype=jnp.float32)
    with mesh:
        want = np.asarray(jax.jit(model.apply)({"params": session.jax_moe["fb_params"]}, x))
    for R in session.results():
        np.testing.assert_allclose(R[f"moe_fb/{mesh_name}"].numpy(), want, atol=1e-4)


# ---- LongContextLM ----

def _rel(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)) / np.abs(np.asarray(b))


@pytest.mark.parametrize("case", ["ring_gqa", "ulysses", "moe_ep", "tp_sp"])
def test_long_context_lm_trains_like_jax(session, case):
    mesh_name, cfg, tok_name, steps = LM_CASES[case]
    jlm = session.jax_lm[case]
    toks = _tokens()[tok_name]
    if case == "tp_sp":  # serve first, from the initial weights
        jax_gen = jlm.generate(PROMPT, 6)
    if case == "moe_ep":
        bare = float(jax_lm_loss(jlm.forward(jlm.state["params"], jnp.asarray(toks)),
                                 jnp.asarray(toks)))
    want = [jlm.train_step(toks) for _ in range(steps)]
    res = session.results()
    for R in res:
        got = R[f"lm/{case}"]["losses"]
        assert (_rel(got, want) <= 1e-5).all(), (got, want)
        assert got == res[0][f"lm/{case}"]["losses"]  # every rank reports the global loss
    if case != "tp_sp":
        assert want[-1] < want[0]
    if case == "moe_ep":
        # the aux term is in the objective: the first loss is not the bare
        # next-token loss of the same logits (the ranks' shards put together)
        logits = session.assemble(mesh_name, lambda R: R["lm/moe_ep"]["logits"])
        port_bare = float(jax_lm_loss(jnp.asarray(logits), jnp.asarray(toks)))
        assert abs(port_bare - bare) <= 1e-5 * abs(bare)
        assert abs(res[0]["lm/moe_ep"]["losses"][0] - port_bare) > 1e-6
        # the experts are split: two of four a rank
        assert all(R["lm/moe_ep"]["shard_shapes"]["block_1.moe.w_up"] == (2, 16, 32) for R in res)
    if case == "tp_sp":
        for R in res:
            np.testing.assert_array_equal(R["lm/tp_sp"]["gen"], jax_gen)
        one = LongContextLM(dtype=torch.float32, device="cpu", **cfg)
        state = one.state
        state["params"] = session.weights["lm/tp_sp"]
        one.state = state
        want_q = one.generate(PROMPT, 6, kv_quant=True)
        for R in res:
            np.testing.assert_array_equal(R["lm/tp_sp"]["gen_kvq"], want_q)
        # tp leaves are released between steps: the model holds no full qkv
        assert all(R["lm/tp_sp"]["shard_shapes"]["block_0.qkv.kernel"] == (0,) for R in res)


def test_router_and_embedding_gradients_at_ep2_equal_ep1(session):
    res = session.results()
    ep1 = res[0]["moe_ep1_grads"]
    for R in res:
        for name, g in R["lm/moe_ep"]["grads"].items():
            np.testing.assert_allclose(g.numpy(), ep1[name].numpy(), atol=1e-6, rtol=0,
                                       err_msg=name)
            assert float(g.abs().max()) > 0
    assert abs(res[0]["lm/moe_ep"]["losses"][0] - res[0]["moe_ep1_loss"]) <= 1e-6


def test_checkpoint_from_dp2_sp2_restores_at_one_device(session):
    session.results()
    _, cfg, _, _ = LM_CASES["ring_gqa"]
    one = LongContextLM(dtype=torch.float32, device="cpu", **cfg)
    assert one.restore_checkpoint(str(session.dir / "ck")) == 4
    saved = torch.load(session.dir / "ck_state.pt", weights_only=True)
    got = one.state
    for n, t in saved["params"].items():
        assert torch.equal(got["params"][n], t), n
    for m in ("exp_avg", "exp_avg_sq"):
        for n, t in saved["opt_state"][m].items():
            assert torch.equal(got["opt_state"][m][n], t), (m, n)
    assert got["opt_state"]["count"] == saved["opt_state"]["count"] == 4


def test_seq_parallel_is_validated():
    with pytest.raises(ValueError, match="seq_parallel"):
        LongContextLM(seq_len=64, device="cpu", seq_parallel="nope", **SMALL)
    with pytest.raises(ValueError, match="seq_parallel"):
        make_lm(None, seq_parallel="nope", **SMALL)

"""The port's ring-vs-Ulysses footprint tool
(`dml_tpu_torch.tools.ring_vs_ulysses`) and the collective recorder it
reads (`parallel.mesh.record_collectives`) against the JAX tool
(`dml_tpu/tools/ring_vs_ulysses.py`), on the CPU.

One module-scoped session of 4 gloo ranks (`analyze_points`: spawned
processes, a `file://` rendezvous in a temporary directory, no fixed
port) runs both points, (T 256, heads 4, sp 4, head_dim 16, batch 2)
and the same at heads 2; the JAX tool compiles the same points on 4 of
the 8 virtual CPU devices.

- Ring makes sp - 1 = 3 shifts of k and v as one message; Ulysses 2
  all-to-alls (q, k, v stacked in, the output out) where JAX's HLO has 4.
- Bytes: JAX's byte counts on the CPU are exactly twice the port's. XLA's
  CPU backend converts the bf16 operands of each collective to float32
  (the collectives in the optimized HLO are f32, checked here), while
  the port's move bf16. So the port's exact bytes times 2 equal JAX's
  exact dynamic bytes (its HLO bytes times the rounds JAX counts).
- `winner_by_bytes` and the skip at heads 2 are JAX's.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dml_tpu.tools import ring_vs_ulysses as jrvu
from dml_tpu_torch.parallel import mesh as tmesh
from dml_tpu_torch.tools import ring_vs_ulysses as rvu

POINTS = (dict(T=256, heads=4, sp=4, head_dim=16, batch=2),
          dict(T=256, heads=2, sp=4, head_dim=16, batch=2))


@pytest.fixture(scope="module")
def session():
    """Both points from one session of 4 gloo ranks, on the CPU."""
    return rvu.analyze_points(POINTS, device="cpu")


def _jax_hlo(p, strategy):
    """The JAX tool's compiled HLO text of one strategy at point `p`."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from dml_tpu.parallel.ring_attention import ring_attention
    from dml_tpu.parallel.ulysses import ulysses_attention

    sp = p["sp"]
    mesh = Mesh(np.array(jax.devices()[:sp]).reshape(1, 1, sp, 1, 1),
                ("dp", "tp", "sp", "pp", "ep"))
    sh = NamedSharding(mesh, P("dp", "sp", None, None))
    arrs = [jax.device_put(jnp.zeros((p["batch"], p["T"], p["heads"], p["head_dim"]),
                                     jnp.bfloat16), sh) for _ in range(3)]
    fn = (lambda q, k, v: ring_attention(q, k, v, mesh, causal=True)) if strategy == "ring" else (
        lambda q, k, v: ulysses_attention(q, k, v, mesh=mesh, causal=True))
    return jax.jit(fn).lower(*arrs).compile().as_text()


def _collective_lines(hlo):
    """(line, its result types) of each collective op in the HLO text."""
    out = []
    for ln in hlo.splitlines():
        rhs = ln.split("=", 1)[-1]
        at = [rhs.find(f" {c}(") for c in jrvu._COLLECTIVES if f" {c}(" in rhs]
        if "=" in ln and at:
            out.append((ln, rhs[:min(at)]))
    return out


@pytest.mark.parametrize("i", range(len(POINTS)))
def test_footprint_against_jax(session, i):
    p, got = POINTS[i], session[i]
    want = jrvu.analyze_point(**p)
    for key in ("T", "heads", "sp", "head_dim", "batch", "activation_mb_per_device",
                "winner_by_bytes"):
        assert got[key] == want[key], key
    sp = p["sp"]
    act = p["batch"] * (p["T"] // sp) * p["heads"] * p["head_dim"] * 2  # bf16 bytes a rank
    ring = got["ring"]
    assert ring["dynamic_rounds"] == want["ring"]["dynamic_rounds"] == sp - 1
    assert ring["recorded"]["ops"] == {
        "collective-permute": {"count": sp - 1, "mb": round((sp - 1) * 2 * act / 2**20, 2)}}
    assert ring["recorded"]["total_bytes"] == (sp - 1) * 2 * act
    strategies = [("ring", sp - 1)]
    if p["heads"] % sp:
        assert "skipped" in got["ulysses"] and "skipped" in want["ulysses"]
        assert got["ulysses"] == want["ulysses"]
    else:
        uly = got["ulysses"]
        assert uly["dynamic_rounds"] == want["ulysses"]["dynamic_rounds"] == 1
        assert uly["recorded"]["ops"]["all-to-all"]["count"] == 2
        assert want["ulysses"]["hlo_static"]["ops"]["all-to-all"]["count"] == 4
        assert uly["recorded"]["total_bytes"] == 4 * act
        strategies.append(("ulysses", 1))
    for name, rounds in strategies:
        lines = _collective_lines(_jax_hlo(p, name))
        assert lines and all("f32[" in res and "bf16[" not in res for _ln, res in lines)
        jax_bytes = sum(jrvu._line_bytes(ln) for ln, _res in lines) * rounds
        assert 2 * got[name]["recorded"]["total_bytes"] == jax_bytes, name


def test_recorder_records_only_inside_its_block(monkeypatch):
    """A collective outside `record_collectives` records nothing; inside,
    one `(op, axis, result bytes)` a call; a block's list stops growing
    when it exits. (A one-rank mesh over fake gloo collectives: nothing
    of torch.distributed's global state is touched.)"""
    import numpy as np

    def fake_gather(parts, src, group=None):
        for p in parts:
            p.copy_(src)

    monkeypatch.setattr(tmesh.dist, "all_gather", fake_gather)
    monkeypatch.setattr(tmesh.dist, "all_reduce", lambda t, group=None: None)
    grid = np.zeros((1, 1, 1, 1, 1), np.int64)
    groups = {"dp": object(), ("dp", "sp"): object()}
    mesh = tmesh.Mesh(dict(dp=1, tp=1, sp=1, pp=1, ep=1), grid, 0, groups, None, "gloo")
    t = torch.ones(3, 5)
    with tmesh.record_collectives() as before:
        pass
    tmesh.all_gather(t, mesh, "dp")
    tmesh.all_reduce(t, mesh, "dp")
    assert before == []
    with tmesh.record_collectives() as rec:
        tmesh.all_gather(t, mesh, "dp")
        tmesh.all_reduce(t, mesh, ("dp", "sp"))
    tmesh.all_gather(t, mesh, "dp")
    assert rec == [("all-gather", "dp", 60), ("all-reduce", "dp+sp", 60)]
    assert tmesh._RECORDS.get() is None


def test_analyze_point_defaults_to_cuda():
    """The ranks run on cuda unless asked for the CPU: with no CUDA
    device `analyze_point` raises before it spawns a rank."""
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rvu.analyze_point(T=256, heads=4, sp=4, head_dim=16)

"""Ring vs Ulysses sequence parallelism: the collective footprint each
strategy makes. PyTorch counterpart of dml_tpu/tools/ring_vs_ulysses.py.

The JAX tool compiles both strategies on a virtual `sp`-device mesh and
reads the collectives out of the optimized HLO. The port has no HLO: it
runs both strategies' forwards on `sp` real ranks (gloo, one process a
rank, a `file://` rendezvous) on bf16 zeros, under
`parallel.mesh.record_collectives()`, and counts the calls each made and
the bytes each call's result holds on rank 0. So where the JAX tool
reads a loop body once (`hlo_static`) and multiplies by the rounds, the
port's `recorded` is already dynamic: every call that ran.

What the records show, at a point where both can run:
- ring: sp - 1 `collective-permute` rounds, each moving one rank's K and
  V block as one message (2 x the activation), serialized against the
  blocks' attention;
- ulysses: one all-to-all of q, k and v stacked (3 x the activation) in,
  one of the output back: 2 calls where JAX's HLO shows 4 (q, k, v and
  the output each alone), moving the same elements;
- heads % sp != 0: Ulysses cannot run, and ring is the only strategy.

The JAX tool's byte counts on the CPU mesh are twice these: XLA's CPU
backend converts bf16 operands of a collective to float32 before it
(`convert` fusions feed f32 collectives in the optimized HLO), where the
port's collectives move the bf16 tensors they are given.

On one card the ranks share it and gloo stages every collective through
the host, so byte counts and call counts are exact and wall times say
nothing about NVLink. `python -m dml_tpu_torch.tools.ring_vs_ulysses
[--device cpu]` prints the JSON table (cuda by default).
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
from typing import Any, Dict, List, Optional, Sequence, Tuple

Records = List[Tuple[str, str, int]]


def collective_footprint(records: Records) -> Dict[str, Any]:
    """Count collectives and sum their per-rank result bytes from
    `parallel.mesh.record_collectives()` records, in the JAX tool's dict
    (keyed by HLO op name; MB rounded as it rounds them), with the exact
    byte total beside it (`total_bytes`)."""
    ops: Dict[str, Dict[str, float]] = {}
    for op, _axis, nbytes in records:
        d = ops.setdefault(op, {"count": 0, "mb": 0.0})
        d["count"] += 1
        d["mb"] += nbytes / 2**20
    for d in ops.values():
        d["mb"] = round(d["mb"], 2)
    return {
        "ops": ops,
        "total_count": sum(d["count"] for d in ops.values()),
        "total_mb": round(sum(d["mb"] for d in ops.values()), 2),
        "total_bytes": sum(nbytes for _op, _axis, nbytes in records),
    }


def point_on_mesh(mesh, T: int, heads: int, *, head_dim: int = 64, batch: int = 2,
                  device=None) -> Dict[str, Any]:
    """Run ring and (where the heads divide) Ulysses attention forwards
    over `mesh`'s sp axis on bf16 zeros of this rank's shard [batch,
    T/sp, heads, head_dim] on `device`, each under
    `record_collectives()`, and return the point's footprint as this rank
    recorded it. Every rank of the mesh calls it with the same
    arguments."""
    import torch

    from ..parallel.mesh import record_collectives
    from ..parallel.ring_attention import ring_attention
    from ..parallel.ulysses import ulysses_attention

    sp = mesh.shape["sp"]
    shape = (batch, T // sp, heads, head_dim)
    q, k, v = (torch.zeros(shape, dtype=torch.bfloat16, device=device) for _ in range(3))
    act_mb = batch * (T // sp) * heads * head_dim * 2 / 2**20
    point: Dict[str, Any] = {
        "T": T, "heads": heads, "sp": sp, "head_dim": head_dim,
        "batch": batch,
        "activation_mb_per_device": round(act_mb, 2),
    }
    with torch.no_grad():
        with record_collectives() as rec:
            ring_attention(q, k, v, mesh, causal=True)
        ring = collective_footprint(rec)
        point["ring"] = {
            "recorded": ring,
            "dynamic_rounds": sp - 1,
            "dynamic_total_mb": ring["total_mb"],
            "note": "k and v as one collective-permute message, sp - 1 rounds",
        }
        if heads % sp == 0:
            with record_collectives() as rec:
                ulysses_attention(q, k, v, mesh, causal=True)
            uly = collective_footprint(rec)
            point["ulysses"] = {
                "recorded": uly,
                "dynamic_rounds": 1,
                "dynamic_total_mb": uly["total_mb"],
                "note": "q, k, v stacked in one all_to_all, 1 out, once per attention call",
            }
            point["winner_by_bytes"] = (
                "ulysses"
                if point["ulysses"]["dynamic_total_mb"]
                < point["ring"]["dynamic_total_mb"]
                else "ring"
            )
        else:
            point["ulysses"] = {
                "skipped": f"heads {heads} % sp {sp} != 0 — ulysses "
                           "impossible; ring is the only strategy here",
            }
            point["winner_by_bytes"] = "ring (only option)"
    return point


def _rank(rank: int, world: int, tmp: str, points: Sequence[Dict[str, Any]], device: str) -> None:
    """One gloo rank of `analyze_points`: every point over a mesh of the
    first `sp` ranks (the others take part only in making it); rank 0
    writes the points to tmp/points.json."""
    import torch
    import torch.distributed as dist

    from ..config import MeshSpec
    from ..parallel.mesh import make_mesh

    if device == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rendezvous", world_size=world,
                            rank=rank)
    try:
        out = []
        for p in points:
            sp = int(p["sp"])
            mesh = make_mesh(MeshSpec(dp=1, tp=1, sp=sp, pp=1, ep=1), ranks=range(sp))
            if mesh.rank is not None:
                kw = {k: p[k] for k in ("head_dim", "batch") if k in p}
                out.append(point_on_mesh(mesh, int(p["T"]), int(p["heads"]), device=device, **kw))
            dist.barrier()
        if rank == 0:
            with open(os.path.join(tmp, "points.json"), "w", encoding="utf-8") as f:
                json.dump(out, f)
    finally:
        dist.destroy_process_group()


def analyze_points(points: Sequence[Dict[str, Any]], device=None) -> List[Dict[str, Any]]:
    """The footprint at each point (dicts of `analyze_point`'s arguments),
    from ONE session of max(sp) gloo ranks spawned on `device` (cuda when
    None: each rank on card rank % count, collectives staged through the
    host; it raises where there is no CUDA device) or on the CPU."""
    import multiprocessing

    from ..models.lm_params import resolve_device

    dev = resolve_device(device).type
    world = max(int(p["sp"]) for p in points)
    with tempfile.TemporaryDirectory(prefix="ring_vs_ulysses_") as tmp:
        ctx = multiprocessing.get_context("spawn")
        procs = [ctx.Process(target=_rank, args=(r, world, tmp, list(points), dev))
                 for r in range(world)]
        for pr in procs:
            pr.start()
        for pr in procs:
            pr.join(timeout=600)
        bad = [(r, pr.exitcode) for r, pr in enumerate(procs) if pr.exitcode != 0]
        for pr in procs:
            if pr.is_alive():
                pr.kill()
                pr.join()
        if bad:
            raise RuntimeError(f"ring_vs_ulysses ranks failed (rank, exit code): {bad}")
        with open(os.path.join(tmp, "points.json"), encoding="utf-8") as f:
            return json.load(f)


def analyze_point(
    T: int, heads: int, sp: int, *, head_dim: int = 64, batch: int = 2,
    device: Optional[Any] = None,
) -> Dict[str, Any]:
    """Run ring and ulysses attention at one (T, heads, sp) point on sp
    ranks and return each strategy's collective footprint."""
    return analyze_points([dict(T=T, heads=heads, sp=sp, head_dim=head_dim, batch=batch)],
                          device=device)[0]


# the published crossover table: two points where ulysses wins
# (heads >= sp: fewer, bigger collectives) and one where it cannot
# run at all (a head count below sp)
POINTS = (
    dict(T=4096, heads=8, sp=8),
    dict(T=8192, heads=16, sp=4),
    dict(T=4096, heads=4, sp=8),
)


def run(points=POINTS, device=None) -> Dict[str, Any]:
    return {"points": analyze_points(points, device=device)}


def main() -> None:
    device = None
    if "--device" in sys.argv[1:]:
        device = sys.argv[sys.argv.index("--device") + 1]
    print(json.dumps(run(device=device), indent=2))


if __name__ == "__main__":
    main()

"""The port's copy of the parts of dml_tpu/config.py that it reads: the
speculative-decoding settings (`inference.lm_backend`, `:195-234`),
`NodeId`, `MeshSpec` and the node table of `ClusterSpec` (the mesh and
the multi-host start-up, `parallel.mesh` and `parallel.multihost`), and
`WorkerGroupSpec` (the serving group whose memory budget
`inference.lm_sharded.check_hbm_budget` reads)."""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

#: break-even acceptance below which a server reverts to plain decode
#: (`lm_spec["spec_min_accept"]`): under ~1/3 acceptance a verify
#: round's expected commit (~rate*k + 1) no longer pays for the
#: verify forward and the draft's own steps
SPEC_MIN_ACCEPT_DEFAULT = 0.35

#: proposals measured before the acceptance gate may fire (and the
#: sliding window's grain after that)
SPEC_MIN_SAMPLES_DEFAULT = 64


def draft_lm_spec(lm_spec: Dict[str, Any], **overrides: Any) -> Dict[str, Any]:
    """A draft-model spec derived from a target `lm_spec`: the same
    vocab, dtype and heads, half the layers, half d_model (rounded up to
    a multiple of n_heads) and half d_ff, weights from `seed + 1`.
    Serving keys (max_slots, chunk, spec_*, kv_cache_mb, weights) are
    dropped; `overrides` pin any field."""
    heads = int(lm_spec.get("n_heads", 8))
    d_model = int(lm_spec["d_model"])
    d_half = max(heads, ((d_model // 2 + heads - 1) // heads) * heads)
    d_ff = int(lm_spec.get("d_ff", 4 * d_model))
    spec: Dict[str, Any] = {
        "name": f"{lm_spec.get('name', 'LM')}-draft",
        "vocab_size": int(lm_spec["vocab_size"]),
        "d_model": d_half,
        "n_heads": heads,
        "n_layers": max(1, int(lm_spec.get("n_layers", 2)) // 2),
        "d_ff": max(d_half, d_ff // 2),
        "dtype": lm_spec.get("dtype", "bfloat16"),
        "seed": int(lm_spec.get("seed", 0)) + 1,
    }
    if lm_spec.get("n_kv_heads") is not None:
        spec["n_kv_heads"] = int(lm_spec["n_kv_heads"])
    spec.update(overrides)
    return spec


# ----------------------------------------------------------------------
# the mesh and the node table: the port's copy of what the mesh
# (`parallel.mesh`) and the multi-host start-up (`parallel.multihost`)
# read from dml_tpu/config.py (`NodeId` :22-47, `MeshSpec` :83-121, and
# the part of `ClusterSpec` that holds the node table)
# ----------------------------------------------------------------------


@dataclass(frozen=True, order=True)
class NodeId:
    """A node's identity: host and control-plane port, a display name and
    an election rank. Ordered by (host, port, name, rank)."""

    host: str
    port: int
    name: str = ""
    rank: int = 0

    @property
    def unique_name(self) -> str:
        return f"{self.host}:{self.port}"

    @property
    def addr(self) -> Tuple[str, int]:
        return (self.host, self.port)

    def __str__(self) -> str:
        return self.name or self.unique_name


@dataclass(frozen=True)
class MeshSpec:
    """Axis sizes of a device mesh: `dp` shards the batch, `tp` the
    weights' output channels, `sp` the sequence, `pp` pipeline stages,
    `ep` experts. A size of -1 fills with the devices (ranks) left; only
    one axis may be -1."""

    dp: int = -1
    tp: int = 1
    sp: int = 1
    pp: int = 1
    ep: int = 1

    def resolve(self, n_devices: int) -> Dict[str, int]:
        """{axis: size} over `n_devices`; ValueError when the sizes do
        not multiply to it (or cannot fill it)."""
        sizes = {"dp": self.dp, "tp": self.tp, "sp": self.sp, "pp": self.pp, "ep": self.ep}
        fixed, free = 1, None
        for ax, s in sizes.items():
            if s == -1:
                if free is not None:
                    raise ValueError("only one mesh axis may be -1")
                free = ax
            else:
                fixed *= s
        if free is not None:
            if n_devices % fixed != 0:
                raise ValueError(f"{n_devices} devices not divisible by fixed axes {fixed}")
            sizes[free] = n_devices // fixed
        elif fixed != n_devices:
            raise ValueError(f"mesh {sizes} != {n_devices} devices")
        return sizes


@dataclass(frozen=True)
class WorkerGroupSpec:
    """A serving group (the port's copy of `dml_tpu/config.py:125-175`):
    nodes that pool their devices into one worker over `mesh`. `members`
    are node names or unique names; `lm_models` the LM models the group
    serves sharded (`inference.lm_sharded`); `roles` optionally splits
    the members into "prefill" and "decode" roles; a `mesh` with pp > 1
    serves pipeline-parallel, each member holding n_layers/pp blocks.
    `hbm_bytes` (0: unchecked) is a member's device-memory budget, which
    `lm_sharded.check_hbm_budget` holds the model's per-member weight
    bytes to."""

    name: str
    members: Tuple[str, ...] = ()
    mesh: MeshSpec = field(default_factory=lambda: MeshSpec(dp=-1, tp=1))
    lm_models: Tuple[str, ...] = ()
    roles: Dict[str, str] = field(default_factory=dict)
    hbm_bytes: int = 0


@dataclass
class ClusterSpec:
    """The node table of the JAX package's cluster spec, in order (a
    node's index in it is its process id), with the introducer and the
    mesh. `from_json` reads a file that the JAX package's
    `ClusterSpec.to_json` wrote and keeps these fields; the rest of that
    spec (timing, store, worker groups, gossip) belongs to the cluster
    layers, which the port does not have yet."""

    nodes: List[NodeId] = field(default_factory=list)
    introducer: Optional[NodeId] = None
    mesh: MeshSpec = field(default_factory=MeshSpec)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, text: str) -> "ClusterSpec":
        raw = json.loads(text)
        intro = raw.get("introducer")
        return cls(nodes=[NodeId(**n) for n in raw.get("nodes", [])],
                   introducer=NodeId(**intro) if intro else None,
                   mesh=MeshSpec(**raw["mesh"]) if raw.get("mesh") else MeshSpec())

    @classmethod
    def from_file(cls, path: str) -> "ClusterSpec":
        with open(path) as f:
            return cls.from_json(f.read())

    @classmethod
    def localhost(cls, n: int, base_port: int = 8001, introducer_port: int = 8888,
                  **kw: Any) -> "ClusterSpec":
        """n nodes on 127.0.0.1 at base_port + i, named H1..Hn, ranked n..1
        (as the JAX package's `localhost`)."""
        nodes = [NodeId("127.0.0.1", base_port + i, name=f"H{i + 1}", rank=n - i)
                 for i in range(n)]
        return cls(nodes=nodes, introducer=NodeId("127.0.0.1", introducer_port, name="DNS"), **kw)

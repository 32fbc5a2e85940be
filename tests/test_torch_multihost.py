"""The port's multi-host start-up (`dml_tpu_torch.parallel.multihost`) and
its copy of the cluster spec's node table (`dml_tpu_torch.config`)
against the JAX package's (`tests/test_multihost.py`,
`tests/test_multihost_2proc.py`).

The two-process case starts two real processes of the port through
`initialize_from_spec` over TCP, on a port found free by binding port 0
(never a fixed one), each on the CPU (gloo), and checks that an
all-reduce over the global mesh sees both ranks. The processes import
torch and the port only. The global batch over a four-rank mesh is
checked in tests/test_torch_parallel.py's rank session.
"""

import os
import socket
import subprocess
import sys

import pytest

from dml_tpu.config import ClusterSpec as JaxClusterSpec
from dml_tpu.config import MeshSpec as JaxMeshSpec
from dml_tpu_torch.config import ClusterSpec, MeshSpec
from dml_tpu_torch.parallel import multihost

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD = r'''
import sys
import torch

torch.set_num_threads(1)
import torch.distributed as dist

from dml_tpu_torch.config import ClusterSpec, MeshSpec
from dml_tpu_torch.parallel import multihost
from dml_tpu_torch.parallel.mesh import all_reduce

spec_path, idx = sys.argv[1], int(sys.argv[2])
spec = ClusterSpec.from_file(spec_path)
pid = multihost.initialize_from_spec(spec, spec.nodes[idx], device="cpu")
assert pid == idx, (pid, idx)
assert multihost._initialized and dist.get_world_size() == 2 and dist.get_backend() == "gloo"
multihost.initialize_from_spec(spec, spec.nodes[idx], device="cpu")  # idempotent
mesh = multihost.global_mesh(MeshSpec(dp=-1))
assert mesh.shape["dp"] == 2 and mesh.coords["dp"] == pid
# each rank contributes its own value: the sum must see both
total = all_reduce(torch.tensor([float(pid + 1)]), mesh, "dp")
assert float(total) == 3.0, float(total)
dist.destroy_process_group()
print(f"MULTIHOST_OK pid={pid} total={float(total)}")
'''


def test_initialize_single_process_is_noop():
    spec = ClusterSpec.localhost(1, base_port=18601, introducer_port=18600)
    pid = multihost.initialize_from_spec(spec, spec.nodes[0], device="cpu")
    assert pid == 0
    assert not multihost._initialized  # single process: no distributed runtime


def test_initialize_unknown_node_rejected():
    spec = ClusterSpec.localhost(2, base_port=18611, introducer_port=18610)
    other = ClusterSpec.localhost(1, base_port=19999, introducer_port=19998)
    with pytest.raises(ValueError, match="not in cluster spec"):
        multihost.initialize_from_spec(spec, other.nodes[0], device="cpu")


def test_cluster_spec_file_written_by_jax_loads(tmp_path):
    jax_spec = JaxClusterSpec.localhost(3, base_port=18621, introducer_port=18620,
                                        mesh=JaxMeshSpec(dp=-1, tp=2))
    path = tmp_path / "spec.json"
    path.write_text(jax_spec.to_json())
    spec = ClusterSpec.from_file(str(path))
    assert [(n.host, n.port, n.name, n.rank) for n in spec.nodes] == [
        (n.host, n.port, n.name, n.rank) for n in jax_spec.nodes]
    assert [n.unique_name for n in spec.nodes] == [n.unique_name for n in jax_spec.nodes]
    assert spec.introducer.unique_name == jax_spec.introducer.unique_name
    assert spec.mesh == MeshSpec(dp=-1, tp=2)
    assert spec.mesh.resolve(8) == jax_spec.mesh.resolve(8)
    assert ClusterSpec.from_json(spec.to_json()) == spec


def test_two_processes_start_from_the_spec_and_reduce(tmp_path):
    with socket.socket() as s:  # a free port for the rendezvous
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    spec = ClusterSpec.localhost(2, base_port=port - multihost.COORD_PORT_OFFSET,
                                 introducer_port=18630)
    spec_path = tmp_path / "spec.json"
    spec_path.write_text(spec.to_json())
    child_path = tmp_path / "child.py"
    child_path.write_text(CHILD)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([REPO] + env.get("PYTHONPATH", "").split(os.pathsep))
    procs = [subprocess.Popen([sys.executable, str(child_path), str(spec_path), str(idx)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, text=True)
             for idx in (0, 1)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=180)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("2-process torch.distributed start-up hung\n" + "\n---\n".join(outs))
    for p, out in zip(procs, outs):
        assert p.returncode == 0 and "MULTIHOST_OK" in out, out

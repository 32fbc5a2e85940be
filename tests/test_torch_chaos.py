"""The port's chaos harness (`cluster/chaos.py`): the in-process
`LocalCluster`, the plan generators, the runner and its invariant sweep.

- The JAX package's own cases of test_chaos, test_elastic and test_scale,
  run against the port (`test_torch_cluster.port_cases`). Every port a
  case names moves into a probed block in 50000-54999 (`PortMap`), so
  these copies never meet the JAX files' literal ports. Left out: the
  cases that need `dml_tpu.tools.claim_check` (it stays with the JAX
  package, beside bench.py; `port_cases` drops them by itself) and the
  one named in `EXCLUDE`.
- The plan generators of both packages give equal event lists, and the
  fuzzer byte-equal datagrams, for the same seeds.
- A guard: every port a probed case bound, and every base a
  `LocalCluster` of a probed case took, lies in 50000-54999.
"""

from __future__ import annotations

import asyncio
import os
import re
import sys

import pytest

from dml_tpu.cluster import chaos as jchaos
from dml_tpu_torch.cluster import chaos as tchaos

import test_torch_cluster as tc
from test_torch_cluster import TESTS, port_cases

CHAOS_FILES = (("test_chaos", "chaos"), ("test_elastic", "elastic"), ("test_scale", "scale"))
#: builds a JAX ShardedInference over a JAX mesh (a JAX-only mesh object)
EXCLUDE = {"test_elastic": ("test_reformed_mesh_bitwise_equality",)}
for _name, _prefix in CHAOS_FILES:
    globals().update(port_cases(_name, _prefix, exclude=EXCLUDE.get(_name, ()),
                                probe_ports=True))

#: cases of each file that need a module the port lacks (the tools)
TOOLS_CASES = {"chaos": set(),
               "elastic": {"claim_check_elastic_block", "claim_check_elastic_summary_only"},
               "scale": {"churn_is_a_scenario_family", "claim_check_scale_block",
                         "claim_check_scale_summary_only"}}


@pytest.mark.parametrize("name,prefix", CHAOS_FILES)
def test_port_cases_cover_each_file(name, prefix):
    with open(os.path.join(TESTS, f"{name}.py"), encoding="utf-8") as f:
        want = set(re.findall(r"^(?:async )?def test_(\w+)", f.read(), re.M))
    got = {k[len(prefix) + 6:] for k in globals() if k.startswith(f"test_{prefix}_")}
    excluded = {k[5:] for k in EXCLUDE.get(name, ())}
    assert got == want - excluded - TOOLS_CASES[prefix], sorted(want - got)


# ----------------------------------------------------------------------
# the plan generators of both packages
# ----------------------------------------------------------------------


def _events(plan):
    return (plan.seed, plan.n_nodes, plan.name, plan.settle_s,
            [e.to_dict() for e in plan.events], plan.to_dict())


@pytest.mark.parametrize("family", jchaos.SCENARIO_FAMILIES)
def test_scenario_plans_equal_across_packages(family):
    assert tchaos.SCENARIO_FAMILIES == jchaos.SCENARIO_FAMILIES
    for seed in (1, 2, 3):
        assert _events(tchaos.scenario_plan(family, seed)) == _events(
            jchaos.scenario_plan(family, seed))


@pytest.mark.parametrize("gen", ["random_plan", "churn_plan", "soak_plan"])
def test_plan_generators_equal_across_packages(gen):
    for seed in (1, 2, 7, 11):
        assert _events(getattr(tchaos, gen)(seed)) == _events(getattr(jchaos, gen)(seed))


def test_fuzz_datagrams_byte_equal_across_packages():
    senders = ("127.0.0.1:9001", "127.0.0.1:9002")
    for seed in (1, 5, 11):
        for kw in ({}, {"join_secret": "s3cret", "universe_epoch": 3}):
            assert tchaos.fuzz_datagrams(seed, 80, senders, **kw) == jchaos.fuzz_datagrams(
                seed, 80, senders, **kw)


# ----------------------------------------------------------------------
# the guard: no probed case binds outside the block range
# ----------------------------------------------------------------------


def _in_range(port: int) -> bool:
    return port == 0 or tc.PORT_LO - 1 <= port <= tc.PORT_HI


def test_probed_cases_bind_only_in_the_block_range(tmp_path):
    """A cluster a probed case builds at a literal base lands in the
    block range, and so does every port bound by the cases of this file
    that ran before this one in this process."""
    local_cluster = sys.modules["port_cases.test_chaos"].LocalCluster
    n_bases = len(tc.CLUSTER_BASES)

    async def run():
        c = local_cluster(3, str(tmp_path / "c"), 23200, seed=0)
        try:
            await c.start()
            await c.wait_for(c.converged, 15.0, "guard convergence")
            return sorted(n.port for n in c.spec.nodes), c.spec.introducer.port, c._join_port
        finally:
            await c.stop()

    with tc.case_port_map():
        ports, intro, join = asyncio.run(run())
    base = tc.CLUSTER_BASES[n_bases]
    assert ports == [base, base + 1, base + 2] and intro == base - 1
    assert tc.PORT_LO <= base and join + 32 <= tc.PORT_HI
    assert set(ports) | {intro} <= set(tc.BOUND_PORTS)
    assert all(tc.PORT_LO <= b <= tc.PORT_HI for b in tc.CLUSTER_BASES), tc.CLUSTER_BASES
    outside = sorted({p for p in tc.BOUND_PORTS if not _in_range(p)})
    assert not outside, outside

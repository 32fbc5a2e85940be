"""The port's cluster layers (`config`, `cluster/`: wire, transport,
membership, election, store) held to the JAX package's own test cases,
and the two packages held to each other on the wire.

`port_cases(name)` runs the test cases of `tests/<name>.py` against the
port: it executes that file's source in a fresh module whose imports of
`dml_tpu.X` resolve to `dml_tpu_torch.X` (where the port has `X`), so
every test, fixture and helper there runs on the port's classes. A case
that reaches a module the port does not have (the chaos harness, the
request router, the tools) is left out, and so is any case named in
`exclude`. The other port test files of the job layers import it from
here, with `free_port_block`, the one helper that finds ports for an
in-process cluster.
"""

from __future__ import annotations

import ast
import builtins
import contextlib
import errno
import functools
import importlib.util
import inspect
import os
import random
import re
import socket
import sys
import threading
import types
from typing import Any, Dict, Iterable

import pytest

from dml_tpu.cluster import wire as jwire
from dml_tpu import config as jconfig
from dml_tpu_torch.cluster import wire as twire
from dml_tpu_torch import config as tconfig

TESTS = os.path.dirname(os.path.abspath(__file__))
_PREFIX = "port_cases."

# ----------------------------------------------------------------------
# ports: contiguous free blocks in 50000-54999 (no test file binds a
# literal port there); the introducer at base - 1, the store data plane
# at base + 10000 (`cluster.store_service.DATA_PORT_OFFSET`). Each
# pytest-xdist worker probes its own slice of the range (`port_slice`):
# a port that is free to bind may still be a live cluster's target (the
# peers of a crashed node go on pinging and gossiping about it), and a
# cluster of another process bound there would take that traffic as its
# own node's.
# ----------------------------------------------------------------------

PORT_LO, PORT_HI = 50000, 54999
DATA_OFFSET = 10000
#: ports a literal base owns past its nodes: the chaos harness's
#: runtime joiners take base + n + 100 onward (`LocalCluster._join_port`)
JOIN_SPAN = 132
_rng = random.Random(os.getpid() ^ int.from_bytes(os.urandom(4), "little"))
_handed: set = set()
_lock = threading.Lock()


def _free(port: int) -> bool:
    """Whether a node could bind at `port` now: its UDP socket there and
    its store data plane's TCP listener at `port + DATA_OFFSET`, with
    SO_REUSEADDR as asyncio's server sets it (so a listener's own
    TIME_WAIT from an earlier case does not count as taken)."""
    for kind, p in ((socket.SOCK_DGRAM, port), (socket.SOCK_STREAM, port + DATA_OFFSET)):
        s = socket.socket(socket.AF_INET, kind)
        try:
            if kind == socket.SOCK_STREAM:
                s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            s.bind(("127.0.0.1", p))
        except OSError:
            return False
        finally:
            s.close()
    return True


def port_slice(worker=None, count=None):
    """(lo, hi) of the probe range that this process's blocks come from:
    the whole of PORT_LO..PORT_HI outside pytest-xdist, else worker gwI's
    I-th of `count` equal slices (from PYTEST_XDIST_WORKER and
    PYTEST_XDIST_WORKER_COUNT), so no two workers hand out one port."""
    worker = os.environ.get("PYTEST_XDIST_WORKER", "") if worker is None else worker
    if count is None:
        count = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1") or 1)
    if not worker.startswith("gw") or count <= 1:
        return PORT_LO, PORT_HI
    span = (PORT_HI - PORT_LO + 1) // count
    lo = PORT_LO + (int(worker[2:]) % count) * span
    return lo, lo + span - 1


def free_port_block(n: int, tries: int = 200) -> int:
    """A base port B such that B-1 .. B+n-1 and their data-plane ports
    (+10000) are free to bind on 127.0.0.1 (UDP and TCP) right now, in
    this process's `port_slice`. Blocks already handed out in this
    process are not handed out again until `release_ports` gives them
    back. A later bind can still lose a race to another process (an
    ephemeral port); callers retry on EADDRINUSE (`port_cases` does)."""
    lo, hi = port_slice()
    if hi - lo < n + 2:
        lo, hi = PORT_LO, PORT_HI
    for _ in range(tries):
        base = _rng.randrange(lo + 1, hi - n)
        with _lock:
            if any(b in _handed for b in range(base - 1, base + n)):
                continue
        ports = list(range(base - 1, base + n))
        if all(_free(p) for p in ports):
            with _lock:
                _handed.update(ports)
            return base
    raise OSError(errno.EADDRINUSE, f"no free block of {n + 1} ports in {lo}-{hi}")


def release_ports(base: int, n: int) -> None:
    with _lock:
        _handed.difference_update(range(base - 1, base + n))


class PortMap:
    """One case's literal ports, each moved into a probed block: the
    first base literal L it sees takes a free block B of `n + JOIN_SPAN`
    ports, and from then on every port L-1 .. L+n+JOIN_SPAN-1 that the
    case names maps to the same offset from B. So a case that binds a
    cluster at 23200 and later rebuilds `ClusterSpec.localhost(...,
    base_port=23200)` to name its nodes sees the ports it bound, and a
    joiner at `NodeId(host, 24230)` beside a cluster at 24220 lands in
    that cluster's block."""

    def __init__(self):
        self.windows = []  # (literal base, span, probed base)

    def base(self, literal: int, n: int) -> int:
        got = self.port(literal)
        if got != literal or PORT_LO <= literal <= PORT_HI:
            return got
        span = n + JOIN_SPAN
        probed = free_port_block(span)
        self.windows.append((literal, span, probed))
        return probed

    def port(self, literal: int) -> int:
        for lit, span, probed in self.windows:
            if lit - 1 <= literal < lit + span:
                return probed + literal - lit
        return literal

    def release(self) -> None:
        for _, span, probed in self.windows:
            release_ports(probed, span)
        self.windows = []


#: the running case's PortMap (cases run one at a time in a process);
#: None outside a probed case
_case_ports: list = [None]
#: every port a probed case bound through the port's UdpTransport, with
#: the bases its LocalClusters took (the guard tests read these)
BOUND_PORTS: list = []
CLUSTER_BASES: list = []


def _map_base(literal: int, n: int) -> int:
    pm = _case_ports[0]
    if pm is None:
        return free_port_block(n)
    return pm.base(literal, n)


def _map_port(literal: int) -> int:
    pm = _case_ports[0]
    return literal if pm is None else pm.port(literal)


def _record_udp_binds():
    from dml_tpu_torch.cluster.transport import UdpTransport

    real = UdpTransport.bind.__func__

    async def bind(cls, host, port, *a, **kw):
        if _case_ports[0] is not None:
            BOUND_PORTS.append(int(port))
        return await real(cls, host, port, *a, **kw)

    UdpTransport.bind = classmethod(bind)


_record_udp_binds()


class ProbedClusterSpec(tconfig.ClusterSpec):
    """The port's ClusterSpec whose `localhost` puts the nodes on the
    case's probed block for the base port the caller named."""

    @classmethod
    def localhost(cls, n: int, base_port: int = 8001, introducer_port: int = 8888, **kw):
        base = _map_base(base_port, n)
        return super().localhost(n, base_port=base, introducer_port=base - 1, **kw)


def _probed_node_id(host, port, *a, **kw):
    return tconfig.NodeId(host, _map_port(port), *a, **kw)


def _probed_chaos():
    """Overrides for the port's `cluster.chaos` as a probed case sees
    it: every entry that takes a base port takes the case's block."""
    from dml_tpu_torch.cluster import chaos

    class LocalCluster(chaos.LocalCluster):
        def __init__(self, n_nodes, root, base_port, *a, **kw):
            base = _map_base(base_port, n_nodes)
            CLUSTER_BASES.append(base)
            super().__init__(n_nodes, root, base, *a, **kw)

    def with_base(fn, n_of):
        @functools.wraps(fn)
        def call(*a, **kw):
            args = inspect.signature(fn).bind(*a, **kw)
            args.arguments["base_port"] = _map_base(args.arguments["base_port"],
                                                    n_of(args.arguments))
            return fn(*args.args, **args.kwargs)

        return call

    plan_n = lambda a: a["plan"].n_nodes  # noqa: E731
    return {
        "LocalCluster": LocalCluster,
        "run_plan": with_base(chaos.run_plan, plan_n),
        "run_plan_sync": with_base(chaos.run_plan_sync, plan_n),
        "diurnal_probe": with_base(chaos.diurnal_probe, lambda a: a.get("n_nodes") or 64),
        "control_plane_probe": with_base(chaos.control_plane_probe, lambda a: a["n_nodes"]),
        "control_plane_probe_sync": with_base(chaos.control_plane_probe_sync,
                                              lambda a: a["n_nodes"]),
    }


class _ProxyModule(types.ModuleType):
    """A port module as a probed case imports it: `overrides` first,
    every other name (and every assignment) the module's own."""

    def __init__(self, real, overrides):
        super().__init__(real.__name__, real.__doc__)
        self.__dict__.update(overrides)
        object.__setattr__(self, "_real", real)

    def __getattr__(self, key):
        return getattr(self._real, key)

    def __setattr__(self, key, value):
        setattr(self._real, key, value)


_PROBED: Dict[str, Any] = {}


def _probed_module(name: str):
    if not _PROBED:
        _PROBED["dml_tpu_torch.config"] = _ProxyModule(
            tconfig, {"ClusterSpec": ProbedClusterSpec, "NodeId": _probed_node_id})
        from dml_tpu_torch.cluster import chaos

        _PROBED["dml_tpu_torch.cluster.chaos"] = _ProxyModule(chaos, _probed_chaos())
    return _PROBED.get(name)


# ----------------------------------------------------------------------
# the JAX package's test cases, run against the port
# ----------------------------------------------------------------------

_real_import = builtins.__import__


def _port_name(name: str) -> str:
    return "dml_tpu_torch" + name[len("dml_tpu"):]


def _has_port(name: str) -> bool:
    try:
        return importlib.util.find_spec(_port_name(name)) is not None
    except ModuleNotFoundError:
        return False


#: the exec'd modules whose clusters take probed ports
_probing: set = set()


def _port_has_names(name: str, fromlist) -> bool:
    """Whether the port's counterpart of module `name` has every name of
    `fromlist`, as an attribute or a submodule."""
    port = importlib.import_module(_port_name(name))
    return all(n == "*" or hasattr(port, n) or _has_port(f"{name}.{n}") for n in fromlist)


def _port_import(name, globals=None, locals=None, fromlist=(), level=0):
    importer = str((globals or {}).get("__name__", ""))
    # `from dml_tpu.X import y` where the port's X lacks y stays the JAX
    # import, so the cases that use y are the ones left out (`_unported`)
    if not (level == 0 and importer.startswith(_PREFIX)
            and (name == "dml_tpu" or name.startswith("dml_tpu."))
            and _has_port(name) and (not fromlist or _port_has_names(name, fromlist))):
        return _real_import(name, globals, locals, fromlist, level)
    mod = _real_import(_port_name(name), globals, locals, fromlist, level)
    if importer not in _probing or not fromlist:
        return mod
    proxy = _probed_module(mod.__name__)
    if proxy is not None:
        return proxy
    subs = {k: _probed_module(f"{mod.__name__}.{k}") for k in fromlist}
    subs = {k: v for k, v in subs.items() if v is not None}
    return _ProxyModule(mod, subs) if subs else mod


builtins.__import__ = _port_import


def _unported(source: str) -> set:
    """What `source` imports from the JAX package that the port lacks: a
    module, or a name that the port's module does not define."""
    out = set()
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.ImportFrom) and node.level == 0 and node.module and (
                node.module == "dml_tpu" or node.module.startswith("dml_tpu.")):
            if not _has_port(node.module):
                out.add(node.module)
                continue
            port = importlib.import_module(_port_name(node.module))
            out |= {f"{node.module}.{a.name}" for a in node.names
                    if not hasattr(port, a.name) and not _has_port(f"{node.module}.{a.name}")}
        elif isinstance(node, ast.Import):
            out |= {a.name for a in node.names
                    if a.name.startswith("dml_tpu.") and not _has_port(a.name)}
    return out


def _helpers_of(fn, ns: Dict[str, Any], seen: set) -> Iterable[Any]:
    """`fn` and the module-level functions and classes of `ns` that it
    reaches by name, transitively."""
    stack = [fn]
    while stack:
        obj = stack.pop()
        if id(obj) in seen:
            continue
        seen.add(id(obj))
        yield obj
        codes = []
        if isinstance(obj, type):
            codes = [v.__code__ for v in vars(obj).values() if isinstance(v, types.FunctionType)]
        elif hasattr(obj, "__code__"):
            codes = [obj.__code__]
        while codes:
            co = codes.pop()
            codes += [c for c in co.co_consts if isinstance(c, types.CodeType)]
            for n in co.co_names:
                v = ns.get(n)
                if isinstance(v, (types.FunctionType, type)) and getattr(v, "__module__", "") == ns["__name__"]:
                    stack.append(v)


def _needs_unported(fn, ns: Dict[str, Any], jax_names: set) -> set:
    need = set()
    for obj in _helpers_of(inspect.unwrap(fn), ns, set()):
        try:
            src = inspect.getsource(obj)
        except (OSError, TypeError):
            continue
        need |= _unported(src)
        need |= {n for n in jax_names if re.search(rf"\b{re.escape(n)}\b", src)}
    return need


@contextlib.contextmanager
def case_port_map():
    """A fresh PortMap for the body (one run of a case); its blocks go
    back when the body ends."""
    pm = _case_ports[0] = PortMap()
    try:
        yield pm
    finally:
        pm.release()
        _case_ports[0] = None


def _probed_case(fn):
    """Run a case under its own PortMap, again (at most twice more) when
    its cluster lost a port race; an async case's every run gets its own
    90 s limit."""
    if inspect.iscoroutinefunction(fn):
        @functools.wraps(fn)
        async def run(**kw):
            import asyncio

            for attempt in range(3):
                with case_port_map():
                    try:
                        return await asyncio.wait_for(fn(**kw), timeout=90.0)
                    except OSError as e:
                        if e.errno != errno.EADDRINUSE or attempt == 2:
                            raise
    else:
        @functools.wraps(fn)
        def run(**kw):
            for attempt in range(3):
                with case_port_map():
                    try:
                        return fn(**kw)
                    except OSError as e:
                        if e.errno != errno.EADDRINUSE or attempt == 2:
                            raise

    return run


def port_cases(name: str, prefix: str, exclude: Iterable[str] = (),
               probe_ports: bool = False) -> Dict[str, Any]:
    """{new name: object} of `tests/<name>.py`'s test cases and fixtures,
    bound to the port. Test `test_x` becomes `test_<prefix>_x`; fixtures
    keep their names. With `probe_ports`, every port a case names
    through `ClusterSpec.localhost`, `NodeId` or a base port of the chaos
    harness (`LocalCluster`, `run_plan`, the probes) moves into probed
    blocks in 50000-54999 (`PortMap`), and cases retry on EADDRINUSE."""
    path = os.path.join(TESTS, f"{name}.py")
    with open(path, encoding="utf-8") as f:
        source = f.read()
    mod = types.ModuleType(_PREFIX + name)
    mod.__file__ = path
    sys.modules[mod.__name__] = mod
    if probe_ports:
        _probing.add(mod.__name__)
    exec(compile(source, path, "exec"), mod.__dict__)
    ns = mod.__dict__
    # names the module bound at import time to the JAX package (its
    # modules the port does not have)
    jax_names = {k for k, v in ns.items()
                 if (getattr(v, "__name__", "") if isinstance(v, types.ModuleType)
                     else getattr(v, "__module__", "") or "").split(".")[0] in ("dml_tpu", "jax")}
    out: Dict[str, Any] = {}
    excluded = set(exclude)
    for key, obj in ns.items():
        if key.startswith("test_") and callable(obj):
            if key in excluded or _needs_unported(obj, ns, jax_names):
                continue
            if probe_ports:
                obj = _probed_case(obj)
            out[f"test_{prefix}_{key[5:]}"] = obj
        elif type(obj).__name__ in ("FixtureFunctionDefinition", "FixtureFunctionMarker") or hasattr(
                obj, "_pytestfixturefunction"):
            out[key] = obj
    unknown = excluded - set(ns)
    assert not unknown, f"{name} has no cases {sorted(unknown)}"
    return out


CLUSTER_FILES = (("test_wire", "wire"), ("test_transport", "transport"),
                 ("test_membership", "membership"), ("test_election", "election"),
                 ("test_store", "store"), ("test_config", "config"))
for _name, _prefix in CLUSTER_FILES:
    globals().update(port_cases(_name, _prefix))


@pytest.mark.parametrize("name,prefix", CLUSTER_FILES)
def test_port_cases_cover_each_file(name, prefix):
    """Every case of these JAX files runs against the port: none needs
    a module the port lacks."""
    with open(os.path.join(TESTS, f"{name}.py"), encoding="utf-8") as f:
        want = set(re.findall(r"^(?:async )?def test_(\w+)", f.read(), re.M))
    got = {k[len(prefix) + 6:] for k in globals() if k.startswith(f"test_{prefix}_")}
    assert want and got == want


# ----------------------------------------------------------------------
# the two packages on one wire
# ----------------------------------------------------------------------


def _payload(t) -> Dict[str, Any]:
    return {"k": 1, "t": t.name, "f": 0.5, "list": [1, "a", None, True],
            "nested": {"a:1": [1.5, 1], "b": {"c": -3}}, "big": 2 ** 40}


@pytest.mark.parametrize("t", list(jwire.MsgType), ids=lambda t: t.name)
def test_every_msgtype_packs_equal_bytes(t):
    tt = twire.MsgType[t.name]
    assert int(tt) == int(t)
    jm = jwire.Message("127.0.0.1:8001", t, _payload(t))
    tm = twire.Message("127.0.0.1:8001", tt, _payload(t))
    assert tm.pack() == jm.pack()
    back = twire.Message.unpack(jm.pack())
    assert back is not None and back.type is tt and back.data == jm.data
    fwd = jwire.Message.unpack(tm.pack())
    assert fwd is not None and fwd.type is t and fwd.data == tm.data


def test_msgtype_sets_equal():
    assert [(m.name, int(m)) for m in jwire.MsgType] == [(m.name, int(m)) for m in twire.MsgType]


def _full_spec(mod):
    return mod.ClusterSpec(
        nodes=[mod.NodeId("10.0.0.%d" % i, 7000 + i, name=f"H{i}", rank=9 - i) for i in range(1, 6)],
        introducer=mod.NodeId("10.0.0.9", 7999, name="DNS"),
        worker_groups=[mod.WorkerGroupSpec("g0", ("H4", "H5"), mod.MeshSpec(dp=1, tp=2),
                                           lm_models=("LM",), roles={"H4": "prefill", "H5": "decode"},
                                           hbm_bytes=1 << 30)],
        ring_k=2, timing=mod.Timing(ping_interval=0.3, ack_timeout=0.2, cleanup_time=1.0),
        store=mod.StoreConfig(root="/r", download_dir="/d"), mesh=mod.MeshSpec(dp=2, tp=2),
        gossip_protocol="full", join_secret="s3cret", universe_epoch=3, train_class_weight=0.25)


def test_cluster_spec_json_reads_both_ways():
    j, t = _full_spec(jconfig), _full_spec(tconfig)
    assert j.to_json() == t.to_json()
    from_j = tconfig.ClusterSpec.from_json(j.to_json())
    from_t = jconfig.ClusterSpec.from_json(t.to_json())
    assert from_j.to_json() == j.to_json() and from_t.to_json() == t.to_json()
    assert [n.unique_name for n in from_j.ring()] == [n.unique_name for n in from_t.ring()]
    assert from_j.group_members_unique("g0") == from_t.group_members_unique("g0")


def test_join_leave_reply_macs_equal():
    node = {"host": "127.0.0.1", "port": 7001, "name": "H1", "rank": 3}
    for fn, args in (("join_mac", ("s", node, "n0", 4)),
                     ("leave_mac", ("s", "127.0.0.1:7001", "n1", 5)),
                     ("join_mac", ("s", node, "n0", 4, "g0")),
                     ("universe_entry_mac", ("s", {"op": "add", "e": 2, "node": node}))):
        assert getattr(tconfig, fn)(*args) == getattr(jconfig, fn)(*args), fn
    assert tconfig.reply_mac("s", "n2", 6, {"x": [1, 2]}) == jconfig.reply_mac("s", "n2", 6, {"x": [1, 2]})


@pytest.mark.parametrize("count", [1, 2, 6, 8])
def test_xdist_workers_probe_disjoint_port_slices(count, monkeypatch):
    """Each pytest-xdist worker hands out blocks from its own slice of
    the probe range, so a port that one worker's cluster still targets
    (a crashed node's, which its peers go on pinging) is never bound by
    another worker's cluster; a chaos case's block (n + JOIN_SPAN ports)
    fits in every slice up to 8 workers."""
    slices = [port_slice(f"gw{i}", count) for i in range(count)]
    assert slices[0][0] == PORT_LO and slices[-1][1] <= PORT_HI
    for (lo, hi), (lo2, _) in zip(slices, slices[1:]):
        assert lo < hi < lo2
        assert hi - lo >= 8 + JOIN_SPAN + 2
    assert port_slice("", count) == port_slice("gw0", 1) == (PORT_LO, PORT_HI)
    monkeypatch.setenv("PYTEST_XDIST_WORKER", f"gw{count - 1}")
    monkeypatch.setenv("PYTEST_XDIST_WORKER_COUNT", str(count))
    lo, hi = slices[-1]
    bases = [free_port_block(5) for _ in range(4)]
    try:
        assert all(lo < b and b + 5 <= hi for b in bases)
        assert len({p for b in bases for p in range(b - 1, b + 5)}) == 4 * 6  # none reused
    finally:
        for b in bases:
            release_ports(b, 5)

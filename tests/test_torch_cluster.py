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
# at base + 10000 (`cluster.store_service.DATA_PORT_OFFSET`)
# ----------------------------------------------------------------------

PORT_LO, PORT_HI = 50000, 54999
DATA_OFFSET = 10000
_rng = random.Random(os.getpid() ^ int.from_bytes(os.urandom(4), "little"))
_handed: set = set()
_lock = threading.Lock()


def _free(port: int) -> bool:
    for kind in (socket.SOCK_DGRAM, socket.SOCK_STREAM):
        s = socket.socket(socket.AF_INET, kind)
        try:
            s.bind(("127.0.0.1", port))
        except OSError:
            return False
        finally:
            s.close()
    return True


def free_port_block(n: int, tries: int = 200) -> int:
    """A base port B such that B-1 .. B+n-1 and their data-plane ports
    (+10000) are free to bind on 127.0.0.1 (UDP and TCP) right now.
    Blocks already handed out in this process are not handed out again.
    A later bind can still lose a race to another process; callers
    retry on EADDRINUSE (`port_cases` does)."""
    for _ in range(tries):
        base = _rng.randrange(PORT_LO + 1, PORT_HI - n)
        with _lock:
            if any(b in _handed for b in range(base - 1, base + n)):
                continue
        ports = list(range(base - 1, base + n))
        if all(_free(p) and _free(p + DATA_OFFSET) for p in ports):
            with _lock:
                _handed.update(ports)
            return base
    raise OSError(errno.EADDRINUSE, f"no free block of {n + 1} ports in {PORT_LO}-{PORT_HI}")


class ProbedClusterSpec(tconfig.ClusterSpec):
    """The port's ClusterSpec whose `localhost` puts the nodes on a free
    block (`free_port_block`), whatever base port the caller named."""

    @classmethod
    def localhost(cls, n: int, base_port: int = 8001, introducer_port: int = 8888, **kw):
        base = free_port_block(n)
        return super().localhost(n, base_port=base, introducer_port=base - 1, **kw)


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


def _port_import(name, globals=None, locals=None, fromlist=(), level=0):
    if (level == 0 and globals is not None
            and str(globals.get("__name__", "")).startswith(_PREFIX)
            and (name == "dml_tpu" or name.startswith("dml_tpu."))
            and _has_port(name)):
        name = _port_name(name)
    return _real_import(name, globals, locals, fromlist, level)


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


def _retry_on_eaddrinuse(fn):
    """Run an async test case again (at most twice more) when its
    cluster lost a port race; each run gets its own time limit."""

    @functools.wraps(fn)
    async def run(**kw):
        import asyncio

        for attempt in range(3):
            try:
                return await asyncio.wait_for(fn(**kw), timeout=90.0)
            except OSError as e:
                if e.errno != errno.EADDRINUSE or attempt == 2:
                    raise

    return run


def port_cases(name: str, prefix: str, exclude: Iterable[str] = (),
               probe_ports: bool = False) -> Dict[str, Any]:
    """{new name: object} of `tests/<name>.py`'s test cases and fixtures,
    bound to the port. Test `test_x` becomes `test_<prefix>_x`; fixtures
    keep their names. With `probe_ports`, `ClusterSpec.localhost` puts
    every cluster on a free port block and async cases retry on
    EADDRINUSE."""
    path = os.path.join(TESTS, f"{name}.py")
    with open(path, encoding="utf-8") as f:
        source = f.read()
    mod = types.ModuleType(_PREFIX + name)
    mod.__file__ = path
    sys.modules[mod.__name__] = mod
    exec(compile(source, path, "exec"), mod.__dict__)
    ns = mod.__dict__
    if probe_ports and "ClusterSpec" in ns:
        ns["ClusterSpec"] = ProbedClusterSpec
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
            if probe_ports and inspect.iscoroutinefunction(obj):
                obj = _retry_on_eaddrinuse(obj)
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

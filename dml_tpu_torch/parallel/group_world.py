"""A group primary's world: one process that drives several ranks, the
port's seam for "one process, several devices", as `parallel.mesh` is
its seam for GSPMD. The JAX package needs none: its group primary builds
the group mesh over its host's devices (`jax.devices()[:want]`,
dml_tpu/jobs/groups.py:751) inside the one process that runs the node.
The port runs one process per rank, so a group primary whose mesh wants
`want` ranks opens a torch.distributed world of `want` ranks with itself
as rank 0 (`open_primary`), and follower processes (`follow`, started
through the `node` verb's `--follow RANK`) join it and run its device
calls:

- Objects that issue collectives are built through the world (`build`):
  the primary broadcasts the factory, a handle and the arguments, every
  rank builds its own copy, and later messages address it by handle. A
  `make_mesh` is built this way too, since it is collective; a rank
  outside a mesh skips the objects built over it and their calls.
- A method marked `@seam` on such an object is a device call: on the
  primary it broadcasts its name, the object's handle and its host
  arguments (a pickled header through `broadcast_object_list`, then
  every tensor and numpy array of the arguments as one byte buffer),
  then runs; each follower runs the same method on its own copy. The
  primary runs all host logic (scheduling, slot adoption, sampling
  choices, clocks, callbacks, the data plane); a follower reads no clock,
  queue or socket outside the world, so it cannot fork from the primary
  whatever the primary's choices depended on. A seam called inside
  another runs as part of it, on every rank.
- Every call of one world goes through one lock on the primary, so two
  threads' collectives never interleave (the image engine and the LM
  backend each run in their own `asyncio.to_thread`).
- Validation belongs before a seam: an exception inside a world call
  leaves the ranks in unknown states, so it breaks the world. The call
  raises `GroupDegraded`, and so does every later call, at once: the
  batch requeues through the job service's WORKER_TASK_FAIL path, and
  nothing hangs past the world's collective timeout. Every wait of the
  primary's is bounded by it: its side of the control channel (the
  broadcast of each header and buffer) and every collective of the
  world's meshes. Only a follower waits longer, for the next call.

Backend: NCCL when every rank has a card of its own (`torch.cuda.
device_count()` >= the world size), else gloo, whose collectives stage
CUDA tensors through the host (`parallel.mesh`); the control channel is a
gloo group either way. Two ranks on one card therefore time host
staging, not NVLink.

Rendezvous: `tcp://<primary's host>:<its port + GROUP_PORT_OFFSET>` for
node processes (`rendezvous_of`), or any init method the caller gives (a
`file://` path under a bench's or a test's temporary directory).
"""

from __future__ import annotations

import contextlib
import datetime
import functools
import importlib
import json
import logging
import os
import subprocess
import sys
import threading
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

log = logging.getLogger(__name__)

#: a group world's rendezvous listens at the primary's control-plane port
#: plus this (the data plane takes +10000, multihost's coordinator +20000)
GROUP_PORT_OFFSET = 5_000
#: how long a primary waits for its followers to join
JOIN_TIMEOUT_S = 120.0
#: every collective of the world's meshes (a lost rank surfaces within it)
COLLECTIVE_TIMEOUT_S = 60.0
#: a follower's side of the control channel: it waits there for the
#: primary's next call as long as the world lives (a node idles for
#: hours). The primary's side has the collective timeout: a follower that
#: stops answering fails the primary's next send within it, a dead one at
#: once (its connection closes). Gloo's timeout is each process's own.
FOLLOWER_CONTROL_TIMEOUT = datetime.timedelta(days=7)


class FollowersMissing(RuntimeError):
    """A group primary's followers did not join its world in time: the
    primary refuses to start rather than serve on fewer ranks."""


def _degraded(msg: str) -> Exception:
    from ..jobs.groups import GroupDegraded

    return GroupDegraded(msg)


def mesh_ranks(mesh_spec) -> int:
    """The ranks a group mesh takes: the product of its axes, 1 when an
    axis is -1 (a group that fills whatever world it has opens none)."""
    sizes = [int(getattr(mesh_spec, a)) for a in ("dp", "tp", "sp", "pp", "ep")]
    if -1 in sizes:
        return 1
    return int(np.prod(sizes))


def rendezvous_of(spec, primary) -> str:
    """The init method of `primary`'s group world (a `config.NodeId`)."""
    return f"tcp://{primary.host}:{primary.port + GROUP_PORT_OFFSET}"


def backend_for(device: torch.device, size: int) -> str:
    """NCCL when every rank has a card of its own, else gloo."""
    if device.type == "cuda" and torch.cuda.device_count() >= size:
        return "nccl"
    return "gloo"


# ----------------------------------------------------------------------
# the wire: a pickled header, then one byte buffer of every array
# ----------------------------------------------------------------------


class _Ref:
    """An object built through the world, by handle."""

    __slots__ = ("handle",)

    def __init__(self, handle: int):
        self.handle = handle


class _Arr:
    """A tensor or numpy array of the arguments: its place in the buffer."""

    __slots__ = ("off", "dtype", "shape", "numpy")

    def __init__(self, off, dtype, shape, numpy):
        self.off, self.dtype, self.shape, self.numpy = off, dtype, shape, numpy


class _Skip:
    """A follower's placeholder for an object over a mesh it is not in."""


_ALIGN = 16


def _encode(x, handles: Dict[int, int], parts: List[torch.Tensor], size: List[int]):
    if id(x) in handles:
        return _Ref(handles[id(x)])
    if isinstance(x, np.ndarray) and x.dtype != object:
        t = torch.from_numpy(np.array(x, copy=True, order="C"))
        return _encode_tensor(t, parts, size, numpy=True)
    if isinstance(x, torch.Tensor):
        if x.device.type != "cpu":
            raise TypeError("a world call takes host arguments; got a tensor on " + str(x.device))
        return _encode_tensor(x.detach(), parts, size, numpy=False)
    if isinstance(x, dict):
        return {k: _encode(v, handles, parts, size) for k, v in x.items()}
    if isinstance(x, (list, tuple)) and type(x) in (list, tuple):
        return type(x)(_encode(v, handles, parts, size) for v in x)
    return x


def _encode_tensor(t: torch.Tensor, parts, size, numpy: bool) -> _Arr:
    off = -(-size[0] // _ALIGN) * _ALIGN
    if off > size[0]:
        parts.append(torch.zeros(off - size[0], dtype=torch.uint8))
    flat = t.contiguous().reshape(-1).view(torch.uint8) if t.numel() else torch.zeros(
        0, dtype=torch.uint8)
    parts.append(flat)
    size[0] = off + flat.numel()
    return _Arr(off, t.dtype, tuple(t.shape), numpy)


def _decode(x, objs: Dict[int, Any], buf: Optional[torch.Tensor]):
    if isinstance(x, _Ref):
        return objs[x.handle]
    if isinstance(x, _Arr):
        n = int(np.prod(x.shape, dtype=np.int64)) * torch.empty(0, dtype=x.dtype).element_size()
        t = (buf[x.off:x.off + n].clone().view(x.dtype).reshape(x.shape) if n
             else torch.empty(x.shape, dtype=x.dtype))
        return t.numpy() if x.numpy else t
    if isinstance(x, dict):
        return {k: _decode(v, objs, buf) for k, v in x.items()}
    if isinstance(x, (list, tuple)) and type(x) in (list, tuple):
        return type(x)(_decode(v, objs, buf) for v in x)
    return x


def _factory_name(factory: Callable) -> str:
    name = f"{factory.__module__}:{factory.__qualname__}"
    if not factory.__module__.startswith("dml_tpu_torch."):
        raise ValueError(f"a world builds the port's own objects only, not {name}")
    return name


def _resolve_factory(name: str) -> Callable:
    mod, _, qual = name.partition(":")
    if not mod.startswith("dml_tpu_torch."):
        raise ValueError(f"a world builds the port's own objects only, not {name}")
    obj: Any = importlib.import_module(mod)
    for part in qual.split("."):
        obj = getattr(obj, part)
    return obj


# ----------------------------------------------------------------------
# the world
# ----------------------------------------------------------------------


class World:
    """The torch.distributed world of one group primary (rank 0) and its
    followers. `stats()` gives the primary's call count, the bytes it
    sent and the host seconds its broadcasts took."""

    def __init__(self, rank: int, size: int, device: torch.device, backend: str,
                 timeout_s: float):
        self.rank, self.size, self.device, self.backend = rank, size, device, backend
        self.timeout_s = float(timeout_s)
        self.control = dist.new_group(
            backend="gloo", timeout=self.timeout if rank == 0 else FOLLOWER_CONTROL_TIMEOUT)
        self.broken: Optional[str] = None
        self._lock = threading.RLock()
        self._tls = threading.local()
        self._objs: Dict[int, Any] = {}
        self._handles: Dict[int, int] = {}  # id(obj) -> handle (the primary's)
        self._next = 1
        self._stats = {"calls": 0, "builds": 0, "array_bytes": 0, "send_s": 0.0,
                       "call_s": 0.0}

    @property
    def timeout(self) -> datetime.timedelta:
        return datetime.timedelta(seconds=self.timeout_s)

    @property
    def primary(self) -> bool:
        return self.rank == 0

    def stats(self) -> Dict[str, Any]:
        return dict(self._stats, size=self.size, backend=self.backend, broken=self.broken)

    # -- the primary's side ---------------------------------------------

    def _inside(self) -> bool:
        return getattr(self._tls, "depth", 0) > 0

    def _pack(self, header: Tuple):
        """(the header with its arrays replaced by places, the byte
        buffer of the arrays or None); TypeError for a device tensor."""
        parts: List[torch.Tensor] = []
        size = [0]
        header = _encode(header, self._handles, parts, size)
        if not size[0]:
            return header, None
        return header, torch.cat(parts) if len(parts) > 1 else parts[0]

    def _send(self, packed) -> None:
        t0 = time.perf_counter()
        header, buf = packed
        dist.broadcast_object_list([header, 0 if buf is None else buf.numel()], src=0,
                                   group=self.control)
        if buf is not None:
            dist.broadcast(buf, src=0, group=self.control)
            self._stats["array_bytes"] += buf.numel()
        self._stats["send_s"] += time.perf_counter() - t0

    def _run(self, header: Tuple, fn: Callable[[], Any], what: str):
        if self._inside():  # a seam inside a world call: part of it on every rank
            return fn()
        with self._lock:
            if self.broken is not None:
                raise _degraded(f"group world is broken ({self.broken}); {what} refused")
            if header[0] == "call":
                self._stats["calls"] += 1
            packed = self._pack(header)
            self._tls.depth = 1
            t0 = time.perf_counter()
            try:
                self._send(packed)
                return fn()
            except BaseException as e:
                self.broken = f"{what}: {type(e).__name__}: {e}"[:500]
                log.error("group world broken in %s: %r", what, e)
                raise _degraded(f"group world lost a rank or failed in {what}: {e!r}") from e
            finally:
                self._tls.depth = 0
                self._stats["call_s"] += time.perf_counter() - t0

    def build(self, factory: Callable, *args, **kwargs):
        """`factory(*args, **kwargs)` on every rank; returns the
        primary's object, which later seams address by handle."""
        name = _factory_name(factory)
        with self._lock:  # builds come from several threads: one handle each
            handle = self._next
            self._next += 1
            obj = self._run(("build", handle, name, args, kwargs),
                            lambda: factory(*args, **kwargs), f"build {name}")
            self._stats["builds"] += 1
            self._register(obj, handle)
        return obj

    def _register(self, obj, handle: int) -> None:
        self._objs[handle] = obj
        self._handles[id(obj)] = handle
        obj._world_mirror = _Mirror(self, handle, ())
        for path in getattr(obj, "_world_parts", ()):
            getattr(obj, path)._world_mirror = _Mirror(self, handle, (path,))

    def call(self, handle: int, path: Tuple[str, ...], name: str, args, kwargs,
             fn: Callable[[], Any]):
        return self._run(("call", handle, path, name, args, kwargs), fn, name)

    def drop(self, obj) -> None:
        """Forget an object on every rank (its memory goes with it)."""
        with self._lock:
            handle = self._handles.pop(id(obj), None)
            if handle is None or self.broken is not None:
                return
            self._objs.pop(handle, None)
            self._run(("drop", handle), lambda: None, "drop")

    def close(self) -> None:
        """End the world: the followers leave their loops and exit. Logs
        the world's stats."""
        global _CURRENT
        log.info("group world closing: %s", json.dumps(self.stats()))
        with self._lock:
            if self.broken is None:
                try:
                    self._send(self._pack(("close",)))
                    dist.monitored_barrier(group=self.control, timeout=self.timeout)
                except Exception as e:  # a lost follower: nothing left to tell
                    log.warning("group world close: %r", e)
            self.broken = self.broken or "closed"
        _teardown()
        if _CURRENT is self:
            _CURRENT = None

    # -- a follower's side ----------------------------------------------

    def serve(self) -> int:
        """Run the primary's builds and calls until it closes the world;
        returns the number of calls run. An exception here means this
        rank forked from the primary: it propagates, and the process
        exits, which the primary sees as a lost rank."""
        calls = 0
        while True:
            msg = [None, None]
            dist.broadcast_object_list(msg, src=0, group=self.control)
            header, nbytes = msg
            buf = None
            if nbytes:
                buf = torch.empty(nbytes, dtype=torch.uint8)
                dist.broadcast(buf, src=0, group=self.control)
            kind = header[0]
            if kind == "close":
                dist.monitored_barrier(group=self.control, timeout=self.timeout)
                return calls
            if kind == "drop":
                self._objs.pop(header[1], None)
                continue
            if kind == "build":
                _, handle, name, args, kwargs = header
                args, kwargs = _decode(args, self._objs, buf), _decode(kwargs, self._objs, buf)
                if "device" in kwargs:  # each rank builds on its own device
                    kwargs["device"] = self.device
                factory = _resolve_factory(name)
                outside = any(_outside(a) for a in list(args) + list(kwargs.values()))
                self._objs[handle] = _Skip() if outside else factory(*args, **kwargs)
                continue
            _, handle, path, name, args, kwargs = header
            obj = self._objs[handle]
            if isinstance(obj, _Skip):
                continue
            for p in path:
                obj = getattr(obj, p)
            getattr(obj, name)(*_decode(args, self._objs, buf), **_decode(kwargs, self._objs, buf))
            calls += 1


def _outside(x) -> bool:
    """A mesh this rank is not in, or an object built over one."""
    from .mesh import Mesh

    return isinstance(x, _Skip) or (isinstance(x, Mesh) and x.distributed and x.rank is None)


class _Mirror:
    """The primary's hook on an object built through the world."""

    __slots__ = ("world", "handle", "path")

    def __init__(self, world: World, handle: int, path: Tuple[str, ...]):
        self.world, self.handle, self.path = world, handle, path

    def __call__(self, name: str, args, kwargs, fn: Callable[[], Any]):
        return self.world.call(self.handle, self.path, name, args, kwargs, fn)


def seam(fn: Callable) -> Callable:
    """Mark a method as a device call: on an object a world built, the
    primary broadcasts it (name, handle, host arguments) before it runs,
    and the followers run it on their copies; elsewhere it just runs."""

    @functools.wraps(fn)
    def wrapper(self, *args, **kwargs):
        mirror = getattr(self, "_world_mirror", None)
        if mirror is None:
            return fn(self, *args, **kwargs)
        return mirror(fn.__name__, args, kwargs, lambda: fn(self, *args, **kwargs))

    return wrapper


class RankTrace:
    """A torch.profiler trace on every rank of a world
    (`observability.profile`; rank r writes under `logdir/rank<r>`):
    built through the world, ended by `stop` (or `__exit__`)."""

    def __init__(self, logdir: str):
        from ..observability import profile

        rank = dist.get_rank() if dist.is_initialized() else 0
        self.logdir = os.path.join(logdir, f"rank{rank}")
        self._trace = profile(self.logdir)
        self._trace.__enter__()

    @seam
    def stop(self) -> None:
        self._trace.__exit__(None, None, None)

    def __exit__(self, *exc) -> None:
        self.stop()


# ----------------------------------------------------------------------
# opening and joining
# ----------------------------------------------------------------------

_CURRENT: Optional[World] = None


def current() -> Optional[World]:
    """This process's open group world, or None."""
    return _CURRENT


def collective_timeout() -> Optional[datetime.timedelta]:
    """The open world's collective timeout (for `parallel.mesh`'s
    groups), or None."""
    return None if _CURRENT is None else _CURRENT.timeout


def _world_of(engine) -> Optional[World]:
    """The world `engine` was built through (None: this process's own
    world, for an engine built lazily through it)."""
    if engine is None:
        return _CURRENT if _CURRENT is not None and _CURRENT.primary else None
    mirror = getattr(engine, "_world_mirror", None)
    return None if mirror is None else mirror.world


def refuse(backend, engine=None, cause: Optional[BaseException] = None) -> None:
    """Raise `GroupDegraded` for a group backend whose engine's world is
    lost (`engine` built through a world, or None for the process's own
    world), its `lost` set first: the job service then routes none of
    this node's batches to it (`_group_serves`), and they run on the
    node's one-device backends, as a degraded group's survivors serve.
    A no-op while the world is whole, and for an engine no world built."""
    world = _world_of(engine)
    if world is None or world.broken is None:
        return
    backend.lost = True
    err = _degraded(f"group world lost a rank ({world.broken}): the group engine refuses "
                    f"the batch, which requeues")
    if cause is not None:
        raise err from cause
    raise err


def build(factory: Callable, *args, **kwargs):
    """`factory(*args, **kwargs)` through this process's world when it is
    a group primary's, else right here (one rank, or a caller that runs
    every rank itself)."""
    w = _CURRENT
    if w is None or not w.primary:
        return factory(*args, **kwargs)
    return w.build(factory, *args, **kwargs)


def drop(obj) -> None:
    """`World.drop` on this process's world, when it has one."""
    if _CURRENT is not None and _CURRENT.primary:
        _CURRENT.drop(obj)


def _teardown() -> None:
    if dist.is_available() and dist.is_initialized():
        try:
            dist.destroy_process_group()
        except Exception as e:
            log.warning("destroy_process_group: %r", e)


def _join(init_method: str, rank: int, size: int, device: torch.device,
          join_timeout_s: float, timeout_s: float) -> World:
    global _CURRENT
    if _CURRENT is not None:
        raise RuntimeError("this process already has a group world")
    if dist.is_initialized():
        raise RuntimeError("torch.distributed is already initialized in this process")
    backend = backend_for(device, size)
    if backend == "nccl":
        torch.cuda.set_device(rank % torch.cuda.device_count())
        device = torch.device("cuda", rank % torch.cuda.device_count())
    try:
        dist.init_process_group(backend, init_method=init_method, world_size=size, rank=rank,
                                timeout=datetime.timedelta(seconds=join_timeout_s))
        world = World(rank, size, device, backend, timeout_s)
    except Exception as e:
        _teardown()
        if rank == 0:
            raise FollowersMissing(
                f"group world {init_method}: {size - 1} follower rank(s) did not join within "
                f"{join_timeout_s:g} s ({type(e).__name__}: {e})") from e
        raise
    _CURRENT = world
    log.info("group world %s up: rank %d of %d (%s, %s)", init_method, rank, size, backend,
             device)
    return world


def _device(device) -> torch.device:
    from ..models.lm_params import resolve_device

    return resolve_device(device)


def open_primary(init_method: str, size: int, device=None,
                 join_timeout_s: float = JOIN_TIMEOUT_S,
                 timeout_s: float = COLLECTIVE_TIMEOUT_S) -> World:
    """Open a world of `size` ranks with this process as rank 0 and wait
    for its followers; `FollowersMissing` when they do not come within
    `join_timeout_s`. `device` (cuda when None; it raises where there is
    none) picks the backend."""
    if size < 2:
        raise ValueError(f"a group world needs at least 2 ranks, got {size}")
    return _join(init_method, 0, size, _device(device), join_timeout_s, timeout_s)


def follow(init_method: str, rank: int, size: int, device=None,
           join_timeout_s: float = JOIN_TIMEOUT_S,
           timeout_s: float = COLLECTIVE_TIMEOUT_S) -> int:
    """Join a primary's world as `rank` and run its calls until it closes
    the world; returns the number of calls run. `device` is checked
    before joining: cuda (the default) raises "no CUDA device" where
    there is none."""
    if not 1 <= rank < size:
        raise ValueError(f"follower rank {rank} is not in 1..{size - 1}")
    dev = _device(device)
    world = _join(init_method, rank, size, dev, join_timeout_s, timeout_s)
    global _CURRENT
    try:
        return world.serve()
    finally:
        _CURRENT = None
        _teardown()


def follow_from_spec(spec, name: str, rank: int, device=None,
                     init_method: Optional[str] = None,
                     join_timeout_s: float = JOIN_TIMEOUT_S) -> int:
    """The `node --follow RANK` entry: follow the world of the group
    primary `name` (a node of `spec` listed first in its worker group),
    whose size is the group mesh's rank count; the rendezvous is
    `rendezvous_of` the primary unless `init_method` names another."""
    me = spec.node_by_name(name) or spec.node_by_unique_name(name)
    if me is None:
        raise SystemExit(f"unknown node {name!r}; spec has {[n.name for n in spec.nodes]}")
    g = spec.group_of_unique(me.unique_name)
    members = spec.group_members_unique(g.name) if g is not None else ()
    if not members or members[0] != me.unique_name:
        raise SystemExit(f"{name} is not a worker group's primary: it has no group world")
    size = mesh_ranks(g.mesh)
    if size < 2:
        raise SystemExit(f"group {g.name}'s mesh takes one rank: it has no followers")
    return follow(init_method or rendezvous_of(spec, me), rank, size, device=device,
                  join_timeout_s=join_timeout_s)


@contextlib.contextmanager
def local_world(spec, name: str, tmp: str, device=None,
                join_timeout_s: float = JOIN_TIMEOUT_S) -> Iterator[World]:
    """The group world of `spec`'s group primary `name` on this host, this
    process its rank 0: the spec written under `tmp`, each follower rank
    started as `python -m dml_tpu_torch node --name <name> --follow RANK`
    (the operator's entry) with a `file://` rendezvous under `tmp`. On
    exit the world closes and every follower process is waited for (and
    killed if it outlives the close by a minute)."""
    me = spec.node_by_name(name) or spec.node_by_unique_name(name)
    g = spec.group_of_unique(me.unique_name) if me is not None else None
    if g is None:
        raise ValueError(f"{name} is in no worker group of the spec")
    size = mesh_ranks(g.mesh)
    dev = _device(device)
    os.makedirs(tmp, exist_ok=True)
    spec_path = os.path.join(tmp, "world_spec.json")
    with open(spec_path, "w") as f:
        f.write(spec.to_json())
    init = "file://" + os.path.join(os.path.abspath(tmp), "world_rendezvous")
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    procs = []
    world = None
    try:
        for rank in range(1, size):
            log_path = os.path.join(tmp, f"follower_{rank}.log")
            with open(log_path, "w") as out:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "dml_tpu_torch", "--log-file", log_path + ".py.log",
                     "node", "--spec", spec_path, "--name", me.name, "--follow", str(rank),
                     "--rendezvous", init, "--device", dev.type,
                     "--join-timeout", str(join_timeout_s)],
                    stdout=out, stderr=subprocess.STDOUT, env=env))
        world = open_primary(init, size, device=dev, join_timeout_s=join_timeout_s)
        yield world
    finally:
        if world is not None:
            world.close()
        for p in procs:
            if world is None:  # no world: nothing will close them
                p.kill()
            try:
                p.wait(timeout=60)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()

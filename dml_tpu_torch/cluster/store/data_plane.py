"""Bulk data plane: asyncio TCP streams between nodes.

Replaces the reference's scp-over-SSH pulls (file_service.py:52-91,
credentials from password.txt, config.py:29-37). Same pull-based
topology — the node that needs bytes dials the node that has them —
but over a credential-free TCP stream protocol on each node's data
port:

    request:  one JSON line {"op": ..., ...}\n
    response: one JSON line {"ok": bool, "size": N, ...}\n + raw bytes

Ops:
- fetch_store: pull a (name, version) — or every version — of a file
  from the remote node's LocalStore (replication + GET path; reference
  replicate_file pulls `filename*`, file_service.py:52-61)
- fetch_token: pull a client-exposed local file (PUT path). The client
  registers the path first and the token travels via the leader —
  unlike scp, arbitrary remote paths are not readable.
- fetch_stream: pull an exposed LIVE byte stream (request front door,
  dml_tpu/ingress/): the serving node registers a StreamFeed, pushes
  chunks into it as an LM request decodes, and the client reads
  length-prefixed chunks until the zero-length EOF frame — tokens
  reach the client while the batch is still decoding.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import random
import secrets
import time
from typing import Dict, List, Optional, Tuple

from .local_store import CorruptionError, LocalStore

log = logging.getLogger(__name__)

_CHUNK = 1 << 16


class TunnelFault:
    """Seeded data-plane fault model: slow and/or failing bulk copies.

    The chaos engine installs one per node's DataPlane; every client
    pull (GET fetch, PUT token pull, repair replicate) first consults
    it. Decisions come from a private ``random.Random(seed)`` so a
    plan re-run makes the identical slow/fail choices per pull.

    - ``delay_s``: every pull sleeps this long first (a congested or
      high-latency tunnel; the copy still succeeds)
    - ``fail_pct``: percent of pulls that raise ConnectionError
      instead of transferring (a flapping link / dying peer)
    """

    def __init__(self, seed: int = 0, delay_s: float = 0.0,
                 fail_pct: float = 0.0):
        if fail_pct < 0 or fail_pct > 100:
            raise ValueError(f"fail_pct {fail_pct} out of range")
        if delay_s < 0:
            raise ValueError("delay_s must be >= 0")
        self.delay_s = delay_s
        self.fail_pct = fail_pct
        self.enabled = True
        self._rng = random.Random(seed)

    async def apply(self) -> None:
        """Consume one decision; sleep and/or raise per the model.
        RNG state advances even while disabled so a plan's decision
        stream doesn't depend on when the fault was switched on."""
        fail = self._rng.random() * 100.0 < self.fail_pct
        if not self.enabled:
            return
        if self.delay_s > 0:
            await asyncio.sleep(self.delay_s)
        if fail:
            raise ConnectionError("injected tunnel fault (TunnelFault)")


class StreamFeed:
    """One live outbound byte stream (token streaming, ingress/).

    The producer ``push()``es chunks from any coroutine on the loop
    (backends decoding on a thread hop via call_soon_threadsafe) and
    ``close()``s at EOF; the data-plane server drains the queue to the
    one puller. Bounded: a puller that never connects cannot grow the
    queue past ``maxsize`` — overflow drops the OLDEST chunk (token
    streaming is a latency optimization; the full result still arrives
    via the request terminal)."""

    def __init__(self, maxsize: int = 4096):
        self._q: asyncio.Queue = asyncio.Queue()
        self._maxsize = maxsize
        self.closed = False
        self.dropped = 0

    def push(self, data: bytes) -> None:
        if self.closed or not data:
            return
        while self._q.qsize() >= self._maxsize:
            try:
                self._q.get_nowait()
                self.dropped += 1
            except asyncio.QueueEmpty:
                break
        self._q.put_nowait(data)

    async def put(self, data: bytes, timeout: float = 120.0) -> None:
        """Backpressured push: awaits for queue room instead of
        dropping. Bulk payloads (the KV-slab handoff) use this —
        push()'s drop-oldest is a token-streaming latency trade that
        would garble a framed byte stream, and an unbounded buffer
        would hold a whole share's slabs in memory when the puller is
        slower than prefill compute. ``timeout`` bounds the wait: a
        puller that NEVER connects leaves the feed open (the serve
        handler's close only fires once a puller came and went), and
        a producer must fail loudly then, not wedge its task forever.
        Raises asyncio.TimeoutError on expiry."""
        if self.closed or not data:
            return
        deadline = time.monotonic() + timeout
        while self._q.qsize() >= self._maxsize and not self.closed:
            if time.monotonic() >= deadline:
                raise asyncio.TimeoutError(
                    f"stream put(): no queue room after {timeout:g}s "
                    "(puller never drained)"
                )
            await asyncio.sleep(0.01)
        if not self.closed:
            self._q.put_nowait(data)

    def close(self) -> None:
        if not self.closed:
            self.closed = True
            self._q.put_nowait(None)

    def drained(self) -> bool:
        """True once the consumer has taken everything, EOF included
        — the producer's cue that unexposing the stream costs nothing."""
        return self.closed and self._q.qsize() == 0

    async def get(self) -> Optional[bytes]:
        return await self._q.get()


class DataPlane:
    def __init__(self, store: LocalStore, host: str = "127.0.0.1", port: int = 0):
        self.store = store
        self.host = host
        self.port = port
        self._server: Optional[asyncio.AbstractServer] = None
        self._exposed: Dict[str, str] = {}  # token -> local path
        self._streams: Dict[str, StreamFeed] = {}  # token -> live feed
        # fault-injection seam: slow/failing outbound pulls (chaos)
        self.fault: Optional[TunnelFault] = None

    async def _maybe_fault(self) -> None:
        if self.fault is not None:
            await self.fault.apply()

    # ---- lifecycle ----

    async def start(self) -> None:
        self._server = await asyncio.start_server(self._handle, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]

    async def stop(self) -> None:
        # snapshot-before-await (dmllint race-yield-hazard): clear the
        # attribute BEFORE awaiting, so a start() racing this stop
        # can't have its fresh server overwritten with None after the
        # wait_closed yield
        server, self._server = self._server, None
        if server is not None:
            server.close()
            await server.wait_closed()

    # ---- client-side path exposure (PUT source) ----

    def expose(self, path: str) -> str:
        token = secrets.token_hex(16)
        self._exposed[token] = os.path.abspath(os.path.expanduser(path))
        return token

    def unexpose(self, token: str) -> None:
        self._exposed.pop(token, None)

    def expose_stream(self, maxsize: int = 4096) -> Tuple[str, StreamFeed]:
        """Register a live outbound stream; returns (token, feed). The
        serving side pushes chunks into the feed and close()s at EOF;
        the token travels to the consumer over the control plane
        (REQUEST_STREAM_READY). ``maxsize`` bounds the buffered
        chunks — producers of bulk framed payloads should pass a
        small bound and feed via the backpressured ``put``."""
        token = secrets.token_hex(16)
        feed = StreamFeed(maxsize)
        self._streams[token] = feed
        return token, feed

    def unexpose_stream(self, token: str) -> None:
        feed = self._streams.pop(token, None)
        if feed is not None:
            feed.close()

    # ---- server ----

    async def _handle(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        try:
            line = await reader.readline()
            try:
                req = json.loads(line)
            except json.JSONDecodeError:
                await self._reply(writer, {"ok": False, "error": "bad request"})
                return
            op = req.get("op")
            if op == "fetch_store":
                await self._serve_store(writer, req)
            elif op == "fetch_token":
                await self._serve_token(writer, req)
            elif op == "fetch_stream":
                await self._serve_stream(writer, req)
            else:
                await self._reply(writer, {"ok": False, "error": f"unknown op {op!r}"})
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except (ConnectionError, OSError, asyncio.TimeoutError) as e:
                # peer vanished mid-close; the OS already reclaimed the
                # socket — but say so instead of eating a real bug
                log.debug("data-plane serve close: %r", e)

    async def _reply(self, writer, header: dict, payload: bytes = b"") -> None:
        writer.write(json.dumps(header).encode() + b"\n")
        for i in range(0, len(payload), _CHUNK):
            writer.write(payload[i : i + _CHUNK])
            await writer.drain()
        await writer.drain()

    async def _serve_store(self, writer, req: dict) -> None:
        name = req.get("file", "")
        if req.get("all_versions"):
            versions = self.store.versions(name)
            blobs = []
            for v in versions:
                # a corrupt version is quarantined by the verified read
                # and NOT served: a repair pull from this replica gets
                # only the good versions — corruption cannot propagate
                try:
                    data, _ = self.store.get_bytes(name, v)
                except (FileNotFoundError, CorruptionError):
                    continue
                blobs.append((v, data))
            if not blobs:
                await self._reply(writer, {"ok": False, "error": "not found"})
                return
            header = {
                "ok": True,
                "versions": [[v, len(d)] for v, d in blobs],
                "size": sum(len(d) for _, d in blobs),
            }
            await self._reply(writer, header, b"".join(d for _, d in blobs))
            return
        try:
            data, v = self.store.get_bytes(name, req.get("version"))
        except (FileNotFoundError, CorruptionError) as e:
            # checksum mismatch quarantined the version; to the caller
            # this replica simply doesn't have the bytes — it retries
            # the next replica, and the re-report + repair sweep heal
            # this one in the background
            await self._reply(writer, {"ok": False, "error": f"not found ({e})"
                                       if isinstance(e, CorruptionError)
                                       else "not found"})
            return
        await self._reply(writer, {"ok": True, "version": v, "size": len(data)}, data)

    async def _serve_token(self, writer, req: dict) -> None:
        path = self._exposed.get(req.get("token", ""))
        if path is None or not os.path.isfile(path):
            await self._reply(writer, {"ok": False, "error": "unknown token"})
            return
        with open(path, "rb") as f:
            data = f.read()
        await self._reply(writer, {"ok": True, "size": len(data)}, data)

    #: inactivity bound per stream chunk: a producer that silently
    #: died must not pin the connection (and its feed) forever
    STREAM_IDLE_TIMEOUT = 60.0

    async def _serve_stream(self, writer, req: dict) -> None:
        """Drain a live StreamFeed to the puller: header line, then
        length-prefixed chunks (4-byte big-endian) until a zero-length
        EOF frame. One puller per token; the token retires after the
        serve (streams are per-request transients, like KV slabs)."""
        import struct as _struct

        token = req.get("token", "")
        feed = self._streams.get(token)
        if feed is None:
            await self._reply(writer, {"ok": False, "error": "unknown token"})
            return
        writer.write(json.dumps({"ok": True, "stream": True}).encode() + b"\n")
        try:
            while True:
                chunk = await asyncio.wait_for(
                    feed.get(), self.STREAM_IDLE_TIMEOUT
                )
                if chunk is None:
                    writer.write(_struct.pack("!I", 0))
                    await writer.drain()
                    return
                writer.write(_struct.pack("!I", len(chunk)) + chunk)
                await writer.drain()
        except asyncio.TimeoutError:
            writer.write(_struct.pack("!I", 0))
            await writer.drain()
        finally:
            self._streams.pop(token, None)
            # one puller per token: once it is done (EOF, idle
            # timeout, or a dead connection unwinding through
            # _handle), nothing will ever drain this feed again —
            # close it so a producer awaiting put() backpressure
            # unblocks instead of waiting on a consumer that left
            feed.close()

    # ---- client ----

    @staticmethod
    async def _rpc(addr: Tuple[str, int], req: dict, timeout: float = 30.0):
        reader, writer = await asyncio.wait_for(asyncio.open_connection(*addr), timeout)
        try:
            writer.write(json.dumps(req).encode() + b"\n")
            await writer.drain()
            header = json.loads(await asyncio.wait_for(reader.readline(), timeout))
            if not header.get("ok"):
                return header, b""
            payload = await asyncio.wait_for(
                reader.readexactly(header.get("size", 0)), timeout
            )
            return header, payload
        finally:
            writer.close()
            try:
                await writer.wait_closed()
            except (ConnectionError, OSError, asyncio.TimeoutError) as e:
                log.debug("data-plane rpc close: %r", e)

    async def fetch_from_store(
        self,
        addr: Tuple[str, int],
        name: str,
        version: Optional[int] = None,
        timeout: float = 30.0,
    ) -> Tuple[bytes, int]:
        """Pull one version (latest if None) from a remote node."""
        await self._maybe_fault()
        header, payload = await self._rpc(
            addr, {"op": "fetch_store", "file": name, "version": version}, timeout
        )
        if not header.get("ok"):
            raise FileNotFoundError(f"{name} at {addr}: {header.get('error')}")
        return payload, int(header["version"])

    async def replicate_from(
        self, addr: Tuple[str, int], name: str, timeout: float = 60.0
    ) -> List[int]:
        """Pull ALL versions of `name` from a live replica into the
        local store (reference replicate_file, file_service.py:52-61)."""
        await self._maybe_fault()
        header, payload = await self._rpc(
            addr, {"op": "fetch_store", "file": name, "all_versions": True}, timeout
        )
        if not header.get("ok"):
            raise FileNotFoundError(f"{name} at {addr}: {header.get('error')}")
        got: List[int] = []
        off = 0
        for v, size in header["versions"]:
            self.store.put_bytes(name, payload[off : off + size], version=int(v))
            off += size
            got.append(int(v))
        return got

    async def fetch_token_bytes(
        self,
        addr: Tuple[str, int],
        token: str,
        timeout: float = 60.0,
    ) -> bytes:
        """Pull an exposed file's raw bytes without landing them in
        the store — the KV-cache slab handoff of disaggregated LM
        serving (inference/lm_sharded.py): the slab is transient
        per-batch state, not a replicated object, so it rides the
        same token protocol as PUT sources but stays out of the
        metadata/replication machinery. TunnelFault applies like any
        other client pull."""
        await self._maybe_fault()
        header, payload = await self._rpc(
            addr, {"op": "fetch_token", "token": token}, timeout
        )
        if not header.get("ok"):
            raise FileNotFoundError(f"token at {addr}: {header.get('error')}")
        return payload

    async def fetch_stream(
        self,
        addr: Tuple[str, int],
        token: str,
        timeout: float = 60.0,
    ):
        """Async generator over a remote live stream's chunks (token
        streaming for per-request LM serving, dml_tpu/ingress/).
        Yields each chunk as it arrives; returns at the zero-length
        EOF frame. ``timeout`` bounds the wait for EACH chunk, not the
        whole stream. TunnelFault applies like any other client pull."""
        import struct as _struct

        await self._maybe_fault()
        reader, writer = await asyncio.wait_for(
            asyncio.open_connection(*addr), timeout
        )
        try:
            writer.write(
                json.dumps({"op": "fetch_stream", "token": token}).encode()
                + b"\n"
            )
            await writer.drain()
            header = json.loads(
                await asyncio.wait_for(reader.readline(), timeout)
            )
            if not header.get("ok"):
                raise FileNotFoundError(
                    f"stream at {addr}: {header.get('error')}"
                )
            while True:
                raw = await asyncio.wait_for(reader.readexactly(4), timeout)
                (size,) = _struct.unpack("!I", raw)
                if size == 0:
                    return
                yield await asyncio.wait_for(
                    reader.readexactly(size), timeout
                )
        finally:
            writer.close()
            try:
                await writer.wait_closed()
            except (ConnectionError, OSError, asyncio.TimeoutError) as e:
                log.debug("data-plane stream close: %r", e)

    async def fetch_token_to_store(
        self,
        addr: Tuple[str, int],
        token: str,
        name: str,
        version: int,
        timeout: float = 60.0,
    ) -> int:
        """PUT path: pull the client's exposed file into the local store
        at an explicit version (the leader assigns the version so all
        replicas agree; the reference lets each replica pick its own
        next version, which can skew)."""
        await self._maybe_fault()
        header, payload = await self._rpc(addr, {"op": "fetch_token", "token": token}, timeout)
        if not header.get("ok"):
            raise FileNotFoundError(f"token at {addr}: {header.get('error')}")
        return self.store.put_bytes(name, payload, version=version)

"""Per-node versioned local file store.

Replaces the reference's FileService (file_service.py:1-124): same
on-disk contract — store root holding `name_versionN` files, newest
`max_versions` kept, inventory reloadable after restart
(file_service.py:23-33) — but transfers are handled by the TCP data
plane, not asyncssh/scp.

File names are sanitized into a flat namespace the way the reference's
CLI usage implies (SDFS names are logical keys, not paths).

Durability + integrity (beyond the reference, which fwrites in place
and trusts the disk):

- writes are crash-safe: bytes land in a same-directory temp file,
  are fsynced, and become visible via one atomic rename — a crash
  mid-write can never leave a truncated version where readers find it
- every version carries a sha256 sidecar (``<file>.sum``), verified
  on read; a mismatch (bit rot, torn overwrite, injected corruption)
  raises :class:`CorruptionError` AND quarantines the bad version —
  it leaves the inventory, so the next periodic re-report tells the
  leader this replica no longer holds it and repair re-copies from a
  good replica. The bytes are kept under ``.corrupt`` for forensics.
- a seeded :class:`DiskFault` seam models failing writes (disk full)
  and corrupted reads for the chaos disk scenarios.
"""

from __future__ import annotations

import errno
import hashlib
import fnmatch
import os
import random
import re
import shutil
from typing import Dict, List, Optional, Tuple

from ...observability import METRICS

_VERSION_RE = re.compile(r"^(?P<name>.+)_version(?P<v>\d+)$")

_M_CORRUPT = METRICS.counter(
    "store_corruption_detected_total",
    "reads that failed checksum verification (bad replica quarantined)")
_M_WRITE_FAIL = METRICS.counter(
    "store_write_failures_total",
    "local writes that failed (disk full / injected write fault)")
# pre-touch: the corruption scenario must be observable at 0, not
# silently absent from `profile metrics` until the first hit
_M_CORRUPT.inc(0)


class CorruptionError(IOError):
    """A stored version's bytes no longer match their recorded
    checksum. The offending version has been quarantined."""


class DiskFault:
    """Seeded local-disk fault model (chaos disk scenarios).

    - ``write_fail_pct``: percent of writes that raise ``OSError
      (ENOSPC)`` — a full or dying disk. Nothing is written.
    - ``corrupt_pct``: percent of reads whose returned bytes are
      bit-flipped AFTER leaving the platter — a bad sector / rotted
      block. Checksum verification then detects and quarantines.

    Decisions come from a private ``random.Random(seed)`` so a chaos
    plan re-run makes the identical fail/corrupt choices. RNG state
    advances even while disabled, keeping the decision stream
    independent of when the fault was switched on.
    """

    def __init__(self, seed: int = 0, write_fail_pct: float = 0.0,
                 corrupt_pct: float = 0.0):
        for name, pct in (("write_fail_pct", write_fail_pct),
                          ("corrupt_pct", corrupt_pct)):
            if pct < 0 or pct > 100:
                raise ValueError(f"{name} {pct} out of range")
        self.write_fail_pct = write_fail_pct
        self.corrupt_pct = corrupt_pct
        self.enabled = True
        self._rng = random.Random(seed)

    def write_fails(self) -> bool:
        fail = self._rng.random() * 100.0 < self.write_fail_pct
        return fail and self.enabled

    def corrupts_read(self) -> bool:
        corrupt = self._rng.random() * 100.0 < self.corrupt_pct
        return corrupt and self.enabled


def _safe(name: str) -> str:
    """Logical SDFS name -> safe flat filename."""
    if not name or name in (".", ".."):
        raise ValueError(f"invalid sdfs name {name!r}")
    return name.replace("/", "__")


def _sha256(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


class LocalStore:
    def __init__(self, root: str, max_versions: int = 5, cleanup_on_startup: bool = False):
        self.root = os.path.abspath(os.path.expanduser(root))
        self.max_versions = max_versions
        if cleanup_on_startup and os.path.isdir(self.root):
            shutil.rmtree(self.root)
        os.makedirs(self.root, exist_ok=True)
        # name -> sorted list of versions (reference
        # load_files_from_directory, file_service.py:23-33)
        self._files: Dict[str, List[int]] = {}
        # fault-injection seam: failing writes / corrupted reads
        # (the chaos engine installs one; None = healthy disk)
        self.fault: Optional[DiskFault] = None
        self.corruption_detected = 0
        self.reload()

    # ---- inventory ----

    def reload(self) -> None:
        self._files.clear()
        for fn in os.listdir(self.root):
            m = _VERSION_RE.match(fn)
            if m:
                self._files.setdefault(m.group("name"), []).append(int(m.group("v")))
        for vs in self._files.values():
            vs.sort()

    def inventory(self) -> Dict[str, List[int]]:
        return {k: list(v) for k, v in sorted(self._files.items())}

    def has(self, name: str, version: Optional[int] = None) -> bool:
        vs = self._files.get(_safe(name))
        if not vs:
            return False
        return version is None or version in vs

    def versions(self, name: str) -> List[int]:
        return list(self._files.get(_safe(name), []))

    def matching(self, pattern: str) -> List[str]:
        return sorted(n for n in self._files if fnmatch.fnmatch(n, _safe(pattern)))

    # ---- storage ----

    def _path(self, name: str, version: int) -> str:
        return os.path.join(self.root, f"{name}_version{version}")

    def _sum_path(self, name: str, version: int) -> str:
        return self._path(name, version) + ".sum"

    def next_version(self, name: str) -> int:
        vs = self._files.get(_safe(name))
        return (vs[-1] + 1) if vs else 1

    def _write_atomic(self, path: str, data: bytes) -> None:
        """Same-directory temp file + fsync + atomic rename: a crash
        at ANY point leaves either the old content or the new —
        never a visible truncated write."""
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    def put_bytes(self, name: str, data: bytes, version: Optional[int] = None) -> int:
        """Store one version; prune to max_versions (reference
        file_service.py:80-84 keeps the 5 newest)."""
        name = _safe(name)
        v = version if version is not None else self.next_version(name)
        if self.fault is not None and self.fault.write_fails():
            _M_WRITE_FAIL.inc()
            raise OSError(errno.ENOSPC, "injected write fault (DiskFault)",
                          self._path(name, v))
        # checksum sidecar BEFORE the data rename: the data file only
        # becomes visible once its checksum is already durable, so a
        # crash between the two leaves (at worst) an orphan .sum, not
        # an unverifiable version
        self._write_atomic(self._sum_path(name, v), _sha256(data).encode())
        self._write_atomic(self._path(name, v), data)
        vs = self._files.setdefault(name, [])
        if v not in vs:
            vs.append(v)
            vs.sort()
        self._prune(name)
        return v

    def put_file(self, name: str, src_path: str, version: Optional[int] = None) -> int:
        with open(src_path, "rb") as f:
            return self.put_bytes(name, f.read(), version)

    def _read_verified(self, name: str, v: int) -> bytes:
        """Read one version's bytes, apply the read-fault seam, verify
        against the checksum sidecar. Mismatch -> quarantine + raise."""
        with open(self._path(name, v), "rb") as f:
            data = f.read()
        if self.fault is not None and self.fault.corrupts_read():
            # a rotted block: flip a bit in whatever came off the disk
            data = bytes([data[0] ^ 0x40]) + data[1:] if data else b"\x40"
        try:
            with open(self._sum_path(name, v), "rb") as f:
                want = f.read().decode().strip()
        except FileNotFoundError:
            return data  # pre-checksum version (legacy): unverifiable
        if _sha256(data) != want:
            self.quarantine(name, v)
            raise CorruptionError(
                f"{name} version {v}: checksum mismatch (quarantined)"
            )
        return data

    def quarantine(self, name: str, version: int) -> None:
        """Evict a corrupt version from the inventory: the periodic
        inventory re-report stops listing it, the leader drops this
        replica from the file's holder set, and the repair sweep
        re-copies from a good replica. Bytes move aside (not deleted)
        for forensics."""
        name = _safe(name)
        self.corruption_detected += 1
        _M_CORRUPT.inc()
        vs = self._files.get(name, [])
        if version in vs:
            vs.remove(version)
            if not vs:
                self._files.pop(name, None)
        for p in (self._path(name, version), self._sum_path(name, version)):
            try:
                os.replace(p, p + ".corrupt")
            except FileNotFoundError:
                pass

    def get_bytes(self, name: str, version: Optional[int] = None) -> Tuple[bytes, int]:
        """Latest (or specific) version's content, checksum-verified."""
        name = _safe(name)
        vs = self._files.get(name)
        if not vs:
            raise FileNotFoundError(name)
        v = vs[-1] if version is None else version
        if v not in vs:
            raise FileNotFoundError(f"{name} version {v}")
        return self._read_verified(name, v), v

    def get_path(self, name: str, version: Optional[int] = None) -> str:
        name = _safe(name)
        vs = self._files.get(name)
        if not vs:
            raise FileNotFoundError(name)
        v = vs[-1] if version is None else version
        if v not in vs:
            raise FileNotFoundError(f"{name} version {v}")
        return self._path(name, v)

    def last_versions(self, name: str, count: int) -> List[Tuple[int, bytes]]:
        """The `get-versions` verb: newest `count` versions, newest
        first (reference worker.py:1834-1878). Corrupt versions are
        quarantined and skipped."""
        name = _safe(name)
        out = []
        for v in reversed(self._files.get(name, [])[-count:]):
            try:
                out.append((v, self._read_verified(name, v)))
            except CorruptionError:
                continue
        return out

    def delete(self, name: str) -> bool:
        """Remove all versions (reference file_service.py:100-111)."""
        name = _safe(name)
        vs = self._files.pop(name, None)
        if not vs:
            return False
        for v in vs:
            for p in (self._path(name, v), self._sum_path(name, v)):
                try:
                    os.remove(p)
                except FileNotFoundError:
                    pass
        return True

    def _prune(self, name: str) -> None:
        vs = self._files.get(name, [])
        while len(vs) > self.max_versions:
            v = vs.pop(0)
            for p in (self._path(name, v), self._sum_path(name, v)):
                try:
                    os.remove(p)
                except FileNotFoundError:
                    pass

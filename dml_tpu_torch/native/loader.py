"""ctypes wrapper for the port's native batch JPEG loader
(`dml_tpu_torch/native/dataloader.cpp`): the counterpart of
dml_tpu/native/loader.py.

The library is built with g++ at first use into `dml_tpu_torch/_build/`
(git-ignored), under a file name keyed by a hash of the source, the
compiler and the flags; the build writes to a temporary path and renames
it into place, so concurrent processes never load half a file. The
flags are the JAX package's (`-O3 -march=native`): without
`-march=native`, g++ forms no fused multiply-adds in the bilinear
resize and a few pixels round the other way, so the two packages would
no longer decode a batch to the same bytes.

The loader is the fast path of `models.preprocess.load_images` for
all-JPEG batches. When no compiler or libjpeg is at hand the build fails,
`native_available()` is False, `build_error()` says why, and
`load_images` decodes with PIL, the JAX package's own fallback.
`DML_NATIVE_LOADER=0` forces PIL. Nothing is built or loaded at import
time.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from typing import Optional, Sequence

import numpy as np

log = logging.getLogger(__name__)

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "dataloader.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build")
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-shared")
LINK_FLAGS = ("-ljpeg", "-lpthread")

_lock = threading.Lock()
_loader: Optional["NativeLoader"] = None
_error: Optional[str] = None  # why the library could not be built or loaded


def _cxx() -> str:
    return os.environ.get("CXX", "g++")


def library_path() -> str:
    """Where the library for this source, compiler and flag set lives."""
    h = hashlib.sha256(" ".join((_cxx(), *CXX_FLAGS, *LINK_FLAGS)).encode())
    with open(_SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libdmlloader-{h.hexdigest()[:16]}.so")


def _build(so: str) -> None:
    """Compile the loader into `so`; raises RuntimeError with the
    compiler's message on failure."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [_cxx(), *CXX_FLAGS, "-o", tmp, _SRC, *LINK_FLAGS]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"{' '.join(cmd)}: {e}") from e
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise RuntimeError(f"{' '.join(cmd)} failed ({proc.returncode}): {proc.stderr[-2000:]}")
    os.replace(tmp, so)


class NativeLoader:
    """The loaded library. `decode_batch` decodes JPEG files into one
    uint8 (N, H, W, 3) array."""

    def __init__(self, lib_path: str):
        self._lib = ctypes.CDLL(lib_path)
        self._lib.dml_decode_batch.restype = ctypes.c_int
        self._lib.dml_decode_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
            ctypes.c_char_p, ctypes.c_int,
        ]
        self._lib.dml_loader_version.restype = ctypes.c_int
        if self._lib.dml_loader_version() < 1:
            raise RuntimeError(f"{lib_path}: loader version {self._lib.dml_loader_version()}")

    def decode_batch(self, paths: Sequence[str], size) -> np.ndarray:
        """JPEG files -> uint8 (N, H, W, 3), one thread per host core.
        Raises RuntimeError with the first file's error on failure (a
        file cut inside its header, say)."""
        n = len(paths)
        h, w = int(size[0]), int(size[1])
        out = np.empty((n, h, w, 3), np.uint8)
        if n == 0:
            return out
        arr = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
        errbuf = ctypes.create_string_buffer(512)
        rc = self._lib.dml_decode_batch(
            arr, n, h, w, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            0, errbuf, len(errbuf),
        )
        if rc != 0:
            raise RuntimeError(f"native decode failed: {errbuf.value.decode(errors='replace')}")
        return out


def get_loader() -> Optional[NativeLoader]:
    """The process-wide loader, built at the first call; None when
    `DML_NATIVE_LOADER=0` or when it cannot be built or loaded (then
    `build_error()` says why, and the call is not repeated)."""
    global _loader, _error
    if os.environ.get("DML_NATIVE_LOADER", "1") == "0":
        return None
    if _loader is not None or _error is not None:
        return _loader
    with _lock:
        if _loader is None and _error is None:
            try:
                so = library_path()
                if not os.path.exists(so):
                    _build(so)
                _loader = NativeLoader(so)
            except Exception as e:  # no g++, no libjpeg: PIL decodes instead
                _error = str(e)
                log.info("native JPEG loader unavailable, PIL decodes: %s", _error)
    return _loader


def native_available() -> bool:
    return get_loader() is not None


def build_error() -> Optional[str]:
    """Why the library could not be built or loaded, or None."""
    return _error

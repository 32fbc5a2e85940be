"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each library is compiled at first use from `dml_tpu_torch/csrc/` into
`dml_tpu_torch/_build/` (listed in .gitignore), under a file name keyed
by a hash of its sources, the headers under csrc/ and the flags, so an
edited source or header rebuilds and an unchanged one loads the existing
build. Nothing here runs at import time; a build or load failure raises
and is never papered over.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Sequence

CSRC_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "_build")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers and spills of every kernel, kept beside the build
)

_lock = threading.Lock()  # guards the two dicts below
_name_locks: Dict[str, threading.Lock] = {}
_loaded: Dict[str, ctypes.CDLL] = {}


def _find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc:
        return nvcc
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    nvcc = os.path.join(home, "bin", "nvcc")
    if os.path.exists(nvcc):
        return nvcc
    raise RuntimeError("nvcc not found (searched PATH and CUDA_HOME)")


def _digest(paths: Sequence[str]) -> str:
    """Hash of the flags, the sources `paths` and every header (*.cuh)
    under CSRC_DIR: a source may include any of them."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh")))
    for p in [*paths, *headers]:
        with open(p, "rb") as f:
            h.update(os.path.basename(p).encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def _library_path(name: str, sources: Sequence[str]) -> str:
    paths = [os.path.join(CSRC_DIR, s) for s in sources]
    return os.path.join(BUILD_DIR, f"lib{name}-{_digest(paths)}.so")


def ptxas_report(name: str, sources: Sequence[str]) -> str:
    """What ptxas said of each kernel (registers, shared memory, spills)
    when lib<name>.so was built from `sources`: the build's `-Xptxas -v`
    output, kept beside the library. Raises if that build is not there."""
    with open(_library_path(name, sources) + ".ptxas") as f:
        return f.read()


def load_library(name: str, sources: Sequence[str]) -> ctypes.CDLL:
    """Compile `sources` (file names under csrc/) into lib<name>.so and
    load it. Thread-safe, one build per library per process at most;
    different libraries build in parallel from different threads."""
    with _lock:
        name_lock = _name_locks.setdefault(name, threading.Lock())
    with name_lock:
        lib = _loaded.get(name)
        if lib is not None:
            return lib
        paths = [os.path.join(CSRC_DIR, s) for s in sources]
        so = _library_path(name, sources)
        if not os.path.exists(so):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{so}.{os.getpid()}.tmp"
            cmd = [_find_nvcc(), *NVCC_FLAGS, "-o", tmp, *paths]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed building {name} ({proc.returncode}):\n"
                    f"{' '.join(cmd)}\n{proc.stderr[-4000:]}"
                )
            with open(f"{tmp}.ptxas", "w") as f:
                f.write(proc.stderr)
            os.replace(f"{tmp}.ptxas", f"{so}.ptxas")  # before the library: one that exists has its report
            os.replace(tmp, so)  # atomic: a concurrent loader never sees half a file
        lib = ctypes.CDLL(so)
        with _lock:
            _loaded[name] = lib
        return lib

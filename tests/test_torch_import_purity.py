"""The port stands alone: no module of dml_tpu_torch, nor chip_smoke.py,
imports jax, flax, msgpack or the JAX package; triton and the CUDA
library load only inside the functions that launch a kernel.

Kept to three test functions or fewer: pytest-xdist's loadfile scheduler
orders files by their test count, so a small count runs the port's files
last, after the cluster simulations that share fixed UDP ports.
"""

import ast
import os

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "msgpack", "dml_tpu")
NATIVE_LOADS = ("ctypes.CDLL", "CDLL", "load_library", "_library")


def _port_files():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, dirnames, filenames in os.walk(os.path.join(ROOT, "dml_tpu_torch")):
        dirnames[:] = sorted(d for d in dirnames if d not in ("__pycache__", "_build"))
        out += [os.path.join(dirpath, f) for f in sorted(filenames) if f.endswith(".py")]
    return out


def _imported_modules(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield node, a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node, node.module


class _ImportTimeCalls(ast.NodeVisitor):
    """Collects triton imports and native-library loads that run when the
    module is imported, i.e. outside any function body."""

    def __init__(self):
        self.depth = 0
        self.found = []

    def visit_FunctionDef(self, node):
        self.depth += 1
        self.generic_visit(node)
        self.depth -= 1

    visit_AsyncFunctionDef = visit_Lambda = visit_FunctionDef

    def visit_Import(self, node):
        if not self.depth and any(a.name.split(".")[0] == "triton" for a in node.names):
            self.found.append(f"line {node.lineno}: import triton")

    def visit_ImportFrom(self, node):
        if not self.depth and (node.module or "").split(".")[0] == "triton":
            self.found.append(f"line {node.lineno}: from triton")

    def visit_Call(self, node):
        if not self.depth and ast.unparse(node.func) in NATIVE_LOADS:
            self.found.append(f"line {node.lineno}: {ast.unparse(node.func)}(...)")
        self.generic_visit(node)


def _parse(path):
    with open(path, encoding="utf-8") as f:
        return ast.parse(f.read(), filename=path)


def test_no_jax_import():
    rel = {os.path.relpath(p, ROOT) for p in _port_files()}
    assert {"chip_smoke.py", "dml_tpu_torch/ops/preprocess.py",
            "dml_tpu_torch/inference/engine.py", "dml_tpu_torch/models/resnet.py",
            "dml_tpu_torch/ops/flash_attention.py", "dml_tpu_torch/ops/decode_attention.py",
            "dml_tpu_torch/models/transformer.py", "dml_tpu_torch/models/lm_params.py",
            "dml_tpu_torch/inference/quantize.py", "dml_tpu_torch/inference/generate.py",
            "dml_tpu_torch/parallel/long_context.py", "dml_tpu_torch/parallel/checkpoint.py",
            "dml_tpu_torch/native/loader.py", "dml_tpu_torch/observability.py",
            "dml_tpu_torch/config.py", "dml_tpu_torch/inference/lm_server.py",
            "dml_tpu_torch/inference/kv_cache.py", "dml_tpu_torch/inference/lm_backend.py",
            "dml_tpu_torch/models/params_io.py", "dml_tpu_torch/parallel/ring_attention.py",
            "dml_tpu_torch/parallel/ulysses.py", "dml_tpu_torch/parallel/moe.py",
            "dml_tpu_torch/parallel/mesh.py", "dml_tpu_torch/parallel/pipeline.py",
            "dml_tpu_torch/inference/lm_sharded.py"} <= rel
    bad = [
        f"{os.path.relpath(path, ROOT)}:{node.lineno}: {name}"
        for path in _port_files()
        for node, name in _imported_modules(_parse(path))
        if name.split(".")[0] in FORBIDDEN
    ]
    assert not bad, f"the port imports the JAX side: {bad}"


def test_kernel_toolchain_loads_lazily():
    found = []
    for path in _port_files():
        v = _ImportTimeCalls()
        v.visit(_parse(path))
        found += [f"{os.path.relpath(path, ROOT)} {f}" for f in v.found]
    assert not found, f"at import time: {found}"


def test_importing_the_port_loads_no_kernel_library():
    import subprocess
    import sys

    code = (
        "import sys; before = set(sys.modules); "
        "import chip_smoke, dml_tpu_torch.inference, dml_tpu_torch.ops._build as b; "
        "import dml_tpu_torch.inference.generate, dml_tpu_torch.models.transformer; "
        "import dml_tpu_torch.parallel.long_context, dml_tpu_torch.native.loader as nl; "
        "import dml_tpu_torch.parallel.ring_attention, dml_tpu_torch.parallel.ulysses; "
        "import dml_tpu_torch.inference.lm_backend, dml_tpu_torch.inference.kv_cache; "
        "import dml_tpu_torch.models.params_io, dml_tpu_torch.config; "
        "import dml_tpu_torch.parallel.pipeline, dml_tpu_torch.inference.lm_sharded; "
        "assert nl._loader is None and nl._error is None; "
        "assert not b._loaded, b._loaded; "
        "bad = [m for m in set(sys.modules) - before "
        "if m.split('.')[0] in ('jax', 'flax', 'msgpack', 'dml_tpu', 'triton')]; "
        "assert not bad, bad"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]

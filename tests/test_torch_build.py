"""The port's kernel build, on the CPU: its cache key covers the headers
the CUDA sources include, so an edited header rebuilds every library
that includes it. No nvcc is needed."""

import os
import re

from dml_tpu_torch.ops import _build


def test_digest_changes_with_a_header_and_nothing_else(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "CSRC_DIR", str(tmp_path))
    src, hdr = tmp_path / "kernel.cu", tmp_path / "shared.cuh"
    src.write_text('#include "shared.cuh"\n')
    hdr.write_text("// v1\n")
    first = _build._digest([str(src)])
    assert _build._digest([str(src)]) == first
    hdr.write_text("// v2\n")
    assert _build._digest([str(src)]) != first
    hdr.write_text("// v1\n")
    assert _build._digest([str(src)]) == first
    (tmp_path / "notes.txt").write_text("not a header\n")
    assert _build._digest([str(src)]) == first
    (tmp_path / "new.cuh").write_text("// another header\n")
    assert _build._digest([str(src)]) != first


def test_every_included_header_lies_in_csrc():
    # the digest hashes csrc/*.cuh: a quoted include from elsewhere would
    # escape it
    sources = [f for f in os.listdir(_build.CSRC_DIR) if f.endswith((".cu", ".cuh"))]
    included = set()
    for name in sources:
        with open(os.path.join(_build.CSRC_DIR, name)) as f:
            included.update(re.findall(r'^#include "([^"]+)"', f.read(), flags=re.M))
    assert "hopper.cuh" in included
    for inc in included:
        assert inc.endswith(".cuh") and os.path.exists(os.path.join(_build.CSRC_DIR, inc)), inc

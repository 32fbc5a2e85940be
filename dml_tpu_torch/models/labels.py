"""ImageNet class labels + top-k decoding.

Replaces keras decode_predictions (reference models.py:38, 63). The
label table is loaded from a local `imagenet_class_index.json` when one
exists (keras cache, or a path given explicitly); in hermetic
environments a synthetic table (`wnid_i` / `class_i`) keeps the output
format identical so downstream result merging works unchanged.
"""

from __future__ import annotations

import functools
import json
import os
from typing import Dict, List, Sequence, Tuple

import numpy as np

_SEARCH_PATHS = (
    "~/.keras/models/imagenet_class_index.json",
    "~/.dml_tpu/imagenet_class_index.json",
)


_OVERRIDE_PATH: str | None = None


def set_class_index_path(path: str | None) -> None:
    """Pin the process-wide label table to a specific file — used by
    tools that locate the class index outside the default search set
    (e.g. a TF-downloaded copy) so the engine's decode_predictions
    reads the same table. None restores the default search."""
    global _OVERRIDE_PATH
    _OVERRIDE_PATH = path
    class_index.cache_clear()


@functools.lru_cache(maxsize=1)
def class_index(path: str | None = None) -> Dict[int, Tuple[str, str]]:
    if path:
        candidates = [path]
    elif _OVERRIDE_PATH:
        candidates = [_OVERRIDE_PATH]
    else:
        candidates = [os.path.expanduser(p) for p in _SEARCH_PATHS]
        env_dir = os.environ.get("DML_TPU_KERAS_WEIGHTS_DIR")
        if env_dir:
            # next to the dropped-in weight files (the TF-free parity
            # flow: one directory holds the .h5s and the class index)
            candidates.insert(
                0, os.path.join(env_dir, "imagenet_class_index.json")
            )
    for p in candidates:
        if p and os.path.exists(p):
            with open(p) as f:
                raw = json.load(f)
            return {int(k): (v[0], v[1]) for k, v in raw.items()}
    return {i: (f"wnid_{i:04d}", f"class_{i:04d}") for i in range(1000)}


def decode_predictions(
    probs: np.ndarray, top: int = 5, path: str | None = None
) -> List[List[Tuple[str, str, float]]]:
    """(N, 1000) probabilities -> per image top-k
    [(wnid, label, score), ...], matching keras decode_predictions."""
    table = class_index(path)
    probs = np.asarray(probs)
    out = []
    for row in probs:
        idx = np.argsort(row)[::-1][:top]
        out.append([(table[int(i)][0], table[int(i)][1], float(row[i])) for i in idx])
    return out


def top1_labels(probs: np.ndarray, path: str | None = None) -> List[str]:
    return [d[0][1] for d in decode_predictions(probs, top=1, path=path)]

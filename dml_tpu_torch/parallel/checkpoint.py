"""Training checkpoint/resume: PyTorch counterpart of
dml_tpu/parallel/checkpoint.py.

Same contract as the JAX package's `CheckpointManager`: one directory
of step-indexed blobs plus `manifest.json` (`{"steps": [...]}`); `keep`
bounds the retained checkpoints, the oldest evicted first; writes are
atomic (tmp file + `os.replace`), so a crash mid-save never corrupts the
latest good checkpoint; `restore(like, step=None)` loads the latest or a
pinned step and raises FileNotFoundError when there is none.

The blob is the port's own format, not flax msgpack: `step_<N>.pt`,
written by `torch.save` from CPU copies of the state's tensors and read
back with `weights_only=True` (tensors, numbers, strings and nested
dicts/lists only; nothing is unpickled that could run code). Weights
cross from the JAX package through numpy (`models.lm_params`), not
through these files.
"""

from __future__ import annotations

import json
import os
from typing import Any, List, Optional

import numpy as np
import torch


def _to_cpu(tree: Any) -> Any:
    """Tensors (and numpy arrays) to detached CPU tensors; dicts, lists
    and tuples recursively; numbers and strings as they are."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(np.array(tree))
    if isinstance(tree, np.generic):
        return tree.item()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


def _like(loaded: Any, like: Any, path: str = "") -> Any:
    """`loaded` checked against `like`'s structure (the same dict keys at
    every level), tensor leaves moved to the device of `like`'s."""
    if isinstance(like, dict):
        if not isinstance(loaded, dict) or set(loaded) != set(like):
            got = sorted(loaded) if isinstance(loaded, dict) else type(loaded).__name__
            raise KeyError(f"checkpoint{path} holds {got}, expected {sorted(like)}")
        return {k: _like(loaded[k], like[k], f"{path}/{k}") for k in like}
    if isinstance(like, torch.Tensor) and isinstance(loaded, torch.Tensor):
        return loaded.to(like.device)
    return loaded


class CheckpointManager:
    """Step-indexed checkpoints in one directory.

    >>> mgr = CheckpointManager(dir, keep=3)
    >>> mgr.save(step=100, state)
    >>> state = mgr.restore(like=template)          # latest
    >>> state = mgr.restore(like=template, step=50) # pinned
    """

    def __init__(self, directory: str, keep: int = 3):
        self.dir = os.path.abspath(os.path.expanduser(directory))
        self.keep = keep
        os.makedirs(self.dir, exist_ok=True)

    # ---- manifest ----

    def _manifest_path(self) -> str:
        return os.path.join(self.dir, "manifest.json")

    def steps(self) -> List[int]:
        try:
            with open(self._manifest_path()) as f:
                return sorted(json.load(f)["steps"])
        except (OSError, ValueError, KeyError):
            return []

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def _write_manifest(self, steps: List[int]) -> None:
        tmp = self._manifest_path() + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"steps": sorted(steps)}, f)
        os.replace(tmp, self._manifest_path())

    def blob_path(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step}.pt")

    # ---- save / restore ----

    def save(self, step: int, state: Any) -> str:
        """Atomic write + manifest update + retention sweep."""
        path = self.blob_path(step)
        tmp = path + ".tmp"
        torch.save(_to_cpu(state), tmp)
        os.replace(tmp, path)
        steps = sorted({*self.steps(), step})
        evicted, steps = steps[: -self.keep], steps[-self.keep :]
        self._write_manifest(steps)
        for s in evicted:
            try:
                os.unlink(self.blob_path(s))
            except FileNotFoundError:
                pass
        return path

    def restore(self, like: Any, step: Optional[int] = None) -> Any:
        """Load a checkpoint (the latest, or `step`) into `like`'s
        structure: the loaded tree must have `like`'s dict keys at every
        level, and its tensors land on the devices of `like`'s."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        state = torch.load(self.blob_path(step), map_location="cpu", weights_only=True)
        return _like(state, like)

"""The inference engine on an NVIDIA GPU.

PyTorch counterpart of dml_tpu/inference/engine.py, with the same public
API and semantics: every loaded model resident on the device, batches
padded to one fixed size per model, a bounded window of forwards in
flight, cost-model constants measured at warmup.

The forward is `ops.preprocess.normalize(batch_u8, spec.preprocess,
dtype)` followed by the model. On a CUDA tensor that normalize launches
the hand-written Hopper kernel (dml_tpu_torch/csrc/normalize.cu; the
"raw" mode of EfficientNet, which normalizes in its graph, is a cast);
ViT's attention launches the flash kernel (csrc/flash_attention.cu);
the convolutions, BN, LayerNorm, pooling and the dense layers are
PyTorch calls, run in channels-last memory.

PyTorch launches asynchronously, as JAX dispatches: `_dispatch_chunk`
enqueues the host->device copy (from pinned memory) and the forward and
returns at once; only the readback to numpy blocks. So the windowed
`infer_arrays` and the enqueue-then-drain `infer_arrays_nowait` overlap
chunk k+1's copy and forward with chunk k's readback as the JAX engine
does.

The engine runs on `cuda` unless the caller passes another device
(`device="cpu"` runs the plain PyTorch versions, as the tests do). With
no CUDA device it raises; it never falls back to the CPU on its own.
"""

from __future__ import annotations

import asyncio
import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from ..models.labels import decode_predictions
from ..models.params_io import from_flax_variables, init_variables
from ..models.preprocess import load_images
from ..models.registry import ModelSpec, get_model
from ..ops.preprocess import normalize


@dataclass
class InferenceResult:
    """Per-batch result (reference writes output_<job>_<batch>_<host>.json
    with top-5 labels per file, models.py:109-126)."""

    model: str
    files: List[str]
    top5: List[List[tuple]]  # per image: [(wnid, label, score) x5]
    load_time: float  # host decode+resize seconds
    infer_time: float  # device seconds (incl. padding waste)
    batch_padded_to: int

    def to_json_dict(self) -> Dict[str, Any]:
        return {
            f: [
                {"wnid": w, "label": l, "score": s}
                for (w, l, s) in t
            ]
            for f, t in zip(self.files, self.top5)
        }


@dataclass
class _LoadedModel:
    spec: ModelSpec
    module: nn.Module  # weights resident on the engine's device
    batch_size: int
    num_classes: int
    seed: int = 0
    load_time: float = 0.0
    first_query: float = 0.0
    per_query: float = 0.0
    explicit_weights: bool = False  # loaded from a checkpoint/the store


class InferenceEngine:
    """Holds every loaded model resident on the device; serves batches.

    `dtype` is the compute precision of the convolutions (bfloat16 by
    default); BN statistics and the classifier head stay float32.
    """

    def __init__(
        self,
        dtype: torch.dtype = torch.bfloat16,
        device: Union[str, torch.device, None] = None,
    ):
        self.device = torch.device("cuda" if device is None else device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "InferenceEngine: no CUDA device is available; pass "
                "device='cpu' to run the plain PyTorch path"
            )
        self.dtype = dtype
        self._models: Dict[str, _LoadedModel] = {}
        # models evicted while serving EXPLICIT weights: a later lazy
        # load must not silently fall back to random init
        self._evicted_explicit: set = set()
        self._reshape_lock = threading.Lock()
        # measured dispatch-mode choice per round composition:
        # key -> (mode, measured_at) — see choose_dispatch_mode
        self._dispatch_mode: Dict[tuple, Tuple[str, float]] = {}

    # ---- loading ----

    def load_model(
        self,
        name: str,
        variables: Any = None,
        batch_size: Optional[int] = None,
        seed: int = 0,
        warmup: bool = True,
    ) -> _LoadedModel:
        """Build the model, place its weights on the device, warm up.

        `variables` is either a PyTorch state_dict of the model or the
        JAX package's layout (nested {'params', 'batch_stats'} tree or a
        flat 'a/b/c' fixture dict), converted by
        `params_io.from_flax_variables`; default is deterministic init.
        """
        spec = get_model(name)
        key = spec.name
        if key in self._models:
            cached = self._models[key]
            if (
                variables is None
                and seed == cached.seed
                and batch_size in (None, cached.batch_size)
            ):
                return cached
            # explicit new weights or batch size: rebuild, don't silently
            # serve the stale entry — but a reload without an explicit
            # batch size keeps the serving one (a C3 set_batch_size must
            # survive a weight rollout), and a reshape/reseed reload of
            # a model serving EXPLICIT weights keeps those weights (a
            # silent fall-through to random init would serve garbage)
            if batch_size is None:
                batch_size = cached.batch_size
            if variables is None and cached.explicit_weights:
                variables = cached.module.state_dict()
            del self._models[key]
        t0 = time.monotonic()
        explicit = variables is not None
        if variables is None:
            if key in self._evicted_explicit:
                raise RuntimeError(
                    f"{key} was evicted while serving explicit weights; "
                    "reload them (load-model) — refusing to silently "
                    "serve random init"
                )
            state = init_variables(spec, seed=seed)
        else:
            self._evicted_explicit.discard(key)
            flax_layout = "params" in variables or any("/" in k for k in variables)
            state = from_flax_variables(variables) if flax_layout else variables
        # the classifier width comes from the weights, as in the JAX engine
        # ("predictions" is the Keras-parity name on the CNN families,
        # "head" on ViT)
        head = state.get("predictions.bias", state.get("head.bias"))
        if head is None:
            raise ValueError(
                f"{spec.name}: cannot find classifier head 'predictions.bias' or "
                f"'head.bias' in the weights (keys: {sorted(state)[:8]}...)"
            )
        num_classes = int(head.shape[-1])
        module = spec.build(dtype=self.dtype, num_classes=num_classes)
        module.load_state_dict(state)  # strict: names any missing/extra key
        module = module.to(self.device, memory_format=torch.channels_last).eval()
        lm = _LoadedModel(
            spec=spec,
            module=module,
            batch_size=batch_size or spec.cost.default_batch_size,
            num_classes=num_classes,
            seed=seed,
            explicit_weights=explicit,
        )
        lm.load_time = time.monotonic() - t0
        self._models[key] = lm
        if warmup:
            self._warmup(lm)
        return lm

    def _forward(self, lm: _LoadedModel, batch_u8: torch.Tensor) -> torch.Tensor:
        """uint8 NHWC batch on the device -> float32 probs on the device."""
        with torch.inference_mode():
            x = normalize(batch_u8, lm.spec.preprocess, self.dtype)
            return lm.module(x)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _warmup(self, lm: _LoadedModel) -> None:
        """Run the forward at the configured batch size (cuDNN picks its
        algorithms on the first call) and measure the cost model's
        constants on the device."""
        dummy = torch.zeros(
            (lm.batch_size, *lm.spec.input_size, 3), dtype=torch.uint8,
            device=self.device,
        )
        self._sync()
        t0 = time.monotonic()
        self._forward(lm, dummy)
        self._sync()
        lm.first_query = time.monotonic() - t0
        t0 = time.monotonic()
        self._forward(lm, dummy)
        self._sync()
        steady_batch = time.monotonic() - t0
        lm.per_query = steady_batch / lm.batch_size

    def unload_model(self, name: str) -> bool:
        """Evict a model's weights from the device. Returns True if it
        was resident."""
        key = get_model(name).name
        lm = self._models.pop(key, None)
        if lm is not None and lm.explicit_weights:
            self._evicted_explicit.add(key)
        return lm is not None

    def evicted_with_explicit_weights(self, name: str) -> bool:
        """True when `name` was unloaded while serving explicit weights
        (a lazy load would refuse; callers should refetch instead)."""
        return get_model(name).name in self._evicted_explicit

    def memory_stats(self) -> Dict[str, Dict[str, float]]:
        """Per-resident-model weight footprint (device bytes of the
        module's parameters and buffers)."""
        out: Dict[str, Dict[str, float]] = {}
        for key, lm in self._models.items():
            n_bytes = sum(
                t.numel() * t.element_size() for t in lm.module.state_dict().values()
            )
            out[key] = {
                "param_mb": round(n_bytes / 1e6, 2),
                "batch_size": lm.batch_size,
            }
        return out

    def set_batch_size(self, name: str, batch_size: int) -> None:
        """C3 verb (reference SET_BATCH_SIZE, worker.py:1028-1037). Warms
        up at the new shape. No-op at the current size; the lock makes
        that check-and-warmup atomic (co-located services sharing one
        engine all fan the same C3 to it within milliseconds)."""
        with self._reshape_lock:
            lm = self._require(name)
            if lm.batch_size == batch_size:
                return
            lm.batch_size = batch_size
            self._warmup(lm)

    def cost_constants(self, name: str) -> Dict[str, float]:
        lm = self._require(name)
        return {
            "load_time": lm.load_time,
            "first_query": lm.first_query,
            "per_query": lm.per_query,
            "batch_size": lm.batch_size,
        }

    def _require(self, name: str) -> _LoadedModel:
        key = get_model(name).name
        if key not in self._models:
            raise KeyError(f"model {key} not loaded")
        return self._models[key]

    # ---- serving ----

    def _dispatch_chunk(self, lm: _LoadedModel, chunk: np.ndarray,
                        bs: Optional[int] = None):
        """Pad one <=bs slice to the fixed batch size and enqueue its
        copy and forward (nothing blocks here). Returns (device probs,
        valid count). THE one pad/dispatch site shared by the sync and
        nowait paths. Callers slicing a whole input at a snapshot of
        lm.batch_size MUST pass that snapshot: a concurrent C3 reshape
        shrinking lm.batch_size mid-drain would otherwise make pad
        negative on the already-sliced chunks."""
        if bs is None:
            bs = lm.batch_size
        pad = bs - chunk.shape[0]
        if pad:
            chunk = np.concatenate(
                [chunk, np.zeros((pad, *chunk.shape[1:]), np.uint8)]
            )
        batch = torch.from_numpy(np.ascontiguousarray(chunk))
        if self.device.type == "cuda":
            # pinned source: the copy is asynchronous and does not wait
            # for the forwards already queued on the stream
            batch = batch.pin_memory().to(self.device, non_blocking=True)
        probs = self._forward(lm, batch)
        return probs, bs - pad

    @staticmethod
    def _readback(probs: torch.Tensor, valid: int) -> np.ndarray:
        return probs[:valid].cpu().numpy()

    def infer_arrays(self, name: str, images_u8: np.ndarray) -> np.ndarray:
        """uint8 (N,H,W,3) -> float32 probs (N, classes). Pads N up to
        the fixed batch size.

        Forwards are enqueued ahead of the blocking readbacks, in a
        window bounded so device memory stays O(window), not O(n).
        """
        lm = self._require(name)
        n = images_u8.shape[0]
        if n == 0:
            return np.zeros((0, lm.num_classes), np.float32)
        bs = lm.batch_size
        window = 4
        pending: List[Any] = []
        out: List[np.ndarray] = []
        for start in range(0, n, bs):
            pending.append(
                self._dispatch_chunk(lm, images_u8[start : start + bs], bs)
            )
            if len(pending) >= window:
                out.append(self._readback(*pending.pop(0)))
        for probs, valid in pending:
            out.append(self._readback(probs, valid))
        return np.concatenate(out)[:n]

    def infer_arrays_nowait(self, name: str, images_u8: np.ndarray):
        """Enqueue the forward(s) for a batch WITHOUT blocking on the
        result; returns a zero-arg callable that blocks and returns the
        float32 probs (N, classes).

        A dispatcher playing several workers on one device enqueues
        every assignment of a scheduling round and then drains them in
        order. At most `window` chunks of THIS handle are in flight at
        once (the rest dispatch lazily as earlier ones drain inside
        result()); a drained handle drops its input and keeps only the
        result, and a re-read returns the same array."""
        lm = self._require(name)
        n = images_u8.shape[0]
        if n == 0:
            return lambda: np.zeros((0, lm.num_classes), np.float32)
        bs = lm.batch_size
        window = 4
        starts = list(range(0, n, bs))
        pending = [
            self._dispatch_chunk(lm, images_u8[s : s + bs], bs)
            for s in starts[:window]
        ]
        remaining = starts[window:]
        cached: List[np.ndarray] = []
        # mutable cell so the drain can DROP the input reference: a
        # long-lived handle must pin only the result, not the input
        src = [images_u8]

        def result() -> np.ndarray:
            if cached:  # handle re-read: same answer, no re-drain
                return cached[0]
            out: List[np.ndarray] = []
            nxt = 0
            while pending:
                out.append(self._readback(*pending.pop(0)))
                if nxt < len(remaining):
                    s = remaining[nxt]
                    pending.append(
                        self._dispatch_chunk(lm, src[0][s : s + bs], bs)
                    )
                    nxt += 1
            cached.append(np.concatenate(out)[:n])
            src.clear()
            remaining.clear()
            return cached[0]

        return result

    def choose_dispatch_mode(
        self,
        round_spec: Sequence[Tuple[str, np.ndarray]],
        rounds: int = 3,
        ttl_s: float = 600.0,
    ) -> str:
        """Measure sync vs pipelined dispatch for a SCHEDULING ROUND
        ([(model, sample_batch), ...], as the dispatcher will drive it)
        and return the faster mode ('sync' | 'pipelined'), cached per
        round composition for `ttl_s` seconds. `rounds` interleaved
        sync/pipelined repetitions, so drift biases neither mode."""
        import statistics

        key = tuple(
            (self._require(n).spec.name, tuple(np.shape(s)))
            for n, s in round_spec
        )
        hit = self._dispatch_mode.get(key)
        if hit is not None and time.monotonic() - hit[1] < ttl_s:
            return hit[0]
        # warm both paths at the exact shapes
        for n, s in round_spec:
            self.infer_arrays(n, s)
            self.infer_arrays_nowait(n, s)()
        t_sync: List[float] = []
        t_pipe: List[float] = []
        for _ in range(rounds):
            t0 = time.monotonic()
            for n, s in round_spec:
                self.infer_arrays(n, s)
            t_sync.append(time.monotonic() - t0)
            t0 = time.monotonic()
            for h in [
                self.infer_arrays_nowait(n, s) for n, s in round_spec
            ]:
                h()
            t_pipe.append(time.monotonic() - t0)
        mode = (
            "pipelined"
            if statistics.median(t_pipe) <= statistics.median(t_sync)
            else "sync"
        )
        self._dispatch_mode[key] = (mode, time.monotonic())
        return mode

    def infer_files(self, name: str, files: Sequence[str], top: int = 5) -> InferenceResult:
        """The reference's perform_inference(model, files) equivalent
        (models.py:74-91): decode on host, forward on the device, top-k."""
        lm = self._require(name)
        t0 = time.monotonic()
        imgs = load_images(files, lm.spec.input_size)
        load_time = time.monotonic() - t0
        t0 = time.monotonic()
        probs = self.infer_arrays(name, imgs)
        infer_time = time.monotonic() - t0
        return InferenceResult(
            model=lm.spec.name,
            files=[str(f) for f in files],
            top5=decode_predictions(probs, top=top),
            load_time=load_time,
            infer_time=infer_time,
            batch_padded_to=lm.batch_size,
        )

    async def infer_files_async(
        self, name: str, files: Sequence[str], top: int = 5
    ) -> InferenceResult:
        """Non-blocking wrapper for an event loop: host decode and the
        blocking device sync run in a thread."""
        return await asyncio.to_thread(self.infer_files, name, files, top)

    @property
    def loaded_models(self) -> List[str]:
        return sorted(self._models)

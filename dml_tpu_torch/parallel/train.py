"""Image-model training: PyTorch counterpart of
dml_tpu/parallel/train.py, on one device or over a dp x tp mesh.

The model zoo becomes trainable (fine-tuning a classifier before serving
it through the engine, say) with the JAX package's recipe and names:
`classification_metrics` (NLL on the softmax output and accuracy, the
one definition train and eval share), `warmup_cosine` (optax's
`warmup_cosine_decay_schedule`), `make_train_step` (with `grad_accum`
and `remat`) and `Trainer`.

What a step does, as the JAX step does it:
- the uint8 batch goes through `ops.preprocess.normalize_sharded`, so
  K1 (csrc/normalize.cu) launches once a step on a CUDA batch (on each
  rank, on its shard), and once an `evaluate`;
- the model runs in training mode: BatchNorm normalizes by the batch's
  statistics and moves its running statistics with Flax's rule
  (`models.layers.BatchNorm`); conv weights are float32 masters cast to
  the compute dtype at each call, so gradients and AdamW updates are
  float32;
- the loss and accuracy returned are those of the forward, before the
  update.

Over a mesh (`parallel.mesh.Mesh`, one process per rank), where GSPMD
places the JAX step's collectives, the port calls them itself:
- every rank is given the same global batch and takes its own rows:
  the dp index's block, or, with `grad_accum`, that block of each
  micro-batch (the rows JAX's step puts on the device); a
  `multihost.GlobalBatch` is already this rank's rows;
- BatchNorm's statistics are the global batch's (per-channel sums
  all-reduced over dp in the forward, and the sums its input gradient
  needs in the backward), as GSPMD computes them;
- parameters and their AdamW moments are held tp-sharded
  (`sharding.partition_params`: dim 0 over tp): each rank holds its
  piece. A step all-gathers the pieces over tp into the model's full
  weights, runs forward and backward on this rank's rows, sums the
  gradients over dp and divides by dp (one all-reduce of every gradient,
  flattened), hands each piece its slice, updates the pieces and drops
  the full weights. (ROADMAP A5 allows this gather-at-use form where
  GSPMD's per-layer collectives have no cheap torch form.) The running
  statistics are replicated: every rank computes the same;
- the loss and accuracy are the global batch's means (an all-reduce
  over dp);
- `state`, `params` and `export_variables` gather the full logical
  tensors on every rank (collectives: every rank of the mesh calls
  them), and the `state` setter takes full tensors and keeps this rank's
  pieces, so states and checkpoints have one layout whatever the mesh.
  A checkpoint is written by the mesh's first rank after every rank
  took part in the gather, and a barrier follows; a restore reads the
  full arrays on every rank and shards them onto the restoring mesh,
  which may be smaller than the saving one.

Differences from the JAX package, by design:
- PyTorch runs eagerly and updates the model and the optimizer in place:
  `make_train_step` returns a closure `(images, labels) -> metrics`, not
  a pure `(state, images, labels) -> (state, metrics)` function.
- The optimizer is `torch.optim.AdamW` with optax.adamw's
  hyperparameters (`adamw.make_adamw`). A learning-rate schedule (a
  function of the 0-based update count, `warmup_cosine`) sets the rate
  before each update, as optax evaluates it at the count.
- `state` is `{"params": {name: tensor}, "batch_stats": {name: tensor},
  "opt_state": {"count", "exp_avg", "exp_avg_sq"} by parameter name,
  "step": int}`; `models.params_io.image_train_state_from_flax`
  converts the JAX Trainer's state to it.

Entry points run on `cuda` unless `device` says otherwise, and raise
when there is no CUDA device; the tests pass `device="cpu"`.
"""

from __future__ import annotations

import math
import time
from contextlib import contextmanager, nullcontext
from typing import Any, Callable, Dict, Mapping, Optional, Union

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..models.layers import frozen_batch_stats, sum_batch_stats
from ..models.lm_params import resolve_device
from ..models.params_io import from_flax_variables, init_variables
from ..models.registry import get_model
from ..ops.preprocess import normalize_sharded
from .adamw import adam_count, adam_state, load_adam_state, make_adamw
from .checkpoint import CheckpointManager
from .mesh import Mesh, all_reduce, barrier, resolve_mesh
from .multihost import GlobalBatch
from .sharding import gather_tree, partition_params, shard, shard_dim

Schedule = Callable[[int], float]


def classification_metrics(probs: torch.Tensor, labels: torch.Tensor):
    """(nll, accuracy), 0-dim float32 tensors: NLL as -log(p + 1e-9) of
    the float32 softmax output at the label, accuracy by argmax."""
    logp = torch.log(probs.to(torch.float32) + 1e-9)
    nll = -logp.gather(1, labels[:, None].long()).mean()
    acc = (probs.argmax(-1) == labels).to(torch.float32).mean()
    return nll, acc


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  end_lr: float = 0.0) -> Schedule:
    """Linear warmup from 0 into a cosine decay to `end_lr`, as a
    function of the 0-based update count (the first update's rate is 0):
    optax's `warmup_cosine_decay_schedule(0, peak_lr, warmup_steps,
    max(total_steps, warmup_steps + 1), end_lr)`. Pass it as
    `Trainer(learning_rate=...)`."""
    decay_steps = max(total_steps, warmup_steps + 1) - warmup_steps
    alpha = 0.0 if peak_lr == 0.0 else end_lr / peak_lr

    def schedule(count: int) -> float:
        if count < warmup_steps:
            return peak_lr * count / warmup_steps
        t = min(count - warmup_steps, decay_steps)
        return peak_lr * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * t / decay_steps)) + alpha)

    return schedule


def make_train_step(
    model: nn.Module,
    preprocess_mode: str,
    optimizer: torch.optim.Optimizer,
    dtype: torch.dtype = torch.bfloat16,
    grad_accum: int = 1,
    remat: bool = False,
    mesh=None,
) -> Callable[[torch.Tensor, torch.Tensor], Dict[str, torch.Tensor]]:
    """The step: (uint8 images [B, H, W, 3], integer labels [B], both on
    the model's device) -> {"loss", "accuracy"} (0-dim float32 tensors,
    from the forward), after one update of `model` and `optimizer` in
    place.

    Over a mesh (`parallel.mesh.Mesh`) the images and labels are this
    rank's rows (`local_rows`), the model's BatchNorms normalize by the
    global batch, the gradients are summed over dp and divided by dp
    before `optimizer.step()`, and the loss and accuracy are the global
    batch's means. `optimizer` is anything with `zero_grad` and `step`
    (the Trainer passes its tp-sharded parameters).

    `grad_accum > 1` splits the batch into that many micro-batches, each
    of whose gradients is taken at the same parameters; BatchNorm's
    running statistics move through them in order; the gradients are
    summed in float32 and scaled by 1/grad_accum, and the loss and
    accuracy are the micro-batches' means. `remat` checkpoints the whole
    forward (`torch.utils.checkpoint`), which runs it again in the
    backward; that second run leaves the running statistics alone, as
    JAX's functional `jax.checkpoint` updates them once."""
    mesh = resolve_mesh(mesh)
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
    if mesh is not None:
        sum_batch_stats(model, lambda t: all_reduce(t, mesh, "dp"))

    def forward(x):
        if not remat:
            return model(x)
        return checkpoint(model, x, use_reentrant=False,
                          context_fn=lambda: (nullcontext(), frozen_batch_stats(model)))

    def train_step(images_u8: torch.Tensor, labels: torch.Tensor) -> Dict[str, torch.Tensor]:
        model.train()
        x = normalize_sharded(images_u8, preprocess_mode, dtype, mesh)
        optimizer.zero_grad(set_to_none=True)
        if grad_accum == 1:
            loss, acc = classification_metrics(forward(x), labels)
            loss.backward()
        else:
            if x.shape[0] % grad_accum:
                raise ValueError(f"grad_accum {grad_accum} must divide the batch {x.shape[0]}")
            loss = acc = torch.zeros((), dtype=torch.float32, device=x.device)
            for xi, yi in zip(x.chunk(grad_accum), labels.chunk(grad_accum)):
                loss_i, acc_i = classification_metrics(forward(xi), yi)
                loss_i.backward()
                loss, acc = loss + loss_i.detach(), acc + acc_i
            inv = 1.0 / grad_accum
            with torch.no_grad():
                for p in model.parameters():
                    if p.grad is not None:
                        p.grad.mul_(inv)
            loss, acc = loss * inv, acc * inv
        if mesh is not None:  # every rank's graph is the same: so are their gradient lists
            _mean_over_dp([p.grad for p in model.parameters() if p.grad is not None], mesh)
            loss, acc = _mean_over_dp([torch.stack([loss.detach(), acc])], mesh)[0]
        optimizer.step()
        return {"loss": loss.detach(), "accuracy": acc}

    return train_step


def _mean_over_dp(tensors, mesh: Mesh):
    """Each tensor replaced in place by its mean over the dp ranks, all of
    them in one all-reduce of their concatenation; returns them."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    all_reduce(flat, mesh, "dp").div_(mesh.shape["dp"])
    off = 0
    for t in tensors:
        t.copy_(flat[off:off + t.numel()].view(t.shape))
        off += t.numel()
    return tensors


def local_rows(batch, mesh: Mesh, grad_accum: int = 1):
    """This rank's rows of a global batch (numpy array or tensor, rows
    first): of each of the `grad_accum` micro-batches (consecutive blocks
    of rows), the block of its dp index, as JAX's step shards each
    micro-batch over dp. A `multihost.GlobalBatch` is this rank's rows
    already: its `local`."""
    if isinstance(batch, GlobalBatch):
        return batch.local
    dp, i = mesh.shape["dp"], mesh.coords["dp"]
    n = batch.shape[0]
    if n % (dp * grad_accum):
        raise ValueError(f"batch of {n} rows does not split into {grad_accum} micro-batches "
                         f"over dp={dp}")
    k = n // (dp * grad_accum)
    if grad_accum == 1:
        return batch[i * k:(i + 1) * k]
    return batch.reshape(grad_accum, dp, k, *batch.shape[1:])[:, i].reshape(
        grad_accum * k, *batch.shape[1:])


class TpParams:
    """A trainer's parameters over a mesh: this rank's tp piece of each
    (`sharding.shard` of the full tensor; a leaf not sharded over tp
    keeps the model's own parameter as its piece), which the optimizer
    updates. `gather` puts the full weights into the model, `step` (the
    step's optimizer call) hands each piece its slice of the model's
    gradient and updates the pieces, and `release` drops the full weights
    again. `specs` (default: `partition_params` of the model's
    parameters) are by parameter name; the LM trainer passes those of
    its full logical shapes."""

    def __init__(self, named, mesh: Mesh, specs=None):
        self.mesh, self.model_named = mesh, named
        self.specs = partition_params({n: p for n, p in named}, mesh) if specs is None else specs
        self.shapes = {n: tuple(p.shape) for n, p in named}
        self.named = [(n, p if shard_dim(self.specs[n]) is None
                       else nn.Parameter(shard(p.detach(), self.specs[n], mesh)))
                      for n, p in named]
        self.sharded = [(n, p, piece) for (n, p), (_, piece) in zip(named, self.named)
                        if piece is not p]
        self.optimizer: Optional[torch.optim.Optimizer] = None
        self.release()

    def pieces(self) -> Dict[str, torch.Tensor]:
        return {n: piece.detach() for n, piece in self.named}

    def gather(self) -> None:
        full = gather_tree(self.pieces(), self.specs, self.mesh)
        for n, p, _ in self.sharded:
            p.data = full[n].contiguous(
                memory_format=torch.channels_last if p.ndim == 4 else torch.contiguous_format)

    def release(self) -> None:
        for _, p, _ in self.sharded:
            p.data = p.data.new_empty(0)
            p.grad = None

    def zero_grad(self, set_to_none: bool = True) -> None:
        self.optimizer.zero_grad(set_to_none=set_to_none)
        for _, p in self.model_named:
            p.grad = None

    def step(self) -> None:
        for n, p, piece in self.sharded:
            piece.grad = None if p.grad is None else shard(p.grad, self.specs[n], self.mesh)
        self.optimizer.step()


class Trainer:
    """An image model and its optimizer, on one device or over a mesh.

    >>> tr = Trainer("ResNet50", batch_size=32)          # cuda, one device
    >>> tr = Trainer("ResNet50", local_mesh(dp=4, tp=2), batch_size=32)  # on every rank
    >>> metrics = tr.step(images_u8, labels)            # {"loss", "accuracy"}
    >>> tr.evaluate(images_u8, labels)                   # running statistics
    >>> tr.save_checkpoint("ckpt"); tr.restore_checkpoint("ckpt")
    >>> engine.load_model("ResNet50", variables=tr.export_variables())
    """

    def __init__(
        self,
        model_name: str,
        mesh=None,
        batch_size: Optional[int] = None,
        learning_rate: Union[float, Schedule] = 1e-3,
        optimizer: Optional[Callable[[list], torch.optim.Optimizer]] = None,
        dtype: torch.dtype = torch.bfloat16,
        seed: int = 0,
        num_classes: int = 1000,
        variables: Any = None,
        grad_accum: int = 1,
        remat: bool = False,
        device=None,
    ):
        """`mesh` is None or a one-device mesh (one device), or a
        `parallel.mesh.Mesh` that this rank is in (every rank of it builds
        the Trainer with the same arguments). `learning_rate` is a float
        or a schedule of the update count (`warmup_cosine`). `optimizer`,
        if given, builds the optimizer from the parameter list (this
        rank's pieces over a mesh) in place of the default AdamW (and
        `learning_rate` is not used); it must keep Adam's state (torch's
        Adam or AdamW), which `state` and the checkpoints carry.
        `variables` is the JAX package's layout (converted by
        `from_flax_variables`) or a state_dict of the model; default: the
        port's seeded init."""
        if batch_size is None:
            raise TypeError("Trainer needs batch_size")
        self.mesh = resolve_mesh(mesh)
        dp = 1 if self.mesh is None else self.mesh.shape["dp"]
        if batch_size % dp:
            raise ValueError(f"batch_size {batch_size} not divisible by dp={dp}")
        if grad_accum < 1 or batch_size % grad_accum:
            raise ValueError(f"grad_accum {grad_accum} must divide batch_size {batch_size}")
        if (batch_size // grad_accum) % dp:
            raise ValueError(f"micro-batch {batch_size // grad_accum} not divisible by dp={dp}")
        self.device = resolve_device(device)
        self.spec = get_model(model_name)
        self.batch_size, self.dtype, self.grad_accum = batch_size, dtype, grad_accum
        if variables is None:
            variables = init_variables(self.spec, seed=seed, num_classes=num_classes)
        elif "params" in variables or any("/" in k for k in variables):
            variables = from_flax_variables(variables)
        model = self.spec.build(dtype=dtype, num_classes=num_classes, param_dtype=torch.float32)
        model.load_state_dict(variables)  # strict: names any missing/extra key
        self.model = model.to(self.device, memory_format=torch.channels_last).train()
        # the optimizer's (name, parameter) pairs: the model's own on one
        # device, this rank's pieces over a mesh
        self._tp = None if self.mesh is None else TpParams(
            list(self.model.named_parameters()), self.mesh)
        self._named = list(self.model.named_parameters()) if self._tp is None else self._tp.named
        self._schedule = learning_rate if callable(learning_rate) and optimizer is None else None
        params = [p for _, p in self._named]
        if optimizer is None:
            lr = learning_rate if self._schedule is None else self._schedule(0)
            self.optimizer = make_adamw(params, lr, self.device)
        else:
            self.optimizer = optimizer(params)
            if not isinstance(self.optimizer, (torch.optim.Adam, torch.optim.AdamW)):
                raise TypeError(f"optimizer must be torch's Adam or AdamW, got "
                                f"{type(self.optimizer).__name__}")
        if self._tp is not None:
            self._tp.optimizer = self.optimizer
        self._train_step = make_train_step(
            self.model, self.spec.preprocess, self._tp or self.optimizer, dtype,
            grad_accum=grad_accum, remat=remat, mesh=self.mesh,
        )
        self._steps = 0
        self.last_step_time: Optional[float] = None

    def _batch(self, images_u8, labels, grad_accum: int = 1):
        """(uint8 images, int64 labels) on the device: this rank's rows
        over a mesh (`local_rows`); host arrays go through pinned memory
        with an asynchronous copy."""
        out = []
        for a in (images_u8, labels):
            if self.mesh is not None:
                a = local_rows(a, self.mesh, grad_accum)
            t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(a))
            if t.device != self.device:
                if self.device.type == "cuda" and t.device.type == "cpu":
                    t = t.pin_memory()
                t = t.to(self.device, non_blocking=True)
            out.append(t)
        x, y = out
        if x.dtype != torch.uint8 or x.ndim != 4:
            raise TypeError(f"expected uint8 images [B,H,W,3], got {x.dtype} {tuple(x.shape)}")
        return x, y.long()

    @contextmanager
    def _full_weights(self):
        """Within the block the model holds its full weights (gathered
        over tp from the pieces, over a mesh)."""
        if self._tp is None:
            yield
            return
        self._tp.gather()
        try:
            yield
        finally:
            self._tp.release()

    def step(self, images_u8, labels) -> Dict[str, float]:
        """One training step on the global batch (every rank of a mesh
        gives the same one, or a `multihost.GlobalBatch` of its rows);
        returns the host-side loss and accuracy of the forward before the
        update."""
        t0 = time.monotonic()
        x, y = self._batch(images_u8, labels, self.grad_accum)
        if self._schedule is not None:
            lr = float(self._schedule(adam_count(self.optimizer, self._named)))
            for group in self.optimizer.param_groups:
                group["lr"] = lr
        with self._full_weights():
            metrics = self._train_step(x, y)
        out = {k: float(v) for k, v in metrics.items()}  # waits for the step
        self._steps += 1
        self.last_step_time = time.monotonic() - t0
        return out

    def evaluate(self, images_u8, labels) -> Dict[str, float]:
        """Inference-mode loss and accuracy on one batch (the global
        batch's over a mesh): the running BatchNorm statistics, nothing
        mutated."""
        x, y = self._batch(images_u8, labels)
        self.model.eval()
        try:
            with torch.no_grad(), self._full_weights():
                probs = self.model(normalize_sharded(x, self.spec.preprocess, self.dtype,
                                                     self.mesh))
                nll, acc = classification_metrics(probs, y)
                if self.mesh is not None:
                    nll, acc = _mean_over_dp([torch.stack([nll, acc])], self.mesh)[0]
        finally:
            self.model.train()
        return {"loss": float(nll), "accuracy": float(acc)}

    # ---- state ----

    def _gathered(self, pieces: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return pieces if self._tp is None else gather_tree(pieces, self._tp.specs, self.mesh)

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        """Every parameter, full (gathered over tp on a mesh: every rank
        calls it)."""
        return self._gathered({n: p.detach() for n, p in self._named})

    def _batch_stats(self) -> Dict[str, torch.Tensor]:
        return {n: b for n, b in self.model.named_buffers()
                if n.endswith((".running_mean", ".running_var"))}

    @property
    def state(self) -> Dict[str, Any]:
        """The full logical state (gathered over tp on a mesh: every rank
        calls it)."""
        opt = adam_state(self.optimizer, self._named)
        opt["exp_avg"], opt["exp_avg_sq"] = (self._gathered(opt[k])
                                             for k in ("exp_avg", "exp_avg_sq"))
        return {"params": self.params, "batch_stats": self._batch_stats(),
                "opt_state": opt, "step": self._steps}

    @state.setter
    def state(self, state: Mapping[str, Any]) -> None:
        """Set the state from full logical tensors (this rank keeps its
        pieces over a mesh)."""
        shapes = ({n: tuple(p.shape) for n, p in self._named} if self._tp is None
                  else self._tp.shapes)
        for key, want in (("params", shapes),
                          ("batch_stats", {n: tuple(t.shape)
                                           for n, t in self._batch_stats().items()})):
            given = state[key]
            if set(given) != set(want):
                raise KeyError(f"state {key} keys {sorted(set(given) ^ set(want))} differ "
                               f"from the model's")
            for n, shape in want.items():
                if tuple(given[n].shape) != shape:
                    raise ValueError(f"state {key} {n!r}: shape {tuple(given[n].shape)}, "
                                     f"the model's is {shape}")
        mine = self._mine
        with torch.no_grad():
            for n, p in self._named:
                p.copy_(mine(n, state["params"][n]))
            for n, t in self._batch_stats().items():
                t.copy_(state["batch_stats"][n])
        opt = state["opt_state"]
        load_adam_state(self.optimizer, self._named, {
            "count": opt["count"],
            **{k: {n: mine(n, v) for n, v in opt[k].items()} for k in ("exp_avg", "exp_avg_sq")}})
        self._steps = int(state["step"])

    def _mine(self, name: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's piece of a full tensor (the tensor on one device)."""
        if self._tp is None:
            return full
        return shard(full.to(self.device), self._tp.specs[name], self.mesh)

    def save_checkpoint(self, directory: str, keep: int = 3) -> str:
        """Write the full training state (params, batch_stats, optimizer
        moments, step): resume-exact, not just weights. Over a mesh every
        rank calls it: all take part in gathering the state, the first
        rank writes, and all wait for the write."""
        mgr = CheckpointManager(directory, keep=keep)
        state = self.state
        if self.mesh is None or self.mesh.index == 0:
            mgr.save(self._steps, state)
        if self.mesh is not None:
            barrier(self.mesh)
        return mgr.blob_path(self._steps)

    def restore_checkpoint(self, directory: str, step: Optional[int] = None) -> int:
        """Load the latest (or a pinned) checkpoint, whatever mesh wrote
        it; returns its step. Over a mesh every rank calls it."""
        self.state = CheckpointManager(directory).restore(like=self.state, step=step)
        return self._steps

    def export_variables(self) -> Dict[str, torch.Tensor]:
        """A float32 CPU copy of the model's full state_dict (weights,
        BatchNorm statistics), which `InferenceEngine.load_model(
        variables=)` takes; over a mesh, on every rank (every rank calls
        it)."""
        sd = {**self.model.state_dict(), **self.params}
        return {k: v.detach().to(device="cpu", dtype=torch.float32, copy=True).contiguous()
                for k, v in sd.items()}

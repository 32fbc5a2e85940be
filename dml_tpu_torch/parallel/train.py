"""Image-model training on one device: PyTorch counterpart of
dml_tpu/parallel/train.py at dp = tp = 1.

The model zoo becomes trainable (fine-tuning a classifier before serving
it through the engine, say) with the JAX package's recipe and names:
`classification_metrics` (NLL on the softmax output and accuracy, the
one definition train and eval share), `warmup_cosine` (optax's
`warmup_cosine_decay_schedule`), `make_train_step` (with `grad_accum`
and `remat`) and `Trainer`.

What a step does, as the JAX step does it:
- the uint8 batch goes through `ops.preprocess.normalize_sharded`, so
  K1 (csrc/normalize.cu) launches once a step on a CUDA batch, and once
  an `evaluate`;
- the model runs in training mode: BatchNorm normalizes by the batch's
  statistics and moves its running statistics with Flax's rule
  (`models.layers.BatchNorm`); conv weights are float32 masters cast to
  the compute dtype at each call, so gradients and AdamW updates are
  float32;
- the loss and accuracy returned are those of the forward, before the
  update.

Differences from the JAX package, by design:
- One device. A mesh of more than one device raises NotImplementedError
  (ROADMAP A5); BatchNorm statistics are the whole batch's, as they are
  under GSPMD.
- PyTorch runs eagerly and updates the model and the optimizer in place:
  `make_train_step` returns a closure `(images, labels) -> metrics`, not
  a pure `(state, images, labels) -> (state, metrics)` function.
- The optimizer is `torch.optim.AdamW` with optax.adamw's
  hyperparameters (`adamw.make_adamw`). A learning-rate schedule (a
  function of the 0-based update count, `warmup_cosine`) sets the rate
  before each update, as optax evaluates it at the count.
- `state` is `{"params": {name: tensor}, "batch_stats": {name: tensor},
  "opt_state": {"count", "exp_avg", "exp_avg_sq"} by parameter name,
  "step": int}`, live tensors; `models.params_io.
  image_train_state_from_flax` converts the JAX Trainer's state to it.

Entry points run on `cuda` unless `device` says otherwise, and raise
when there is no CUDA device; the tests pass `device="cpu"`.
"""

from __future__ import annotations

import math
import time
from contextlib import nullcontext
from typing import Any, Callable, Dict, Mapping, Optional, Union

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..models.layers import frozen_batch_stats
from ..models.lm_params import resolve_device
from ..models.params_io import from_flax_variables, init_variables
from ..models.registry import get_model
from ..ops.preprocess import normalize_sharded
from . import mesh_size
from .adamw import adam_count, adam_state, load_adam_state, make_adamw
from .checkpoint import CheckpointManager

Schedule = Callable[[int], float]


def _one_device(mesh) -> None:
    if mesh_size(mesh) > 1:
        raise NotImplementedError(
            "training over a mesh of more than one device (dp/tp sharding) is not "
            "ported yet: ROADMAP A5 (multi-GPU forms)"
        )


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

    `grad_accum > 1` splits the batch into that many micro-batches, each
    of whose gradients is taken at the same parameters; BatchNorm's
    running statistics move through them in order; the gradients are
    summed in float32 and scaled by 1/grad_accum, and the loss and
    accuracy are the micro-batches' means. `remat` checkpoints the whole
    forward (`torch.utils.checkpoint`), which runs it again in the
    backward; that second run leaves the running statistics alone, as
    JAX's functional `jax.checkpoint` updates them once."""
    _one_device(mesh)
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")

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
        optimizer.step()
        return {"loss": loss.detach(), "accuracy": acc}

    return train_step


class Trainer:
    """An image model and its optimizer on one device.

    >>> tr = Trainer("ResNet50", batch_size=32)          # cuda
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
        """`learning_rate` is a float or a schedule of the update count
        (`warmup_cosine`). `optimizer`, if given, builds the optimizer
        from the parameter list in place of the default AdamW (and
        `learning_rate` is not used); it must keep Adam's state (torch's
        Adam or AdamW), which `state` and the checkpoints carry.
        `variables` is the JAX package's layout (converted by
        `from_flax_variables`) or a state_dict of the model; default:
        the port's seeded init."""
        if batch_size is None:
            raise TypeError("Trainer needs batch_size")
        _one_device(mesh)
        if grad_accum < 1 or batch_size % grad_accum:
            raise ValueError(f"grad_accum {grad_accum} must divide batch_size {batch_size}")
        self.device = resolve_device(device)
        self.spec = get_model(model_name)
        self.mesh, self.batch_size, self.dtype = mesh, batch_size, dtype
        if variables is None:
            variables = init_variables(self.spec, seed=seed, num_classes=num_classes)
        elif "params" in variables or any("/" in k for k in variables):
            variables = from_flax_variables(variables)
        model = self.spec.build(dtype=dtype, num_classes=num_classes, param_dtype=torch.float32)
        model.load_state_dict(variables)  # strict: names any missing/extra key
        self.model = model.to(self.device, memory_format=torch.channels_last).train()
        self._named = list(self.model.named_parameters())
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
        self._train_step = make_train_step(
            self.model, self.spec.preprocess, self.optimizer, dtype,
            grad_accum=grad_accum, remat=remat, mesh=mesh,
        )
        self._steps = 0
        self.last_step_time: Optional[float] = None

    def _batch(self, images_u8, labels):
        """(uint8 images, int64 labels) on the device; host arrays go
        through pinned memory with an asynchronous copy."""
        out = []
        for a in (images_u8, labels):
            t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.asarray(a))
            if t.device != self.device:
                if self.device.type == "cuda" and t.device.type == "cpu":
                    t = t.pin_memory()
                t = t.to(self.device, non_blocking=True)
            out.append(t)
        x, y = out
        if x.dtype != torch.uint8 or x.ndim != 4:
            raise TypeError(f"expected uint8 images [B,H,W,3], got {x.dtype} {tuple(x.shape)}")
        return x, y.long()

    def step(self, images_u8, labels) -> Dict[str, float]:
        """One training step; returns the host-side loss and accuracy of
        the forward before the update."""
        t0 = time.monotonic()
        x, y = self._batch(images_u8, labels)
        if self._schedule is not None:
            lr = float(self._schedule(adam_count(self.optimizer, self._named)))
            for group in self.optimizer.param_groups:
                group["lr"] = lr
        metrics = self._train_step(x, y)
        out = {k: float(v) for k, v in metrics.items()}  # waits for the step
        self._steps += 1
        self.last_step_time = time.monotonic() - t0
        return out

    def evaluate(self, images_u8, labels) -> Dict[str, float]:
        """Inference-mode loss and accuracy on one batch: the running
        BatchNorm statistics, nothing mutated."""
        x, y = self._batch(images_u8, labels)
        self.model.eval()
        try:
            with torch.no_grad():
                probs = self.model(normalize_sharded(x, self.spec.preprocess, self.dtype,
                                                     self.mesh))
                nll, acc = classification_metrics(probs, y)
        finally:
            self.model.train()
        return {"loss": float(nll), "accuracy": float(acc)}

    # ---- state ----

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        return {n: p.detach() for n, p in self._named}

    def _batch_stats(self) -> Dict[str, torch.Tensor]:
        return {n: b for n, b in self.model.named_buffers()
                if n.endswith((".running_mean", ".running_var"))}

    @property
    def state(self) -> Dict[str, Any]:
        return {"params": self.params, "batch_stats": self._batch_stats(),
                "opt_state": adam_state(self.optimizer, self._named), "step": self._steps}

    @state.setter
    def state(self, state: Mapping[str, Any]) -> None:
        with torch.no_grad():
            for key, own in (("params", self.params), ("batch_stats", self._batch_stats())):
                given = state[key]
                if set(given) != set(own):
                    raise KeyError(f"state {key} keys {sorted(set(given) ^ set(own))} differ "
                                   f"from the model's")
                for n, t in own.items():
                    if tuple(given[n].shape) != tuple(t.shape):
                        raise ValueError(f"state {key} {n!r}: shape {tuple(given[n].shape)}, "
                                         f"the model's is {tuple(t.shape)}")
                    t.copy_(given[n])
        load_adam_state(self.optimizer, self._named, state["opt_state"])
        self._steps = int(state["step"])

    def save_checkpoint(self, directory: str, keep: int = 3) -> str:
        """Write the full training state (params, batch_stats, optimizer
        moments, step): resume-exact, not just weights."""
        return CheckpointManager(directory, keep=keep).save(self._steps, self.state)

    def restore_checkpoint(self, directory: str, step: Optional[int] = None) -> int:
        """Load the latest (or a pinned) checkpoint; returns its step."""
        self.state = CheckpointManager(directory).restore(like=self.state, step=step)
        return self._steps

    def export_variables(self) -> Dict[str, torch.Tensor]:
        """A float32 CPU copy of the model's state_dict (weights, BatchNorm
        statistics), which `InferenceEngine.load_model(variables=)` takes."""
        return {k: v.detach().to(device="cpu", dtype=torch.float32, copy=True).contiguous()
                for k, v in self.model.state_dict().items()}

"""Long-context LM training, on one device or over a mesh: PyTorch
counterpart of dml_tpu/parallel/long_context.py.

`make_lm` builds the `TransformerLM` whose attention fits the mesh: at
sp = 1 the port's `ops.flash_attention` on each rank's rows (the JAX
package places heads over tp; here every tp rank computes all heads, as
the port's gather-at-use tp forms do, with the same result); at sp > 1
`ring_attention` or `ulysses_attention` over the mesh
(`seq_parallel`). So a training step runs the flash forward kernel (K2)
and, through its autograd Function, the backward kernels (K3) on every
attention block. `LongContextLM` holds the float32 params and the AdamW
state and runs `train_step` (loss, backward, optimizer step), `forward`,
`generate` (the trained weights served by `inference.generate`) and
checkpoints (`parallel.checkpoint`). With `num_experts > 0` every
`moe_every`-th block is a mixture of experts (`parallel.moe`), and the
objective adds `moe_aux_weight` times the mean of the blocks'
load-balance losses to the next-token loss, as the JAX package's train
step does.

Over a mesh (`parallel.mesh.Mesh`, one process per rank, every rank
calling with the same arguments), where GSPMD places the JAX step's
collectives, the port calls them:
- every rank is given the global tokens [B, T] and takes its dp rows and
  its sp slice of the sequence, whose positions start at sp index x
  T/sp (rope's offset);
- the loss is the JAX package's global mean over B (T - 1) predictions:
  the last position of sp shard s predicts the first token of shard s +
  1 (taken from the global tokens), the last shard's last position
  predicts nothing; each rank's sum over its predictions, divided by B
  (T - 1), is all-reduced over dp and sp, and so is the aux term, a
  mean over the routing groups, which every ep rank computes alike and
  counts once;
- gradients are summed over the dp x sp plane (one all-reduce of a flat
  buffer; a group of one at dp = sp = 1); the ring's and
  Ulysses' backward carry the other shards' share home, and MoE blocks
  sum their input's share over ep (`parallel.moe`), so every leaf's
  gradient comes out equal on the ranks that hold it;
- parameters and their AdamW moments are held sharded at rest: tp
  leaves (`sharding.partition_params`, dim 0 over tp: the LM keeps
  Flax's [in, out] layout, so its tp pieces are not JAX's device shards,
  and the full weights are the same) are gathered at use and their
  pieces updated (`train.TpParams`), expert tensors hold this rank's
  experts over ep;
- `state` gathers the full logical tensors (every rank calls it), its
  setter keeps this rank's pieces, so states and checkpoints have one
  layout whatever the mesh; a checkpoint is written by the mesh's first
  rank after every rank took part in the gather, and restores onto any
  mesh;
- `forward` returns this rank's logits shard [B/dp, T/sp, vocab];
  `generate` serves on every rank from the gathered weights through the
  one-device `inference.generate` (K2, then K4), the same tokens on
  every rank.

Differences from the JAX package, by design:
- PyTorch runs eagerly: no jit, and the state is updated in place
  (`adamw.make_adamw`: torch's AdamW with optax.adamw's
  hyperparameters).
- `state` is `{"params": TransformerLM state_dict, "opt_state":
  {"count", "exp_avg", "exp_avg_sq"} by parameter name, "step"}`;
  `models.lm_params.lm_train_state_from_flax` converts the JAX state to
  it. On one device the getter's tensors are the live ones, not copies.
- `generate` serves the trained weights in the JAX package's cast form:
  every floating leaf with ndim >= 2 (block kernels, expert tensors and
  the router, embedding, lm_head) rounded once to the model dtype, norm
  scales float32; `inference.generate` routes with the rounded router
  promoted back to float32, as JAX promotes it.

Entry points run on `cuda` unless `device` says otherwise, and raise
when there is no CUDA device; the tests pass `device="cpu"`.
"""

from __future__ import annotations

import dataclasses
import functools
from contextlib import contextmanager
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from ..inference.generate import LMConfig, generate as _generate
from ..inference.quantize import quantize_lm_params
from ..models.lm_params import init_lm_params, params_tree_of, resolve_device, state_dict_of
from ..models.transformer import TransformerLM
from ..ops.flash_attention import flash_attention
from .adamw import adam_state, load_adam_state, make_adamw
from .checkpoint import CheckpointManager
from .mesh import Mesh, all_reduce, barrier, resolve_mesh
from .ring_attention import ring_attention
from .sharding import gather_tree, partition_params, shard, shard_dim
from .train import TpParams, local_rows
from .ulysses import ulysses_attention

SEQ_PARALLEL = ("ring", "ulysses")


def make_lm(mesh=None, seq_parallel: str = "ring", **config) -> TransformerLM:
    """A TransformerLM whose attention fits `mesh` (None or a mesh of one
    device: one device): at sp > 1 `ring_attention` or `ulysses_attention`
    over it, else the flash kernel. `seq_parallel` is validated whatever
    the mesh, as the JAX package validates it."""
    if seq_parallel not in SEQ_PARALLEL:
        raise ValueError(f"seq_parallel must be 'ring' or 'ulysses', got {seq_parallel!r}")
    mesh = resolve_mesh(mesh)
    attention = flash_attention
    if mesh is not None and mesh.shape["sp"] > 1:
        fn = ring_attention if seq_parallel == "ring" else ulysses_attention
        attention = functools.partial(fn, mesh=mesh)
    return TransformerLM(attention=attention, mesh=mesh, **config)


def lm_loss(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Next-token cross entropy in float32; the last position predicts
    nothing."""
    logp = torch.log_softmax(logits[:, :-1].to(torch.float32), dim=-1)
    tgt = tokens[:, 1:].long()
    return -logp.gather(-1, tgt[..., None])[..., 0].mean()


class LongContextLM:
    """The LM with its train step, on one device or over a mesh.

    >>> lm = LongContextLM(seq_len=2048, vocab_size=32000, d_model=1024)
    >>> lm = LongContextLM(local_mesh(dp=1, sp=2), seq_len=2048, ...)  # on every rank
    >>> loss = lm.train_step(tokens)          # tokens [B, 2048], the global batch
    >>> logits = lm.forward(tokens)
    >>> lm.save_checkpoint("ckpt"); lm.restore_checkpoint("ckpt")
    """

    def __init__(
        self,
        mesh=None,
        seq_len: Optional[int] = None,
        learning_rate: float = 3e-4,
        dtype: torch.dtype = torch.bfloat16,
        seed: int = 0,
        moe_aux_weight: float = 1e-2,
        device=None,
        **config,
    ):
        """`mesh` is None or a one-device mesh (one device), or a
        `parallel.mesh.Mesh` that this rank is in; `config` holds the
        model's fields and `seq_parallel` ("ring" or "ulysses")."""
        if seq_len is None:
            raise TypeError("LongContextLM needs seq_len")
        self.device = resolve_device(device)
        self.mesh: Optional[Mesh] = resolve_mesh(mesh)
        sp = 1 if self.mesh is None else self.mesh.shape["sp"]
        if seq_len % sp:
            raise ValueError(f"seq_len {seq_len} not divisible by sp={sp}")
        self.seq_len = seq_len
        self.moe_aux_weight = moe_aux_weight
        self.model = make_lm(self.mesh, dtype=dtype, **config).to(self.device)
        m = self.model
        self.cfg = LMConfig(vocab_size=m.vocab_size, d_model=m.d_model, n_heads=m.n_heads,
                            n_layers=m.n_layers, d_ff=m.d_ff, dtype=m.dtype,
                            n_kv_heads=m.n_kv_heads)
        full = state_dict_of(init_lm_params(
            self.cfg, seed=seed, device=self.device, num_experts=m.num_experts,
            moe_every=m.moe_every))
        self._tp: Optional[TpParams] = None
        if self.mesh is None:
            m.load_state_dict(full)
            self._named = list(m.named_parameters())
        else:
            # specs of the full logical shapes: tp over dim 0, experts over ep
            self._specs = partition_params(
                {n: torch.empty(t.shape, device="meta") for n, t in full.items()}, self.mesh)
            m.load_state_dict({n: self._ep_piece(n, t) for n, t in full.items()})
            self._tp = TpParams(list(m.named_parameters()), self.mesh, self._specs)
            self._named = self._tp.named
        del full
        self.optimizer = make_adamw([p for _, p in self._named], learning_rate, self.device)
        if self._tp is not None:
            self._tp.optimizer = self.optimizer
        self.step = 0
        self._serve: Optional[tuple] = None  # (step, {form: params tree})

    def _ep_piece(self, name: str, full: torch.Tensor) -> torch.Tensor:
        """What the module holds of a full leaf: this rank's experts of an
        expert tensor sharded over ep, else the whole leaf."""
        spec = self._specs[name]
        return full if shard_dim(spec, "ep") is None else shard(full, spec, self.mesh)

    def _tokens(self, tokens) -> torch.Tensor:
        t = torch.as_tensor(tokens, device=self.device)
        if t.ndim != 2:
            raise ValueError(f"tokens must be [B, T], got {tuple(t.shape)}")
        return t

    def _rank_slice(self, t: torch.Tensor):
        """(this rank's tokens, their next-token targets, the position of
        its first token) from the global [B, T]: its dp rows and sp slice
        (all of it on one device); the targets run one past the slice,
        into the next shard, and stop at T."""
        if self.mesh is None:
            return t, t[:, 1:], 0
        rows = local_rows(t, self.mesh)
        sp, s = self.mesh.shape["sp"], self.mesh.coords["sp"]
        if t.shape[1] % sp:
            raise ValueError(f"T {t.shape[1]} not divisible by sp={sp}")
        tl = t.shape[1] // sp
        return rows[:, s * tl:(s + 1) * tl], rows[:, s * tl + 1:(s + 1) * tl + 1], s * tl

    @contextmanager
    def _full_weights(self):
        """Within the block the model holds its full tp leaves (gathered
        from the pieces, over a mesh)."""
        if self._tp is None:
            yield
            return
        self._tp.gather()
        try:
            yield
        finally:
            self._tp.release()

    def forward(self, tokens) -> torch.Tensor:
        """Logits f32: [B, T, vocab] on one device, this rank's shard
        [B/dp, T/sp, vocab] over a mesh."""
        x, _, offset = self._rank_slice(self._tokens(tokens))
        with torch.no_grad(), self._full_weights():
            return self.model(x, offset=offset)

    def loss(self, tokens) -> torch.Tensor:
        """The training objective on `tokens`, differentiable: the
        next-token loss plus `moe_aux_weight` times the mean of the MoE
        blocks' load-balance losses (none without experts). Without that
        term the top-2 router can collapse onto one expert and drop
        tokens. Over a mesh (inside the full weights, as `train_step`
        calls it) this rank's share: its predictions' summed loss over B
        (T - 1), and its aux over dp x sp; the sum over the dp and sp
        ranks is the objective."""
        t = self._tokens(tokens)
        x, tgt, offset = self._rank_slice(t)
        logits, aux = self.model(x, return_aux=True, offset=offset)
        logp = torch.log_softmax(logits[:, :tgt.shape[1]].to(torch.float32), dim=-1)
        b, n = t.shape
        loss = -logp.gather(-1, tgt[..., None].long()).sum() / (b * (n - 1))
        if aux:
            shards = 1 if self.mesh is None else self.mesh.shape["dp"] * self.mesh.shape["sp"]
            loss = loss + self.moe_aux_weight * (sum(aux) / len(aux)) / shards
        return loss

    def _sum_over_dp_sp(self, loss: torch.Tensor) -> torch.Tensor:
        """Every gradient of the model, and the loss share, summed over
        the dp x sp plane in one all-reduce of a flat buffer; returns the
        loss."""
        params = [p for _, p in self.model.named_parameters()]
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        flat = torch.cat([p.grad.reshape(-1) for p in params] + [loss.reshape(1)])
        all_reduce(flat, self.mesh, ("dp", "sp"))
        off = 0
        for p in params:
            p.grad.copy_(flat[off:off + p.numel()].view(p.shape))
            off += p.numel()
        return flat[-1]

    def train_step(self, tokens) -> float:
        """One AdamW step on the objective; returns the loss before the
        step (the global batch's, over a mesh)."""
        opt = self._tp or self.optimizer
        with self._full_weights():
            opt.zero_grad(set_to_none=True)
            loss = self.loss(tokens)
            loss.backward()
            loss = loss.detach()
            if self.mesh is not None:
                loss = self._sum_over_dp_sp(loss)
            opt.step()
        self.step += 1
        return float(loss)

    # ---- state ----

    def _gathered(self, pieces: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Full tensors from this rank's pieces (collectives over tp and
        ep, over a mesh)."""
        if self.mesh is None:
            return pieces
        return gather_tree(gather_tree(pieces, self._specs, self.mesh, "tp"),
                           self._specs, self.mesh, "ep")

    def _params(self) -> Dict[str, torch.Tensor]:
        return self._gathered({n: p.detach() for n, p in self._named})

    @property
    def state(self) -> Dict[str, Any]:
        """The full logical state (gathered over a mesh: every rank calls
        it)."""
        opt = adam_state(self.optimizer, self._named)
        opt["exp_avg"], opt["exp_avg_sq"] = (self._gathered(opt[k])
                                             for k in ("exp_avg", "exp_avg_sq"))
        return {"params": self._params(), "opt_state": opt, "step": self.step}

    @state.setter
    def state(self, state: Mapping[str, Any]) -> None:
        """Set the state from full logical tensors (this rank keeps its
        pieces over a mesh)."""
        names = {n for n, _ in self._named}
        if set(state["params"]) != names:
            raise KeyError(f"state params keys {sorted(set(state['params']) ^ names)} differ "
                           f"from the model's")
        with torch.no_grad():
            for n, p in self._named:
                mine = self._mine(n, state["params"][n])
                if mine.shape != p.shape:
                    raise ValueError(f"state params {n!r}: shape {tuple(mine.shape)}, the "
                                     f"model's is {tuple(p.shape)}")
                p.copy_(mine)
        opt = state["opt_state"]
        load_adam_state(self.optimizer, self._named, {
            "count": opt["count"],
            **{k: {n: self._mine(n, v) for n, v in opt[k].items()}
               for k in ("exp_avg", "exp_avg_sq")}})
        self.step = int(state["step"])
        self._serve = None

    def _mine(self, name: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's piece of a full tensor (over tp or ep, or whole; the
        tensor itself on one device)."""
        full = full.to(self.device)
        return full if self.mesh is None else shard(full, self._specs[name], self.mesh)

    def save_checkpoint(self, directory: str, keep: int = 3) -> str:
        """Write the full training state. Over a mesh every rank calls it:
        all take part in gathering the state, the first rank writes, and
        all wait for the write."""
        mgr = CheckpointManager(directory, keep=keep)
        state = self.state
        if self.mesh is None or self.mesh.index == 0:
            mgr.save(self.step, state)
        if self.mesh is not None:
            barrier(self.mesh)
        return mgr.blob_path(self.step)

    def restore_checkpoint(self, directory: str, step: Optional[int] = None) -> int:
        """Load the latest (or a pinned) checkpoint, whatever mesh wrote
        it; returns its step. Over a mesh every rank calls it."""
        self.state = CheckpointManager(directory).restore(like=self.state, step=step)
        return self.step

    # ---- serving ----

    def generate(
        self,
        prompt,
        max_new_tokens: int,
        temperature: float = 0.0,
        top_k: Optional[int] = None,
        seed: int = 0,
        quantize_weights: bool = False,
        serve_dtype_cast: bool = True,
        kv_quant: bool = False,
    ) -> np.ndarray:
        """Autoregressive decoding with the trained weights
        (`inference.generate`): int32 [B, max_new_tokens]. By default every
        float32 leaf with ndim >= 2 (block kernels, embedding, lm_head) is
        cast once to the model dtype for serving, as the JAX package does
        (a second copy stays resident; `serve_dtype_cast=False` serves the
        training weights themselves); `quantize_weights=True` serves
        weight-only int8, `kv_quant=True` an int8 KV cache. Serving forms
        are cached per training step. Over a mesh every rank calls it:
        the forms are made from the gathered weights, and every rank
        serves the same tokens."""
        cfg = dataclasses.replace(self.cfg, kv_quant=kv_quant)
        params = self._serving_params(quantized=quantize_weights, cast=serve_dtype_cast)
        prompt = torch.as_tensor(np.asarray(prompt, dtype=np.int32), device=self.device)
        toks = _generate(params, cfg, prompt, max_new_tokens, temperature=temperature,
                         top_k=top_k, seed=seed)
        return toks.cpu().numpy()

    def _serving_params(self, quantized: bool, cast: bool) -> Dict[str, Any]:
        """The serving form of the weights (int8, model-dtype cast, or the
        training weights themselves: zero-copy on one device, gathered
        over a mesh), cached against the training step so serving after
        more training derives it again."""
        if quantized:
            key = "int8"
        elif cast and self.cfg.dtype != torch.float32:
            key = "cast"
        else:
            return params_tree_of(self._params())
        if self._serve is None or self._serve[0] != self.step:
            self._serve = (self.step, {})
        forms = self._serve[1]
        if key not in forms:
            with torch.no_grad():
                tree = params_tree_of(self._params())
                forms[key] = quantize_lm_params(tree) if key == "int8" else _cast_tree(tree, self.cfg.dtype)
        return forms[key]


def _cast_tree(tree: Dict[str, Any], dtype: torch.dtype) -> Dict[str, Any]:
    """Every floating leaf with ndim >= 2 (block kernels, lm_head,
    embedding) rounded to `dtype`; 1-d leaves (norm scales) and int8
    leaves as they are: the JAX package's cast form
    (dml_tpu/parallel/long_context.py:292-295)."""
    if isinstance(tree, dict):
        return {k: _cast_tree(v, dtype) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor) and tree.ndim >= 2 and tree.is_floating_point():
        return tree.to(dtype)
    return tree

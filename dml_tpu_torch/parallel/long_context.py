"""Long-context LM training on one device: PyTorch counterpart of
dml_tpu/parallel/long_context.py at sp=1.

`make_lm` builds the `TransformerLM` whose attention is the port's
`ops.flash_attention`, so a training step runs the flash forward kernel
(K2) and, through its autograd Function, the backward kernels (K3) in
every layer; `LongContextLM` holds the float32 params and the AdamW
state and runs `train_step` (loss, backward, optimizer step), `forward`,
`generate` (the trained weights served by `inference.generate`) and
checkpoints (`parallel.checkpoint`). With `num_experts > 0` every
`moe_every`-th block is a mixture of experts (`parallel.moe`), and the
objective adds `moe_aux_weight` times the mean of the blocks'
load-balance losses to the next-token loss, as the JAX package's
train step does.

Differences from the JAX package, by design:
- One device. A mesh that asks for more than one device (sequence,
  data or tensor parallelism: ring or Ulysses attention, GSPMD) raises
  NotImplementedError; the LM's forms over a mesh are ROADMAP A5(b).
- PyTorch runs eagerly: no jit, and the state is updated in place
  (`adamw.make_adamw`: torch's AdamW with optax.adamw's
  hyperparameters).
- `state` is `{"params": TransformerLM state_dict, "opt_state":
  {"count", "exp_avg", "exp_avg_sq"} by parameter name, "step"}`;
  `models.lm_params.lm_train_state_from_flax` converts the JAX state to
  it. The getter's tensors are the live ones, not copies.
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
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from ..inference.generate import LMConfig, generate as _generate
from ..inference.quantize import quantize_lm_params
from ..models.lm_params import init_lm_params, params_tree_of, resolve_device, state_dict_of
from ..models.transformer import TransformerLM
from ..ops.flash_attention import flash_attention
from . import mesh_size
from .adamw import adam_state, load_adam_state, make_adamw
from .checkpoint import CheckpointManager

SEQ_PARALLEL = ("ring", "ulysses")


def make_lm(mesh=None, seq_parallel: str = "ring", **config) -> TransformerLM:
    """A TransformerLM whose attention is the flash kernel (forward and
    backward). `seq_parallel` is validated as the JAX package validates
    it, whatever the mesh; a mesh of more than one device raises."""
    if seq_parallel not in SEQ_PARALLEL:
        raise ValueError(f"seq_parallel must be 'ring' or 'ulysses', got {seq_parallel!r}")
    if mesh_size(mesh) > 1:
        raise NotImplementedError(
            "the LM over a mesh of more than one device (ring/Ulysses sequence "
            "parallelism) is not ported yet: ROADMAP A5(b) (multi-GPU forms)"
        )
    return TransformerLM(attention=flash_attention, **config)


def lm_loss(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Next-token cross entropy in float32; the last position predicts
    nothing."""
    logp = torch.log_softmax(logits[:, :-1].to(torch.float32), dim=-1)
    tgt = tokens[:, 1:].long()
    return -logp.gather(-1, tgt[..., None])[..., 0].mean()


class LongContextLM:
    """The LM with its train step, on one device.

    >>> lm = LongContextLM(seq_len=2048, vocab_size=32000, d_model=1024)
    >>> loss = lm.train_step(tokens)          # tokens [B, 2048]
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
        if seq_len is None:
            raise TypeError("LongContextLM needs seq_len")
        self.device = resolve_device(device)
        self.mesh, self.seq_len = mesh, seq_len
        self.moe_aux_weight = moe_aux_weight
        self.model = make_lm(mesh, dtype=dtype, **config).to(self.device)
        m = self.model
        self.cfg = LMConfig(vocab_size=m.vocab_size, d_model=m.d_model, n_heads=m.n_heads,
                            n_layers=m.n_layers, d_ff=m.d_ff, dtype=m.dtype,
                            n_kv_heads=m.n_kv_heads)
        m.load_state_dict(state_dict_of(init_lm_params(
            self.cfg, seed=seed, device=self.device, num_experts=m.num_experts,
            moe_every=m.moe_every)))
        self.optimizer = make_adamw(m.parameters(), learning_rate, self.device)
        self.step = 0
        self._serve: Optional[tuple] = None  # (step, {form: params tree})

    def _tokens(self, tokens) -> torch.Tensor:
        t = torch.as_tensor(tokens, device=self.device)
        if t.ndim != 2:
            raise ValueError(f"tokens must be [B, T], got {tuple(t.shape)}")
        return t

    def forward(self, tokens) -> torch.Tensor:
        """Logits [B, T, vocab] f32."""
        with torch.no_grad():
            return self.model(self._tokens(tokens))

    def loss(self, tokens) -> torch.Tensor:
        """The training objective on `tokens`, differentiable: the
        next-token loss plus `moe_aux_weight` times the mean of the MoE
        blocks' load-balance losses (none without experts). Without that
        term the top-2 router can collapse onto one expert and drop
        tokens."""
        t = self._tokens(tokens)
        logits, aux = self.model(t, return_aux=True)
        loss = lm_loss(logits, t)
        if aux:
            loss = loss + self.moe_aux_weight * (sum(aux) / len(aux))
        return loss

    def train_step(self, tokens) -> float:
        """One AdamW step on the next-token loss; returns the loss before
        the step."""
        self.optimizer.zero_grad(set_to_none=True)
        loss = self.loss(tokens)
        loss.backward()
        self.optimizer.step()
        self.step += 1
        return float(loss.detach())

    # ---- state ----

    def _params(self) -> Dict[str, torch.Tensor]:
        return {n: p.detach() for n, p in self.model.named_parameters()}

    @property
    def state(self) -> Dict[str, Any]:
        named = list(self.model.named_parameters())
        return {"params": self._params(), "opt_state": adam_state(self.optimizer, named),
                "step": self.step}

    @state.setter
    def state(self, state: Mapping[str, Any]) -> None:
        self.model.load_state_dict(state["params"])
        load_adam_state(self.optimizer, list(self.model.named_parameters()),
                        state["opt_state"])
        self.step = int(state["step"])
        self._serve = None

    def save_checkpoint(self, directory: str, keep: int = 3) -> str:
        return CheckpointManager(directory, keep=keep).save(self.step, self.state)

    def restore_checkpoint(self, directory: str, step: Optional[int] = None) -> int:
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
        cast once to the model dtype for serving, as the JAX package does (a second copy stays resident; `serve_dtype_cast=False`
        serves the training weights themselves); `quantize_weights=True`
        serves weight-only int8, `kv_quant=True` an int8 KV cache.
        Serving forms are cached per training step."""
        cfg = dataclasses.replace(self.cfg, kv_quant=kv_quant)
        params = self._serving_params(quantized=quantize_weights, cast=serve_dtype_cast)
        prompt = torch.as_tensor(np.asarray(prompt, dtype=np.int32), device=self.device)
        toks = _generate(params, cfg, prompt, max_new_tokens, temperature=temperature,
                         top_k=top_k, seed=seed)
        return toks.cpu().numpy()

    def _serving_params(self, quantized: bool, cast: bool) -> Dict[str, Any]:
        """The serving form of the weights (int8, model-dtype cast, or the
        training weights themselves, zero-copy), cached against the
        training step so serving after more training derives it again."""
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

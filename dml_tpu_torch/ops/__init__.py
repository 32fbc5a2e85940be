"""Hand-written Hopper kernels and their plain PyTorch versions.

- `preprocess.fused_normalize`: uint8 image -> normalized bf16/f32 in
  one pass (csrc/normalize.cu), the counterpart of the JAX package's
  Pallas `_normalize_kernel`; the engine reaches it through `normalize`,
  the image Trainer through `normalize_sharded`.
- `flash_attention.flash_attention(_lse)`: blockwise attention forward
  with an online softmax (csrc/flash_attention.cu), the counterpart of
  the Pallas flash `_fwd_kernel`; runs in the LM's prefill.
- `decode_attention.decode_attention`: one decode step against the
  head-major KV cache, bf16/f32/int8 (csrc/decode_attention.cu), the
  counterpart of the Pallas `_decode_kernel`; runs in every decode step.
"""

"""Hand-written Hopper kernels and their plain PyTorch versions.

- `preprocess.fused_normalize`: uint8 image -> normalized bf16/f32 in
  one pass (csrc/normalize.cu), the counterpart of the JAX package's
  Pallas `_normalize_kernel`.
"""

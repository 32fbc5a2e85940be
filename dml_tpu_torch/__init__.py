"""PyTorch/CUDA port of dml_tpu, for an NVIDIA H100.

Mirrors the JAX package's layout (`models/`, `ops/`, `inference/`,
`parallel/`, `data.py`) so each module's counterpart is found by name.
It imports torch and numpy and nothing of the JAX package. The kernels that the JAX package wrote
in Pallas for the TPU are written here by hand for Hopper (CUDA C++
sources in `csrc/`, built with nvcc at first use); everything XLA
compiled there is an ordinary PyTorch call here.
"""

"""Training: `long_context.LongContextLM` (the LM's train step with the
flash kernels forward and backward, on one device) and
`checkpoint.CheckpointManager` (atomic, retained, step-indexed
checkpoints). Multi-device forms (the mesh, sequence parallelism) are
not ported yet."""

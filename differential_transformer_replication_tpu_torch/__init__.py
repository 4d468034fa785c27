"""PyTorch/CUDA port of the differential-transformer system.

A second package beside the JAX reference
(``differential_transformer_replication_tpu``): same module names, same
param and cache layouts at every public function, PyTorch idiom inside,
and a hand-written Hopper kernel (CUDA C++ or Triton) for every TPU
kernel on the ported paths. It imports ``torch`` and never ``jax``, and
nothing of the JAX package. Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``; kernel wrappers dispatch by the device
of their tensors (GPU kernel on CUDA, plain PyTorch version on CPU).
"""

"""Ops of the PyTorch port: plain tensor functions, and the four
kernel-holding modules (``fused_norm_residual``, ``fused_ffn``,
``flash``, ``decode_attention``) whose wrappers launch a hand-written
Hopper kernel on a CUDA tensor and run their plain version on a CPU
tensor, forward and (where the TPU kernel has one) backward."""

"""w8 helpers and the hand-written Hopper kernels.

``w8_kernel`` (the W8A8 GEMM) and ``decode_step`` (the whole decode step)
each hold a wrapper that launches its CUDA kernel for tensors on the card
and uses the plain PyTorch version beside it for tensors on the CPU.
"""

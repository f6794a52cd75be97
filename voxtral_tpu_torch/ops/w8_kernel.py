"""K2: the W8A8 GEMM, a hand-written CUDA kernel for Hopper.

Replaces ``voxtral_tpu/ops/w8_pallas.py::w8_matmul_pallas`` (the Pallas
kernel ``_w8_kernel``):

    y[m, n] = float(sum_k xq[m, k] * codes[n, k]) * sx[m] * scale[n]

with the sum exact in int32.  On the TPU the kernel ran only the
first-token lm_head; here it runs every w8 linear of the model (encoder,
adapter, prefill, ADA vectors, lm_head), since CUDA PyTorch has no
int8 x int8 -> int32 matmul.  Source: ``csrc/w8_matmul.cu``.

What bounds it on the H100: at decode shapes (M <= 64) the bytes of int8
weights streamed from HBM (the 131072 x 3072 lm_head is 403 MB per
call); the kernel is a GEMV that reads each weight byte once with
16-byte loads — a warp per output row with ``__dp4a`` up to 8 rows, a
warp per 8 output rows with int8 tensor-core ``mma.sync`` above (the
38-row prefill, speculative rows).  At encoder shapes (M in the
hundreds) the integer dot rate: the kernel is a 64 x 64 shared-memory
tiled ``__dp4a`` GEMM; tensor cores there (``mma.sync`` / ``wgmma``)
are later work.
"""

from __future__ import annotations

import ctypes

import torch

from voxtral_tpu_torch.ops._build import check, kernel_fn

_P = ctypes.c_void_p
_I = ctypes.c_int

# Exact integer products through float32: each partial sum over a chunk
# of <= 1024 int8 x int8 products is an integer below 1024 * 127**2 <
# 2**24, so float32 holds it exactly (TF32 off).
_EXACT_F32_CHUNK = 1024


def int8_dot(xq: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """Exact int32 ``xq [M, K] @ codes [N, K]^T`` with plain PyTorch ops."""
    if xq.device.type == "cpu":
        return xq.to(torch.int32) @ codes.to(torch.int32).T
    # CUDA PyTorch has no integer matmul: exact float32 matmuls over K
    # chunks, summed in float64 (the partials are exact integers).
    acc = None
    for k0 in range(0, xq.shape[1], _EXACT_F32_CHUNK):
        k1 = k0 + _EXACT_F32_CHUNK
        part = (xq[:, k0:k1].float() @ codes[:, k0:k1].float().T).double()
        acc = part if acc is None else acc + part
    return acc.to(torch.int32)


def w8_matmul_plain(xq: torch.Tensor, sx: torch.Tensor, codes: torch.Tensor,
                    scale: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel (same epilogue order)."""
    z = int8_dot(xq, codes)
    return z.float() * sx.reshape(-1, 1).float() * scale.float()


def _check_operands(xq, sx, codes, scale):
    if xq.dtype != torch.int8 or codes.dtype != torch.int8:
        raise TypeError(f"w8_matmul: int8 operands required, got "
                        f"{xq.dtype} and {codes.dtype}")
    if sx.dtype != torch.float32 or scale.dtype != torch.float32:
        raise TypeError("w8_matmul: sx and scale must be float32")
    if xq.dim() != 2 or codes.dim() != 2 or xq.shape[1] != codes.shape[1]:
        raise ValueError(f"w8_matmul: shapes {tuple(xq.shape)} x "
                         f"{tuple(codes.shape)} do not contract")
    m, n = xq.shape[0], codes.shape[0]
    if sx.numel() != m or scale.numel() != n:
        raise ValueError("w8_matmul: scale sizes do not match M / N")
    devs = {t.device for t in (xq, sx, codes, scale)}
    if len(devs) != 1:
        raise ValueError(f"w8_matmul: operands on several devices {devs}")


def w8_matmul(xq: torch.Tensor, sx: torch.Tensor, codes: torch.Tensor,
              scale: torch.Tensor) -> torch.Tensor:
    """xq [M, K] i8, sx [M, 1] f32, codes [N, K] i8, scale [N] f32
    -> [M, N] f32.

    CPU tensors take :func:`w8_matmul_plain`; CUDA tensors launch the
    kernel (and count the launch in ``w8_matmul.launches``) or raise.
    """
    _check_operands(xq, sx, codes, scale)
    dev = xq.device
    if dev.type == "cpu":
        return w8_matmul_plain(xq, sx, codes, scale)
    if dev.type != "cuda":
        raise RuntimeError(f"w8_matmul: unsupported device {dev}")
    for name, t in (("xq", xq), ("sx", sx), ("codes", codes),
                    ("scale", scale)):
        if not t.is_contiguous():
            raise ValueError(f"w8_matmul: {name} must be contiguous")
    m, k = xq.shape
    n = codes.shape[0]
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        fn = kernel_fn("vx_w8_matmul", [_P] * 5 + [_I] * 3 + [_P])
        stream = torch.cuda.current_stream(dev).cuda_stream
        check(fn(xq.data_ptr(), sx.data_ptr(), codes.data_ptr(),
                 scale.data_ptr(), out.data_ptr(), m, n, k, stream),
              "w8_matmul")
    w8_matmul.launches += 1
    return out


w8_matmul.launches = 0

"""K3: the fused Q4_0 dequant + matmul, a hand-written CUDA kernel for
Hopper.

Replaces ``voxtral_tpu/ops/q4_pallas.py::q4_matmul_pallas`` (the Pallas
kernel ``_q4_matmul_kernel``) on packed weights:

    codes_packed int32 [K/8, N]: word (i, n) holds (code[n, 8i + j] + 8)
                                 in nibble j (bits 4j .. 4j + 3);
    scales_t     bf16  [K/32, N]: the group scales, transposed.

It computes what the TPU kernel computes, at its rounding points, in
natural k order (the TPU kernel's plane permutation is a layout trick):

    y[m, n] = sum_k bf16(x[m, k]) * bf16(nib[k, n] * s[k/32, n])
              - sum_b xb8[m, b] * s[b, n],
    xb8[m, b] = 8 * (sum of the f32 x[m, 32b .. 32b + 31])

where ``nib`` is the unsigned nibble 0..15 and the second sum is the
exact contribution of the constant -8 offset.  The scales are bf16
because the packed format rounds the on-disk f16 scales once
(:func:`transpose_scales`, as the JAX package does); the exact f16
scales are the ``q4g`` format's (K1 mode (h)).  Source:
``csrc/q4_matmul.cu``; the dispatch sends it at most
``ops.q4.DECODE_MAX_ROWS`` = 8 rows (decode linears and the lm_head).

What bounds it on the H100: the packed weights streamed from HBM, 0.5625
bytes per weight with the scales (1.93 GB per full-width decode step,
0.576 ms at 3.35 TB/s).  The simple design: a block of 8 warps per 32
output columns, each lane one column (a warp reads 128 contiguous bytes
of a packed row), the warps splitting K by groups of 32; x staged in
shared memory in K chunks, rounded to bf16 there; the float sums in f64
(exact products, rounded once) so kernel and plain version agree bit
for bit.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from voxtral_tpu_torch.ops._build import check, kernel_fn

_P = ctypes.c_void_p
_I = ctypes.c_int

MAX_ROWS = 8  # rows of x per launch (ops.q4.DECODE_MAX_ROWS)


# ---------------------------------------------------------------------------
# Host-side packing (numpy)
# ---------------------------------------------------------------------------


def pack_codes(codes: np.ndarray) -> np.ndarray:
    """int8 codes [N, K] (-8..7) -> transposed packed int32 [K/8, N].

    Word (i, n) = sum_j (codes[n, 8i+j] + 8) << (4*j).
    """
    n, k = codes.shape
    assert k % 8 == 0
    c = (codes.astype(np.int64) + 8).T.reshape(k // 8, 8, n)  # [K/8, 8, N]
    shifts = (4 * np.arange(8, dtype=np.int64))[None, :, None]
    words = np.sum(c << shifts, axis=1)
    return words.astype(np.uint32).view(np.int32)


def unpack_codes(packed: np.ndarray) -> np.ndarray:
    """Inverse of :func:`pack_codes` -> int8 [N, K]."""
    k8, n = packed.shape
    u = packed.view(np.uint32).astype(np.int64)  # [K/8, N]
    planes = [((u >> (4 * j)) & 0xF) - 8 for j in range(8)]
    out = np.stack(planes, axis=1).reshape(8 * k8, n)  # [K, N]
    return out.T.astype(np.int8).copy()


def transpose_scales(scales: np.ndarray) -> np.ndarray:
    """[N, K/32] f16 -> [K/32, N] bf16 (one round-to-nearest, as the JAX
    package's packed format stores them)."""
    import ml_dtypes

    return np.ascontiguousarray(scales.T.astype(ml_dtypes.bfloat16))


# ---------------------------------------------------------------------------
# Packed-format helpers (plain PyTorch)
# ---------------------------------------------------------------------------


def supported(x: torch.Tensor, q4: dict) -> bool:
    """The kernel's shape gate (JAX ``pallas_supported``): K % 256 == 0
    and N % 128 == 0; the tiny ADA matmuls stay plain."""
    if "codes_packed" not in q4:
        return False
    k8, n = q4["codes_packed"].shape
    k = 8 * k8
    return k % 256 == 0 and n % 128 == 0 and x.shape[-1] == k


def _unpack_planes(packed: torch.Tensor) -> torch.Tensor:
    """int32 [K/8, ...] -> unsigned nibbles [K, ...] (int32, 0..15) in
    natural k order (k = 8i + j)."""
    k8 = packed.shape[0]
    planes = [(packed >> (4 * j)) & 0xF for j in range(8)]
    return torch.stack(planes, dim=1).reshape(8 * k8, *packed.shape[1:])


def q4_packed_dequant_rows(q4: dict, rows: torch.Tensor,
                           dtype=torch.bfloat16) -> torch.Tensor:
    """Gather + dequant rows (along N) of a packed table -> [..., K]."""
    packed = q4["codes_packed"][:, rows]  # [K/8, ...]
    scales = q4["scales_t"][:, rows]  # [K/32, ...]
    codes = _unpack_planes(packed) - 8  # [K, ...]
    deq = codes.to(dtype) * torch.repeat_interleave(scales, 32,
                                                    dim=0).to(dtype)
    return deq.movedim(0, -1)


def q4_packed_dequant_full(q4: dict, dtype=torch.bfloat16) -> torch.Tensor:
    """The dequantized weight [N, K] (the prefill path's operand)."""
    codes = _unpack_planes(q4["codes_packed"]) - 8  # [K, N]
    scales = torch.repeat_interleave(q4["scales_t"].to(dtype), 32, dim=0)
    return (codes.to(dtype) * scales).T


# ---------------------------------------------------------------------------
# Plain PyTorch version and the kernel wrapper
# ---------------------------------------------------------------------------


def q4_matmul_plain(x: torch.Tensor, packed: torch.Tensor,
                    scales_t: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel, at its rounding points, sums
    in f64 rounded once to f32.  x [M, K] -> [M, N] f32."""
    m, k = x.shape
    xf = x.float()
    w = _unpack_planes(packed).to(torch.bfloat16) * torch.repeat_interleave(
        scales_t, 32, dim=0).to(torch.bfloat16)  # bf16 [K, N]
    main = (xf.to(torch.bfloat16).double() @ w.double()).float()
    xb8 = xf.reshape(m, k // 32, 32).double().sum(dim=-1).float() * 8.0
    corr = (xb8.double() @ scales_t.double()).float()
    return main - corr


def _check_operands(x, packed, scales_t):
    if packed.dtype != torch.int32 or scales_t.dtype != torch.bfloat16:
        raise TypeError(f"q4_matmul: int32 packed codes and bf16 scales "
                        f"required, got {packed.dtype} and {scales_t.dtype}")
    if x.dim() != 2 or packed.dim() != 2 or scales_t.dim() != 2:
        raise ValueError("q4_matmul: x, packed and scales_t must be 2-D")
    m, k = x.shape
    k8, n = packed.shape
    if 8 * k8 != k or tuple(scales_t.shape) != (k // 32, n):
        raise ValueError(f"q4_matmul: x {tuple(x.shape)}, packed "
                         f"{tuple(packed.shape)} and scales_t "
                         f"{tuple(scales_t.shape)} do not match")
    devs = {t.device for t in (x, packed, scales_t)}
    if len(devs) != 1:
        raise ValueError(f"q4_matmul: operands on several devices {devs}")


def q4_matmul_packed(x: torch.Tensor, packed: torch.Tensor,
                     scales_t: torch.Tensor) -> torch.Tensor:
    """x [M, K] (any float dtype, M <= 8), packed [K/8, N] int32,
    scales_t [K/32, N] bf16 -> [M, N] f32.

    CPU tensors take :func:`q4_matmul_plain`; CUDA tensors launch the
    kernel (and count the launch in ``q4_matmul_packed.launches``) or
    raise.
    """
    _check_operands(x, packed, scales_t)
    dev = x.device
    if dev.type == "cpu":
        return q4_matmul_plain(x, packed, scales_t)
    if dev.type != "cuda":
        raise RuntimeError(f"q4_matmul: unsupported device {dev}")
    m, k = x.shape
    n = packed.shape[1]
    if not (1 <= m <= MAX_ROWS and k % 256 == 0 and n % 128 == 0):
        raise ValueError(f"q4_matmul: the kernel takes 1..{MAX_ROWS} rows, "
                         f"K % 256 == 0 and N % 128 == 0; got M={m} K={k} "
                         f"N={n}")
    for name, t in (("packed", packed), ("scales_t", scales_t)):
        if not t.is_contiguous():
            raise ValueError(f"q4_matmul: {name} must be contiguous")
    xf = x.float().contiguous()
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        fn = kernel_fn("vx_q4_matmul", [_P] * 4 + [_I] * 3 + [_P])
        stream = torch.cuda.current_stream(dev).cuda_stream
        check(fn(xf.data_ptr(), packed.data_ptr(), scales_t.data_ptr(),
                 out.data_ptr(), m, n, k, stream), "q4_matmul")
    q4_matmul_packed.launches += 1
    return out


q4_matmul_packed.launches = 0

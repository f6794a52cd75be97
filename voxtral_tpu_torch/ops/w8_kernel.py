"""K2: the W8A8 GEMM, a hand-written CUDA kernel for Hopper.

Replaces ``voxtral_tpu/ops/w8_pallas.py::w8_matmul_pallas`` (the Pallas
kernel ``_w8_kernel``):

    y[m, n] = float(sum_k xq[m, k] * codes[n, k]) * sx[m] * scale[n]

with the sum exact in int32.  On the TPU the kernel ran only the
first-token lm_head; here it runs every w8 linear of the model (encoder,
adapter, prefill, ADA vectors, lm_head), since CUDA PyTorch has no
int8 x int8 -> int32 matmul.  Source: ``csrc/w8_matmul.cu``.

What bounds it on the H100: up to 16 rows (decode, the ADA vectors,
the lm_head) the bytes of int8 weights streamed from HBM (the 131072 x
3072 lm_head is 403 MB per call); the kernel is a GEMV that reads each
weight byte once with 16-byte loads (a warp per output row with
``__dp4a`` up to 8 rows, a warp per 8 output rows with int8 tensor-core
``mma.sync`` above).  Above 16 rows (encoder, adapter, prefill) the
int8 operation count and the operands' bytes, a few microseconds each:
a Hopper GEMM with ``wgmma`` m64n128k32 int8 tiles fed by TMA loads
through an mbarrier ring, and an exact split-K where the output tiles
are fewer than the SMs (the K slices of a tile form a cluster and add
their int32 tiles in slice order through distributed shared memory).
:func:`k2_plan` picks the route and the split from the shape, before
the launch.
"""

from __future__ import annotations

import ctypes

import torch

from voxtral_tpu_torch.ops._build import check, kernel_fn

_P = ctypes.c_void_p
_I = ctypes.c_int

# K2's routes (csrc/w8_matmul.cu): the GEMVs of csrc/w8_common.cuh, the
# tensor-core GEMM with 64- or 128-row output tiles (128 columns each).
ROUTE_GEMV, ROUTE_WGMMA64, ROUTE_WGMMA128 = 0, 1, 2
ROUTE_NAMES = {ROUTE_GEMV: "GEMV", ROUTE_WGMMA64: "wgmma 64x128",
               ROUTE_WGMMA128: "wgmma 128x128"}
GEMM_MIN_ROWS = 16    # up to this many rows the product is a weight stream
N_SMS = 132           # H100 SXM
MAX_SLICES = 8        # K slices of one tile: a portable cluster
_BK = _BN = 128       # K bytes per pipeline stage, output columns per tile
_MIN_KB_PER_SLICE = 4  # a K slice walks at least 512 bytes of K

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


def _tiles(m: int, n: int, route: int) -> int:
    bm = 64 if route == ROUTE_WGMMA64 else 128
    return -(-m // bm) * -(-n // _BN)


def k2_plan(m: int, n: int, k: int, aligned: bool = True) -> tuple:
    """(route, K slices) of K2 at M x K x N, from the shape alone.

    Up to :data:`GEMM_MIN_ROWS` rows, K % 32 != 0 or rows not 16-byte
    aligned (``aligned`` False): the GEMVs.  Else the tensor-core GEMM,
    64-row tiles up to 64 rows and 128-row tiles above, its K cut into as
    many slices (at most 8, one cluster a tile) as keep the tiles x
    slices within the SMs, each slice at least 512 bytes of K, all slices
    the same length but the last."""
    if m <= GEMM_MIN_ROWS or k % 32 or not aligned:
        return ROUTE_GEMV, 1
    route = ROUTE_WGMMA64 if m <= 64 else ROUTE_WGMMA128
    kb = -(-k // _BK)
    splits = max(1, min(N_SMS // _tiles(m, n, route),
                        kb // _MIN_KB_PER_SLICE, MAX_SLICES))
    per = -(-kb // splits)
    return route, -(-kb // per)


def _aligned(*ts) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in ts)


def _launch(xq, sx, codes, scale, route: int, splits: int) -> torch.Tensor:
    """Launch K2 on ``route`` with ``splits`` K slices and count the
    launch."""
    m, k = xq.shape
    n = codes.shape[0]
    dev = xq.device
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        fn = kernel_fn("vx_w8_matmul", [_P] * 5 + [_I] * 5 + [_P])
        stream = torch.cuda.current_stream(dev).cuda_stream
        check(fn(xq.data_ptr(), sx.data_ptr(), codes.data_ptr(),
                 scale.data_ptr(), out.data_ptr(), m, n, k, route, splits,
                 stream),
              "w8_matmul")
    w8_matmul.launches += 1
    return out


def _check_cuda(xq, sx, codes, scale) -> None:
    dev = xq.device
    if dev.type != "cuda":
        raise RuntimeError(f"w8_matmul: unsupported device {dev}")
    for name, t in (("xq", xq), ("sx", sx), ("codes", codes),
                    ("scale", scale)):
        if not t.is_contiguous():
            raise ValueError(f"w8_matmul: {name} must be contiguous")


def w8_matmul(xq: torch.Tensor, sx: torch.Tensor, codes: torch.Tensor,
              scale: torch.Tensor) -> torch.Tensor:
    """xq [M, K] i8, sx [M, 1] f32, codes [N, K] i8, scale [N] f32
    -> [M, N] f32.

    CPU tensors take :func:`w8_matmul_plain`; CUDA tensors launch the
    kernel on the route :func:`k2_plan` gives the shape (and count the
    launch in ``w8_matmul.launches``) or raise.
    """
    _check_operands(xq, sx, codes, scale)
    if xq.device.type == "cpu":
        return w8_matmul_plain(xq, sx, codes, scale)
    _check_cuda(xq, sx, codes, scale)
    return _launch(xq, sx, codes, scale,
                   *w8_matmul_route(xq, codes))


def w8_matmul_route(xq: torch.Tensor, codes: torch.Tensor) -> tuple:
    """(route, K slices) :func:`w8_matmul` launches for these operands."""
    return k2_plan(xq.shape[0], codes.shape[0], xq.shape[1],
                   _aligned(xq, codes))


def w8_matmul_on(route: int, xq: torch.Tensor, sx: torch.Tensor,
                 codes: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """K2 on a route the caller names, one K slice (``chip_smoke.py``
    times the GEMV beside the GEMM at 16 < M <= 64 rows with it); the
    launch counts as any other.  The C entry refuses a GEMM route the
    shape cannot take."""
    _check_operands(xq, sx, codes, scale)
    _check_cuda(xq, sx, codes, scale)
    return _launch(xq, sx, codes, scale, route, 1)


w8_matmul.launches = 0

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
0.576 ms at 3.35 TB/s); at 8 rows the f32 FFMAs.  The design: a warp per
128 output columns, each lane loading 16 bytes of a packed row (four
columns) several groups ahead; the nibbles turned into bf16(nib * s) two
at a time by one bf16x2 FMA; K split over the warps of a block and over
a thread-block cluster (:func:`k3_plan`) so that every shape fills the
card, the partials merged in a fixed order.  Each packed row's 8
products are summed in f32 in k order, a group's four row sums in f32,
and the groups (with the offset correction) in f64, rounded once
(:func:`q4_matmul_plain` states the same order), so kernel and plain
version agree bit for bit.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from voxtral_tpu_torch.ops._build import check, kernel_fn

_P = ctypes.c_void_p
_I = ctypes.c_int

MAX_ROWS = 8  # rows of x per launch (ops.q4.DECODE_MAX_ROWS)
TILE_COLS = 128  # output columns of a warp
MAX_WARPS = 8    # warps of a block
MAX_SPLITS = 8   # blocks of a cluster along K
SM_COUNT = 132   # the H100 SXM's; the wrapper asks the card
_N_CHUNK = 32768  # columns of the plain version's working set


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
    """Plain PyTorch version of the kernel, at its rounding points and in
    its summation order.  x [M, K] -> [M, N] f32:

        R[m, g, r, n] = the f32 sum, k = 32 g + 8 r .. 32 g + 8 r + 7 in
                     order, of the exact products bf16(x[m, k]) *
                     bf16(nib[k, n] * s[g, n]) (packed row 4 g + r)
        G[m, g, n] = ((R_0 + R_1) + R_2) + R_3 in f32
        xb8[m, g]  = 8 * f32(the f64 sum of x[m, 32 g .. 32 g + 31])
        y[m, n]    = f32(sum_g (G[m, g, n] - xb8[m, g] * s[g, n])) in f64

    The f64 group sum is exact while the terms stay within about 2^21 of
    one another, so its order does not matter; the f32 sums are the only
    order-dependent rounding and are stated as the kernel's (the JAX
    kernel sums the whole dot in f32 on the MXU).  Eight sequential
    steps over the four rows at once, then three adds: the launches of
    this version on the card are what its time is made of."""
    m, k = x.shape
    g = k // 32
    xf = x.float()
    xb4 = xf.to(torch.bfloat16).float().reshape(m, g, 4, 8)
    xb8 = (xf.reshape(m, g, 32).double().sum(dim=-1).float() * 8.0).double()
    shifts = torch.arange(0, 32, 4, dtype=torch.int32, device=x.device)
    cols = []
    for n0 in range(0, packed.shape[1], _N_CHUNK):
        sc = scales_t[:, n0:n0 + _N_CHUNK]
        # Nibble j of word i is k = 8 i + j: [K/8, 8, n] -> [G, 32, n].
        nib = (packed[:, None, n0:n0 + _N_CHUNK] >> shifts[:, None]) & 0xF
        w = (nib.reshape(g, 32, -1).to(torch.bfloat16)
             * sc[:, None, :].to(torch.bfloat16)).float()
        w = w.reshape(g, 4, 8, -1)  # [G, packed row, k in the row, n]
        rs = torch.zeros((m, g, 4, w.shape[-1]), dtype=torch.float32,
                         device=x.device)
        for j in range(8):
            # The exact products added in k order, in f32: a product of
            # two bf16 values is exact, so addcmul rounds only the add.
            torch.addcmul(rs, xb4[:, :, :, j, None], w[None, :, :, j, :],
                          out=rs)
        gs = ((rs[:, :, 0] + rs[:, :, 1]) + rs[:, :, 2]) + rs[:, :, 3]
        terms = gs.double() - xb8[:, :, None] * sc.double()[None]
        cols.append(terms.sum(dim=1).float())
    return torch.cat(cols, dim=1)


def k3_plan(m: int, n: int, k: int, sms: int = SM_COUNT) -> tuple:
    """(tw, kw, splits) of a K3 launch, from the built library
    (``vx_q4_plan``, ``csrc/q4_matmul.cu::q4_plan``, which also owns the
    shared-memory layout it must fit): blocks of tw x kw warps, tw column
    tiles of 128 each walked by kw warps over disjoint groups of K, and a
    cluster of ``splits`` blocks along K, sized so that every shape fills
    ``sms`` SMs.  ValueError where no plan fits."""
    out = (ctypes.c_int * 4)()
    code = _plan_entry()(m, n, k, sms, ctypes.cast(out, ctypes.c_void_p))
    if code:
        raise ValueError(f"q4_matmul: no plan for M={m} N={n} K={k} (a "
                         f"block's slice of x does not fit its shared "
                         f"memory, or the shape is not the kernel's)")
    return out[0], out[1], out[2]


@functools.lru_cache(maxsize=1)
def _plan_entry():
    return kernel_fn("vx_q4_plan", [_I] * 4 + [_P])


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
    kernel on :func:`k3_plan`'s plan (and count the launch in
    ``q4_matmul_packed.launches``) or raise.
    """
    _check_operands(x, packed, scales_t)
    dev = x.device
    if dev.type == "cpu":
        return q4_matmul_plain(x, packed, scales_t)
    if dev.type != "cuda":
        raise RuntimeError(f"q4_matmul: unsupported device {dev}")
    m, k = x.shape
    return q4_matmul_on(_plan(m, packed.shape[1], k, dev), x, packed,
                        scales_t)


q4_matmul_packed.launches = 0


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _plan_at(m: int, n: int, k: int, sms: int) -> tuple:
    return k3_plan(m, n, k, sms)


def _plan(m: int, n: int, k: int, dev: torch.device) -> tuple:
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    return _plan_at(m, n, k, _sm_count(index))


def q4_matmul_on(plan: tuple, x: torch.Tensor, packed: torch.Tensor,
                 scales_t: torch.Tensor) -> torch.Tensor:
    """K3 on CUDA tensors with a given plan (tw, kw, splits): the launch
    :func:`q4_matmul_packed` makes with :func:`k3_plan`'s, or any other
    (tests, tuning).  Counts in ``q4_matmul_packed.launches``."""
    m, k = x.shape
    n = packed.shape[1]
    dev = x.device
    if not (1 <= m <= MAX_ROWS and k % 256 == 0 and n % 128 == 0):
        raise ValueError(f"q4_matmul: the kernel takes 1..{MAX_ROWS} rows, "
                         f"K % 256 == 0 and N % 128 == 0; got M={m} K={k} "
                         f"N={n}")
    if not (packed.is_contiguous() and scales_t.is_contiguous()):
        raise ValueError("q4_matmul: packed and scales_t must be contiguous")
    if packed.data_ptr() % 16 or scales_t.data_ptr() % 8:
        raise ValueError("q4_matmul: packed must be 16-byte and scales_t "
                         "8-byte aligned")
    tw, kw, splits = plan
    if (tw * kw > MAX_WARPS or not 1 <= splits <= MAX_SPLITS
            or n % (TILE_COLS * tw)):
        raise ValueError(f"q4_matmul: plan {plan} does not take M={m} "
                         f"N={n} K={k}")
    xf = x if x.dtype == torch.float32 and x.is_contiguous() else (
        x.float().contiguous())
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    if dev.index is None or dev.index == torch.cuda.current_device():
        code = _launch(xf, packed, scales_t, out, m, n, k, plan, dev)
    else:
        with torch.cuda.device(dev):
            code = _launch(xf, packed, scales_t, out, m, n, k, plan, dev)
    check(code, "q4_matmul")
    q4_matmul_packed.launches += 1
    return out


def _launch(xf, packed, scales_t, out, m, n, k, plan, dev) -> int:
    stream = torch.cuda.current_stream(dev).cuda_stream
    return _entry()(xf.data_ptr(), packed.data_ptr(), scales_t.data_ptr(),
                    out.data_ptr(), m, n, k, *plan, stream)


@functools.lru_cache(maxsize=1)
def _entry():
    return kernel_fn("vx_q4_matmul", [_P] * 4 + [_I] * 6 + [_P])

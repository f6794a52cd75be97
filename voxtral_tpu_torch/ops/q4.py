"""Q4_0 quantized weights: repacking, dequant and the q4 matmul dispatch
(port of ``voxtral_tpu/ops/q4.py``).

GGUF Q4_0 on-disk format: 18 bytes per block of 32 elements along the
innermost (K) axis — a little-endian f16 scale followed by 16 bytes of
packed nibbles; byte ``i`` holds element ``i`` in its low nibble and
element ``i+16`` in its high nibble; ``value = (nibble - 8) * scale``.

Two leaf forms, as in the JAX package (``N`` = out, ``K`` = in
features; ``y = x @ W^T``):

* unpacked ``{"q4": {"codes": int8[N, K] (-8..7), "scales": f16[N, K/32]}}``
  — the exact re-encoding of Q4_0 (the ``q4g`` format, whose decode
  runs K1 mode (h));
* packed ``{"q4": {"codes_packed": int32[K/8, N], "scales_t":
  bf16[K/32, N]}}`` — nibbles packed eight to a word (the ``q4``
  format, whose decode runs K3, :mod:`voxtral_tpu_torch.ops.q4_kernel`).

The dispatch keeps the JAX row split: at most ``DECODE_MAX_ROWS`` rows
take the decode path (K3 for packed leaves, the exact blocked
contraction for unpacked ones); more rows (encoder, adapter, prefill)
dequantize to bf16 and run one f32-accumulated matmul, as the JAX
package leaves those to XLA outside any Pallas kernel.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import numpy as np
import torch

Q4_BLOCK = 32
_BYTES_PER_BLOCK = 18

# Row threshold between the decode (blocked / K3) and prefill (dequant)
# paths.
DECODE_MAX_ROWS = 8

# (x [M, K], codes_packed [K/8, N], scales_t [K/32, N]) -> [M, N] f32:
# the K3 wrapper or its plain version.
Q4MatmulFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor],
                      torch.Tensor]


# ---------------------------------------------------------------------------
# Host-side (numpy) packing / unpacking
# ---------------------------------------------------------------------------


def dequantize_q4_0(raw, num_elements: int) -> np.ndarray:
    """CPU dequant of raw Q4_0 bytes -> f32."""
    raw = np.frombuffer(raw, dtype=np.uint8) if isinstance(raw, bytes) else raw
    n_blocks = num_elements // Q4_BLOCK
    blocks = raw[: n_blocks * _BYTES_PER_BLOCK].reshape(n_blocks,
                                                         _BYTES_PER_BLOCK)
    scales = blocks[:, :2].copy().view(np.float16).astype(np.float32)
    packed = blocks[:, 2:]
    lo = (packed & 0x0F).astype(np.int8) - 8
    hi = ((packed >> 4) & 0x0F).astype(np.int8) - 8
    codes = np.concatenate([lo, hi], axis=1)  # [B, 32] in element order
    return (codes.astype(np.float32) * scales).reshape(-1)


def quantize_q4_0(values: np.ndarray) -> bytes:
    """Quantize f32 -> raw Q4_0 bytes (llama.cpp's Q4_0 rule)."""
    flat = np.asarray(values, dtype=np.float32).reshape(-1)
    assert flat.size % Q4_BLOCK == 0, "Q4_0 needs multiples of 32 elements"
    blocks = flat.reshape(-1, Q4_BLOCK)
    # scale = max_abs_elem / -8 (signed; keeps the extreme exact).
    absmax_idx = np.argmax(np.abs(blocks), axis=1)
    maxval = blocks[np.arange(blocks.shape[0]), absmax_idx]
    d = maxval / -8.0
    d16 = d.astype(np.float16)
    d32 = d16.astype(np.float32)
    with np.errstate(divide="ignore"):
        inv_d = np.where(d32 != 0,
                         np.divide(1.0, np.where(d32 != 0, d32, 1.0)), 0.0)
    q = np.clip(blocks * inv_d[:, None] + 8.5, 0.0, 15.0).astype(np.uint8)
    lo, hi = q[:, :16], q[:, 16:]
    packed = (lo | (hi << 4)).astype(np.uint8)
    out = np.empty((blocks.shape[0], _BYTES_PER_BLOCK), dtype=np.uint8)
    out[:, :2] = d16[:, None].view(np.uint8).reshape(-1, 2)
    out[:, 2:] = packed
    return out.tobytes()


def repack_q4_0(raw, shape: tuple[int, int]) -> dict[str, np.ndarray]:
    """Raw Q4_0 bytes -> {"codes": int8[N, K], "scales": f16[N, K//32]}.

    Scales stay float16, the exact on-disk value.  ``shape`` = [N, K]
    (out, in), already dim-reversed from GGUF order by the caller.
    """
    n, k = shape
    assert k % Q4_BLOCK == 0, f"K={k} not a multiple of {Q4_BLOCK}"
    raw = np.frombuffer(raw, dtype=np.uint8) if isinstance(raw, bytes) else raw
    n_blocks = (n * k) // Q4_BLOCK
    blocks = raw[: n_blocks * _BYTES_PER_BLOCK].reshape(n_blocks,
                                                         _BYTES_PER_BLOCK)
    scales = blocks[:, :2].copy().view(np.float16).reshape(n, k // Q4_BLOCK)
    packed = blocks[:, 2:]
    lo = (packed & 0x0F).astype(np.int8) - 8
    hi = ((packed >> 4) & 0x0F).astype(np.int8) - 8
    codes = np.concatenate([lo, hi], axis=1).reshape(n, k)
    return {"codes": codes, "scales": scales}


def quantize_to_q4_params(w: np.ndarray) -> dict[str, Any]:
    """f32 [N, K] -> an unpacked {"q4": {...}} leaf."""
    return {"q4": repack_q4_0(quantize_q4_0(w), w.shape)}


# ---------------------------------------------------------------------------
# Device-side ops
# ---------------------------------------------------------------------------


def is_q4(w: Any) -> bool:
    return isinstance(w, dict) and "q4" in w


def q4_dequant_rows(q4: dict, rows: torch.Tensor,
                    dtype=torch.bfloat16) -> torch.Tensor:
    """Gather + dequantize rows of a q4 matrix (embedding lookups).

    rows: int [...] -> [..., K] in ``dtype`` (the product rounds to it).
    """
    if "codes_packed" in q4:
        from voxtral_tpu_torch.ops.q4_kernel import q4_packed_dequant_rows

        return q4_packed_dequant_rows(q4, rows, dtype)
    codes = q4["codes"][rows]
    scales = q4["scales"][rows]
    return codes.to(dtype) * torch.repeat_interleave(scales.to(dtype),
                                                     Q4_BLOCK, dim=-1)


def _q4_matmul_blocked(x: torch.Tensor, codes: torch.Tensor,
                       scales: torch.Tensor) -> torch.Tensor:
    """Decode path of unpacked leaves: per-block partial dots of bf16 x
    and codes in f32, then scaled and summed over the blocks in f32.
    x [..., K]; codes [N, K]; scales [N, K/32] -> [..., N] f32."""
    n, k = codes.shape
    nb = k // Q4_BLOCK
    xb = x.to(torch.bfloat16).float().reshape(*x.shape[:-1], nb, Q4_BLOCK)
    cb = codes.float().reshape(n, nb, Q4_BLOCK)
    z = torch.einsum("...bk,nbk->...nb", xb, cb)
    return torch.einsum("...nb,nb->...n", z, scales.float())


def q4g_matmul_a8(x: torch.Tensor, codes: torch.Tensor,
                  scales: torch.Tensor) -> torch.Tensor:
    """Reference of K1 mode (h)'s group-32 math in plain f32 ops: per-row
    int8 activation quantization (the W8A8 formula), exact group dots,
    f16-exact group scales in the f32 epilogue.
    x [..., K]; codes [N, K] int8; scales [N, K/32] f16 -> [..., N] f32.
    """
    from voxtral_tpu_torch.ops.w8 import quantize_activations

    n, k = codes.shape
    nb = k // Q4_BLOCK
    xq, sx = quantize_activations(x)
    # Each group dot is an integer below 32 * 127 * 8 < 2**24: exact in
    # f32 (TF32 off).
    z = torch.einsum("...bk,nbk->...nb",
                     xq.float().reshape(*x.shape[:-1], nb, Q4_BLOCK),
                     codes.float().reshape(n, nb, Q4_BLOCK))
    return torch.einsum("...nb,nb->...n", z, scales.float()) * sx


def _q4_matmul_dequant(x: torch.Tensor, codes: torch.Tensor,
                       scales: torch.Tensor) -> torch.Tensor:
    """Prefill path of unpacked leaves: bf16 weights (each code times its
    bf16 scale, rounded to bf16), one f32-accumulated matmul."""
    w = codes.to(torch.bfloat16) * torch.repeat_interleave(
        scales.to(torch.bfloat16), Q4_BLOCK, dim=-1)
    return x.to(torch.bfloat16).float() @ w.float().T


def q4_matmul(x: torch.Tensor, q4: dict,
              mm: Optional[Q4MatmulFn] = None) -> torch.Tensor:
    """y = x @ W_q4^T; x [..., K] -> [..., N] f32.

    Dispatches on the row count like the JAX package: packed leaves at
    <= ``DECODE_MAX_ROWS`` rows whose shape K3 takes go through ``mm``
    (the K3 wrapper by default, or its plain version); everything else
    is plain PyTorch.
    """
    lead, k = x.shape[:-1], x.shape[-1]
    rows = int(np.prod(lead)) if x.dim() > 1 else 1
    if "codes_packed" in q4:
        from voxtral_tpu_torch.ops import q4_kernel as k3

        packed, scales_t = q4["codes_packed"], q4["scales_t"]
        if rows <= DECODE_MAX_ROWS and k3.supported(x, q4):
            mm = mm or k3.q4_matmul_packed
            y = mm(x.reshape(-1, k), packed, scales_t)
            return y.reshape(*lead, packed.shape[1])
        w = k3.q4_packed_dequant_full(q4)
        return x.to(torch.bfloat16).float() @ w.float().T
    codes, scales = q4["codes"], q4["scales"]
    if rows <= DECODE_MAX_ROWS:
        return _q4_matmul_blocked(x, codes, scales)
    return _q4_matmul_dequant(x, codes, scales)

"""W8A8 linears: rowwise-int8 weights x per-row int8 activations.

Port of ``voxtral_tpu/ops/w8.py``.  Leaf format (as in the JAX package):
``{"w8": {"codes": int8[N, K], "scale": f32[N]}}`` with
``W[n, k] ~= codes[n, k] * scale[n]``.  Activations are quantized per
row with a dynamic absmax scale; the int8 product accumulates exactly in
int32 and both scales fold into the f32 epilogue.  Every w8 linear of
the port — encoder, adapter, prefill, ADA vectors, lm_head — goes
through the W8A8 GEMM of :mod:`voxtral_tpu_torch.ops.w8_kernel` (CUDA
PyTorch has no int8 x int8 -> int32 matmul).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

W8MatmulFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor],
                      torch.Tensor]


def quantize_w8_rowwise(w_nk) -> dict:
    """f32 [..., N, K] -> {"w8": {codes, scale}} with symmetric rowwise
    scales: numpy in, numpy out; a tensor stays a tensor on its device
    (the same arithmetic, the 127 divided as a tensor, as in
    :func:`quantize_activations`)."""
    if isinstance(w_nk, torch.Tensor):
        w = w_nk.float()
        absmax = w.abs().amax(dim=-1)
        scale = absmax / torch.full_like(absmax, 127.0)
        inv = torch.where(scale > 0, 1.0 / scale.clamp(min=1e-30),
                          torch.zeros_like(scale))
        codes = torch.clamp(torch.round(w * inv[..., None]), -127, 127)
        return {"w8": {"codes": codes.to(torch.int8).contiguous(),
                       "scale": scale.contiguous()}}
    absmax = np.abs(w_nk).max(axis=-1)
    scale = (absmax / 127.0).astype(np.float32)
    inv = np.where(scale > 0, 1.0 / np.maximum(scale, 1e-30), 0.0)
    codes = np.clip(np.rint(w_nk * inv[..., None]), -127, 127).astype(np.int8)
    return {"w8": {"codes": codes, "scale": scale}}


def quantize_activations(x: torch.Tensor):
    """Symmetric per-row int8 quantization -> (xq int8, sx f32 [..., 1]).

    ``round(x / sx)`` with a true division and round-half-to-even
    (``torch.round``); ``sx = max(absmax, 1e-8) / 127``.  Multiplying by
    a reciprocal instead would move the ties.  PyTorch's CUDA division by
    a Python scalar multiplies by the scalar's reciprocal, so the 127
    comes as a tensor, which every device divides by exactly.
    """
    xf = x.float()
    absmax = xf.abs().amax(dim=-1, keepdim=True)
    sx = torch.clamp(absmax, min=1e-8) / torch.full_like(absmax, 127.0)
    xq = torch.clamp(torch.round(xf / sx), -127, 127).to(torch.int8)
    return xq, sx


def w8_matmul(x: torch.Tensor, w8: dict,
              mm: Optional[W8MatmulFn] = None) -> torch.Tensor:
    """y = x @ W^T; x [..., K] -> [..., N] f32.

    ``mm`` is the GEMM on quantized operands ``(xq [M, K], sx [M, 1],
    codes, scale) -> [M, N]``: the kernel wrapper by default, or its
    plain version to run the same model without the kernels.
    """
    if mm is None:
        from voxtral_tpu_torch.ops.w8_kernel import w8_matmul as mm
    codes, scale = w8["codes"], w8["scale"]
    xq, sx = quantize_activations(x)
    lead = x.shape[:-1]
    y = mm(xq.reshape(-1, x.shape[-1]).contiguous(), sx.reshape(-1, 1),
           codes, scale)
    return y.reshape(*lead, codes.shape[0])


def w8_dequant_rows(w8: dict, rows: torch.Tensor,
                    dtype=torch.bfloat16) -> torch.Tensor:
    """Gather + dequantize rows (embedding lookups)."""
    codes = w8["codes"][rows]
    scale = w8["scale"][rows]
    return codes.to(dtype) * scale[..., None].to(dtype)

"""Explicit device handling and dtype helpers.

Every function of the port takes its device as an argument; nothing here
sets a global default device.  An entry point given no device runs on
the card (``cuda``); the CPU runs the kernels' plain versions only when
the caller passes ``"cpu"``.  The one process-wide setting the port
makes is :func:`disable_tf32`: float32 matmuls and convolutions run in
full float32, and bfloat16 matmuls sum in full float32, as the JAX
reference computes them.
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike) -> torch.device:
    """``None`` means the card (``cuda``); anything else is passed to
    ``torch.device``.  Without a card, ``None`` raises: there is no
    silent CPU fallback."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available (torch.cuda.is_available() is "
            "False); pass device=\"cpu\" to run the plain PyTorch versions "
            "of the kernels on the CPU")
    return torch.device("cuda")


def disable_tf32() -> None:
    """Turn both TF32 switches and cuBLAS's reduced-precision bf16 sums
    off.

    A float32 matmul on the card runs in full float32 by default, but a
    float32 convolution goes through cuDNN in TF32 (about three decimal
    digits).  ``conv_downsample`` runs in float32, so both switches are
    set here, in one place.  A bf16 x bf16 GEMM may sum in reduced
    precision by default; the dense linears (``models.layers.linear``)
    take cuBLAS's bf16 GEMM as the JAX reference's ``dot`` with
    ``preferred_element_type=f32`` followed by one rounding to bf16, so
    its sums must be float32 too.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def _bf16_numpy_dtype():
    import ml_dtypes

    return np.dtype(ml_dtypes.bfloat16)


def to_torch(arr, device: DeviceLike = None) -> torch.Tensor:
    """numpy array (``ml_dtypes.bfloat16`` included) -> tensor on ``device``.

    ``torch.from_numpy`` refuses ml_dtypes' bfloat16, so those arrays go
    through a uint16 view and come back with ``.view(torch.bfloat16)``.
    """
    a = np.ascontiguousarray(np.asarray(arr))
    if not a.flags.writeable:  # e.g. a view of a JAX array
        a = a.copy()
    if a.dtype == _bf16_numpy_dtype():
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(resolve_device(device))


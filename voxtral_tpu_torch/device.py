"""Explicit device handling and dtype helpers.

Every function of the port takes its device as an argument; nothing here
sets a global default device.  The one process-wide setting the port
makes is :func:`disable_tf32`: float32 matmuls and convolutions run in
full float32, as the JAX reference computes them.
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike) -> torch.device:
    """``None`` means the CPU; anything else is passed to ``torch.device``."""
    return torch.device("cpu") if device is None else torch.device(device)


def disable_tf32() -> None:
    """Turn both TF32 switches off.

    A float32 matmul on the card runs in full float32 by default, but a
    float32 convolution goes through cuDNN in TF32 (about three decimal
    digits).  ``conv_downsample`` runs in float32, so both switches are
    set here, in one place.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


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


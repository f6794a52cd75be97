"""The JAX package's numpy parameter tree -> the port's tensors.

The tree keeps its structure: nested dicts whose leaves are numpy arrays
(``{"w8": {"codes", "scale"}}``, ``{"q4": ...}`` and ``{"nt": w}``
dicts, dense bfloat16 ``ml_dtypes`` and float32 arrays, ``[L, ...]``
stacks).  Each leaf becomes a tensor on ``device`` with the
same dtype, so the two packages run on the same numbers.
"""

from __future__ import annotations

from typing import Any

from voxtral_tpu_torch.device import DeviceLike, resolve_device, to_torch


def params_from_numpy(tree: Any, device: DeviceLike = None) -> Any:
    """Recursively convert a numpy parameter tree to tensors on ``device``."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, dev) for k, v in tree.items()}
    return to_torch(tree, dev)

"""Device-memory admission (port of ``voxtral_tpu/utils/hbm.py``).

A session or pool estimates its footprint before it allocates: weights
(counted once per storage) + the caches it asks for + a workspace
allowance, against the card's memory.  Refusing up front with the
numbers beats an out-of-memory error halfway through a stream.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

# Allowance for the kernels' scratch, logits, RoPE tables, the caching
# allocator's fragmentation: coarse, to catch multi-GB misconfigurations.
WORKSPACE_BYTES = 1 * 2**30


class HBMBudgetError(RuntimeError):
    """Requested geometry cannot fit the device's memory."""


def device_hbm_budget(device=None) -> Optional[int]:
    """Usable bytes on ``device`` (a CUDA device: its total memory), or
    None when no budget applies (the CPU).  ``VOXTRAL_HBM_BYTES``
    overrides, as in the JAX package."""
    env = os.environ.get("VOXTRAL_HBM_BYTES")
    if env:
        return int(env)
    dev = torch.device(device) if device is not None else None
    if dev is None or dev.type != "cuda":
        return None
    return int(torch.cuda.get_device_properties(dev).total_memory)


def tree_unique_bytes(*trees) -> int:
    """Bytes of the tensor leaves across nested dicts and lists, each
    underlying storage counted once (fused stacks may share storage with
    the parameter leaves they were cut from)."""
    seen: set = set()
    total = 0

    def walk(node):
        nonlocal total
        if isinstance(node, dict):
            for v in node.values():
                walk(v)
        elif isinstance(node, (list, tuple)):
            for v in node:
                walk(v)
        elif isinstance(node, torch.Tensor):
            st = node.untyped_storage()
            key = (str(node.device), st.data_ptr())
            if key not in seen:
                seen.add(key)
                total += st.nbytes()

    for tree in trees:
        if tree is not None:
            walk(tree)
    return total


def model_hbm_bytes(model) -> int:
    """Weights resident on the device: params + fused decode stacks (on a
    mesh, every shard's copy: the placed TP stacks, or the DP groups'
    stacks; on a card the shards share, counted once)."""
    return tree_unique_bytes(*(getattr(model, name, None) for name in (
        "params", "fused_decode", "fused_tp", "_dp_stacks")))


def check_hbm(model, cache_bytes: int, what: str, rows: int = 0) -> None:
    """Raise :class:`HBMBudgetError` when weights + ``cache_bytes`` +
    workspace exceed the budget of the model's device; nothing on the
    CPU (unless ``VOXTRAL_HBM_BYTES`` sets a budget)."""
    budget = device_hbm_budget(model.device)
    if budget is None:
        return
    weights = model_hbm_bytes(model)
    need = weights + cache_bytes + WORKSPACE_BYTES
    if need <= budget:
        return
    gib = 2.0**30
    hints = []
    if rows:
        fit = int((budget - weights - WORKSPACE_BYTES)
                  / max(cache_bytes / rows, 1))
        if fit > 0:
            hints.append(f"reduce to <= {fit} streams")
    hints.append("bound the session (unbounded=False, a shorter "
                 "max_duration_s)")
    raise HBMBudgetError(
        f"{what} needs ~{need / gib:.1f} GiB of device memory (weights "
        f"{weights / gib:.1f} + caches {cache_bytes / gib:.1f} + workspace "
        f"{WORKSPACE_BYTES / gib:.1f}) but the device budget is "
        f"{budget / gib:.1f} GiB.  Try: " + "; ".join(hints))

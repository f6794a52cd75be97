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


def _leaves(node):
    """The tensor leaves of nested dicts, lists and tuples."""
    if isinstance(node, dict):
        for v in node.values():
            yield from _leaves(v)
    elif isinstance(node, (list, tuple)):
        for v in node:
            yield from _leaves(v)
    elif isinstance(node, torch.Tensor):
        yield node


def _storage_key(t: torch.Tensor) -> tuple:
    return str(t.device), t.untyped_storage().data_ptr()


def tree_unique_bytes(*trees) -> int:
    """Bytes of the tensor leaves across nested dicts and lists, each
    underlying storage counted once (fused stacks may share storage with
    the parameter leaves they were cut from)."""
    storages = {_storage_key(t): t.untyped_storage().nbytes()
                for t in _leaves(trees)}
    return sum(storages.values())


def model_hbm_bytes(model) -> int:
    """Weights resident on the device: params + fused decode stacks (on a
    mesh, every shard's copy: the placed TP stacks, or the DP groups'
    stacks; on a card the shards share, counted once)."""
    return tree_unique_bytes(*(getattr(model, name, None) for name in (
        "params", "fused_decode", "fused_tp", "_dp_stacks")))


def shard_weight_bytes(model, d: int, i: int) -> int:
    """Weights that position (d, i) of the model's mesh holds: its TP
    shards (``fused_tp[name][d][i]``) or its data group's K1 stacks
    (``_dp_stacks[name][d]``), each at its own size (a shard on a card
    the shards share is a view of the stacked leaf); the first position
    also the tree and the single-device stacks, whose storage its group's
    stacks may share."""
    trees = ((model.params, model.fused_decode) if (d, i) == (0, 0)
             else ())
    seen = {_storage_key(t) for t in _leaves(trees)}
    own = [leaf[d][i] for leaf in (model.fused_tp or {}).values()]
    own += [leaf[d] for leaf in (model._dp_stacks or {}).values()
            if leaf is not None]
    return tree_unique_bytes(*trees) + sum(
        t.numel() * t.element_size() for t in _leaves(own)
        if _storage_key(t) not in seen)


def check_hbm(model, cache_bytes: int, what: str, rows: int = 0,
              dp: int = 1, first_bytes: int = 0) -> None:
    """Raise :class:`HBMBudgetError` when weights + caches + workspace
    exceed the budget; nothing on the CPU (unless ``VOXTRAL_HBM_BYTES``
    sets a budget).

    ``cache_bytes`` grow with the ``rows``; ``first_bytes`` stay on the
    model's (the mesh's first) device.  ``dp > 1`` spreads the rows over
    that many data groups, each holding ``cache_bytes / dp`` beside its
    own weights (JAX's ``check_hbm(dp=)``, ``voxtral_tpu/utils/hbm.py:
    85-96``).  On a model with a mesh (``model.parallel``, dp x tp > 1)
    the rows' caches also split over the tp model shards (their KV
    heads), and each position (d, i) of the first ``dp`` data groups is
    held to the budget of its own device with the weights it holds
    (:func:`shard_weight_bytes`), ``cache_bytes / (dp x tp)`` and, at
    (0, 0), ``first_bytes``: each shard's own budget, as JAX holds each
    chip.  A device named at several positions (the shards of a mesh on
    one card, a correctness set-up) is held once per position."""
    plan = getattr(model, "parallel", None)
    meshed = plan is not None and plan.dp * plan.tp > 1
    dp, tp = max(dp, 1), plan.tp if meshed else 1
    per_shard = cache_bytes // (dp * tp)
    positions = ([(d, i) for d in range(dp) for i in range(tp)] if meshed
                 else [(0, 0)])
    for d, i in positions:
        dev = plan.mesh.devices[d][i] if meshed else model.device
        budget = device_hbm_budget(dev)
        if budget is None:
            continue
        weights = (shard_weight_bytes(model, d, i) if meshed
                   else model_hbm_bytes(model))
        first = first_bytes if (d, i) == (0, 0) else 0
        need = weights + per_shard + first + WORKSPACE_BYTES
        if need <= budget:
            continue
        gib = 2.0**30
        hints = []
        if rows:
            fit = int((budget - weights - first - WORKSPACE_BYTES)
                      / max(per_shard / rows, 1))
            if fit > 0:
                hints.append(f"reduce to <= {fit} streams")
        hints.append("bound the session (unbounded=False, a shorter "
                     "max_duration_s)")
        where = f" on mesh shard ({d}, {i}), {dev}," if meshed else ""
        raise HBMBudgetError(
            f"{what} needs ~{need / gib:.1f} GiB of device memory{where} "
            f"(weights {weights / gib:.1f} + caches "
            f"{(per_shard + first) / gib:.1f} + workspace "
            f"{WORKSPACE_BYTES / gib:.1f}) but the device budget is "
            f"{budget / gib:.1f} GiB.  Try: " + "; ".join(hints))

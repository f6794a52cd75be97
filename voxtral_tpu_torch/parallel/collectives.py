"""The two collectives of the meshed decode, in one process.

``psum`` is the model-axis all-reduce that follows each TP half
(``ops/decode_tp.py``); ``argmax_resolve`` is the ``pmax`` + ``pmin``
pair that turns each vocab shard's (max, first local index) into the
global greedy token (JAX ``tp_lm_head_token``,
``decode_tp_pallas.py:1410-1417``).  Both take one tensor per model
shard, each on its shard's device, and fix the order of the sum (shard
0, 1, ...), so a run is deterministic at any tp.  A later slice puts
``torch.distributed`` (NCCL) behind these two functions.
"""

from __future__ import annotations

from typing import Sequence

import torch

_NO_INDEX = 2 ** 30  # JAX's pmin sentinel


def psum(parts: Sequence[torch.Tensor],
         devices: Sequence[torch.device]) -> list[torch.Tensor]:
    """Sum the model-axis partials in shard order on the first part's
    device, then copy the sum to each of ``devices`` (a copy is the tensor
    itself where the device is the same)."""
    total = parts[0]
    for part in parts[1:]:
        total = total + part.to(total.device)
    return [total.to(dev) for dev in devices]


def argmax_resolve(values: Sequence[torch.Tensor],
                   indices: Sequence[torch.Tensor],
                   shard_rows: int) -> torch.Tensor:
    """The global greedy token from each vocab shard's (max [B, 1],
    first local index [B, 1]): the largest value over the shards
    (``pmax``), then the lowest global index among the shards holding it
    (``pmin`` of index + shard x ``shard_rows``), which is
    ``torch.argmax``'s first index over the whole vocabulary.  -> [B]
    int32 on the first shard's device."""
    dev = values[0].device
    v = torch.cat([t.to(dev).float() for t in values], dim=1)
    idx = torch.cat([t.to(dev).long() + s * shard_rows
                     for s, t in enumerate(indices)], dim=1)
    gmax = v.amax(dim=1, keepdim=True)
    cand = torch.where(v >= gmax, idx, torch.full_like(idx, _NO_INDEX))
    return cand.amin(dim=1).to(torch.int32)

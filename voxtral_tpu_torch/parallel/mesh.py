"""The device mesh of the port (counterpart of
``voxtral_tpu/parallel/mesh.py``).

JAX's mesh is single-controller: one process drives every device and
``shard_map`` runs a function once per shard.  The port mirrors that in
one process.  A :class:`Mesh` is a grid ``[n_data, n_model]`` of
``torch.device``s; a shard's weights and caches live on its device; a
per-shard function is a plain loop over the shards
(``ops/decode_tp.py::tp_decode_step``,
``parallel/dp_decode.py::dp_decode_stack_step``); the two collectives
the decode needs, the model-axis sum and the greedy token's resolution,
are the functions of ``parallel/collectives.py``, so that NCCL can take
their place later without touching their callers.

Layout, as JAX's: tensor parallelism (the ``model`` axis) shards the
decoder's attention heads, FFN rows and the tied lm_head's vocab rows
(``ops/decode_tp.py``: Megatron column / row pairs, one sum after WO and
one after W2); data parallelism (the ``data`` axis) shards the batch
rows, each data group holding the whole model (DP) or its own model
shards (DP x TP).

What runs where (the one-shot path, live sessions and pools): the
encoder, the adapter, the prefill and the first token's lm_head run
whole, unsharded, on the mesh's first device over the whole batch; the
decode loop then runs per shard, each data group on its rows from the
first decoded position on (a solo session on data group 0's shards).
The GSPMD-partitioned encoder / prefill and ``torch.distributed`` across
processes are not ported (ROADMAP).  ``param_shardings`` / ``shard_params`` /
``kv_cache_sharding`` exist only to drive GSPMD and are not ported.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

DATA_AXIS = "data"
MODEL_AXIS = "model"


class Mesh:
    """A grid ``devices[d][i]`` of torch devices: data group ``d``,
    model shard ``i``.  A device may appear more than once (then the
    shards on it run one after another on it)."""

    axis_names = (DATA_AXIS, MODEL_AXIS)

    def __init__(self, devices: Sequence[Sequence[torch.device]]):
        self.devices = [list(row) for row in devices]
        if not self.devices or not self.devices[0] or any(
                len(row) != len(self.devices[0]) for row in self.devices):
            raise ValueError("a mesh is a non-empty rectangular grid of "
                             "devices")
        self.shape = {DATA_AXIS: len(self.devices),
                      MODEL_AXIS: len(self.devices[0])}

    @property
    def first(self) -> torch.device:
        """The device of data group 0, model shard 0 (where the unsharded
        stages run)."""
        return self.devices[0][0]

    def __repr__(self) -> str:
        return (f"Mesh({self.shape[DATA_AXIS]} data x "
                f"{self.shape[MODEL_AXIS]} model: {self.devices})")


class ParallelPlan:
    """The user-surface description of a meshed run (CLI ``--dp`` /
    ``--tp``), carried by ``VoxtralModel``: the transcribe path routes its
    decode through the TP halves (tp > 1, with a data axis when dp > 1)
    or the DP loop of K1 (dp > 1).  ``dp`` and ``tp`` are the mesh's axis
    lengths."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh

    @property
    def dp(self) -> int:
        return self.mesh.shape[DATA_AXIS]

    @property
    def tp(self) -> int:
        return self.mesh.shape[MODEL_AXIS]


def make_mesh(n_data: int = 1, n_model: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """A ``(data, model)`` mesh over ``devices`` (default: every card,
    ``torch.cuda.device_count()`` of them), filled row by row; raises
    ValueError when they are too few.  An explicit list may name a
    device more than once: ``["cpu"] * 4`` (tests) or ``["cuda:0"] * 2``
    (a tp = 2 mesh whose shards share one card)."""
    if n_data < 1 or n_model < 1:
        raise ValueError(f"mesh axes must be >= 1, got data={n_data}, "
                         f"model={n_model}")
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    n = n_data * n_model
    if n > len(devices):
        raise ValueError(f"Mesh needs {n} devices, only {len(devices)} "
                         "available")
    return Mesh([devices[d * n_model:(d + 1) * n_model]
                 for d in range(n_data)])


def row_groups(streams: int, n_data: int, spec: int = 1) -> list[slice]:
    """The rows of each data group: ``streams`` split in equal blocks,
    each stream's ``spec`` rows together (the row order (stream, draft
    slot)).  ValueError when the data axis does not divide the streams
    (JAX's message)."""
    if streams % n_data:
        raise ValueError(
            f"streams {streams} (rows {streams * spec} / spec {spec}) not "
            f"divisible by mesh axis {DATA_AXIS}={n_data}")
    per = streams // n_data * spec
    return [slice(d * per, (d + 1) * per) for d in range(n_data)]

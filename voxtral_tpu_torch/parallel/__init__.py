"""The mesh seam of the port: tensor and data parallelism in one
process (``mesh.py``), the two collectives (``collectives.py``) and the
data-parallel K1 step (``dp_decode.py``).  The tensor-parallel halves
are ``ops/decode_tp.py``."""

from voxtral_tpu_torch.parallel.collectives import argmax_resolve, psum
from voxtral_tpu_torch.parallel.dp_decode import dp_decode_stack_step
from voxtral_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    ParallelPlan,
    make_mesh,
    row_groups,
)

__all__ = ["DATA_AXIS", "MODEL_AXIS", "Mesh", "ParallelPlan",
           "argmax_resolve", "dp_decode_stack_step", "make_mesh", "psum",
           "row_groups"]

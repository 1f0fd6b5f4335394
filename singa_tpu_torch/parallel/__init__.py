"""Parallel building blocks (counterpart of singa_tpu/parallel/).

Ported so far: the process mesh and its axis context (`mesh`: N-D
meshes of process groups, the batch-axis context DistOpt's BatchNorm
sync reads), and sequence parallelism (`ring`: ring attention, plain
and with flash blocks, and the single-device `full_attention`;
`ulysses`: all-to-all head re-sharding), and tensor parallelism (`tp`:
Megatron's column and row products, the interleaved QKV helpers),
expert parallelism (`moe`), pipeline parallelism (`pipeline`: GPipe's
`pipeline_apply`) and the hand-written strategy steps (`raw_steps`).
"""

from singa_tpu_torch.parallel.mesh import (  # noqa: F401
    axis_context,
    get_mesh,
    in_axis,
    local_world_size,
)
from singa_tpu_torch.parallel.pipeline import pipeline_apply  # noqa: F401

__all__ = ["get_mesh", "axis_context", "in_axis", "local_world_size",
           "pipeline_apply"]

"""Multi-stream serving and data parallelism over ``torch.distributed``.
Counterpart of ``m4depth_tpu/parallel``."""

from m4depth_tpu_torch.parallel.mesh import (
    data_axes,
    data_group,
    distributed_init,
    host_shard_indices,
    local_batch,
    make_hybrid_mesh,
    make_mesh,
    rank_and_world,
)
from m4depth_tpu_torch.parallel.serving import (
    FreshFrameStream,
    assert_collective_free,
    compile_step,
    replicate_params,
    shard_stream_inputs,
    sharded_stream,
)

__all__ = [
    "FreshFrameStream",
    "assert_collective_free",
    "compile_step",
    "data_axes",
    "data_group",
    "distributed_init",
    "host_shard_indices",
    "local_batch",
    "make_hybrid_mesh",
    "make_mesh",
    "rank_and_world",
    "replicate_params",
    "shard_stream_inputs",
    "sharded_stream",
]

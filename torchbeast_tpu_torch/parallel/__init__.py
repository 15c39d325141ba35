"""The data-parallel learner: the mesh and the sharded update
(counterpart of torchbeast_tpu/parallel/). Only the `data` axis is in the
port; the tensor-, expert-, sequence- and pipeline-parallel axes, the
device split and the fleet are ROADMAP.md Queue 1 items of their own."""

from torchbeast_tpu_torch.parallel.dp import (  # noqa: F401
    ParallelLearner,
    ParallelUpdate,
    Sharded,
    ShardedStep,
    ShardedTarget,
    check_consistent_restore,
    initialize_distributed,
    make_parallel_update_step,
    process_count,
    process_index,
    replicate,
    shard_batch,
)
from torchbeast_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    cpu_device_count,
    create_mesh,
    visible_devices,
)

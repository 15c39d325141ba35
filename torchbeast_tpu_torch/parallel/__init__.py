"""The data-parallel learner and expert parallelism: the mesh, the
sharded update and the expert leaves' placement (counterpart of
torchbeast_tpu/parallel/). The `data` and `expert` axes are in the port;
the tensor-, sequence- and pipeline-parallel axes, the device split and
the fleet are ROADMAP.md Queue 1 items of their own."""

from torchbeast_tpu_torch.parallel.dp import (  # noqa: F401
    ParallelLearner,
    ParallelUpdate,
    RoutingExchange,
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
from torchbeast_tpu_torch.parallel.ep import (  # noqa: F401
    expert_param_shardings,
    place_expert_params,
    set_expert_devices,
)

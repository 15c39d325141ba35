"""The data-parallel learner, expert parallelism and the device split's
serving: the mesh, the sharded update, the expert leaves' placement and
the per-slice inference stacks (counterpart of torchbeast_tpu/parallel/).
The `data` and `expert` axes and the Sebulba split (sebulba.py, over
runtime/placement.py) are in the port; the tensor-, sequence- and
pipeline-parallel axes and the fleet are ROADMAP.md Queue 1 items of
their own."""

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
from torchbeast_tpu_torch.parallel.sebulba import (  # noqa: F401
    SebulbaServing,
    ShardedStateTables,
    SliceRouter,
    SliceStack,
    build_sebulba_serving,
    slice_gauge_snapshot,
)

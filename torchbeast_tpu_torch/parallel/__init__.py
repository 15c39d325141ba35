"""The data-parallel learner, tensor, pipeline and expert parallelism and
the device split's serving: the mesh, the sharded update, the leaf rules
of the `model`, `pipe` and `expert` axes, the GPipe schedule and the
per-slice inference stacks (counterpart of torchbeast_tpu/parallel/).
The `data`, `model`, `seq`, `pipe` and `expert` axes, the Sebulba split
(sebulba.py, over runtime/placement.py) and the fleet's learner
strategy (dp.fleet_strategy; the fleet itself is fleet/) are in the
port. The reference's shardy_partitioner selects an XLA partitioner
and has no counterpart here. Under --expert_parallel and
--tensor_parallel the learner mesh keeps the split leaves as resident
slices on their devices (models/sharded.py; `local_view` assembles the
one-device tree)."""

from torchbeast_tpu_torch.parallel.dp import (  # noqa: F401
    ParallelLearner,
    ParallelUpdate,
    RoutingExchange,
    Sharded,
    ShardedStep,
    ShardedTarget,
    check_consistent_restore,
    fleet_strategy,
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
from torchbeast_tpu_torch.models.sharded import local_view  # noqa: F401
from torchbeast_tpu_torch.parallel.ep import (  # noqa: F401
    expert_param_shardings,
    set_expert_devices,
    shard_expert_params,
)
from torchbeast_tpu_torch.parallel.pp import (  # noqa: F401
    can_pipeline,
    default_n_microbatches,
    pipeline_apply,
    pipeline_apply_multi,
    set_pipeline,
    stack_stages,
    stage_param_shardings,
)
from torchbeast_tpu_torch.parallel.tp import (  # noqa: F401
    dense_kernel_shardings,
    merge_param_shardings,
    set_model_devices,
    transformer_tp_shardings,
)
from torchbeast_tpu_torch.parallel.sebulba import (  # noqa: F401
    SebulbaServing,
    ShardedStateTables,
    SliceRouter,
    SliceStack,
    build_sebulba_serving,
    slice_gauge_snapshot,
)

"""Runtime: queues, dynamic batching, wire protocol, env servers, actor
pool — the reference's `libtorchbeast` layer (SURVEY.md §2.1 N3-N9),
re-designed for the framed-socket transport and XLA-static inference.

Python implementations carry the semantics and the test surface; the C++
hot-path equivalents are the port's core (torchbeast_tpu_torch/csrc/native/,
built at first use and loaded by native.py).

The port's copy of torchbeast_tpu/runtime/__init__.py.
"""

from torchbeast_tpu_torch.runtime.queues import (  # noqa: F401
    AsyncError,
    Batch,
    BatchingQueue,
    ClosedBatchingQueue,
    DevicePrefetcher,
    DynamicBatcher,
)

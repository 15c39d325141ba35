"""The device split's stream ordering on the card
(torchbeast_tpu_torch/serving/snapshot.py `latest_on`, the pinned
runtime/state_table.py DeviceStateTable). Every test needs a CUDA device
and skips without one; like tests/test_torch_kernels_cuda.py this module
imports no jax, so on the GPU machine it runs as
    python -m pytest --noconftest -m cuda tests/test_torch_split_cuda.py

No CPU test can show these races: a publish cast on one stream and a
slice copying it from another.
"""

import numpy as np
import pytest
import torch

from torchbeast_tpu_torch import nest, telemetry
from torchbeast_tpu_torch.runtime.state_table import DeviceStateTable
from torchbeast_tpu_torch.serving import PolicySnapshotStore

pytestmark = pytest.mark.cuda

SLEEP_CYCLES = 1_000_000_000  # about half a second of one spinning kernel


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the split's streams run only on "
                    "the GPU")
    return torch.device("cuda", 0)


def test_latest_on_waits_for_the_publish_cast(cuda):
    """The learner's stream is held by a long kernel before it writes and
    casts a new version; a slice copying that version from its own stream
    must see the written values, not what the memory held before."""
    store = PolicySnapshotStore(1, registry=telemetry.MetricsRegistry())
    learner = torch.cuda.Stream(cuda)
    params = [torch.zeros(1 << 20, device=cuda)]
    torch.cuda.synchronize()
    with torch.cuda.stream(learner):
        torch.cuda._sleep(SLEEP_CYCLES)
        params[0].fill_(3.0)
        store.note_update(1)
        store.publish(1, params)
    slice_stream = torch.cuda.Stream(cuda)
    with torch.cuda.stream(slice_stream):
        version, placed = store.latest_on(cuda)
        got = placed[0].clone()
    torch.cuda.synchronize()
    assert version == 1
    assert bool((got == 3.0).all())
    # One copy per (version, device, stream): the same stream reads the
    # cached tree, another stream gets a tree of its own.
    with torch.cuda.stream(slice_stream):
        assert store.latest_on(cuda)[1] is placed
    with torch.cuda.stream(torch.cuda.Stream(cuda)):
        assert store.latest_on(cuda)[1] is not placed


def test_pinned_table_runs_on_its_own_stream(cuda):
    """A pinned table's work is queued on its stream whichever thread's
    stream is current: a step stays behind nothing on the default
    stream, and a reset from the default stream is ordered with the
    table's steps."""
    table = DeviceStateTable({"h": torch.zeros(1, 1, 4)}, num_slots=4,
                             act_fn=lambda ctx, env, s: (
                                 {"a": env["x"]}, {"h": s["h"] + 1}),
                             batch_dim=1, device=cuda)
    assert table.stream is not None and table.device == cuda
    for leaf in nest.flatten(table._rows):
        assert leaf.device == cuda
    env = {"x": np.ones((1, 4), np.float32)}
    # One step first: the pinned host blocks a step allocates are cached
    # after it (a first allocation may wait for the whole device).
    table.fetch(table.step(np.arange(4), np.zeros(4, bool), env), 4)
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)  # the default stream is busy
    out = table.step(np.arange(4), np.ones(4, bool), env)
    fetched = table.fetch(out, 4)
    # The default stream is still spinning: the step did not wait for it.
    assert not torch.cuda.current_stream(cuda).query()
    np.testing.assert_array_equal(fetched["a"], np.ones((1, 4)))
    table.reset([1])
    state = [float(table.read_slot(s)["h"][0, 0, 0]) for s in range(4)]
    assert state == [1.0, 0.0, 1.0, 1.0]
    torch.cuda.synchronize()

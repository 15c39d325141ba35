"""graphs._capture on the CPU, with stand-ins for torch's CUDA graph API:
the cyclic garbage collector is off for the whole capture (a graph it
freed then would be reset mid-capture, which invalidates the capture)
and back as it was after it, also when the captured function raises."""

import gc

import pytest
import torch

from torchbeast_tpu_torch import graphs


class _Graph:
    def register_generator_state(self, generator):
        pass


class _Capture:
    """torch.cuda.graph's stand-in: records the collector's state at entry
    and exit."""

    seen = []

    def __init__(self, graph, stream=None):
        pass

    def __enter__(self):
        _Capture.seen.append(gc.isenabled())

    def __exit__(self, *exc):
        _Capture.seen.append(gc.isenabled())
        return False


@pytest.fixture
def fake_cuda_graphs(monkeypatch):
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _Graph)
    monkeypatch.setattr(torch.cuda, "graph", _Capture)
    monkeypatch.setattr(torch.cuda, "Stream", lambda: None)
    _Capture.seen = []
    was = gc.isenabled()
    yield
    if was:
        gc.enable()
    else:
        gc.disable()


@pytest.mark.parametrize("collecting", [True, False])
def test_capture_keeps_the_collector_off(fake_cuda_graphs, collecting):
    (gc.enable if collecting else gc.disable)()
    inside = []
    _, out, _ = graphs._capture(lambda: inside.append(gc.isenabled()) or 7)
    assert out == 7
    assert inside == [False] and _Capture.seen == [False, False]
    assert gc.isenabled() == collecting


def test_capture_restores_the_collector_when_fn_raises(fake_cuda_graphs):
    gc.enable()

    def fail():
        raise RuntimeError("capture failed")

    with pytest.raises(RuntimeError, match="capture failed"):
        graphs._capture(fail)
    assert gc.isenabled()

"""The plain reference of the benchmark's learner cells.

Plain PyTorch in float32 with TF32 off (`plain_math`), written from the
published descriptions: the IMPALA network (Espeholt et al. 2018, Fig. 3)
and the Nature DQN trunk as torchbeast's AtariNet, the done-masked LSTM
core, V-trace, the IMPALA losses, the global-norm clip, torch-semantics
RMSprop and the linear learning-rate decay. It imports nothing of the
program under test and nothing of the JAX package: it shares with the
program only the parameter names and layouts it loads weights under.

A configuration file names its network module here (`"reference"`): a
module with `param_shapes(net, frame_shape, num_actions)`,
`state_shapes(net, num_actions, batch_size)` and
`forward(params, batch, state, net, num_actions)`.
"""

import contextlib
import importlib

import torch


def network(name: str):
    """The network module `portbench.reference.<name>`."""
    return importlib.import_module(f"portbench.reference.{name}")


@contextlib.contextmanager
def plain_math():
    """float32 matrix products and convolutions in full float32 (no TF32)
    for the body; the previous settings come back after it."""
    matmul = torch.backends.cuda.matmul.allow_tf32
    cudnn = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn

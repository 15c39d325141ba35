"""Checkpoints of the port (torchbeast_tpu_torch/utils/checkpoint.py and
the drivers' use of it) against the reference's, for --opt_impl xla and
pallas at --precision f32 and bf16_train on the deep model + LSTM:

- the reference's monobeast trains 2 updates on Mock and writes
  model.ckpt; the port restores it with params, RMSprop nu, the bf16 f32
  master, the schedule's count and the step equal to the reference's own
  restore (exact, bit for bit); the port's monobeast then resumes the run
  and writes its own checkpoint, which the reference's load_checkpoint
  restores onto templates from its own init, again equal bit for bit to
  what the port reads from it;
- the port's own write/read round trip is exact for every optimizer
  tree (momentum and the factored second moment too);
- a pickle file is refused, and the write leaves no .tmp behind.
"""

import logging
import os
import pickle

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import flax.serialization as flax_ser  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from torchbeast_tpu import learner as jax_learner  # noqa: E402
from torchbeast_tpu import monobeast as jax_monobeast  # noqa: E402
from torchbeast_tpu.utils import checkpoint as jax_checkpoint  # noqa: E402
from torchbeast_tpu_torch import learner as port_learner  # noqa: E402
from torchbeast_tpu_torch import monobeast as port_monobeast  # noqa: E402
from torchbeast_tpu_torch import weights  # noqa: E402
from torchbeast_tpu_torch.utils import checkpoint  # noqa: E402
from tests.torch_port_fixtures import few_torch_threads  # noqa: E402,F401

FRAME, ACTIONS, T, B = (84, 84, 4), 6, 4, 2
CASES = [("xla", "f32"), ("xla", "bf16_train"), ("pallas", "f32"),
         ("pallas", "bf16_train")]


def _args(tmp_path, opt_impl, policy, total_steps):
    return ["--env", "Mock", "--model", "deep", "--use_lstm",
            "--num_actors", str(B), "--batch_size", str(B),
            "--unroll_length", str(T), "--total_steps", str(total_steps),
            "--serial_envs", "--savedir", str(tmp_path), "--xpid", "x",
            "--opt_impl", opt_impl, "--precision", policy]


def _bits(leaf):
    """(dtype name, the leaf's values as an exactly comparable array)."""
    if torch.is_tensor(leaf):
        name = str(leaf.dtype).replace("torch.", "")
        if leaf.dtype == torch.bfloat16:
            return name, leaf.view(torch.int16).numpy()
        return name, leaf.numpy()
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":
        return "bfloat16", arr.view(np.int16)
    return arr.dtype.name, arr


def _same(ref, port, path="."):
    """Two trees equal in structure, dtypes and every bit."""
    if isinstance(ref, dict):
        assert isinstance(port, dict), path
        assert set(ref) == set(port), (path, sorted(ref), sorted(port))
        for k in ref:
            _same(ref[k], port[k], f"{path}/{k}")
        return
    if ref is None or port is None:
        assert ref is None and port is None, path
        return
    (rn, rv), (pn, pv) = _bits(ref), _bits(port)
    assert rn == pn, (path, rn, pn)
    assert rv.shape == pv.shape, (path, rv.shape, pv.shape)
    np.testing.assert_array_equal(rv, pv, err_msg=path)


def _jax_restore(path, jflags):
    _, params = jax_monobeast._init_model_and_params(
        jflags, ACTIONS, B, FRAME)
    opt_state = jax_learner.make_optimizer(
        jax_monobeast.hparams_from_flags(jflags)).init(params)
    restored = jax_checkpoint.load_checkpoint(
        path, params_template=params, opt_state_template=opt_state)
    return (restored, flax_ser.to_state_dict(restored["params"]),
            flax_ser.to_state_dict(restored["opt_state"]))


def _port_state(pflags):
    model = port_monobeast.build_model(pflags, ACTIONS, FRAME,
                                       torch.device("cpu"))
    hp = port_monobeast.hparams_from_flags(pflags)
    optimizer = port_learner.make_optimizer(
        hp, list(model.parameters()),
        layouts=weights.jax_layouts(model) if hp.opt_factored else None)
    return model, optimizer


@pytest.mark.parametrize("opt_impl,policy", CASES)
def test_checkpoints_resume_across_the_packages(tmp_path, caplog, opt_impl,
                                                policy):
    path = str(tmp_path / "x" / "model.ckpt")
    jflags = jax_monobeast.make_parser().parse_args(
        _args(tmp_path, opt_impl, policy, 2 * T * B) + ["--no_telemetry"])
    jax_monobeast.train(jflags)

    # The reference's checkpoint, read by both packages.
    ref, ref_params, ref_opt = _jax_restore(path, jflags)
    pflags = port_monobeast.make_parser().parse_args(
        _args(tmp_path, opt_impl, policy, 3 * T * B) + ["--disable_cuda"])
    model, optimizer = _port_state(pflags)
    got = checkpoint.load_train_state(path, model, optimizer)
    assert got["step"] == ref["step"] == 2 * T * B
    assert optimizer.state.count == 2
    _same(ref_params, checkpoint.params_tree(model))
    _same(ref_opt, checkpoint.opt_state_tree(model, optimizer))
    if policy == "bf16_train":
        assert all(torch.equal(p, m.to(torch.bfloat16)) for p, m in
                   zip(model.parameters(), optimizer.state.master))

    # The port's monobeast resumes the run for one more update and
    # writes its checkpoint, which the reference reads.
    with caplog.at_level(logging.INFO):
        stats = port_monobeast.train(pflags)
    assert "Resuming preempted job" in caplog.text
    assert stats["step"] == 3 * T * B
    ref, ref_params, ref_opt = _jax_restore(path, jflags)
    model, optimizer = _port_state(pflags)
    got = checkpoint.load_train_state(path, model, optimizer)
    assert got["step"] == ref["step"] == 3 * T * B
    assert optimizer.state.count == 3
    assert int(np.asarray(_count(ref_opt))) == 3
    _same(ref_params, checkpoint.params_tree(model))
    _same(ref_opt, checkpoint.opt_state_tree(model, optimizer))
    assert not os.path.exists(path + ".tmp")


def _count(tree):
    """The schedule's count in a reference optimizer state dict."""
    if "count" in tree:
        return tree["count"]
    for v in tree.values():
        if isinstance(v, dict) and _count(v) is not None:
            return _count(v)
    return None


def _state_tensors(state):
    """Every tensor of the port's optimizer state (nu, the trace, the
    master; a factored nu's row/col/nu triples)."""
    out = []
    for group in (state.nu, state.mom, state.master):
        for item in group or ():
            if isinstance(item, list):  # factored: triples per JAX leaf
                out += [x for triple in item for x in triple]
            else:
                out.append(item)
    return out


@pytest.mark.parametrize("extra", [
    [], ["--momentum", "0.9"], ["--precision", "bf16_train"],
    ["--precision", "bf16_train", "--momentum", "0.5"],
    ["--factored_opt_state"],
    ["--factored_opt_state", "--precision", "bf16_train"],
    ["--opt_impl", "pallas"], ["--opt_impl", "pallas", "--momentum", "0.9"],
    ["--opt_impl", "pallas", "--precision", "bf16_train", "--momentum",
     "0.5"],
])
def test_the_ports_round_trip_is_exact(tmp_path, extra):
    """Random state in every leaf (params, nu, trace, master, count), one
    save and one load into a fresh model and optimizer: equal bits."""
    pflags = port_monobeast.make_parser().parse_args(
        ["--disable_cuda", "--env", "Mock", "--model", "deep", "--use_lstm",
         *extra])
    model, optimizer = _port_state(pflags)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for t in [*model.parameters(), *_state_tensors(optimizer.state)]:
            t.copy_(torch.rand(t.shape, generator=gen))
    optimizer.state = optimizer.state._replace(count=7)
    path = str(tmp_path / "model.ckpt")
    checkpoint.save_train_state(path, model, optimizer, step=123,
                                flags={"env": "Mock"}, stats={"loss": 1.5})
    model2, optimizer2 = _port_state(pflags)
    got = checkpoint.load_train_state(path, model2, optimizer2)
    assert (got["step"], got["flags"], got["stats"]) == (
        123, {"env": "Mock"}, {"loss": 1.5})
    assert optimizer2.state.count == 7
    _same(checkpoint.params_tree(model), checkpoint.params_tree(model2))
    _same(checkpoint.opt_state_tree(model, optimizer),
          checkpoint.opt_state_tree(model2, optimizer2))
    assert not os.path.exists(path + ".tmp")


def test_another_optimizers_checkpoint_raises_before_loading(tmp_path):
    """An xla checkpoint into a pallas run (and back) raises, and leaves
    the run's params as they were."""
    path = str(tmp_path / "model.ckpt")
    flags = port_monobeast.make_parser().parse_args(
        ["--disable_cuda", "--env", "Mock", "--model", "deep", "--use_lstm"])
    model, optimizer = _port_state(flags)
    checkpoint.save_train_state(path, model, optimizer, step=1)
    other = port_monobeast.make_parser().parse_args(
        ["--disable_cuda", "--env", "Mock", "--model", "deep", "--use_lstm",
         "--opt_impl", "pallas", "--seed", "7"])
    model2, optimizer2 = _port_state(other)
    before = [p.detach().clone() for p in model2.parameters()]
    with pytest.raises(ValueError, match="checkpoint tree"):
        checkpoint.load_train_state(path, model2, optimizer2)
    assert all(torch.equal(a, b) for a, b in zip(before,
                                                 model2.parameters()))
    checkpoint.save_train_state(path, model2, optimizer2, step=1)
    with pytest.raises(ValueError, match="checkpoint tree"):
        checkpoint.load_train_state(path, model, optimizer)


def test_pickle_is_refused_and_the_write_is_atomic(tmp_path):
    path = str(tmp_path / "sub" / "model.ckpt")
    checkpoint.atomic_write(path, b"\x81\xa1a\x01")
    assert os.listdir(tmp_path / "sub") == ["model.ckpt"]
    with open(path, "wb") as f:
        pickle.dump({"params": 1}, f)
    flags = port_monobeast.make_parser().parse_args(
        ["--disable_cuda", "--env", "Mock", "--model", "deep", "--use_lstm"])
    model, optimizer = _port_state(flags)
    with pytest.raises(ValueError, match="pickle"):
        checkpoint.load_train_state(path, model, optimizer)
    with pytest.raises(ValueError, match="pickle"):
        checkpoint.load_params(path, model)

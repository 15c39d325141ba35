"""The port's checkpoint converter between the transformer layouts
(torchbeast_tpu_torch/utils/convert.py) against the reference's
(torchbeast_tpu/utils/convert.py) on the CPU.

- Both directions on the reference's own trees (TransformerNet and
  PipelinedTransformerNet inits: 2 layers, d_model 32, 4 heads, memory 5,
  6x6x2 frames): every leaf equal, bit for bit, to the reference's
  conversion.
- A converted tree drives the other family of the port to the source
  family's outputs: two unrolls (T=4, B=8, dones planted), logits,
  baseline and the carried cache within rtol 1e-5 / atol 1e-5, argmax
  actions equal.
- The refusals: MoE blocks, a tree of the wrong layout, and a checkpoint
  whose params hold no tree of the source layout, which writes nothing.
- A checkpoint file converted by both packages gives the same bytes, and
  the CLI converts through a subprocess.
- Resume: a `--pipeline_stages 2` checkpoint written by monobeast of each
  package (2 updates on Mock, T=4, B=2), converted to the sequential
  layout, is resumed as `--model transformer` by the OTHER package's
  monobeast for a third update.
"""

import logging
import os
import subprocess
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import jax  # noqa: E402

from torchbeast_tpu import monobeast as jax_monobeast  # noqa: E402
from torchbeast_tpu.models import create_model as jax_create_model  # noqa
from torchbeast_tpu.utils import convert as jax_convert  # noqa: E402
from torchbeast_tpu_torch import monobeast as port_monobeast  # noqa: E402
from torchbeast_tpu_torch import weights  # noqa: E402
from torchbeast_tpu_torch.models import create_model as port_create_model
from torchbeast_tpu_torch.utils import checkpoint, convert  # noqa: E402
from torchbeast_tpu_torch.utils import serialization  # noqa: E402
from tests.torch_port_fixtures import few_torch_threads  # noqa: E402,F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T, B, A = 4, 8, 5
FRAME = (6, 6, 2)
SIZE = dict(num_layers=2, d_model=32, num_heads=4, memory_len=5)
FAMILY = {"sequential": "transformer", "pipelined": "pipelined_transformer"}
OTHER = {"sequential": "pipelined", "pipelined": "sequential"}
PORT_FN = {"pipelined": convert.transformer_to_pipelined,
           "sequential": convert.pipelined_to_transformer}
JAX_FN = {"pipelined": jax_convert.transformer_to_pipelined,
          "sequential": jax_convert.pipelined_to_transformer}


def _inputs(seed):
    rng = np.random.default_rng(seed)
    done = rng.random((T, B)) < 0.2
    done[1, 0] = True
    return {
        "frame": rng.integers(0, 256, (T, B) + FRAME, dtype=np.uint8),
        "reward": (3 * rng.standard_normal((T, B))).astype(np.float32),
        "done": done,
        "last_action": rng.integers(0, A, (T, B)).astype(np.int32),
    }


def _jax_params(layout, **kw):
    """The reference's init of the `layout` family (numpy leaves)."""
    model = jax_create_model(FAMILY[layout], num_actions=A, **SIZE,
                             **kw)
    params = model.init(
        {"params": jax.random.PRNGKey(0), "action": jax.random.PRNGKey(1)},
        _inputs(0), model.initial_state(B))
    return jax.device_get(params)


def _same(a, b, path="."):
    if isinstance(b, dict):
        assert isinstance(a, dict) and set(a) == set(b), (path, sorted(a),
                                                          sorted(b))
        for k in b:
            _same(a[k], b[k], f"{path}/{k}")
        return
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=path)


@pytest.mark.parametrize("to", ["pipelined", "sequential"])
def test_both_directions_match_the_reference(to):
    source = _jax_params(OTHER[to])
    got = PORT_FN[to](source)
    want = jax.device_get(JAX_FN[to](source))
    _same(got, want)
    # And back: the source tree again, bit for bit.
    _same(PORT_FN[OTHER[to]](got), source)


def _port(layout, params):
    model = port_create_model(FAMILY[layout], A, frame_shape=FRAME, **SIZE)
    weights.load_jax_params(model, params)
    return model


def _two_unrolls(model):
    state = model.initial_state(B)
    with torch.no_grad():
        for seed in (11, 12):
            out, state = model(
                {k: torch.from_numpy(v) for k, v in _inputs(seed).items()},
                state, sample_action=False)
    return out, state


@pytest.mark.parametrize("to", ["pipelined", "sequential"])
def test_converted_tree_gives_the_source_familys_outputs(to):
    source = _jax_params(OTHER[to])
    want, want_state = _two_unrolls(_port(OTHER[to], source))
    got, got_state = _two_unrolls(_port(to, PORT_FN[to](source)))
    torch.testing.assert_close(got.action, want.action, rtol=0, atol=0)
    torch.testing.assert_close(got.policy_logits, want.policy_logits,
                               rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got.baseline, want.baseline, rtol=1e-5,
                               atol=1e-5)
    for (gk, gv, gval), (wk, wv, wval) in zip(got_state, want_state):
        torch.testing.assert_close(gk, wk, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(gv, wv, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(gval, wval, rtol=0, atol=0)


def test_moe_blocks_and_wrong_layouts_are_refused():
    moe = _jax_params("sequential", num_experts=2)
    with pytest.raises(ValueError) as theirs:
        jax_convert.transformer_to_pipelined(moe)
    with pytest.raises(ValueError, match="MoE blocks cannot convert") as ours:
        convert.transformer_to_pipelined(moe)
    assert str(ours.value) == str(theirs.value)
    with pytest.raises(ValueError, match="not a TransformerNet tree"):
        convert.transformer_to_pipelined(_jax_params("pipelined"))
    with pytest.raises(ValueError, match="not a PipelinedTransformerNet"):
        convert.pipelined_to_transformer(_jax_params("sequential"))
    with pytest.raises(ValueError, match="unknown target layout"):
        convert.convert_subtrees({}, "ring")


def _port_args(tmp_path, xpid, model, total_steps, *extra):
    return ["--env", "Mock", "--model", model, "--num_actors", "2",
            "--batch_size", "2", "--unroll_length", "4", "--total_steps",
            str(total_steps), "--serial_envs", "--savedir", str(tmp_path),
            "--xpid", xpid, *extra]


def _port_checkpoint(tmp_path, xpid, *extra):
    flags = port_monobeast.make_parser().parse_args(_port_args(
        tmp_path, xpid, "pipelined_transformer", 16, "--pipeline_stages",
        "2", "--disable_cuda", *extra))
    port_monobeast.train(flags)
    return str(tmp_path / xpid / "model.ckpt")


def test_a_checkpoint_with_nothing_to_convert_writes_nothing(tmp_path):
    path = _port_checkpoint(tmp_path, "p")
    out = str(tmp_path / "out.ckpt")
    with pytest.raises(ValueError, match="nothing was written"):
        convert.convert_checkpoint(path, out, "pipelined")
    assert not os.path.exists(out)


def test_both_packages_convert_a_file_to_the_same_bytes(tmp_path):
    """A port-written checkpoint (--opt_impl pallas: nu and count beside
    the params) converted by each package's convert_checkpoint, and the
    CLI through a subprocess."""
    path = _port_checkpoint(tmp_path, "p", "--opt_impl", "pallas")
    ours, theirs = str(tmp_path / "ours.ckpt"), str(tmp_path / "theirs.ckpt")
    convert.convert_checkpoint(path, ours, "sequential")
    jax_convert.convert_checkpoint(path, theirs, "sequential")
    with open(ours, "rb") as f, open(theirs, "rb") as g:
        assert f.read() == g.read()
    cli = str(tmp_path / "cli.ckpt")
    done = subprocess.run(
        [sys.executable, "-m", "torchbeast_tpu_torch.utils.convert",
         "--input", ours, "--output", cli, "--to", "pipelined"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert done.returncode == 0, done.stderr
    assert "converted" in done.stdout
    src = checkpoint.read_payload(path)
    back = checkpoint.read_payload(cli)
    assert back["flags"]["model"] == "pipelined_transformer"
    assert checkpoint.read_payload(ours)["flags"]["model"] == "transformer"
    for key in ("params", "opt_state"):
        _same(serialization.msgpack_restore(back[key]),
              serialization.msgpack_restore(src[key]))


def _jax_args(tmp_path, xpid, model, total_steps, *extra):
    return _port_args(tmp_path, xpid, model, total_steps, "--no_telemetry",
                      *extra)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_a_converted_checkpoint_resumes_in_the_other_package(
        tmp_path, caplog, writer):
    src = tmp_path / "pipelined"
    dest = tmp_path / "x"
    dest.mkdir()
    if writer == "port":
        path = _port_checkpoint(tmp_path, "pipelined")
    else:
        jax_monobeast.train(jax_monobeast.make_parser().parse_args(
            _jax_args(tmp_path, "pipelined", "pipelined_transformer", 16,
                      "--pipeline_stages", "2")))
        path = str(src / "model.ckpt")
    convert.convert_checkpoint(path, str(dest / "model.ckpt"), "sequential")
    with caplog.at_level(logging.INFO):
        if writer == "port":
            stats = jax_monobeast.train(jax_monobeast.make_parser()
                                        .parse_args(_jax_args(
                                            tmp_path, "x", "transformer",
                                            24)))
        else:
            stats = port_monobeast.train(port_monobeast.make_parser()
                                         .parse_args(_port_args(
                                             tmp_path, "x", "transformer",
                                             24, "--disable_cuda")))
    assert "Resuming preempted job" in caplog.text
    assert stats["step"] == 24
    assert np.isfinite(stats["total_loss"])

"""--superstep_k and --overlap_collect in the port's drivers, on the CPU
(the ports of the reference's driver tests in tests/test_monobeast.py
and tests/test_polybeast.py):

- monobeast --superstep_k 2 trains bit for bit as --superstep_k 1: the
  checkpoints' params and optimizer state are equal;
- a K=2 dispatch counts K*T*batch_size frames, and K must be >= 1 and
  divide the sub-batches of a collect (the reference's errors);
- --overlap_collect trains, checkpoints and resumes;
- the policy lag: acting during collect c reads the params as they were
  after collect c-2's updates with --overlap_collect (lag exactly 1),
  after collect c-1's without it;
- polybeast --superstep_k 2 trains through the arena, lands on whole
  supersteps, checkpoints an update count of K per dispatch, and
  resumes.
"""

import os

import numpy as np
import pytest
import torch

from torchbeast_tpu_torch import learner as port_learner
from torchbeast_tpu_torch import monobeast, polybeast
from torchbeast_tpu_torch.utils import serialization
from tests.torch_port_fixtures import few_torch_threads  # noqa: F401

T = 5


def _mono(tmp_path, xpid, *extra, model=("--model", "shallow")):
    return monobeast.make_parser().parse_args([
        "--disable_cuda", "--env", "Mock", *model,
        "--num_actors", "4", "--batch_size", "2",
        "--unroll_length", str(T), "--serial_envs",
        "--savedir", str(tmp_path), "--xpid", xpid, *extra,
    ])


def _payload(tmp_path, xpid):
    with open(tmp_path / xpid / "model.ckpt", "rb") as f:
        return serialization.msgpack_restore(f.read())


def _count(tree):
    """The update count in a checkpoint's optimizer tree (msgpack bytes
    inside the payload, as the reference writes it)."""
    if isinstance(tree, bytes):
        tree = serialization.msgpack_restore(tree)
    if "count" in tree:
        return int(tree["count"])
    for v in tree.values():
        found = _count(v) if isinstance(v, dict) else None
        if found is not None:
            return found
    return None


def test_superstep_trains_bit_identically_to_sequential(tmp_path):
    """deep + LSTM, the kernels' switches on: the K=2 dispatch applies
    the same updates in the same order, the schedules tick per update,
    acting sees the params between collects, and the Mock env and the
    seeds make the run deterministic."""
    runs = []
    for k in (1, 2):
        flags = _mono(tmp_path, f"ss-k{k}", "--superstep_k", str(k),
                      "--total_steps", "80", "--vtrace_impl", "pallas",
                      "--opt_impl", "pallas", "--entropy_cost_final", "0.0",
                      model=("--model", "deep", "--use_lstm"))
        runs.append((monobeast.train(flags), _payload(tmp_path, f"ss-k{k}")))
    (stats1, ck1), (stats2, ck2) = runs
    assert ck1["step"] == ck2["step"] == 80
    # The serialized trees, byte for byte.
    assert ck1["params"] == ck2["params"]
    assert ck1["opt_state"] == ck2["opt_state"]
    assert _count(ck1["opt_state"]) == 80 // (T * 2)
    assert stats1["total_loss"] == stats2["total_loss"]


def test_superstep_step_accounting(tmp_path):
    stats = monobeast.train(_mono(tmp_path, "ss-acct", "--superstep_k", "2",
                                  "--total_steps", "40"))
    assert stats["step"] >= 40
    assert stats["step"] % (2 * T * 2) == 0  # K * T * batch_size


@pytest.mark.parametrize("k,match", [("3", "must divide the 2 learner"),
                                     ("0", "must be >= 1")])
def test_superstep_rejected(tmp_path, k, match):
    with pytest.raises(ValueError, match=match):
        monobeast.train(_mono(tmp_path, "ss-bad", "--superstep_k", k,
                              "--total_steps", "40"))


def test_overlap_collect_trains_checkpoints_and_resumes(tmp_path):
    stats = monobeast.train(_mono(tmp_path, "ovl", "--overlap_collect",
                                  "--total_steps", "40"))
    assert stats["step"] >= 40
    assert np.isfinite(stats["total_loss"])
    assert _payload(tmp_path, "ovl")["step"] == stats["step"]
    stats2 = monobeast.train(_mono(tmp_path, "ovl", "--overlap_collect",
                                   "--superstep_k", "2",
                                   "--total_steps", "80"))
    assert stats2["step"] >= 80
    ck = _payload(tmp_path, "ovl")
    assert ck["step"] == stats2["step"]
    assert _count(ck["opt_state"]) == stats2["step"] // (T * 2)


def _flat(params):
    return torch.cat([p.detach().reshape(-1) for p in params]).clone()


@pytest.mark.parametrize("overlap", [False, True])
def test_policy_lag(tmp_path, monkeypatch, overlap):
    """Every acting step's params, against the learner's after each
    collect's dispatches: collect c acts on the head after collect
    c - 1 - lag (the initial params before the first)."""
    events = []
    make_act, make_dispatch = (port_learner.make_act_step,
                               port_learner.make_update_dispatch)

    def act_step(model, device, generator=None, capture=None):
        inner = make_act(model, device, generator, capture)
        params = list(model.parameters())
        events.append(("init", _flat(params)))

        def step(env, state):
            events.append(("act", _flat(params)))
            return inner(env, state)
        return step

    def update_dispatch(model, optimizer, hp, k=1, capture=None):
        inner = make_dispatch(model, optimizer, hp, k, capture)
        params = list(model.parameters())

        def dispatch(batch, state):
            out = inner(batch, state)
            events.append(("update", _flat(params)))
            return out
        return dispatch

    monkeypatch.setattr(port_learner, "make_act_step", act_step)
    monkeypatch.setattr(port_learner, "make_update_dispatch",
                        update_dispatch)
    extra = ("--overlap_collect",) if overlap else ()
    collects = 4
    monobeast.train(_mono(tmp_path, f"lag{overlap}", *extra,
                          "--total_steps", str(collects * T * 4)))
    assert events[0][0] == "init"
    heads = [events[0][1]]  # the chain head after each collect
    acting = [[]]  # the params of each collect's acting steps
    for kind, fp in events[1:]:
        if kind == "act":
            if len(heads) > len(acting):
                acting.append([])
            acting[-1].append(fp)
        elif len(heads) == len(acting):
            heads.append(fp)
        else:
            heads[-1] = fp
    assert len(acting) == collects and len(heads) == collects + 1
    lag = 1 if overlap else 0
    for c, fps in enumerate(acting):
        want = heads[max(c - lag, 0)]
        assert all(torch.equal(fp, want) for fp in fps), c
    # The heads differ from one another, so the lags are told apart.
    assert not torch.equal(heads[1], heads[2])


def test_polybeast_superstep_trains_and_resumes(tmp_path):
    args = ["--disable_cuda", "--env", "Mock", "--model", "deep",
            "--use_lstm", "--num_servers", "2", "--batch_size", "2",
            "--unroll_length", str(T), "--savedir", str(tmp_path),
            "--xpid", "poly-ss", "--pipes_basename",
            f"unix:{tmp_path}/pipes", "--max_inference_batch_size", "4",
            "--superstep_k", "2", "--vtrace_impl", "pallas",
            "--opt_impl", "pallas"]
    parse = polybeast.make_parser().parse_args
    stats = polybeast.train(parse(args + ["--total_steps", "40"]))
    assert stats["step"] >= 40
    assert stats["step"] % (2 * T * 2) == 0  # K * T * batch_size
    assert stats["updates"] == stats["step"] // (2 * T * 2)  # dispatches
    assert np.isfinite(stats["total_loss"])
    assert stats["health"] == "HEALTHY"
    ck = _payload(tmp_path, "poly-ss")
    assert ck["step"] == stats["step"]
    assert _count(ck["opt_state"]) == stats["step"] // (T * 2)
    stats2 = polybeast.train(parse(args + ["--total_steps",
                                           str(stats["step"] + 20)]))
    assert stats2["step"] > stats["step"]
    assert stats2["step"] % (2 * T * 2) == 0
    assert _count(_payload(tmp_path, "poly-ss")["opt_state"]) == (
        stats2["step"] // (T * 2))
    assert os.path.exists(tmp_path / "poly-ss" / "logs.csv")

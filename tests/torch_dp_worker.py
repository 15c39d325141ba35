"""Worker of the port's multi-process data-parallel tests: one process of
a torch.distributed gloo group on the CPU, 2 devices each
(XLA_FLAGS=--xla_force_host_platform_device_count=2).

    torch_dp_worker.py update <rank> <processes> <port> <outdir>
    torch_dp_worker.py update_ep <rank> <processes> <port> <outdir>
    torch_dp_worker.py update_tp <rank> <processes> <port> <outdir>
    torch_dp_worker.py poly <rank> <processes> <port> <savedir>
        <total_steps>
    torch_dp_worker.py poly_ep <rank> <processes> <port> <savedir>
        <total_steps>
    torch_dp_worker.py poly_tp <rank> <processes> <port> <savedir>
        <total_steps> [native]
    torch_dp_worker.py poly_sp <rank> <processes> <port> <savedir>
        <total_steps> [native]

`update`: the DP update over every process's shards of one 8-row batch
(each process passes its rows) against the one-device update on all 8
rows, computed in each process; the params are saved to
<outdir>/params<rank>.npy. `poly`: polybeast through its own parser with
--coordinator_address, 2 Mock env servers a process, a 4-device learner.
`update_ep` and `poly_ep` do the same for the MoE transformer
(tests/test_torch_ep.py's) on a (data = processes) x (expert 2) mesh,
each process one data row of 2 expert devices: the routing counts are
all_gathered across the processes in every MoE layer. `update_tp` and
`poly_tp` do so for the transformer (tests/test_torch_tp.py's) on a
(data = processes) x (model 2) mesh, each process one data row of 2
model devices (`poly_tp` on the Python pool, or with `native` on the
C++ core). `poly_sp` runs the transformer with --sequence_parallel 2 on
a (data = processes) x (seq 2) mesh, each process one data row of 2 seq
devices.

Everything runs under the __main__ guard: polybeast's env servers are
fresh interpreters, and this module must not join the group at import.
"""

import os
import sys


def update(rank, procs, port, outdir):
    import numpy as np
    import torch

    from tests.test_torch_parallel import (
        A, B, FRAME, STAT_KEYS, _hp, _torch, make_batch)
    from torchbeast_tpu_torch import learner as learner_lib
    from torchbeast_tpu_torch import parallel
    from torchbeast_tpu_torch.models import create_model

    torch.set_num_threads(1)
    parallel.initialize_distributed(f"127.0.0.1:{port}", procs, rank,
                                    backend="gloo")
    torch.manual_seed(3)
    model = create_model("shallow", A, use_lstm=True, frame_shape=FRAME)
    twin = __import__("copy").deepcopy(model)
    hp = learner_lib.HParams(**_hp())
    rng = np.random.default_rng(5)
    state = tuple(torch.from_numpy(
        (0.5 * rng.standard_normal(s.shape)).astype(np.float32))
        for s in model.initial_state(B))
    batch = _torch(make_batch())
    opt = learner_lib.make_optimizer(hp, list(model.parameters()))
    want = learner_lib.update_body(model, opt, hp)(batch, state)

    mesh = parallel.create_mesh(2 * procs)
    assert mesh.shape == {"data": 2 * procs, "model": 1}, mesh.shape
    rows = slice(rank * B // procs, (rank + 1) * B // procs)
    opt2 = learner_lib.make_optimizer(hp, list(twin.parameters()))
    update = parallel.make_parallel_update_step(twin, opt2, hp, mesh)
    got = update({k: v[:, rows] for k, v in batch.items()},
                 tuple(s[:, rows] for s in state))
    for key in STAT_KEYS:
        np.testing.assert_allclose(float(got[key]), float(want[key]),
                                   rtol=1e-4, err_msg=key)
    for p, q in zip(model.parameters(), twin.parameters()):
        np.testing.assert_allclose(q.detach().numpy(), p.detach().numpy(),
                                   rtol=1e-5, atol=2e-6)
    flat = torch.cat([p.detach().reshape(-1) for p in twin.parameters()])
    np.save(os.path.join(outdir, f"params{rank}.npy"), flat.numpy())
    torch.distributed.destroy_process_group()
    print("two-process update matches one device OK")


def update_ep(rank, procs, port, outdir):
    import numpy as np
    import torch

    from tests.test_torch_ep import (
        A, B, FRAME, KW, STAT_KEYS, _hp, _torch, make_batch)
    from torchbeast_tpu_torch import learner as learner_lib
    from torchbeast_tpu_torch import parallel
    from torchbeast_tpu_torch.models import create_model

    torch.set_num_threads(1)
    parallel.initialize_distributed(f"127.0.0.1:{port}", procs, rank,
                                    backend="gloo")
    torch.manual_seed(3)
    model = create_model("transformer", A, frame_shape=FRAME, **KW)
    twin = __import__("copy").deepcopy(model)
    hp = learner_lib.HParams(**_hp())
    state = model.initial_state(B)
    batch = _torch(make_batch())
    opt = learner_lib.make_optimizer(hp, list(model.parameters()))
    want = learner_lib.update_body(model, opt, hp)(batch, state)

    mesh = parallel.create_mesh(2 * procs, expert_parallelism=2)
    assert mesh.shape == {"data": procs, "model": 1, "expert": 2}, mesh.shape
    rows = slice(rank * B // procs, (rank + 1) * B // procs)
    opt2 = learner_lib.make_optimizer(hp, list(twin.parameters()))
    update = parallel.make_parallel_update_step(twin, opt2, hp, mesh)
    got = update({k: v[:, rows] for k, v in batch.items()},
                 tuple(tuple(t[:, rows] for t in layer) for layer in state))
    for key in STAT_KEYS:
        np.testing.assert_allclose(float(got[key]), float(want[key]),
                                   rtol=1e-4, err_msg=key)
    for p, q in zip(model.parameters(), twin.parameters()):
        np.testing.assert_allclose(q.detach().numpy(), p.detach().numpy(),
                                   rtol=1e-4, atol=1e-6)
    flat = torch.cat([p.detach().reshape(-1) for p in twin.parameters()])
    np.save(os.path.join(outdir, f"params{rank}.npy"), flat.numpy())
    torch.distributed.destroy_process_group()
    print("two-process data x expert update matches one device OK")


def update_tp(rank, procs, port, outdir):
    import numpy as np
    import torch

    from tests.test_torch_ep import A, B, FRAME, STAT_KEYS, _hp, _torch
    from tests.test_torch_ep import make_batch
    from tests.test_torch_tp import KW
    from torchbeast_tpu_torch import learner as learner_lib
    from torchbeast_tpu_torch import parallel
    from torchbeast_tpu_torch.models import create_model

    torch.set_num_threads(1)
    parallel.initialize_distributed(f"127.0.0.1:{port}", procs, rank,
                                    backend="gloo")
    torch.manual_seed(3)
    model = create_model("transformer", A, frame_shape=FRAME, **KW)
    twin = __import__("copy").deepcopy(model)
    hp = learner_lib.HParams(**_hp())
    state = model.initial_state(B)
    batch = _torch(make_batch())
    opt = learner_lib.make_optimizer(hp, list(model.parameters()))
    want = learner_lib.update_body(model, opt, hp)(batch, state)

    mesh = parallel.create_mesh(2 * procs, model_parallelism=2)
    assert mesh.shape == {"data": procs, "model": 2}, mesh.shape
    rows = slice(rank * B // procs, (rank + 1) * B // procs)
    opt2 = learner_lib.make_optimizer(hp, list(twin.parameters()))
    update = parallel.make_parallel_update_step(twin, opt2, hp, mesh)
    got = update({k: v[:, rows] for k, v in batch.items()},
                 tuple(tuple(t[:, rows] for t in layer) for layer in state))
    for key in STAT_KEYS:
        if key in want:
            np.testing.assert_allclose(float(got[key]), float(want[key]),
                                       rtol=1e-4, err_msg=key)
    for p, q in zip(model.parameters(), twin.parameters()):
        np.testing.assert_allclose(q.detach().numpy(), p.detach().numpy(),
                                   rtol=1e-4, atol=1e-6)
    flat = torch.cat([p.detach().reshape(-1) for p in twin.parameters()])
    np.save(os.path.join(outdir, f"params{rank}.npy"), flat.numpy())
    torch.distributed.destroy_process_group()
    print("two-process data x model update matches one device OK")


def poly(rank, procs, port, savedir, total_steps, ep=False, tp=False,
         native=False, sp=False):
    from torchbeast_tpu_torch import polybeast

    model = (["--model", "transformer", "--num_experts", "4",
              "--expert_parallel", "2", "--num_learner_devices", "2"]
             if ep else ["--model", "transformer", "--tensor_parallel",
                         "2", "--num_learner_devices", "2"]
             if tp else ["--model", "transformer", "--sequence_parallel",
                         "2", "--num_learner_devices", "2"]
             if sp else ["--model", "shallow", "--use_lstm",
                         "--num_learner_devices", "4"])
    runtime = (["--native_runtime"] if native
               else ["--no_native_runtime"])
    flags = polybeast.make_parser().parse_args([
        "--disable_cuda", "--env", "Mock", *model, "--xpid", "poly-dist",
        "--coordinator_address", f"127.0.0.1:{port}",
        "--num_servers", "2", "--batch_size", "4", "--unroll_length", "5",
        "--total_steps", str(total_steps),
        "--savedir", savedir, "--pipes_basename",
        f"unix:{savedir}/pipes{rank}", "--max_inference_batch_size", "4",
        *runtime, "--checkpoint_interval_s", "100000"])
    stats = polybeast.main(flags)
    print(f"worker {rank}: final step {stats['step']} updates "
          f"{stats['updates']}")


def main():
    mode, rank, procs, port = sys.argv[1], *map(int, sys.argv[2:5])
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    os.environ["TORCHBEAST_NUM_PROCESSES"] = str(procs)
    os.environ["TORCHBEAST_PROCESS_ID"] = str(rank)
    import logging

    logging.basicConfig(level=logging.INFO)
    if mode == "update":
        update(rank, procs, port, sys.argv[5])
    elif mode == "update_ep":
        update_ep(rank, procs, port, sys.argv[5])
    elif mode == "update_tp":
        update_tp(rank, procs, port, sys.argv[5])
    else:
        poly(rank, procs, port, sys.argv[5], int(sys.argv[6]),
             ep=mode == "poly_ep", tp=mode == "poly_tp",
             native=sys.argv[7:] == ["native"], sp=mode == "poly_sp")


if __name__ == "__main__":
    main()

"""Worker of the port's fleet driver tests: one host of a polybeast
--fleet run on the CPU.

    torch_fleet_worker.py <rank> <hosts> <port> <savedir> <total_steps>
        <wire|group>

`wire`: the CPU's own strategy (no process group; the coordinator
averages the params after each dispatch). `group`: the process-group
strategy the card takes, on the CPU: parallel.fleet_strategy answers
"xla" here, and the host joins the fleet's gloo group first (the
rendezvous address, the host count as world size, the host rank), so
the learner mesh spans the hosts. The last stdout
line is one JSON object: the run's step and health, and a digest of the
learner's params at the end.

Everything runs under the __main__ guard: polybeast's env servers are
fresh interpreters.
"""

import hashlib
import json
import sys


def main():
    rank, hosts, port, savedir, total_steps, mode = sys.argv[1:7]
    import torch

    from torchbeast_tpu_torch import monobeast, parallel, polybeast

    torch.set_num_threads(1)
    built = []
    build_model = monobeast.build_model

    def capture(*args, **kwargs):
        model = build_model(*args, **kwargs)
        built.append(model)
        return model

    monobeast.build_model = capture
    polybeast._configure_logging()
    flags = polybeast.make_parser().parse_args([
        "--disable_cuda", "--env", "Mock", "--num_servers", "2",
        "--batch_size", "4", "--unroll_length", "5", "--total_steps",
        total_steps, "--max_inference_batch_size", "4",
        "--pipes_basename", f"unix:{savedir}/pipes", "--savedir", savedir,
        "--xpid", "fleet", "--replica_refresh_updates", "1",
        "--checkpoint_interval_s", "100000",
        "--fleet", f"host={rank}/{hosts},coord=127.0.0.1:{port}"])
    if mode == "group":
        parallel.fleet_strategy = lambda device: "xla"
        parallel.initialize_distributed(f"127.0.0.1:{port}", int(hosts),
                                        int(rank), backend="gloo")
        try:
            stats = polybeast.train(flags)
        finally:
            torch.distributed.destroy_process_group()
    else:
        stats = polybeast.train(flags)
    digest = hashlib.sha256()
    for p in built[0].parameters():
        digest.update(p.detach().contiguous().numpy().tobytes())
    print(json.dumps({"rank": int(rank), "step": int(stats["step"]),
                      "health": stats["health"],
                      "params": digest.hexdigest()}))


if __name__ == "__main__":
    main()

"""The cells of BENCHMARK.json at sizes a CPU test holds: T=3, B=2; the
deep trunk at 4/8/8 channels on 16x16 frames, the shallow one on 36x36
frames (its smallest). Every other setting is the cell's own."""

import copy

from portbench import cells


def tiny(workload: str):
    cell = cells.load(workload)
    config = copy.deepcopy(cell.config)
    traffic = dict(cell.traffic, unroll_length=3, batch_size=2,
                   trace_updates=2)
    if config["reference"] == "impala_resnet":
        config["net"]["channels"] = [4, 8, 8]
        config["argv"] += ["--trunk_channels", "4,8,8"]
        config["frame_shape"] = [16, 16, 4]
    else:
        config["frame_shape"] = [36, 36, 4]
    return cell._replace(config=config, traffic=traffic)


WORKLOADS = ("deep_lstm.learn", "shallow_lstm.learn")

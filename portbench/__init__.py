"""portbench: the benchmark of torchbeast_tpu_torch, the PyTorch and CUDA
port, on one or more NVIDIA GPUs.

One run measures one cell of BENCHMARK.json (a configuration under a
traffic mix) for --seconds and prints one JSON line:

    python3 -m portbench.run --workload deep_lstm.learn --seed 7 \\
        --seconds 20 --trace 0

Everything that belongs to one configuration, traffic mix or metric is a
file of its own, found by the name BENCHMARK.json gives it:
`configs/<config>.json` (the program's flags, the sizes, the math mode,
the limits of the output check), `traffic/<traffic>.json` (the
parameters that `generate` draws the inputs from), `metrics/<metric>.py`
(a reader with `read(ctx)`) and `reference/<network>.py` (the plain
network that the output check follows). Nothing here imports jax or the
JAX package, and the reference imports nothing of the program.
"""

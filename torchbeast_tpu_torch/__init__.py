"""torchbeast_tpu_torch: the PyTorch + CUDA port of torchbeast_tpu.

The JAX package (`torchbeast_tpu/`) is the reference; this package mirrors
its module names so each counterpart is easy to find, and runs on an
NVIDIA H100. Every Pallas kernel of the reference that the port covers is
a hand-written CUDA kernel under `csrc/`, built at first use by
`ops/_build.py` and held against its plain PyTorch version by the repo
root's `chip_smoke.py`.

The package imports torch and numpy only — never jax, flax, optax or any
module of `torchbeast_tpu` (importing that package loads jax).
"""

"""Fresh weights drawn as flax draws them (the reference's modules keep
flax's default initialisers).

- Conv and dense kernels: lecun_normal, jax's
  `variance_scaling(1.0, "fan_in", "truncated_normal")`: a standard normal
  truncated to [-2, 2], times sqrt(1 / fan_in) / 0.8796..., the std of
  that truncated normal, so the drawn kernel has variance 1 / fan_in.
  fan_in is the product of the JAX leaf's input axes: kh * kw * C_in for
  a Conv, the input features for a Dense, d_model for a DenseGeneral
  q/k/v (kernel [d, H, hd]) and H * hd for the DenseGeneral `out`
  (kernel [H, hd, d]; flax reshapes a DenseGeneral kernel to
  (prod(in axes), prod(out axes)) before it draws).
- The MoE leaves (models/moe.py): the router's kernel [d, E] is a Dense
  kernel, fan_in d. The expert kernels w_in [E, d, ff] and w_out
  [E, ff, d] are rank-3 leaves, and flax's `variance_scaling` counts
  every axis but the last two in the receptive field, so the leading
  expert axis multiplies fan_in: d * E for w_in and ff * E for w_out.
  b_in and b_out are zeros.
- Biases: zeros (torch.nn.init.zeros_).
- `nn.OptimizedLSTMCell`'s recurrent kernels: orthogonal, each gate's
  [H, H] block on its own (flax makes hi, hf, hg, ho as four params); its
  input kernels lecun_normal with fan_in = D.

Every draw is f32 from the global generator, so the caller seeds it
(monobeast.build_model under `fork_rng`); the precision policy casts the
params afterwards, as the reference casts its f32 init. The two
packages' generators differ, so equal seeds give equal distributions,
never equal bits.
"""

import math

import torch

# The std of a standard normal truncated to [-2, 2] (jax.nn.initializers'
# variance_scaling constant).
TRUNCATED_STD = 0.87962566103423978


@torch.no_grad()
def lecun_normal_(t: torch.Tensor, fan_in: int,
                  generator=None) -> torch.Tensor:
    """Fill t with lecun_normal for `fan_in`: cut at +-2 std. torch's
    trunc_normal_ takes its cut-offs as values, not in units of std.
    `generator` (one on t's device) in place of the global one."""
    std = math.sqrt(1.0 / fan_in) / TRUNCATED_STD
    return torch.nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std,
                                       generator=generator)


@torch.no_grad()
def orthogonal_gates_(t: torch.Tensor) -> torch.Tensor:
    """Each [H, H] gate block of an LSTM's [4H, H] recurrent weight
    orthogonal on its own, drawn as flax's `orthogonal()` draws a square
    kernel: the Q of a QR of a standard normal matrix, its columns' signs
    fixed by R's diagonal (torch's orthogonal_ does the same)."""
    for block in t.chunk(4, 0):
        torch.nn.init.orthogonal_(block)
    return t

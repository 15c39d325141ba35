"""The port's V-trace and fused losses (torchbeast_tpu_torch/ops/vtrace.py,
ops/losses.py) against the JAX package on the CPU.

Inputs are made with numpy from a fixed seed and handed to both
packages. The JAX side runs its Pallas kernel as its own tests do on the
CPU (interpreted); the port's "pallas" impl runs the kernel's plain
PyTorch version on a CPU tensor. Tolerance: rtol 1e-5 (the impls differ
only by float reassociation), atol 1e-5 for values near zero.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torchbeast_tpu.ops import losses as jax_losses
from torchbeast_tpu.ops import vtrace as jax_vtrace
from torchbeast_tpu_torch.ops import losses as port_losses
from torchbeast_tpu_torch.ops import vtrace as port_vtrace
from tests.torch_port_fixtures import few_torch_threads  # noqa: F401

RTOL, ATOL = 1e-5, 1e-5


def _inputs(T, B, seed=0):
    rng = np.random.default_rng(seed)
    return dict(
        log_rhos=rng.uniform(-2.5, 2.5, (T, B)).astype(np.float32),
        discounts=((rng.random((T, B)) > 0.1) * 0.99).astype(np.float32),
        rewards=rng.standard_normal((T, B)).astype(np.float32),
        values=(2 * rng.standard_normal((T, B))).astype(np.float32),
        bootstrap_value=(2 * rng.standard_normal(B)).astype(np.float32),
    )


def _port(x):
    return {k: torch.from_numpy(v) for k, v in x.items()}


@pytest.mark.parametrize("T", [1, 80])
@pytest.mark.parametrize("scan_impl", port_vtrace.SCAN_IMPLS)
def test_from_importance_weights_matches_jax(scan_impl, T):
    x = _inputs(T, 8, seed=T)
    want = jax_vtrace.from_importance_weights(**x, scan_impl=scan_impl)
    got = port_vtrace.from_importance_weights(**_port(x), scan_impl=scan_impl)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), RTOL, ATOL)


@functools.lru_cache(maxsize=1)
def _long_unroll_reference():
    x = _inputs(4000, 16, seed=3)
    return x, jax_vtrace.from_importance_weights(**x,
                                                 scan_impl="associative")


@pytest.mark.parametrize("scan_impl", port_vtrace.SCAN_IMPLS)
def test_long_unroll_matches_jax_associative(scan_impl):
    x, want = _long_unroll_reference()
    got = port_vtrace.from_importance_weights(**_port(x), scan_impl=scan_impl)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), RTOL, ATOL)


@pytest.mark.parametrize("clip", [(1.0, 1.0), (3.7, 2.2), (None, None)])
def test_clip_thresholds_match_jax(clip):
    x = _inputs(12, 4, seed=7)
    kw = dict(clip_rho_threshold=clip[0], clip_pg_rho_threshold=clip[1])
    want = jax_vtrace.from_importance_weights(**x, scan_impl="sequential",
                                              **kw)
    got = port_vtrace.from_importance_weights(**_port(x), scan_impl="pallas",
                                              **kw)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), RTOL, ATOL)


def _loss_inputs(T=20, B=4, A=5, seed=11):
    rng = np.random.default_rng(seed)
    return dict(
        behavior_policy_logits=rng.standard_normal((T, B, A)).astype(
            np.float32),
        target_policy_logits=rng.standard_normal((T, B, A)).astype(
            np.float32),
        actions=rng.integers(0, A, (T, B)).astype(np.int32),
        discounts=((rng.random((T, B)) > 0.1) * 0.99).astype(np.float32),
        rewards=rng.standard_normal((T, B)).astype(np.float32),
        values=rng.standard_normal((T, B)).astype(np.float32),
        bootstrap_value=rng.standard_normal(B).astype(np.float32),
    )


@pytest.mark.parametrize("scan_impl", port_vtrace.SCAN_IMPLS)
def test_fused_policy_losses_and_grads_match_jax(scan_impl):
    x = _loss_inputs()

    def jax_total(logits, values):
        pg, base = jax_losses.vtrace_policy_losses(
            **{**x, "target_policy_logits": logits, "values": values},
            scan_impl=scan_impl,
        )
        return pg + base, (pg, base)

    (_, (jpg, jbase)), (jg_logits, jg_values) = jax.value_and_grad(
        jax_total, argnums=(0, 1), has_aux=True
    )(jnp.asarray(x["target_policy_logits"]), jnp.asarray(x["values"]))

    t = _port(x)
    logits = t["target_policy_logits"].clone().requires_grad_(True)
    values = t["values"].clone().requires_grad_(True)
    pg, base = port_losses.vtrace_policy_losses(
        **{**t, "target_policy_logits": logits, "values": values},
        scan_impl=scan_impl,
    )
    (pg + base).backward()
    np.testing.assert_allclose(float(pg.detach()), float(jpg), RTOL)
    np.testing.assert_allclose(float(base.detach()), float(jbase), RTOL)
    np.testing.assert_allclose(logits.grad.numpy(), np.asarray(jg_logits),
                               RTOL, ATOL)
    np.testing.assert_allclose(values.grad.numpy(), np.asarray(jg_values),
                               RTOL, ATOL)


def test_from_logits_and_separate_losses_match_jax():
    x = _loss_inputs(seed=5)
    want = jax_vtrace.from_logits(**x)
    got = port_vtrace.from_logits(**_port(x))
    for field in want._fields:
        np.testing.assert_allclose(
            getattr(got, field).detach().numpy(),
            np.asarray(getattr(want, field)), RTOL, ATOL, err_msg=field,
        )
    logits = x["target_policy_logits"]
    adv = np.array(want.pg_advantages)
    pairs = [
        (jax_losses.compute_entropy_loss(logits),
         port_losses.compute_entropy_loss(torch.from_numpy(logits))),
        (jax_losses.compute_baseline_loss(adv),
         port_losses.compute_baseline_loss(torch.from_numpy(adv))),
        (jax_losses.compute_policy_gradient_loss(logits, x["actions"], adv),
         port_losses.compute_policy_gradient_loss(
             torch.from_numpy(logits), torch.from_numpy(x["actions"]),
             torch.from_numpy(adv))),
    ]
    for w, g in pairs:
        np.testing.assert_allclose(float(g), float(w), RTOL)


def test_targets_carry_no_gradient_and_upcast_to_f32():
    x = _port(_inputs(6, 3))
    x["values"] = x["values"].double().requires_grad_(True)
    for impl in port_vtrace.SCAN_IMPLS:
        out = port_vtrace.from_importance_weights(**x, scan_impl=impl)
        for t in out:
            assert t.dtype == torch.float32
            assert not t.requires_grad


def test_kernel_wrapper_checks_inputs():
    x = [torch.zeros(4, 3) for _ in range(6)] + [torch.zeros(3)]
    port_vtrace.vtrace_targets(*x)
    with pytest.raises(ValueError, match="dtype"):
        port_vtrace.vtrace_targets(*x[:6], torch.zeros(3, dtype=torch.float64))
    with pytest.raises(ValueError, match="bootstrap_value"):
        port_vtrace.vtrace_targets(*x[:6], torch.zeros(4))
    with pytest.raises(ValueError, match="shape"):
        port_vtrace.vtrace_targets(torch.zeros(4, 2), *x[1:])
    with pytest.raises(ValueError, match="scan_impl"):
        port_vtrace.from_importance_weights(
            *[torch.zeros(2, 2)] * 4, torch.zeros(2), scan_impl="bogus")


def test_cpu_tensors_take_the_plain_version():
    before = port_vtrace.vtrace_targets.launches
    x = _port(_inputs(5, 2))
    port_vtrace.from_importance_weights(**x, scan_impl="pallas")
    assert port_vtrace.vtrace_targets.launches == before

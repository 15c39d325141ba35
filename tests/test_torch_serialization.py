"""The port's msgpack codec (torchbeast_tpu_torch/utils/serialization.py)
against flax.serialization, in both directions: the same trees give the
same bytes, and each package reads the other's bytes bit for bit (f32,
int32, uint8 and bfloat16 leaves, numpy scalars, None, and the scalar
kinds a checkpoint's flags and stats hold)."""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import flax.serialization as flax_ser  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from torchbeast_tpu_torch.utils import serialization  # noqa: E402


def _bf16_pair(rng, shape):
    """One bfloat16 leaf as flax holds it (an ml_dtypes array) and as the
    port holds it (a torch.bfloat16 tensor), with equal bits."""
    ref = np.asarray(jnp.asarray(rng.standard_normal(shape), jnp.bfloat16))
    bits = np.array(ref.view(np.int16))
    return ref, torch.from_numpy(bits).view(torch.bfloat16)


def _trees(seed=0):
    """(flax's tree, the port's tree): equal but for the bf16 leaves'
    container."""
    rng = np.random.default_rng(seed)
    bf_ref, bf_port = _bf16_pair(rng, (3, 5))
    common = {
        "params": {
            "Conv_0": {
                "kernel": rng.standard_normal((3, 3, 4, 16)).astype(
                    np.float32),
                "bias": np.zeros(16, np.float32),
            },
            "steps": np.arange(7, dtype=np.int32),
            "frame": rng.integers(0, 256, (2, 84), dtype=np.uint8),
            "flag": np.array([True, False]),
            "empty": np.zeros((0,), np.float32),
        },
        "count": np.asarray(3, np.int32),
        "scalar_f32": np.float32(2.5),
        "scalar_i32": np.int32(-7),
        "mom": None,
        "flags": {"env": "Mock", "lr": 4.8e-4, "seed": 1234, "big": 2 ** 40,
                  "neg": -300, "on": True, "off": False, "none": None,
                  "long": "x" * 300},
        "wide": {str(i): i for i in range(20)},
        "blob": b"\x00\x01" * 200,
    }
    ref = dict(common, bf=bf_ref)
    port = dict(common, bf=bf_port)
    return ref, port


def _equal_bits(a, b):
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b)
        for k in a:
            _equal_bits(a[k], b[k])
        return
    if a is None or isinstance(a, (str, bytes, bool, int, float)):
        assert a == b and type(a) is type(b), (a, b)
        return
    if torch.is_tensor(a) or torch.is_tensor(b):
        bits = []
        for x in (a, b):
            if torch.is_tensor(x):
                assert x.dtype == torch.bfloat16
                bits.append(x.view(torch.int16).numpy())
            else:
                assert np.asarray(x).dtype.name == "bfloat16"
                bits.append(np.asarray(x).view(np.int16))
        np.testing.assert_array_equal(*bits)
        return
    assert np.asarray(a).dtype == np.asarray(b).dtype
    assert np.shape(a) == np.shape(b)
    assert type(a) is type(b) or (isinstance(a, np.ndarray)
                                  and isinstance(b, np.ndarray))
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_serialize_writes_flax_bytes():
    """msgpack_serialize (sorted maps, as flax's not-in-place serialize)
    and to_bytes (the tree's own order) give flax's bytes exactly."""
    ref, port = _trees()
    assert serialization.msgpack_serialize(port) == \
        flax_ser.msgpack_serialize(ref)
    assert serialization.to_bytes(port) == flax_ser.to_bytes(ref)


def test_flax_reads_the_ports_bytes_bit_for_bit():
    ref, port = _trees(1)
    _equal_bits(flax_ser.msgpack_restore(
        serialization.msgpack_serialize(port)), ref)


def test_the_port_reads_flaxs_bytes_bit_for_bit():
    ref, port = _trees(2)
    got = serialization.msgpack_restore(flax_ser.msgpack_serialize(ref))
    _equal_bits(got, port)
    assert isinstance(got["scalar_f32"], np.float32)
    assert got["bf"].dtype == torch.bfloat16


def test_lists_and_tuples_become_index_maps():
    tree = {"chain": (np.zeros(2, np.float32), [None, np.int32(1)])}
    assert serialization.to_bytes(tree) == flax_ser.to_bytes(tree)
    assert serialization.to_state_dict(tree) == {
        "chain": {"0": tree["chain"][0], "1": {"0": None, "1": 1}}}


def test_chunked_leaves_and_other_ext_codes_raise():
    chunked = {"w": {serialization.CHUNKED: True, "shape": {"0": 2},
                     "chunks": {"0": np.zeros(2, np.float32)}}}
    with pytest.raises(serialization.CheckpointFormatError, match="chunked"):
        serialization.msgpack_restore(flax_ser.msgpack_serialize(chunked))
    complex_ext = flax_ser.msgpack_serialize({"c": 1 + 2j})
    with pytest.raises(serialization.CheckpointFormatError, match="ext"):
        serialization.msgpack_restore(complex_ext)


def test_tensors_and_numpy_convert_both_ways():
    _, port = _trees(3)
    tree = {"a": port["params"]["Conv_0"], "bf": port["bf"]}
    tensors = serialization.to_tensors(tree)
    assert torch.equal(tensors["a"]["kernel"],
                       torch.from_numpy(tree["a"]["kernel"]))
    host = serialization.to_numpy(tensors)
    assert host["bf"].dtype == np.float32
    np.testing.assert_array_equal(host["bf"], port["bf"].float().numpy())

"""The port's kernel build (torchbeast_tpu_torch/ops/_build.py) on the CPU:
the ctypes argument types it sets must match the C entry points that the
CUDA sources declare, parameter for parameter, since ctypes converts each
argument by the declared type and a mismatch shows only on the GPU."""

import ctypes
import os
import re

import pytest

from torchbeast_tpu_torch.ops import _build

_DECL = re.compile(r"TBT_API\s+int\s+(\w+)\s*\(([^)]*)\)", re.S)


def _declared():
    """{entry point name: [ctypes type per parameter]} from the sources."""
    out = {}
    for path in _build.sources():
        if not path.endswith(".cu"):
            continue
        with open(path) as f:
            text = f.read()
        for name, params in _DECL.findall(text):
            types = []
            for param in params.split(","):
                param = " ".join(param.split())
                if "*" in param:
                    types.append(ctypes.c_void_p)
                elif param.startswith("float "):
                    types.append(ctypes.c_float)
                elif param.startswith("int "):
                    types.append(ctypes.c_int)
                else:
                    raise AssertionError(
                        f"{os.path.basename(path)}: {name}: parameter "
                        f"{param!r} has no ctypes mapping here")
            out[name] = types
    return out


def test_every_entry_point_has_a_signature():
    assert set(_declared()) == set(_build.SIGNATURES)


@pytest.mark.parametrize("name", sorted(_build.SIGNATURES))
def test_signature_matches_the_c_declaration(name):
    assert _build.SIGNATURES[name] == _declared()[name]

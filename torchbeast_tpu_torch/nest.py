"""Nested-structure helpers over tensors and numpy arrays (the subset of
torchbeast_tpu/nest.py that the port's rollout uses).

A nest is a leaf, or a tuple/list/dict/NamedTuple of nests. Dicts keep
their insertion order (the reference's jax pytrees sort keys; nothing in
the port depends on either order).
"""

from typing import Any, Callable


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def map(fn: Callable[[Any], Any], nest: Any) -> Any:  # noqa: A001
    """Apply fn to every leaf, preserving structure."""
    if _is_namedtuple(nest):
        return type(nest)(*(map(fn, v) for v in nest))
    if isinstance(nest, (tuple, list)):
        return type(nest)(map(fn, v) for v in nest)
    if isinstance(nest, dict):
        return {k: map(fn, v) for k, v in nest.items()}
    return fn(nest)


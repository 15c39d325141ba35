"""Nested-structure helpers over tensors and numpy arrays (the port's
copy of torchbeast_tpu/nest.py, whose functions wrap jax.tree_util).

A nest is a leaf, None (an empty nest, as in a jax pytree), or a
tuple/list/dict/NamedTuple of nests. `map` keeps a dict's insertion
order; `flatten`, `pack_as` and `front` visit a dict's keys sorted, as
jax's pytrees do, so a flatten/pack_as round trip rebuilds any nest.
"""

from typing import Any, Callable, List, Sequence


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def map(fn: Callable[[Any], Any], nest: Any) -> Any:  # noqa: A001
    """Apply fn to every leaf, preserving structure."""
    if nest is None:
        return None
    if _is_namedtuple(nest):
        return type(nest)(*(map(fn, v) for v in nest))
    if isinstance(nest, (tuple, list)):
        return type(nest)(map(fn, v) for v in nest)
    if isinstance(nest, dict):
        return {k: map(fn, v) for k, v in nest.items()}
    return fn(nest)


def _children(nest):
    if isinstance(nest, dict):
        return [nest[k] for k in sorted(nest)]
    return list(nest)


def _is_node(nest) -> bool:
    return nest is None or isinstance(nest, (tuple, list, dict))


def flatten(nest: Any) -> List[Any]:
    """Depth-first list of leaves (dict keys sorted)."""
    if nest is None:
        return []
    if not _is_node(nest):
        return [nest]
    return [leaf for child in _children(nest) for leaf in flatten(child)]


def _pack(nest, leaves):
    if nest is None:
        return None
    if not _is_node(nest):
        return next(leaves)
    if isinstance(nest, dict):
        return {k: _pack(nest[k], leaves) for k in sorted(nest)}
    values = [_pack(v, leaves) for v in nest]
    if _is_namedtuple(nest):
        return type(nest)(*values)
    return type(nest)(values)


def pack_as(nest: Any, flat: Sequence[Any]) -> Any:
    """Inverse of flatten against a template structure."""
    flat = list(flat)
    n = len(flatten(nest))
    if n != len(flat):
        raise ValueError(
            f"Structure had {n} leaves, but {len(flat)} values were given "
            "to pack_as"
        )
    return _pack(nest, iter(flat))


def front(nest: Any) -> Any:
    """First leaf in depth-first order."""
    leaves = flatten(nest)
    if not leaves:
        raise ValueError("front() called on empty nest")
    return leaves[0]

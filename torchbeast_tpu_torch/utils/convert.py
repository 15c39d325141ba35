"""Convert checkpointed params between the two transformer layouts
(counterpart of torchbeast_tpu/utils/convert.py, without flax or jax).

`TransformerNet` keeps one scope per block (`block_i/q/kernel`,
`block_i/Dense_0/...` in the reference's tree); `PipelinedTransformerNet`
keeps every block parameter as one stacked `[L, ...]` leaf (`wq`, `w1`,
...). The two compute the same function (the shared attention body and
cache roll of ops/attention.py, the same LayerNorm epsilon and FFN), so a
converted checkpoint carries the same policy across: a run trained with
one family continues with the other.

`transformer_to_pipelined` and `pipelined_to_transformer` map the
reference's params trees (nested dicts of numpy arrays, or of torch
tensors: a checkpoint's bf16 leaves decode to torch.bfloat16 tensors,
utils/serialization.py), under "params" or bare, with the reference's
leaf map and refusals. `convert_checkpoint` converts a whole checkpoint
file (utils/checkpoint.py's format, which both packages write): the
params, every params-shaped subtree of the optimizer state (RMSprop's
nu, the momentum trace, the f32 master), every params-shaped subtree of
the `extra` blobs, and the recorded `flags.model`.

    python -m torchbeast_tpu_torch.utils.convert --input model.ckpt \\
        --output converted.ckpt --to {pipelined,sequential}
"""

import argparse
from typing import Any, Dict

import numpy as np
import torch

from torchbeast_tpu_torch.utils import serialization
from torchbeast_tpu_torch.utils.checkpoint import atomic_write, read_payload

# (sequential per-block path, stacked leaf) pairs; q/k/v/out are scopes
# with kernel+bias, LayerNorms are scopes with scale+bias.
_LEAF_MAP = (
    (("q", "kernel"), "wq"),
    (("q", "bias"), "bq"),
    (("k", "kernel"), "wk"),
    (("k", "bias"), "bk"),
    (("v", "kernel"), "wv"),
    (("v", "bias"), "bv"),
    (("out", "kernel"), "wo"),
    (("out", "bias"), "bo"),
    (("rel_bias",), "rel_bias"),
    (("LayerNorm_0", "scale"), "ln1_scale"),
    (("LayerNorm_0", "bias"), "ln1_bias"),
    (("LayerNorm_1", "scale"), "ln2_scale"),
    (("LayerNorm_1", "bias"), "ln2_bias"),
    (("Dense_0", "kernel"), "w1"),
    (("Dense_0", "bias"), "b1"),
    (("Dense_1", "kernel"), "w2"),
    (("Dense_1", "bias"), "b2"),
)


def _unwrap(params: Dict) -> Dict:
    return params["params"] if set(params) == {"params"} else params


def _get(tree: Dict, path):
    for key in path:
        tree = tree[key]
    return tree


def _set(tree: Dict, path, value):
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def _stack(leaves):
    if any(torch.is_tensor(leaf) for leaf in leaves):
        return torch.stack([torch.as_tensor(leaf) for leaf in leaves])
    return np.stack(leaves, axis=0)


def transformer_to_pipelined(params: Any) -> Dict:
    """TransformerNet param tree -> PipelinedTransformerNet param tree."""
    p = _unwrap(params)
    blocks = sorted(
        (k for k in p if k.startswith("block_")),
        key=lambda k: int(k.split("_")[1]),
    )
    if not blocks:
        raise ValueError("no block_* scopes — not a TransformerNet tree")
    if any("moe" in p[b] for b in blocks):
        raise ValueError(
            "MoE blocks cannot convert: PipelinedTransformerNet has no "
            "MoE formulation (its FFN is dense by design)"
        )
    out: Dict = {}
    for path, stacked in _LEAF_MAP:
        out[stacked] = _stack([_get(p[b], path) for b in blocks])
    out["encoder"] = p["Dense_0"]  # frame encoder
    out["extras"] = p["extras"]
    out["final_scale"] = p["LayerNorm_0"]["scale"]
    out["final_bias"] = p["LayerNorm_0"]["bias"]
    out["head"] = p["head"]
    return {"params": out}


def pipelined_to_transformer(params: Any) -> Dict:
    """PipelinedTransformerNet param tree -> TransformerNet param tree."""
    p = _unwrap(params)
    if "wq" not in p:
        raise ValueError(
            "no stacked `wq` leaf — not a PipelinedTransformerNet tree"
        )
    num_layers = p["wq"].shape[0]
    out: Dict = {}
    for layer in range(num_layers):
        block: Dict = {}
        for path, stacked in _LEAF_MAP:
            _set(block, path, p[stacked][layer])
        out[f"block_{layer}"] = block
    out["Dense_0"] = p["encoder"]
    out["extras"] = p["extras"]
    out["LayerNorm_0"] = {
        "scale": p["final_scale"],
        "bias": p["final_bias"],
    }
    out["head"] = p["head"]
    return {"params": out}


def _is_sequential_tree(d: Dict) -> bool:
    return "block_0" in d and "extras" in d


def _is_pipelined_tree(d: Dict) -> bool:
    return "wq" in d and "encoder" in d


def convert_subtrees(tree: Any, to: str):
    """Every params-shaped subtree (bare, the content of a "params"
    collection) anywhere in `tree`, converted: the shape in which the
    optimizer states carry their params mirror. Returns (converted tree,
    number of subtrees converted)."""
    if to == "pipelined":
        detect, fn = _is_sequential_tree, transformer_to_pipelined
    elif to == "sequential":
        detect, fn = _is_pipelined_tree, pipelined_to_transformer
    else:
        raise ValueError(f"unknown target layout {to!r}")
    count = [0]

    def walk(node):
        if isinstance(node, dict):
            if detect(node):
                count[0] += 1
                return fn(node)["params"]
            return {k: walk(v) for k, v in node.items()}
        return node

    return walk(tree), count[0]


def convert_checkpoint(in_path: str, out_path: str, to: str) -> None:
    """Convert a saved checkpoint between the transformer layouts: the
    params, the optimizer's params-shaped trees, the `extra` blobs and
    the recorded model flag. A file whose params hold no tree of the
    source layout raises, and nothing is written."""
    payload = read_payload(in_path)
    n_params_converted = 0
    for key in ("params", "opt_state"):
        tree = serialization.msgpack_restore(payload[key])
        tree, n = convert_subtrees(tree, to)
        if key == "params":
            n_params_converted = n
        payload[key] = serialization.to_bytes(tree)
    # `extra` holds driver-specific serialized trees; convert any
    # params-shaped state inside them too (e.g. target params).
    for k, blob in (payload.get("extra") or {}).items():
        tree, _ = convert_subtrees(serialization.msgpack_restore(blob), to)
        payload["extra"][k] = serialization.to_bytes(tree)
    if n_params_converted == 0:
        raise ValueError(
            f"{in_path}: no {('sequential', 'pipelined')[to == 'sequential']}"
            "-layout transformer tree found in `params` — wrong "
            "checkpoint or wrong --to direction; nothing was written"
        )
    if payload.get("flags", {}).get("model"):
        payload["flags"]["model"] = (
            "pipelined_transformer" if to == "pipelined" else "transformer"
        )
    atomic_write(out_path, serialization.msgpack_serialize(payload))


def _cli(argv=None):
    ap = argparse.ArgumentParser(
        description="Convert a checkpoint between the sequential and "
        "pipelined transformer layouts."
    )
    ap.add_argument("--input", required=True)
    ap.add_argument("--output", required=True)
    ap.add_argument("--to", required=True,
                    choices=["pipelined", "sequential"])
    args = ap.parse_args(argv)
    convert_checkpoint(args.input, args.output, args.to)
    print(f"converted {args.input} -> {args.output} ({args.to})")


if __name__ == "__main__":
    _cli()

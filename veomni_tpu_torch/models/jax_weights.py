"""Carry weights between the JAX reference's param tree and the port.

The reference keeps a plain tree with per-layer leaves stacked on a leading
``[L, ...]`` axis (``veomni_tpu/models/transformer.py:183-215``): top-level
``embed_tokens`` [V,H], ``norm`` [H], optional ``lm_head`` [H,V], and
``layers`` {name: [L, ...]}, where a MoE layer's ``experts`` is a nested
subtree {gate_proj, up_proj: [L,E,H,I], down_proj: [L,E,I,H]} beside
``router`` [L,H,E]. The port holds one ``DecoderLayer`` per layer with the
same leaf names (``experts.gate_proj`` for the nested ones) and the same
``[in, out]`` matrix layout, so leaves move across unstacked and
untransposed. The tree's leaves are numpy arrays (``np.asarray`` of the JAX
arrays); this module imports no JAX.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from veomni_tpu_torch.models.transformer import Transformer


def _top_level(model: Transformer):
    return {name: p for name, p in model.named_parameters(recurse=False)}


def _flatten(tree: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    """{"experts": {"gate_proj": x}} -> {"experts.gate_proj": x}."""
    flat = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            flat.update(_flatten(value, f"{prefix}{key}."))
        else:
            flat[prefix + key] = value
    return flat


def _nest(flat: Dict[str, Any]) -> Dict[str, Any]:
    """The inverse of :func:`_flatten`."""
    tree: Dict[str, Any] = {}
    for name, value in flat.items():
        *parents, leaf = name.split(".")
        node = tree
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = value
    return tree


@torch.no_grad()
def load_jax_params(model: Transformer, tree: Dict[str, Any]) -> None:
    """Copy a JAX param tree (numpy leaves) into ``model`` in place."""
    top = _top_level(model)
    want = set(top) | {"layers"}
    if set(tree) != want:
        raise KeyError(f"param tree keys {sorted(tree)} != model keys {sorted(want)}")
    for name, param in top.items():
        _copy(param, tree[name], name)
    layers = _flatten(tree["layers"])
    names = {n for n, _ in model.layers[0].named_parameters()}
    if set(layers) != names:
        raise KeyError(f"layer keys {sorted(layers)} != model layer keys {sorted(names)}")
    for leaf, stacked in layers.items():
        stacked = np.asarray(stacked)
        if stacked.shape[0] != len(model.layers):
            raise ValueError(f"layers.{leaf}: {stacked.shape[0]} layers, model has {len(model.layers)}")
        for i, layer in enumerate(model.layers):
            _copy(layer.get_parameter(leaf), stacked[i], f"layers.{leaf}[{i}]")


def _copy(param: torch.Tensor, value, name: str) -> None:
    src = torch.from_numpy(np.array(value))  # a writable copy
    if tuple(src.shape) != tuple(param.shape):
        raise ValueError(f"{name}: shape {tuple(src.shape)} != {tuple(param.shape)}")
    param.copy_(src.to(param.dtype))


def to_jax_tree(model: Transformer, *, grads: bool = False) -> Dict[str, Any]:
    """The model's params (or their ``.grad``) as a JAX-layout numpy tree,
    layers stacked on a leading axis, for comparison with the reference."""

    def val(p):
        t = p.grad if grads else p
        if t is None:
            t = torch.zeros_like(p)
        return t.detach().float().cpu().numpy()

    tree: Dict[str, Any] = {name: val(p) for name, p in _top_level(model).items()}
    names = [n for n, _ in model.layers[0].named_parameters()]
    tree["layers"] = _nest({
        n: np.stack([val(layer.get_parameter(n)) for layer in model.layers]) for n in names
    })
    return tree

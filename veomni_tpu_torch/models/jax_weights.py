"""Carry weights between the JAX reference's param tree and the port.

The reference keeps a plain tree with per-layer leaves stacked on a leading
``[L, ...]`` axis (``veomni_tpu/models/transformer.py:183-215``): top-level
``embed_tokens`` [V,H], ``norm`` [H], optional ``lm_head`` [H,V], and
``layers`` {name: [L, ...]}, where a MoE layer's ``experts`` is a nested
subtree {gate_proj, up_proj: [L,E,H,I], down_proj: [L,E,I,H]} beside
``router`` [L,H,E] (and, in the deepseek dialect, ``shared_experts`` and
``e_score_correction_bias`` [L,E]). With ``first_k_dense_replace`` the
leading dense layers form a second stacked subtree, ``dense_layers``
(``:200-204``), and ``layers`` holds the MoE layers after them. The port
holds one ``DecoderLayer`` per layer, the dense ones first, with the same
leaf names (``experts.gate_proj`` for the nested ones) and the same
``[in, out]`` matrix layout, so leaves move across unstacked and
untransposed. The reference's LoRA adapter tree (``lora_a``/``lora_b``/
``scale`` under each adapted leaf path) moves across the same way into the
port's ``lora.LoraAdapters``, which keep it stacked. The tree's leaves are
numpy arrays (``np.asarray`` of the JAX arrays); this module imports no
JAX.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch
from torch import nn

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


def _segments(model: Transformer):
    """{subtree name: the layers it stacks}: ``dense_layers`` (the leading
    dense layers of a MoE config, when it has any) and ``layers``."""
    k = model.cfg.first_k_dense_replace if model.cfg.is_moe else 0
    segments = {"dense_layers": model.layers[:k]} if k else {}
    segments["layers"] = model.layers[k:]
    return segments


def stacked_leaves(model: Transformer) -> Dict[str, List[Tuple[nn.Module, str]]]:
    """{the reference's leaf path: [(module, parameter name)]}: a top-level
    leaf (``embed_tokens``) has one owner, a stacked one (``layers.q_proj``,
    ``layers.experts.gate_proj``, ``dense_layers.q_proj``) one per layer of
    its segment, in layer order. The paths are the reference's
    ``param_path_str`` of its tree, which its regexes (LoRA targets,
    ``freeze_modules``, ``module_lr_scales``) are matched against."""
    out: Dict[str, List[Tuple[nn.Module, str]]] = {
        name: [(model, name)] for name in _top_level(model)}
    for seg, layers in _segments(model).items():
        for name, _ in layers[0].named_parameters():
            out[f"{seg}.{name}"] = [(layer, name) for layer in layers]
    return out


def named_jax_parameters(module: nn.Module) -> List[Tuple[str, torch.Tensor]]:
    """(reference leaf path, parameter) for every parameter of a
    ``Transformer`` (a stacked path once per layer) or of a module with its
    own ``named_jax_parameters`` (``lora.LoraAdapters``)."""
    own = getattr(module, "named_jax_parameters", None)
    if own is not None:
        return list(own())
    return [(path, owner.get_parameter(name))
            for path, owners in stacked_leaves(module).items() for owner, name in owners]


@torch.no_grad()
def load_jax_params(model: Transformer, tree: Dict[str, Any]) -> None:
    """Copy a JAX param tree (numpy leaves) into ``model`` in place."""
    top = _top_level(model)
    segments = _segments(model)
    want = set(top) | set(segments)
    if set(tree) != want:
        raise KeyError(f"param tree keys {sorted(tree)} != model keys {sorted(want)}")
    for name, param in top.items():
        _copy(param, tree[name], name)
    for seg, layers in segments.items():
        leaves = _flatten(tree[seg])
        names = {n for n, _ in layers[0].named_parameters()}
        if set(leaves) != names:
            raise KeyError(f"{seg} keys {sorted(leaves)} != model layer keys {sorted(names)}")
        for leaf, stacked in leaves.items():
            stacked = np.asarray(stacked)
            if stacked.shape[0] != len(layers):
                raise ValueError(f"{seg}.{leaf}: {stacked.shape[0]} layers, model has "
                                 f"{len(layers)}")
            for i, layer in enumerate(layers):
                _copy(layer.get_parameter(leaf), stacked[i], f"{seg}.{leaf}[{i}]")


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
    for seg, layers in _segments(model).items():
        names = [n for n, _ in layers[0].named_parameters()]
        tree[seg] = _nest({
            n: np.stack([val(layer.get_parameter(n)) for layer in layers]) for n in names
        })
    return tree


@torch.no_grad()
def load_jax_adapters(adapters: nn.Module, tree: Dict[str, Any]) -> None:
    """Copy the reference's adapter tree (``init_lora_params``'s
    ``{"layers": {"q_proj": {"lora_a", "lora_b", "scale"}}}``, numpy
    leaves) into the port's ``lora.LoraAdapters`` in place: both hold each
    leaf stacked over the layers, so the leaves move across as they are."""
    flat = _flatten(tree)
    live = dict(adapters.named_jax_parameters())
    if set(flat) != set(live):
        raise KeyError(f"adapter tree keys differ: {sorted(set(flat) ^ set(live))}")
    for name, p in live.items():
        _copy(p, flat[name], name)


def adapters_to_jax_tree(adapters: nn.Module, *, grads: bool = False) -> Dict[str, Any]:
    """The adapters (or their ``.grad``) as the reference's nested numpy tree."""

    def val(p):
        t = p.grad if grads else p
        if t is None:
            t = torch.zeros_like(p)
        return t.detach().float().cpu().numpy()

    return _nest({name: val(p) for name, p in adapters.named_jax_parameters()})

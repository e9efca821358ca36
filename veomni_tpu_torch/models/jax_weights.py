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

A VLM composite (``models/qwen2_vl.py``, ``models/qwen2_5_vl.py``,
``models/qwen3_vl.py``) is the
tree ``{language_model: <the text tree>, vision_tower: {patch_embed,
blocks: {name: [L, ...]}, merger: {...}}}``: the text tree moves across as
above, the tower's ``blocks`` unstacked into its block modules. The omni
thinkers (``models/qwen3_omni_moe.py``, ``models/qwen2_5_omni.py``) add
``audio_tower: {conv*, layers: {name: [L, ...]}, ...}``, its ``layers``
unstacked alike; a tower module's ``JAX_LAYOUT`` names the leaves it keeps
in torch's layout (the conv kernels: OIHW where the reference keeps HWIO,
``[out, in, k]`` where it keeps ``[k, in, out]``) with the permutation
from the reference's.
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


# a tower's module lists that the reference stacks on a leading axis: a
# vision tower's blocks, Qwen3-VL's deepstack mergers (stacked over the K
# taps) and an audio tower's layers
_TOWER_STACKS = ("blocks", "deepstack_mergers", "layers")
# a composite's towers, each a subtree of the reference's tree
_TOWERS = ("vision_tower", "audio_tower")


def _towers(model: nn.Module) -> Dict[str, nn.Module]:
    return {name: getattr(model, name) for name in _TOWERS if hasattr(model, name)}


def _layout(owner: nn.Module, name: str):
    """The permutation from the reference's layout of leaf ``name`` to the
    module's, or None where they agree."""
    return getattr(owner, "JAX_LAYOUT", {}).get(name)


def _tower_leaves(tower: nn.Module) -> Dict[str, List[Tuple[nn.Module, str]]]:
    """A tower's leaves: its own (``patch_embed``), ``blocks.<name>``
    stacked over its blocks (and ``deepstack_mergers.<name>`` over its
    mergers, ``layers.<name>`` over an audio tower's layers), and each other
    submodule's (``merger.fc1_w``)."""
    out = {name: [(tower, name)] for name, _ in tower.named_parameters(recurse=False)}
    for sub_name, sub in tower.named_children():
        if sub_name in _TOWER_STACKS:
            for name, _ in sub[0].named_parameters():
                out[f"{sub_name}.{name}"] = [(block, name) for block in sub]
        else:
            for name, _ in sub.named_parameters():
                out[f"{sub_name}.{name}"] = [(sub, name)]
    return out


def stacked_leaves(model: nn.Module) -> Dict[str, List[Tuple[nn.Module, str]]]:
    """{the reference's leaf path: [(module, parameter name)]}: a top-level
    leaf (``embed_tokens``) has one owner, a stacked one (``layers.q_proj``,
    ``layers.experts.gate_proj``, ``dense_layers.q_proj``) one per layer of
    its segment, in layer order. The paths are the reference's
    ``param_path_str`` of its tree, which its regexes (LoRA targets,
    ``freeze_modules``, ``module_lr_scales``) are matched against. A VLM
    composite's paths start with ``language_model.``, ``vision_tower.`` or
    ``audio_tower.``."""
    if hasattr(model, "language_model"):
        out = {f"language_model.{k}": v for k, v in stacked_leaves(model.language_model).items()}
        for tname, tower in _towers(model).items():
            out.update({f"{tname}.{k}": v for k, v in _tower_leaves(tower).items()})
        return out
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


def is_stacked_path(path: str) -> bool:
    """Whether the reference stacks this leaf over layers (a leading
    ``[L, ...]`` axis): the text layers and dense layers of a
    ``Transformer``, a VLM tower's blocks and an audio tower's layers."""
    return (path.removeprefix("language_model.").startswith(("layers.", "dense_layers."))
            or path.startswith(tuple(f"{t}.{s}." for t in _TOWERS for s in _TOWER_STACKS)))


def reference_leaves(module: nn.Module) -> List[Tuple[str, List[torch.Tensor], bool]]:
    """(reference leaf path, parameters, stacked) for every leaf of the
    reference's tree: the reference's leaf is ``torch.stack(parameters)``
    when ``stacked``, else the one parameter. A module with its own
    ``named_jax_parameters`` (``lora.LoraAdapters``) holds each leaf whole."""
    own = getattr(module, "named_jax_parameters", None)
    if own is not None:
        return [(path, [p], False) for path, p in own()]
    return [(path, [owner.get_parameter(name) for owner, name in owners], is_stacked_path(path))
            for path, owners in stacked_leaves(module).items()]


@torch.no_grad()
def load_jax_params(model: nn.Module, tree: Dict[str, Any]) -> None:
    """Copy a JAX param tree (numpy leaves) into ``model`` in place."""
    if hasattr(model, "language_model"):
        towers = _towers(model)
        if set(tree) != {"language_model", *towers}:
            raise KeyError(f"composite param tree keys {sorted(tree)} != language_model, "
                           f"{', '.join(towers)}")
        load_jax_params(model.language_model, tree["language_model"])
        for tname, tower in towers.items():
            leaves = _tower_leaves(tower)
            flat = _flatten(tree[tname])
            if set(flat) != set(leaves):
                raise KeyError(f"{tname} keys differ: {sorted(set(flat) ^ set(leaves))}")
            for path, owners in leaves.items():
                value = np.asarray(flat[path])
                stacked = path.startswith(tuple(f"{s}." for s in _TOWER_STACKS))
                if stacked and value.shape[0] != len(owners):
                    raise ValueError(f"{tname}.{path}: {value.shape[0]} blocks, model has "
                                     f"{len(owners)}")
                for i, (owner, name) in enumerate(owners):
                    v = value[i] if stacked else value
                    perm = _layout(owner, name)
                    _copy(owner.get_parameter(name), v if perm is None else v.transpose(perm),
                          f"{tname}.{path}")
        return
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


def to_jax_tree(model: nn.Module, *, grads: bool = False) -> Dict[str, Any]:
    """The model's params (or their ``.grad``) as a JAX-layout numpy tree,
    layers stacked on a leading axis, for comparison with the reference."""

    def val(p):
        t = p.grad if grads else p
        if t is None:
            t = torch.zeros_like(p)
        return t.detach().float().cpu().numpy()

    def jax_val(owner, name):
        perm = _layout(owner, name)
        v = val(owner.get_parameter(name))
        return v if perm is None else v.transpose(np.argsort(perm))

    if hasattr(model, "language_model"):
        out = {"language_model": to_jax_tree(model.language_model, grads=grads)}
        for tname, tower in _towers(model).items():
            leaves = {}
            for path, owners in _tower_leaves(tower).items():
                vals = [jax_val(owner, name) for owner, name in owners]
                leaves[path] = (np.stack(vals) if path.startswith(
                    tuple(f"{s}." for s in _TOWER_STACKS)) else vals[0])
            out[tname] = _nest(leaves)
        return out

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

"""LoRA: an adapter tree merged into the frozen base weights inside the forward.

Port of ``veomni_tpu/lora/lora.py``. The reference keeps the adapters as a
tree parallel to the base params, ``{path: {lora_a, lora_b, scale}}``, runs
the base model on ``W + scale * A @ B`` and takes gradients with respect to
the adapter tree only. Here:

* :class:`LoraAdapters` is that tree as an ``nn.Module``: one
  :class:`LoraLeaf` per adapted reference leaf path (``layers.q_proj``,
  ``layers.experts.gate_proj``), holding ``lora_a``, ``lora_b`` and
  ``scale`` in the reference's layout and dtype, stacked over the layers
  (``[L, in, r]``, ``[L, r, out]``; expert tensors ``[L, E, in, r]``,
  ``[L, E, r, out]``), so an adapter file reads the same in both
  packages. Its parameters are the train state's: the optimizer, the
  checkpoint and the grad mask see the adapters alone.
* :meth:`LoraAdapters.merged` is a context: inside it, each adapted
  parameter's owning layer holds a merge that ``DecoderLayer.w`` applies
  where the forward reads the weight: layer ``i`` gets ``W_i + scale *
  A[i] @ B[i]``, in f32, cast to the base dtype (``merge_lora_params``,
  ``:88``). The merge runs inside the layer's remat regions, so one layer's
  merged copy is alive at a time and backward merges again; the merged
  expert weights still go through the grouped GEMM kernels, whose weight
  gradient (K6) flows into the expert adapters. On leaving it the base
  reads its own weights again.
* :func:`apply_lora_to_loss_fn` freezes the base (``requires_grad`` off: no
  gradient, no optimizer state) and returns ``loss(adapters, batch)``, run
  inside ``adapters.merged()``. A backward that recomputes remat regions
  must run inside it too: the train step holds it over each micro-batch's
  forward and backward (``build_train_step(scope=LoraAdapters.merged)``).
* :func:`save_merged_hf` writes the merged full model as an HF directory,
  merging one layer at a time as the write reaches it.

As in the reference, ``scale`` is a leaf of the adapter tree, so it takes a
gradient and the optimizer updates it (not decayed: it is 0-d). Its
gradient is 0 while ``B`` is 0, at the first step. Over a mesh the plan's
LoRA rules (``parallel/parallel_plan.py::lora_parallel_plan_rules``) split
the expert adapters over ``ep``; :func:`merge_lora_params` copies the base,
so the merged model keeps its experts' ep slice.
"""

from __future__ import annotations

import contextlib
import copy
import functools
import json
import os
import re
from typing import Callable, Dict, Iterator, Optional, Tuple

import torch
from torch import nn

from veomni_tpu_torch.lora.config import LoraConfig
from veomni_tpu_torch.models import hf_io
from veomni_tpu_torch.models.jax_weights import stacked_leaves
from veomni_tpu_torch.models.transformer import Transformer
from veomni_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

ADAPTER_WEIGHTS = "adapter_model.safetensors"
ADAPTER_CONFIG = "adapter_config.json"
_STACKED = ("layers", "dense_layers")


def _match(cfg: LoraConfig, path: str) -> Optional[Tuple[int, float]]:
    for pattern, ov in cfg.overrides.items():
        if re.search(pattern, path):
            return int(ov.get("rank", cfg.rank)), float(ov.get("alpha", cfg.alpha))
    for pattern in cfg.target_patterns:
        if re.search(pattern, path):
            return cfg.rank, cfg.alpha
    return None


class LoraLeaf(nn.Module):
    """The adapter of one reference leaf: ``lora_a``, ``lora_b``, ``scale``."""

    def __init__(self, lora_a: torch.Tensor, lora_b: torch.Tensor, scale: torch.Tensor):
        super().__init__()
        self.lora_a = nn.Parameter(lora_a)
        self.lora_b = nn.Parameter(lora_b)
        self.scale = nn.Parameter(scale)


def merge_weight(w: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                 scale: torch.Tensor) -> torch.Tensor:
    """``W + scale * A @ B``, computed in f32 and cast to W's dtype."""
    delta = torch.matmul(a.float(), b.float()) * scale
    return (w.float() + delta).to(w.dtype)


def _merge_layer(leaf: LoraLeaf, layer: Optional[int], w: torch.Tensor) -> torch.Tensor:
    """The merged weight of one owner of ``leaf``: layer ``layer``'s slice
    of a stacked leaf (a per-layer 1-D parameter's stacked ``[L, H]`` leaf
    has ``A [L, r]`` and an unstacked ``B [r, H]``), or a top-level leaf."""
    a, b = leaf.lora_a, leaf.lora_b
    if layer is not None:
        a = a[layer]
        if w.ndim > 1:
            b = b[layer]
    return merge_weight(w, a, b, leaf.scale)


def _key(path: str) -> str:
    return path.replace(".", "/")


class LoraAdapters(nn.Module):
    """The adapter tree of a base ``Transformer``. The base's modules are
    held by reference, not as submodules: ``parameters()`` and
    ``state_dict()`` are the adapters alone."""

    def __init__(self, base: Transformer, leaves: Dict[str, LoraLeaf]):
        super().__init__()
        self.leaves = nn.ModuleDict({_key(path): leaf for path, leaf in leaves.items()})
        self.paths = list(leaves)
        owners = stacked_leaves(base)
        object.__setattr__(self, "_owners", {path: owners[path] for path in self.paths})
        self._depth = 0

    def leaf(self, path: str) -> LoraLeaf:
        return self.leaves[_key(path)]

    def named_jax_parameters(self) -> Iterator[Tuple[str, torch.Tensor]]:
        """(the reference's adapter leaf path, parameter):
        ``layers.q_proj.lora_a``, ``layers.q_proj.scale``, ..."""
        for path in self.paths:
            for name, p in self.leaf(path).named_parameters():
                yield f"{path}.{name}", p

    @contextlib.contextmanager
    def merged(self):
        """Inside this context every forward read of an adapted base weight
        is the merged one; it nests, and the outermost exit detaches."""
        if self._depth == 0:
            for path in self.paths:
                stacked = path.split(".")[0] in _STACKED
                for i, (owner, name) in enumerate(self._owners[path]):
                    owner.merges[name] = functools.partial(
                        _merge_layer, self.leaf(path), i if stacked else None)
        self._depth += 1
        try:
            yield self
        finally:
            self._depth -= 1
            if self._depth == 0:
                for path in self.paths:
                    for owner, name in self._owners[path]:
                        owner.merges.pop(name, None)

    @contextlib.contextmanager
    def unmerged(self):
        """Inside this context the base reads its own weights, even within
        :meth:`merged` (the DPO trainer's frozen reference policy of a fresh
        adapter is the bare base); on leaving it the merges held return."""
        held = [(owner, name, owner.merges.pop(name)) for path in self.paths
                for owner, name in self._owners[path] if name in owner.merges]
        try:
            yield self
        finally:
            for owner, name, merge in held:
                owner.merges[name] = merge


def init_lora_params(generator: Optional[torch.Generator], base: Transformer,
                     cfg: LoraConfig) -> LoraAdapters:
    """Adapters on every base leaf a target (or override) regex matches and
    whose reference leaf has two or more dims: ``A ~ N(0, 0.02)``, ``B = 0``
    (so the merged model starts equal to the base), ``scale = alpha /
    rank``, A and B in the base dtype on the base's device. ``generator``
    None leaves A at 0, for a caller that loads the adapter."""
    leaves: Dict[str, LoraLeaf] = {}
    for path, owners in stacked_leaves(base).items():
        m = _match(cfg, path)
        p = owners[0][0].get_parameter(owners[0][1])
        shape = ((len(owners), *p.shape) if path.split(".")[0] in _STACKED else tuple(p.shape))
        if m is None or len(shape) < 2:
            continue
        rank, alpha = m
        *batch, fan_in, fan_out = shape
        if generator is None:
            a = torch.zeros((*batch, fan_in, rank), dtype=torch.float32, device=p.device)
        else:
            a = torch.randn((*batch, fan_in, rank), generator=generator, dtype=torch.float32,
                            device=generator.device).to(p.device) * 0.02
        b = torch.zeros((*batch, rank, fan_out), dtype=p.dtype, device=p.device)
        scale = torch.tensor(alpha / rank, dtype=torch.float32, device=p.device)
        leaves[path] = LoraLeaf(a.to(p.dtype), b, scale)
    logger.info_rank0("LoRA adapters on %d tensors (rank=%d)", len(leaves), cfg.rank)
    return LoraAdapters(base, leaves)


@torch.no_grad()
def merge_lora_params(base: Transformer, adapters: LoraAdapters) -> Transformer:
    """A new model holding ``W + scale * A @ B`` for the adapted leaves and
    the base weights elsewhere: a second whole model on the base's device
    (:func:`save_merged_hf` writes the merged model without one)."""
    # a copy of the base (over a mesh its experts keep their ep slice), trainable
    merged = copy.deepcopy(base).requires_grad_(True)
    owners = stacked_leaves(merged)
    for path in adapters.paths:
        stacked = path.split(".")[0] in _STACKED
        for i, (owner, name) in enumerate(owners[path]):
            w = owner.get_parameter(name)
            w.copy_(_merge_layer(adapters.leaf(path), i if stacked else None, w))
    return merged


@torch.no_grad()
def save_merged_hf(base: Transformer, adapters: LoraAdapters, out_dir: str) -> None:
    """Write the merged full model (``W + scale * A @ B``) to ``out_dir`` in
    HF format, with its config.json. The write streams one tensor at a time
    in name order, in which each layer's tensors are contiguous: a layer's
    weights are merged when the write first reads one of them and dropped
    when it moves to the next layer, so the export holds one layer's merged
    copy at a time."""
    held: Dict[str, object] = {}

    def read(owner: nn.Module, name: str) -> torch.Tensor:
        if held.get("owner") is not owner:
            held.clear()
            held["owner"] = owner
        if name not in held:
            held[name] = owner.w(name)
        return held[name]

    with adapters.merged():
        hf_io.save_hf_checkpoint(base, base.cfg, out_dir, read=read)


def apply_lora_to_loss_fn(loss_fn: Callable, base: Transformer) -> Callable:
    """``loss_fn(model, batch)`` -> ``lora_loss(adapters, batch)``: the base
    is frozen (no gradient, so no optimizer state) and the loss runs on the
    merged weights, inside ``adapters.merged()``."""
    base.requires_grad_(False)

    def lora_loss(adapters: LoraAdapters, batch):
        with adapters.merged():
            return loss_fn(base, batch)

    return lora_loss


# ------------------------------------------------------------------ save/load
def adapter_state(adapters: LoraAdapters) -> Dict[str, torch.Tensor]:
    """{``layers.q_proj.lora_a``: tensor, ...}: the adapter file's keys."""
    return {path: p for path, p in adapters.named_jax_parameters()}


def save_adapter(adapters: LoraAdapters, cfg: LoraConfig, out_dir: str) -> None:
    """Adapter-only checkpoint with the reference's files and keys:
    ``adapter_model.safetensors`` and ``adapter_config.json``."""
    os.makedirs(out_dir, exist_ok=True)
    flat = {k: v.detach() for k, v in adapter_state(adapters).items()}
    hf_io.save_file(flat, os.path.join(out_dir, ADAPTER_WEIGHTS))
    with open(os.path.join(out_dir, ADAPTER_CONFIG), "w") as f:
        json.dump({"rank": cfg.rank, "alpha": cfg.alpha,
                   "target_patterns": cfg.target_patterns}, f, indent=2)
    logger.info_rank0("saved LoRA adapter to %s (%d tensors)", out_dir, len(flat))


@torch.no_grad()
def load_adapter(adapter_dir: str, adapters: LoraAdapters) -> LoraAdapters:
    """Copy an adapter saved by :func:`save_adapter` (or by the reference)
    into ``adapters`` in place, each tensor cast to the live one's dtype."""
    flat = hf_io.load_file(os.path.join(adapter_dir, ADAPTER_WEIGHTS))
    live = adapter_state(adapters)
    if set(flat) != set(live):
        raise KeyError(f"{adapter_dir}: adapter keys {sorted(set(flat) ^ set(live))} do not "
                       "match the configured adapters")
    for key, p in live.items():
        src = flat[key]
        if tuple(src.shape) != tuple(p.shape):
            raise ValueError(f"{key}: shape {tuple(src.shape)} != {tuple(p.shape)}")
        p.copy_(src.to(p.dtype))
    return adapters

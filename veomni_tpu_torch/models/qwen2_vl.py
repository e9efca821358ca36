"""Qwen2-VL: the full-attention ViT, mrope and the merger.

Port of ``veomni_tpu/models/qwen2_vl.py`` (upstream contract: HF
``Qwen2VLForConditionalGeneration``). It shares the Qwen2.5-VL composite,
collator row contract and HF key maps (``models/qwen2_5_vl.py``); what
differs (``:5-15``):

* the blocks use LayerNorm with a bias and a quick-GELU fc1/fc2 MLP
  (``mlp_ratio`` x the width) (``:225-250``);
* no window attention: every layer attends within a frame (HF builds
  ``cu_seqlens`` per (h w) frame; here one segment id per frame, 0 for the
  padding), and the patches stay in processor (merge-block) order, so no
  window permutation and no ``reverse`` gather;
* the merger is LayerNorm -> fc1 -> GELU -> fc2 into the LM width;
* mrope t-positions are plain frame indices for every grid (``:204-218``).

The tower's ``hidden_size`` is the LM width (the merger's output); its
blocks' width is ``embed_dim`` (1280 in the published checkpoints, 16
heads of 80).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from veomni_tpu_torch.models import qwen2_5_vl as q25
from veomni_tpu_torch.models.config import TransformerConfig
from veomni_tpu_torch.models.qwen2_5_vl import (
    VisionBlock,
    VisionLanguageModel,
    VisionTower,
    _pad_to,
    _param,
    _per_image_pos_hw,
)


@dataclass
class Qwen2VisionConfig:
    """HF ``Qwen2VLVisionConfig`` surface (defaults = 7B checkpoint)."""

    depth: int = 32
    embed_dim: int = 1280
    hidden_size: int = 3584          # LM width (merger output)
    hidden_act: str = "quick_gelu"
    mlp_ratio: int = 4
    num_heads: int = 16
    in_channels: int = 3
    patch_size: int = 14
    spatial_merge_size: int = 2
    temporal_patch_size: int = 2
    initializer_range: float = 0.02
    # qwen2_vl has no time scaling; 1.0 makes the shared qwen2_5_vl mrope
    # walk give plain frame indices for video grids
    tokens_per_second: float = 1.0

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

    @property
    def intermediate_size(self) -> int:
        return self.embed_dim * self.mlp_ratio

    @property
    def patch_dim(self) -> int:
        return self.in_channels * self.temporal_patch_size * self.patch_size ** 2

    @property
    def merge_unit(self) -> int:
        return self.spatial_merge_size ** 2

    @property
    def out_hidden_size(self) -> int:  # trainer/collator shared surface
        return self.hidden_size

    @property
    def width(self) -> int:
        return self.embed_dim


@dataclass
class Qwen2VLConfig:
    text: TransformerConfig = field(default_factory=TransformerConfig)
    vision: Qwen2VisionConfig = field(default_factory=Qwen2VisionConfig)
    image_token_id: int = 151655
    video_token_id: int = 151656
    vision_start_token_id: int = 151652
    freeze_vision: bool = False
    model_type: str = "qwen2_vl"

    def __post_init__(self):
        if isinstance(self.text, dict):
            self.text = TransformerConfig(**self.text)
        if isinstance(self.vision, dict):
            self.vision = Qwen2VisionConfig(**self.vision)

    def __getattr__(self, name):  # FlopsCounter / trainer surface
        return getattr(object.__getattribute__(self, "text"), name)


# ---------------------------------------------------------------------------
# host-side index plan
# ---------------------------------------------------------------------------

def vision_metadata(grid_thw: Sequence[Tuple[int, int, int]], cfg: Qwen2VisionConfig,
                    n_pad_patches: int) -> Dict[str, np.ndarray]:
    """The static index plan of a packed patch sequence in processor order:
    ``pos_hw`` [N, 2] rope positions, ``seg`` [N] per-frame segments (0 =
    padding; HF ``cu_seqlens = repeat_interleave(h*w, t)``), ``merged_mask``
    [N / merge_unit] (``:162-201``)."""
    pos_list, segs = [], []
    seg_id = 0
    n = 0
    for (t, h, w) in grid_thw:
        pos_list.append(_per_image_pos_hw(t, h, w, cfg.spatial_merge_size))
        for _ in range(t):
            seg_id += 1
            segs.append(np.full(h * w, seg_id, np.int32))
        n += t * h * w
    if n > n_pad_patches:
        raise ValueError(f"{n} patches exceed the static budget {n_pad_patches}; raise "
                         "data.max_patches or drop images upstream")
    m_pad = n_pad_patches // cfg.merge_unit
    return {
        "pos_hw": _pad_to(np.concatenate(pos_list).astype(np.int32) if pos_list
                          else np.zeros((0, 2), np.int32), n_pad_patches),
        "seg": _pad_to(np.concatenate(segs) if segs else np.zeros((0,), np.int32),
                       n_pad_patches),
        "merged_mask": _pad_to(np.ones(n // cfg.merge_unit, bool), m_pad, fill=False),
    }


def mrope_position_ids(input_ids: np.ndarray, grid_thw: Sequence[Tuple[int, int, int]],
                       cfg: Qwen2VLConfig, video: Optional[Sequence[bool]] = None) -> np.ndarray:
    """HF ``get_rope_index``: the qwen2_5_vl walk with t-indices that are
    plain frame numbers for every grid (interval pinned to 1)."""
    del video  # no image/video distinction in the qwen2_vl walk
    return q25.mrope_position_ids(input_ids, grid_thw, cfg,
                                  second_per_grid_ts=[1.0] * len(grid_thw),
                                  video=[True] * len(grid_thw))


# ---------------------------------------------------------------------------
# the tower
# ---------------------------------------------------------------------------

def layer_norm(x, w, b, eps: float = 1e-6):
    """f32 LayerNorm (population variance), cast back (``_layer_norm``)."""
    dt = x.dtype
    x = x.float()
    mean = x.mean(-1, keepdim=True)
    var = (x - mean).square().mean(-1, keepdim=True)
    x = (x - mean) * torch.rsqrt(var + eps)
    return (x * w.float() + b.float()).to(dt)


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


class Qwen2VisionBlock(VisionBlock):
    """LayerNorm -> qkv (biased) -> 2-D rope -> attention -> proj ->
    LayerNorm -> fc1 -> quick-GELU -> fc2 (``_vision_block``, ``:238-250``)."""

    def __init__(self, cfg: Qwen2VisionConfig, text: TransformerConfig, device):
        super().__init__(cfg, text)
        d, i = cfg.embed_dim, cfg.intermediate_size
        p = lambda *shape: _param(device, text.param_dtype, *shape)  # noqa: E731
        self.norm1_w, self.norm1_b = p(d), p(d)
        self.norm2_w, self.norm2_b = p(d), p(d)
        self.qkv_w, self.qkv_b = p(d, 3 * d), p(3 * d)
        self.proj_w, self.proj_b = p(d, d), p(d)
        self.fc1_w, self.fc1_b = p(d, i), p(i)
        self.fc2_w, self.fc2_b = p(i, d), p(d)

    def _norm(self, x, which: int):
        return layer_norm(x, self.w(f"norm{which}_w"), self.w(f"norm{which}_b"))

    def _mlp(self, y):
        return self._linear(quick_gelu(self._linear(y, "fc1_w", "fc1_b")), "fc2_w", "fc2_b")


class Qwen2Merger(q25.MergedReads):
    """LayerNorm, then each 2x2 group of patches concatenated and through
    fc1 -> GELU (tanh form, ``jax.nn.gelu``'s default) -> fc2 into the LM
    width (``:285-290``)."""

    def __init__(self, cfg: Qwen2VisionConfig, dtype, device):
        super().__init__()
        d, md = cfg.embed_dim, cfg.embed_dim * cfg.merge_unit
        p = lambda *shape: _param(device, dtype, *shape)  # noqa: E731
        self.ln_q_w, self.ln_q_b = p(d), p(d)
        self.fc1_w, self.fc1_b = p(md, md), p(md)
        self.fc2_w, self.fc2_b = p(md, cfg.hidden_size), p(cfg.hidden_size)

    def forward(self, x, merge_unit: int):
        dt = x.dtype
        y = layer_norm(x, self.w("ln_q_w"), self.w("ln_q_b"))
        y = y.reshape(x.shape[0] // merge_unit, merge_unit * x.shape[1])
        y = F.gelu(y @ self.w("fc1_w").to(dt) + self.w("fc1_b").to(dt), approximate="tanh")
        return y @ self.w("fc2_w").to(dt) + self.w("fc2_b").to(dt)


class Qwen2VisionTower(VisionTower):
    def __init__(self, cfg: Qwen2VisionConfig, text: TransformerConfig, device):
        super().__init__(cfg, text)
        self.patch_embed = _param(device, text.param_dtype, cfg.patch_dim, cfg.embed_dim)
        self.blocks = nn.ModuleList(Qwen2VisionBlock(cfg, text, device)
                                    for _ in range(cfg.depth))
        self.merger = Qwen2Merger(cfg, text.param_dtype, device)

    def layer_segments(self, i: int) -> str:
        return "vis_seg"


class Qwen2VLModel(VisionLanguageModel):
    TOWER = Qwen2VisionTower

    def tower_inputs(self, batch):
        return {"vis_seg": batch["vis_seg"]}, None

    def save_hf(self, out_dir: str, read=None) -> None:
        save_hf_checkpoint(self, out_dir, read=read)


# ---------------------------------------------------------------------------
# HF checkpoint io
# ---------------------------------------------------------------------------

_VIS_BLOCK_MAP = [
    ("norm1_w", "norm1.weight", False),
    ("norm1_b", "norm1.bias", False),
    ("norm2_w", "norm2.weight", False),
    ("norm2_b", "norm2.bias", False),
    ("qkv_w", "attn.qkv.weight", True),
    ("qkv_b", "attn.qkv.bias", False),
    ("proj_w", "attn.proj.weight", True),
    ("proj_b", "attn.proj.bias", False),
    ("fc1_w", "mlp.fc1.weight", True),
    ("fc1_b", "mlp.fc1.bias", False),
    ("fc2_w", "mlp.fc2.weight", True),
    ("fc2_b", "mlp.fc2.bias", False),
]
_MERGER_MAP = {
    "ln_q_w": ("merger.ln_q.weight", False),
    "ln_q_b": ("merger.ln_q.bias", False),
    "fc1_w": ("merger.mlp.0.weight", True),
    "fc1_b": ("merger.mlp.0.bias", False),
    "fc2_w": ("merger.mlp.2.weight", True),
    "fc2_b": ("merger.mlp.2.bias", False),
}


def load_hf_checkpoint(model_dir: Optional[str], model: Qwen2VLModel,
                       tensors=None) -> Qwen2VLModel:
    return q25.hf_to_params(model_dir, model, _VIS_BLOCK_MAP, _MERGER_MAP, tensors)


def save_hf_checkpoint(model: Qwen2VLModel, out_dir: str, read=None, **kw) -> None:
    from veomni_tpu_torch.models import hf_io

    hf_io.write_hf_checkpoint(q25.hf_sources(model, _VIS_BLOCK_MAP, _MERGER_MAP, read),
                              hf_config(model.cfg), out_dir, **kw)


def hf_config(cfg: Qwen2VLConfig) -> Dict[str, Any]:
    """The HF ``config.json`` of the composite (``:457-477``)."""
    v = cfg.vision
    return {
        "model_type": "qwen2_vl",
        "architectures": ["Qwen2VLForConditionalGeneration"],
        "image_token_id": cfg.image_token_id,
        "video_token_id": cfg.video_token_id,
        "vision_start_token_id": cfg.vision_start_token_id,
        "text_config": {**cfg.text.to_hf_config(), "model_type": "qwen2_vl_text"},
        "vision_config": {
            "model_type": "qwen2_vl", "depth": v.depth, "embed_dim": v.embed_dim,
            "hidden_size": v.hidden_size, "hidden_act": v.hidden_act, "mlp_ratio": v.mlp_ratio,
            "num_heads": v.num_heads, "in_channels": v.in_channels, "patch_size": v.patch_size,
            "spatial_merge_size": v.spatial_merge_size,
            "temporal_patch_size": v.temporal_patch_size,
        },
    }


def config_from_hf(hf: Dict[str, Any], **overrides) -> Qwen2VLConfig:
    """Build from an HF Qwen2VLConfig dict (config.json, ``:482``)."""
    vis_hf = dict(hf.get("vision_config") or {})
    fields = set(Qwen2VisionConfig.__dataclass_fields__)
    return Qwen2VLConfig(
        text=q25.text_config_from_hf(hf, **overrides),
        vision=Qwen2VisionConfig(**{k: v for k, v in vis_hf.items() if k in fields}),
        image_token_id=hf.get("image_token_id", 151655),
        video_token_id=hf.get("video_token_id", 151656),
        vision_start_token_id=hf.get("vision_start_token_id", 151652),
    )

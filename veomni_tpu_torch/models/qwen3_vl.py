"""Qwen3-VL and Qwen3-VL-MoE: the deepstack ViT, interleaved mrope.

Port of ``veomni_tpu/models/qwen3_vl.py`` (upstream contract: HF
``Qwen3VLForConditionalGeneration`` and ``Qwen3VLMoeForConditionalGeneration``),
packed mode:

* the host-side index plan, numpy, run by the collator: ``_per_image_pos_hw``,
  the bilinear plan of the learnable position embedding
  (``_per_image_pos_interp``, HF ``fast_pos_embed_interpolate``),
  ``vision_metadata``, ``mrope_position_ids`` (HF ``get_rope_index``) and
  ``split_video_grids`` (``:163-313``);
* the tower (``:320-435``): the Conv3d patch embed as one ``[patch_dim, D]``
  product with its bias, plus the position embedding gathered from its
  ``[num_position_embeddings, D]`` table by the plan's four corners and
  weights; LayerNorm blocks with per-frame attention, the 2-D vision rope
  and a biased fc1 / GELU (tanh) / fc2 MLP, in the processor's merge-block
  patch order (no window reorder); after block ``i`` of
  ``deepstack_visual_indexes`` a post-shuffle-norm merger taps the patches
  (``deepstack_mergers``), and the last block's output goes through the
  merger (LayerNorm, then fc1 / exact GELU / fc2);
* the composite's loss (``:442-527``): the merged features scattered into
  the placeholder tokens, the deepstack features scattered alike and added
  after each of the first K text layers (``Transformer.forward_hidden``'s
  ``post_layer_residuals``), the text transformer (the qwen3 or qwen3_moe
  dialect) on interleaved mrope position ids [B, 3, S];
* the HF I/O (``:533-743``): ``model.language_model.*`` text keys (the MoE's
  experts fused as ``mlp.experts.gate_up_proj`` [E, H, 2I], gate | up
  halves, ``models/hf_io.py``) and ``model.visual.*`` tower keys.

The tower attends non-causally through ``ops.attention`` at head dim 1152 /
16 = 72: on the card that is the ``cuda_flash`` kernels K1-K3
(``ops/cuda/flash_attention.py``), whose 3-D tensor maps take D = 72.

PyTorch idiom: ``Qwen3VLModel`` is the port's ``VisionLanguageModel``
(``models/qwen2_5_vl.py``) with this tower; its ``blocks`` and
``deepstack_mergers`` are one module each where the reference stacks them
on a leading axis (``models/jax_weights.py`` carries them across).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from veomni_tpu_torch.models import qwen2_5_vl as q25
from veomni_tpu_torch.models import qwen2_vl
from veomni_tpu_torch.models.config import TransformerConfig
from veomni_tpu_torch.models.qwen2_5_vl import (
    VisionBlock,
    VisionLanguageModel,
    VisionTower,
    _pad_to,
    _param,
    vision_rope,
)


@dataclass
class Qwen3VisionConfig:
    """HF ``Qwen3VLVisionConfig`` surface (defaults = HF defaults)."""

    depth: int = 27
    hidden_size: int = 1152
    intermediate_size: int = 4304
    num_heads: int = 16
    in_channels: int = 3
    patch_size: int = 16
    temporal_patch_size: int = 2
    spatial_merge_size: int = 2
    out_hidden_size: int = 3584
    num_position_embeddings: int = 2304
    deepstack_visual_indexes: Tuple[int, ...] = (8, 16, 24)
    hidden_act: str = "gelu_pytorch_tanh"
    initializer_range: float = 0.02

    def __post_init__(self):
        self.deepstack_visual_indexes = tuple(self.deepstack_visual_indexes)

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def patch_dim(self) -> int:
        return self.in_channels * self.temporal_patch_size * self.patch_size ** 2

    @property
    def merge_unit(self) -> int:
        return self.spatial_merge_size ** 2

    @property
    def num_grid_per_side(self) -> int:
        return int(self.num_position_embeddings ** 0.5)

    @property
    def width(self) -> int:
        return self.hidden_size


@dataclass
class Qwen3VLConfig:
    text: TransformerConfig = field(default_factory=TransformerConfig)
    vision: Qwen3VisionConfig = field(default_factory=Qwen3VisionConfig)
    image_token_id: int = 151655
    video_token_id: int = 151656
    vision_start_token_id: int = 151652
    freeze_vision: bool = False
    model_type: str = "qwen3_vl"

    def __post_init__(self):
        if isinstance(self.text, dict):
            self.text = TransformerConfig(**self.text)
        if isinstance(self.vision, dict):
            self.vision = Qwen3VisionConfig(**self.vision)

    def __getattr__(self, name):  # FlopsCounter / trainer surface
        return getattr(object.__getattribute__(self, "text"), name)


# ---------------------------------------------------------------------------
# host-side index plan (numpy; runs in the collator)
# ---------------------------------------------------------------------------

def _merge_block_order(h: int, w: int, m: int) -> np.ndarray:
    """The permutation from row-major (h*w) to the processor's merge-block
    order (each m*m group of adjacent patches contiguous)."""
    idx = np.arange(h * w).reshape(h // m, m, w // m, m)
    return idx.transpose(0, 2, 1, 3).reshape(-1)


def _per_image_pos_interp(t: int, h: int, w: int, cfg: Qwen3VisionConfig):
    """The bilinear plan of the learnable position-embedding grid for one
    (t, h, w) grid: (idx [4, t*h*w] into the flat table, wts [4, t*h*w]),
    in merge-block order (HF ``fast_pos_embed_interpolate``)."""
    n = cfg.num_grid_per_side
    h_idxs, w_idxs = np.linspace(0, n - 1, h), np.linspace(0, n - 1, w)
    h_floor, w_floor = h_idxs.astype(np.int64), w_idxs.astype(np.int64)
    h_ceil, w_ceil = np.clip(h_floor + 1, None, n - 1), np.clip(w_floor + 1, None, n - 1)
    dhg, dwg = np.meshgrid(h_idxs - h_floor, w_idxs - w_floor, indexing="ij")
    w11 = dhg * dwg
    w10 = dhg - w11
    w01 = dwg - w11
    w00 = 1 - dhg - w01
    hf_g, wf_g = np.meshgrid(h_floor, w_floor, indexing="ij")
    hc_g, wc_g = np.meshgrid(h_ceil, w_ceil, indexing="ij")
    idx = np.stack([hf_g * n + wf_g, hf_g * n + wc_g, hc_g * n + wf_g,
                    hc_g * n + wc_g]).reshape(4, -1)
    wts = np.stack([w00, w01, w10, w11]).reshape(4, -1)
    order = _merge_block_order(h, w, cfg.spatial_merge_size)
    return np.tile(idx[:, order], (1, t)), np.tile(wts[:, order], (1, t))


def vision_metadata(grid_thw: Sequence[Tuple[int, int, int]], cfg: Qwen3VisionConfig,
                    n_pad_patches: int) -> Dict[str, np.ndarray]:
    """The static index plan of a batch's packed patches (processor order,
    no window reorder), sized for ``n_pad_patches`` patches: ``pos_hw``
    [N, 2] (rope positions), ``pos_interp_idx`` / ``pos_interp_w`` [4, N]
    (the bilinear plan; padding weighs 0), ``seg_full`` [N] (one segment a
    frame, 0 = padding) and ``merged_mask`` [N / merge_unit]."""
    pos_list, segf, ii, iw = [], [], [], []
    n_tokens = frame_seg = 0
    for t, h, w in grid_thw:
        pos_list.append(q25._per_image_pos_hw(t, h, w, cfg.spatial_merge_size))
        idx, wts = _per_image_pos_interp(t, h, w, cfg)
        ii.append(idx)
        iw.append(wts)
        for _ in range(t):
            frame_seg += 1
            segf.append(np.full(h * w, frame_seg, np.int32))
        n_tokens += t * h * w
    if n_tokens > n_pad_patches:
        raise ValueError(f"{n_tokens} patches exceed the static budget {n_pad_patches}; raise "
                         "data.max_patches or drop images upstream")
    m_pad = n_pad_patches // cfg.merge_unit
    idx = np.concatenate(ii, 1).astype(np.int32) if ii else np.zeros((4, 0), np.int32)
    wts = np.concatenate(iw, 1).astype(np.float32) if iw else np.zeros((4, 0), np.float32)
    return {
        "pos_hw": _pad_to(np.concatenate(pos_list).astype(np.int32) if pos_list
                          else np.zeros((0, 2), np.int32), n_pad_patches),
        "pos_interp_idx": _pad_to(idx.T, n_pad_patches).T.copy(),
        "pos_interp_w": _pad_to(wts.T, n_pad_patches).T.copy(),
        "seg_full": _pad_to(np.concatenate(segf) if segf else np.zeros((0,), np.int32),
                            n_pad_patches),
        "merged_mask": _pad_to(np.ones(n_tokens // cfg.merge_unit, bool), m_pad, fill=False),
    }


def mrope_position_ids(input_ids: np.ndarray, grid_thw: Sequence[Tuple[int, int, int]],
                       cfg) -> np.ndarray:
    """HF qwen3_vl ``get_rope_index`` (``:274``): input_ids [B, S] ->
    position_ids [B, 3, S]. Vision spans get 3-D grid positions whose t index
    is a plain ``arange(t)`` (video grids come split per frame,
    ``split_video_grids``); text spans go on 1-D from the running max."""
    b, s = input_ids.shape
    out = np.zeros((b, 3, s), np.int64)
    grids = iter(list(grid_thw))
    m = cfg.vision.spatial_merge_size
    for row in range(b):
        ids = input_ids[row]
        chunks: List[np.ndarray] = []
        is_vis = (ids == cfg.image_token_id) | (ids == cfg.video_token_id)
        p = st = 0
        while p < s:
            if not is_vis[p]:
                p += 1
                continue
            t, h, w = next(grids)
            lh, lw = h // m, w // m
            start = (chunks[-1].max() + 1) if chunks else 0
            if p > st:
                chunks.append(np.broadcast_to(np.arange(p - st), (3, p - st)) + start)
                start = chunks[-1].max() + 1
            t_idx = np.arange(t)[:, None].repeat(lh * lw, 1).reshape(-1)
            h_idx = np.tile(np.arange(lh)[None, :, None], (t, 1, lw)).reshape(-1)
            w_idx = np.tile(np.arange(lw)[None, None, :], (t, lh, 1)).reshape(-1)
            chunks.append(np.stack([t_idx, h_idx, w_idx]) + start)
            p += t * lh * lw
            st = p
        if st < s:
            start = (chunks[-1].max() + 1) if chunks else 0
            chunks.append(np.broadcast_to(np.arange(s - st), (3, s - st)) + start)
        out[row] = np.concatenate(chunks, axis=1)
    return out


def split_video_grids(grid_thw: Sequence[Tuple[int, int, int]]) -> List[Tuple[int, int, int]]:
    """HF qwen3_vl ``get_rope_index``'s first step: (t, h, w) -> t grids of
    (1, h, w)."""
    out: List[Tuple[int, int, int]] = []
    for t, h, w in grid_thw:
        out.extend([(1, h, w)] * t)
    return out


# ---------------------------------------------------------------------------
# the tower
# ---------------------------------------------------------------------------

class Qwen3VisionBlock(VisionBlock):
    """LayerNorm -> qkv (biased) -> 2-D rope -> attention -> proj ->
    LayerNorm -> fc1 -> GELU (tanh for ``gelu_pytorch_tanh``) -> fc2
    (``_vision_block``, ``:339-354``)."""

    def __init__(self, cfg: Qwen3VisionConfig, text: TransformerConfig, device):
        super().__init__(cfg, text)
        d, i = cfg.hidden_size, cfg.intermediate_size
        p = lambda *shape: _param(device, text.param_dtype, *shape)  # noqa: E731
        self.norm1_w, self.norm1_b = p(d), p(d)
        self.norm2_w, self.norm2_b = p(d), p(d)
        self.qkv_w, self.qkv_b = p(d, 3 * d), p(3 * d)
        self.proj_w, self.proj_b = p(d, d), p(d)
        self.fc1_w, self.fc1_b = p(d, i), p(i)
        self.fc2_w, self.fc2_b = p(i, d), p(d)

    def _norm(self, x, which: int):
        return qwen2_vl.layer_norm(x, self.w(f"norm{which}_w"), self.w(f"norm{which}_b"))

    def _mlp(self, y):
        approx = "tanh" if self.vcfg.hidden_act == "gelu_pytorch_tanh" else "none"
        y = F.gelu(self._linear(y, "fc1_w", "fc1_b"), approximate=approx)
        return self._linear(y, "fc2_w", "fc2_b")


class Qwen3Merger(q25.MergedReads):
    """The patch merger (``_merger``, ``:357-366``): LayerNorm over a patch
    (``postshuffle`` False) or over each merged group of ``merge_unit``
    patches (the deepstack mergers), then fc1 -> exact GELU -> fc2."""

    def __init__(self, cfg: Qwen3VisionConfig, dtype, device, postshuffle: bool):
        super().__init__()
        md = cfg.hidden_size * cfg.merge_unit
        ln = md if postshuffle else cfg.hidden_size
        p = lambda *shape: _param(device, dtype, *shape)  # noqa: E731
        self.postshuffle = postshuffle
        self.ln_w, self.ln_b = p(ln), p(ln)
        self.fc1_w, self.fc1_b = p(md, md), p(md)
        self.fc2_w, self.fc2_b = p(md, cfg.out_hidden_size), p(cfg.out_hidden_size)

    def forward(self, x, merge_unit: int):
        dt = x.dtype
        md = merge_unit * x.shape[1]
        if self.postshuffle:
            y = qwen2_vl.layer_norm(x.reshape(-1, md), self.w("ln_w"), self.w("ln_b"))
        else:
            y = qwen2_vl.layer_norm(x, self.w("ln_w"), self.w("ln_b")).reshape(-1, md)
        y = F.gelu(y @ self.w("fc1_w").to(dt) + self.w("fc1_b").to(dt))
        return y @ self.w("fc2_w").to(dt) + self.w("fc2_b").to(dt)


class Qwen3VisionTower(VisionTower):
    """``patch_embed_w`` [patch_dim, D] and ``patch_embed_b``, ``pos_embed``
    [num_position_embeddings, D], ``blocks``, ``merger`` and one
    ``deepstack_mergers`` entry a tap. ``forward`` returns (merged [M, out],
    deepstack [K, M, out])."""

    PATCH_EMBED = "patch_embed_w"

    def __init__(self, cfg: Qwen3VisionConfig, text: TransformerConfig, device):
        super().__init__(cfg, text)
        dt = text.param_dtype
        self.patch_embed_w = _param(device, dt, cfg.patch_dim, cfg.hidden_size)
        self.patch_embed_b = _param(device, dt, cfg.hidden_size)
        self.pos_embed = _param(device, dt, cfg.num_position_embeddings, cfg.hidden_size)
        self.blocks = nn.ModuleList(Qwen3VisionBlock(cfg, text, device) for _ in range(cfg.depth))
        self.merger = Qwen3Merger(cfg, dt, device, postshuffle=False)
        self.deepstack_mergers = nn.ModuleList(
            Qwen3Merger(cfg, dt, device, postshuffle=True) for _ in cfg.deepstack_visual_indexes)

    def layer_segments(self, i: int) -> str:
        return "vis_seg_full"

    def forward(self, pixel_values, pos_hw, segs, reverse=None, interp=None):
        cfg, dt = self.cfg, self.text.dtype
        x = pixel_values.to(dt) @ self.w("patch_embed_w").to(dt) + self.w("patch_embed_b").to(dt)
        idx, wts = interp
        x = x + (self.w("pos_embed").to(dt)[idx.long()] * wts.to(dt)[..., None]).sum(0)
        cos, sin = vision_rope(pos_hw, cfg.head_dim)
        taps = {i: k for k, i in enumerate(sorted(cfg.deepstack_visual_indexes))}
        deepstack = []
        for i, block in enumerate(self.blocks):
            x = block(x, cos, sin, segs[self.layer_segments(i)][None])
            if i in taps:
                deepstack.append(self.deepstack_mergers[taps[i]](x, cfg.merge_unit))
        merged = self.merger(x, cfg.merge_unit)
        stack = torch.stack(deepstack) if deepstack else merged.new_zeros((0,) + merged.shape)
        return merged, stack


class Qwen3VLModel(VisionLanguageModel):
    """The composite: its tower returns the deepstack taps beside the merged
    features, which ``merged_hidden`` scatters and adds after the first K
    text layers (``_vision_merged_hidden``, ``:470-518``)."""

    TOWER = Qwen3VisionTower

    def tower_inputs(self, batch):
        return {"vis_seg_full": batch["vis_seg_full"]}, None

    def tower_kwargs(self, batch):
        return {"interp": (batch["vis_pos_interp_idx"], batch["vis_pos_interp_w"])}

    def save_hf(self, out_dir: str, read=None) -> None:
        save_hf_checkpoint(self, out_dir, read=read)


# ---------------------------------------------------------------------------
# HF checkpoint io
# ---------------------------------------------------------------------------

_VIS_BLOCK_MAP = [
    # (ours, hf suffix, transpose)
    ("norm1_w", "norm1.weight", False),
    ("norm1_b", "norm1.bias", False),
    ("norm2_w", "norm2.weight", False),
    ("norm2_b", "norm2.bias", False),
    ("qkv_w", "attn.qkv.weight", True),
    ("qkv_b", "attn.qkv.bias", False),
    ("proj_w", "attn.proj.weight", True),
    ("proj_b", "attn.proj.bias", False),
    ("fc1_w", "mlp.linear_fc1.weight", True),
    ("fc1_b", "mlp.linear_fc1.bias", False),
    ("fc2_w", "mlp.linear_fc2.weight", True),
    ("fc2_b", "mlp.linear_fc2.bias", False),
]
_MERGER_MAP = [
    ("ln_w", "norm.weight", False),
    ("ln_b", "norm.bias", False),
    ("fc1_w", "linear_fc1.weight", True),
    ("fc1_b", "linear_fc1.bias", False),
    ("fc2_w", "linear_fc2.weight", True),
    ("fc2_b", "linear_fc2.bias", False),
]


def _tower_map(vcfg: Qwen3VisionConfig) -> List[Tuple[str, str, bool]]:
    """(tower parameter path, HF suffix under ``visual.``, transpose) for
    every tower tensor but the patch embedding's weight and the blocks'."""
    out = [("patch_embed_b", "patch_embed.proj.bias", False),
           ("pos_embed", "pos_embed.weight", False)]
    out += [(f"merger.{ours}", f"merger.{suffix}", tr) for ours, suffix, tr in _MERGER_MAP]
    for k in range(len(vcfg.deepstack_visual_indexes)):
        out += [(f"deepstack_mergers.{k}.{ours}", f"deepstack_merger_list.{k}.{suffix}", tr)
                for ours, suffix, tr in _MERGER_MAP]
    return out


def load_hf_checkpoint(model_dir: Optional[str], model: Qwen3VLModel,
                       tensors=None) -> Qwen3VLModel:
    return q25.hf_to_params(model_dir, model, _VIS_BLOCK_MAP, {}, tensors,
                            tower_map=_tower_map(model.cfg.vision))


def save_hf_checkpoint(model: Qwen3VLModel, out_dir: str, read=None, **kw) -> None:
    from veomni_tpu_torch.models import hf_io

    sources = q25.hf_sources(model, _VIS_BLOCK_MAP, {}, read, _tower_map(model.cfg.vision))
    hf_io.write_hf_checkpoint(sources, hf_config(model.cfg), out_dir, **kw)


def hf_config(cfg: Qwen3VLConfig) -> Dict[str, Any]:
    """The HF ``config.json`` of the composite (``:669-704``)."""
    moe = cfg.model_type == "qwen3_vl_moe"
    v = cfg.vision
    text = cfg.text.to_hf_config()
    text.pop("expert_layout", None)
    return {
        "model_type": cfg.model_type,
        "architectures": ["Qwen3VLMoeForConditionalGeneration" if moe
                          else "Qwen3VLForConditionalGeneration"],
        "image_token_id": cfg.image_token_id,
        "video_token_id": cfg.video_token_id,
        "vision_start_token_id": cfg.vision_start_token_id,
        "text_config": {**text, "model_type": "qwen3_vl_moe_text" if moe else "qwen3_vl_text"},
        "vision_config": {
            "model_type": cfg.model_type, "depth": v.depth, "hidden_size": v.hidden_size,
            "intermediate_size": v.intermediate_size, "num_heads": v.num_heads,
            "in_channels": v.in_channels, "patch_size": v.patch_size,
            "temporal_patch_size": v.temporal_patch_size,
            "spatial_merge_size": v.spatial_merge_size, "out_hidden_size": v.out_hidden_size,
            "num_position_embeddings": v.num_position_embeddings,
            "deepstack_visual_indexes": list(v.deepstack_visual_indexes),
            "hidden_act": v.hidden_act,
        },
    }


def config_from_hf(hf: Dict[str, Any], **overrides) -> Qwen3VLConfig:
    """Build from an HF Qwen3VLConfig / Qwen3VLMoeConfig dict (config.json,
    ``:709``): the text dialect is qwen3 (qwen3_moe with the fused-chunked
    expert layout), its mrope interleaved."""
    moe = hf.get("model_type") == "qwen3_vl_moe"
    text_hf = dict(hf.get("text_config") or {})
    for key in q25._TEXT_KEYS_AT_TOP + ("head_dim",):
        if key not in text_hf and key in hf:
            text_hf[key] = hf[key]
    rs = dict(text_hf.get("rope_scaling") or {})
    rs.setdefault("mrope_interleaved", True)
    text_hf["rope_scaling"] = rs
    composite = {k: overrides.pop(k) for k in ("freeze_vision",) if k in overrides}
    overrides.pop("model_type", None)
    if moe:
        overrides.setdefault("expert_layout", "fused_chunked")
    text = TransformerConfig.from_hf_config(
        {**text_hf, "model_type": "qwen3_moe" if moe else "qwen3"}, **overrides)
    vis_hf = dict(hf.get("vision_config") or {})
    fields = set(Qwen3VisionConfig.__dataclass_fields__)
    return Qwen3VLConfig(
        text=text,
        vision=Qwen3VisionConfig(**{k: v for k, v in vis_hf.items() if k in fields}),
        image_token_id=hf.get("image_token_id", 151655),
        video_token_id=hf.get("video_token_id", 151656),
        vision_start_token_id=hf.get("vision_start_token_id", 151652),
        model_type="qwen3_vl_moe" if moe else "qwen3_vl",
        **composite,
    )

"""Qwen2.5-VL: the window-attention ViT, mrope and the 2x2 merger.

Port of ``veomni_tpu/models/qwen2_5_vl.py`` (upstream contract: HF
``Qwen2_5_VLForConditionalGeneration``), packed mode:

* the host-side index plan, numpy, run by the collator: ``_per_image_pos_hw``
  and ``_per_image_window_plan`` (HF ``get_window_index``), ``vision_metadata``
  and ``mrope_position_ids`` (HF ``get_rope_index``) (``:153-313``);
* the tower (``:320-402``): the Conv3d patch embed as one ``[patch_dim, D]``
  product, the 2-D vision rope over (h, w) patch positions, RMSNorm blocks
  with a biased SwiGLU MLP on a window-ordered patch sequence, where the
  layers of ``fullatt_block_indexes`` attend with ``seg_full`` (per frame)
  and the others with ``seg_window`` (per 112-pixel window), then the 2x2
  merger and the ``reverse`` gather back to image order;
* the composite's loss (``:409-529``): tower features scattered into the
  placeholder tokens of the embedded text (``merge_vision_features``), then
  the text transformer with mrope position ids [B, 3, S];
* the HF I/O (``:552-730``), reading both ``model.language_model.*`` and the
  older ``model.*`` text keys and ``visual.*`` / ``model.visual.*`` tower keys.

The tower attends non-causally through ``ops.attention`` at head dim 1280 /
16 = 80: on the card that is the ``cuda_flash`` kernels K1-K3
(``ops/cuda/flash_attention.py``), whose 3-D tensor maps take D = 80.

PyTorch idiom: ``Qwen25VLModel`` holds ``language_model`` (the port's
``Transformer``) and ``vision_tower``, whose ``blocks`` are one module per
layer where the reference stacks them on a leading axis; parameters keep
the reference's names and ``[in, out]`` layout (``models/jax_weights.py``
carries them across). ``freeze_vision`` runs the tower without autograd, so
its parameters get no gradient: the train step gives them a zero one, and
AdamW still decays them, as optax does behind the reference's
``stop_gradient`` (``:496-497``). The tower's blocks take the text config's
remat policy (``ctx``: the attention kernels' forward is not rerun), where
the reference checkpoints each block whole; the numbers are the same.

Per-row vision batches (``flatten_per_row_vision``, ``:456``) come from a
batch split over ranks (``trainer/vlm_trainer.py``). Under sequence
parallelism the tower's attention runs without it and ``merged_hidden``
keeps the rank's chunk of the merged sequence.
"""

from __future__ import annotations

from contextlib import nullcontext
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from veomni_tpu_torch import ops
from veomni_tpu_torch.models.config import TransformerConfig
from veomni_tpu_torch.parallel.parallel_state import get_parallel_state_or_none, use_parallel_state
from veomni_tpu_torch.models.transformer import Transformer
from veomni_tpu_torch.models.transformer import init_params as init_text_params
from veomni_tpu_torch.utils.device import DeviceLike, resolve_device


@dataclass
class Qwen25VisionConfig:
    """HF ``Qwen2_5_VLVisionConfig`` surface (defaults = 7B checkpoint)."""

    depth: int = 32
    hidden_size: int = 1280
    intermediate_size: int = 3420
    num_heads: int = 16
    in_channels: int = 3
    patch_size: int = 14
    temporal_patch_size: int = 2
    spatial_merge_size: int = 2
    window_size: int = 112
    fullatt_block_indexes: Tuple[int, ...] = (7, 15, 23, 31)
    out_hidden_size: int = 3584
    hidden_act: str = "silu"
    tokens_per_second: float = 2.0
    initializer_range: float = 0.02

    def __post_init__(self):
        self.fullatt_block_indexes = tuple(self.fullatt_block_indexes)

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
    def width(self) -> int:
        """The blocks' width (``hidden_size`` here, ``embed_dim`` in Qwen2-VL)."""
        return self.hidden_size


@dataclass
class Qwen25VLConfig:
    text: TransformerConfig = field(default_factory=TransformerConfig)
    vision: Qwen25VisionConfig = field(default_factory=Qwen25VisionConfig)
    image_token_id: int = 151655
    video_token_id: int = 151656
    vision_start_token_id: int = 151652
    freeze_vision: bool = False
    model_type: str = "qwen2_5_vl"

    def __post_init__(self):
        if isinstance(self.text, dict):
            self.text = TransformerConfig(**self.text)
        if isinstance(self.vision, dict):
            self.vision = Qwen25VisionConfig(**self.vision)

    def __getattr__(self, name):  # FlopsCounter / trainer surface
        return getattr(object.__getattribute__(self, "text"), name)


# ---------------------------------------------------------------------------
# host-side index plan (numpy; runs in the collator)
# ---------------------------------------------------------------------------

def _per_image_pos_hw(t: int, h: int, w: int, m: int) -> np.ndarray:
    """(h, w) rope position per patch in the processor's merge-block patch
    order (HF ``rot_pos_emb``: (h/m, w/m, m, m) flattening)."""
    hpos = np.arange(h)[:, None].repeat(w, 1)
    wpos = np.arange(w)[None, :].repeat(h, 0)

    def order(x):
        return x.reshape(h // m, m, w // m, m).transpose(0, 2, 1, 3).reshape(-1)

    per_t = np.stack([order(hpos), order(wpos)], -1)  # [h*w, 2]
    return np.tile(per_t, (t, 1))


def _per_image_window_plan(t: int, h: int, w: int, cfg: Qwen25VisionConfig):
    """HF ``get_window_index`` for one image: (window_index [t*lh*lw], the
    merged-token permutation into window order; the merged-token count of
    each non-empty window)."""
    m = cfg.spatial_merge_size
    lh, lw = h // m, w // m
    vit_ws = cfg.window_size // m // cfg.patch_size
    index = np.arange(t * lh * lw).reshape(t, lh, lw)
    pad_h = (-lh) % vit_ws
    pad_w = (-lw) % vit_ws
    nwh, nww = (lh + pad_h) // vit_ws, (lw + pad_w) // vit_ws
    padded = np.full((t, lh + pad_h, lw + pad_w), -100)
    padded[:, :lh, :lw] = index
    padded = padded.reshape(t, nwh, vit_ws, nww, vit_ws).transpose(0, 1, 3, 2, 4)
    padded = padded.reshape(t, nwh * nww, vit_ws, vit_ws)
    sizes = (padded != -100).sum((2, 3)).reshape(-1)
    flat = padded.reshape(-1)
    window_index = flat[flat != -100]
    return window_index, [int(s) for s in sizes if s > 0]


def _pad_to(x: np.ndarray, size: int, fill=0) -> np.ndarray:
    out = np.full((size,) + x.shape[1:], fill, x.dtype)
    out[: len(x)] = x
    return out


def vision_metadata(grid_thw: Sequence[Tuple[int, int, int]], cfg: Qwen25VisionConfig,
                    n_pad_patches: int) -> Dict[str, np.ndarray]:
    """The static index plan of a batch's packed image patches, sized for
    ``n_pad_patches`` patches and ``n_pad_patches // merge_unit`` merged
    tokens: ``patch_gather`` [N] (the window-order gather over the
    processor-order patches, applied by the collator), ``pos_hw`` [N, 2]
    (rope positions, window order), ``seg_window`` / ``seg_full`` [N]
    (segment ids of windowed layers, per window, and of global layers, per
    frame; 0 = padding), ``reverse``
    [M] (window order -> image order of the merged tokens) and
    ``merged_mask`` [M] (the valid merged tokens)."""
    unit = cfg.merge_unit
    pos_list, gather, segw, segf = [], [], [], []
    reverse_parts = []
    merged_offset = 0  # merged tokens emitted so far (image order)
    win_seg = 0
    frame_seg = 0
    for t, h, w in grid_thw:
        n_merged = t * (h // cfg.spatial_merge_size) * (w // cfg.spatial_merge_size)
        widx, wsizes = _per_image_window_plan(t, h, w, cfg)
        # patch-level gather: merged token widx[j] -> its `unit` patches
        pg = (widx[:, None] * unit + np.arange(unit)[None, :]).reshape(-1)
        gather.append(pg + merged_offset * unit)
        pos = _per_image_pos_hw(t, h, w, cfg.spatial_merge_size)
        pos_list.append(pos[pg])
        # the full-attention layers attend within a frame, as HF's
        # cu_seqlens = repeat_interleave(h * w, t); the window order keeps
        # each frame's patches together. The reference gives a whole grid one
        # segment (ROADMAP.md queue 3, diverges on purpose: t > 1 only)
        for _ in range(t):
            frame_seg += 1
            segf.append(np.full(h * w, frame_seg, np.int32))
        for sz in wsizes:
            win_seg += 1
            segw.append(np.full(sz * unit, win_seg, np.int32))
        reverse_parts.append(np.argsort(widx) + merged_offset)
        merged_offset += n_merged

    n = merged_offset * unit
    if n > n_pad_patches:
        raise ValueError(f"{n} patches exceed the static budget {n_pad_patches}; raise "
                         "data.max_patches or drop images upstream")
    m_pad = n_pad_patches // unit
    pg = np.concatenate(gather) if gather else np.zeros((0,), np.int64)
    return {
        "patch_gather": _pad_to(pg.astype(np.int32), n_pad_patches, fill=max(n, 1) - 1),
        "pos_hw": _pad_to(np.concatenate(pos_list).astype(np.int32) if pos_list
                          else np.zeros((0, 2), np.int32), n_pad_patches),
        "seg_window": _pad_to(np.concatenate(segw) if segw else np.zeros((0,), np.int32),
                              n_pad_patches),
        "seg_full": _pad_to(np.concatenate(segf) if segf else np.zeros((0,), np.int32),
                            n_pad_patches),
        "reverse": _pad_to(np.concatenate(reverse_parts).astype(np.int32) if reverse_parts
                           else np.zeros((0,), np.int32), m_pad, fill=max(m_pad, 1) - 1),
        "merged_mask": _pad_to(np.ones(merged_offset, bool), m_pad, fill=False),
    }


def mrope_position_ids(input_ids: np.ndarray, grid_thw: Sequence[Tuple[int, int, int]], cfg,
                       second_per_grid_ts: Optional[Sequence[float]] = None,
                       video: Optional[Sequence[bool]] = None) -> np.ndarray:
    """HF ``get_rope_index``: input_ids [B, S] -> position_ids [B, 3, S]
    (t/h/w streams). Vision spans get 3-D grid positions; text spans go on
    1-D from the running max. Each grid takes exactly its merged-token
    count of placeholders, so adjacent images stay distinct."""
    b, s = input_ids.shape
    out = np.zeros((b, 3, s), np.int64)
    vis_iter = iter(list(zip(grid_thw, video or [False] * len(grid_thw),
                             second_per_grid_ts or [1.0] * len(grid_thw))))
    m = cfg.vision.spatial_merge_size
    for row in range(b):
        ids = input_ids[row]
        pos_chunks: List[np.ndarray] = []
        is_vis = (ids == cfg.image_token_id) | (ids == cfg.video_token_id)
        p = 0
        st = 0
        while p < s:
            if not is_vis[p]:
                p += 1
                continue
            (t, h, w), is_video, spg = next(vis_iter)
            lt, lh, lw = t, h // m, w // m
            st_idx = (pos_chunks[-1].max() + 1) if pos_chunks else 0
            text_len = p - st
            if text_len:
                pos_chunks.append(np.broadcast_to(np.arange(text_len), (3, text_len)) + st_idx)
                st_idx = pos_chunks[-1].max() + 1
            interval = spg * cfg.vision.tokens_per_second if is_video else 0.0
            t_idx = (np.arange(lt)[:, None] * interval).astype(np.int64)
            t_idx = t_idx.repeat(lh * lw, 1).reshape(-1)
            h_idx = np.tile(np.arange(lh)[None, :, None], (lt, 1, lw)).reshape(-1)
            w_idx = np.tile(np.arange(lw)[None, None, :], (lt, lh, 1)).reshape(-1)
            pos_chunks.append(np.stack([t_idx, h_idx, w_idx]) + st_idx)
            p += lt * lh * lw
            st = p
        if st < s:
            st_idx = (pos_chunks[-1].max() + 1) if pos_chunks else 0
            text_len = s - st
            pos_chunks.append(np.broadcast_to(np.arange(text_len), (3, text_len)) + st_idx)
        out[row] = np.concatenate(pos_chunks, axis=1)
    return out


# ---------------------------------------------------------------------------
# the tower
# ---------------------------------------------------------------------------

def vision_rope(pos_hw: torch.Tensor, head_dim: int):
    """The 2-D vision rope (HF ``Qwen2_5_VisionRotaryEmbedding``, ``:367-374``):
    head_dim / 2 frequencies, the first half turned by the patch's row, the
    second by its column. pos_hw [N, 2] -> (cos, sin) [1, N, head_dim] f32."""
    half = head_dim // 2
    exponent = torch.arange(0, half, 2, dtype=torch.float32, device=pos_hw.device) / half
    inv_freq = 1.0 / (10000.0 ** exponent)
    fh = pos_hw[:, 0:1].float() * inv_freq  # [N, hd/4]
    fw = pos_hw[:, 1:2].float() * inv_freq
    freqs = torch.cat([fh, fw], -1)
    emb = torch.cat([freqs, freqs], -1)[None]
    return torch.cos(emb), torch.sin(emb)


def _param(device, dtype, *shape) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device))


class MergedReads(nn.Module):
    """A tower module whose forward reads each of its parameters through
    :meth:`w`, where a LoRA adapter (``lora/lora.py``) merges into it, as
    ``DecoderLayer.w`` does."""

    def __init__(self):
        super().__init__()
        self.merges: Dict[str, Any] = {}

    def w(self, name: str) -> torch.Tensor:
        merge = self.merges.get(name)
        p = self.get_parameter(name)
        return p if merge is None else merge(p)


class VisionBlock(MergedReads):
    """One tower block; the family's subclass names its norm and MLP
    parameters and computes them (``_norm``, ``_mlp``)."""

    def __init__(self, cfg, text: TransformerConfig):
        super().__init__()
        self.vcfg, self.text = cfg, text

    def _linear(self, x, w: str, b: str):
        dt = x.dtype
        return x @ self.w(w).to(dt) + self.w(b).to(dt)

    def _qkv(self, x, cos, sin):
        n, _ = x.shape
        cfg = self.vcfg
        qkv = self._linear(self._norm(x, 1), "qkv_w", "qkv_b")
        q, k, v = qkv.view(1, n, 3 * cfg.num_heads, cfg.head_dim).chunk(3, dim=2)
        q, k = ops.apply_rotary(q, k, cos, sin)
        return q, k, v

    def _tail(self, x, attn):
        n, d = x.shape
        x = x + self._linear(attn.reshape(n, d), "proj_w", "proj_b")
        return x + self._mlp(self._norm(x, 2))

    def forward(self, x, cos, sin, seg):
        """x [N, D] -> [N, D]; ``seg`` [1, N] segment ids of this layer's
        attention (non-causal within a segment)."""
        text = self.text

        def attend(q, k, v):
            # the tower's patches are the rank's whole micro-batch: its
            # attention runs with sequence parallelism off, also when a remat
            # backward recomputes it outside the caller's scope
            ps = get_parallel_state_or_none()
            with use_parallel_state(ps.without_sp()) if ps is not None else nullcontext():
                return ops.attention(q, k, v, segment_ids=seg, causal=False)

        if not (text.remat and torch.is_grad_enabled()):
            return self._tail(x, attend(*self._qkv(x, cos, sin)))
        if text.remat_policy == "ctx":
            q, k, v = checkpoint(self._qkv, x, cos, sin, use_reentrant=False)
            return checkpoint(self._tail, x, attend(q, k, v), use_reentrant=False)
        return checkpoint(lambda y: self._tail(y, attend(*self._qkv(y, cos, sin))), x,
                          use_reentrant=False)


class Qwen25VisionBlock(VisionBlock):
    """RMSNorm -> qkv (biased) -> 2-D rope -> attention -> proj -> RMSNorm ->
    biased SwiGLU (``_vision_block``, ``:327-340``)."""

    def __init__(self, cfg: Qwen25VisionConfig, text: TransformerConfig, device):
        super().__init__(cfg, text)
        d, i = cfg.hidden_size, cfg.intermediate_size
        p = lambda *shape: _param(device, text.param_dtype, *shape)  # noqa: E731
        self.norm1, self.norm2 = p(d), p(d)
        self.qkv_w, self.qkv_b = p(d, 3 * d), p(3 * d)
        self.proj_w, self.proj_b = p(d, d), p(d)
        self.gate_w, self.gate_b = p(d, i), p(i)
        self.up_w, self.up_b = p(d, i), p(i)
        self.down_w, self.down_b = p(i, d), p(d)

    def _norm(self, x, which: int):
        return ops.rms_norm(x, self.w(f"norm{which}").to(x.dtype), 1e-6)

    def _mlp(self, y):
        act = F.silu(self._linear(y, "gate_w", "gate_b")) * self._linear(y, "up_w", "up_b")
        return self._linear(act, "down_w", "down_b")


class Qwen25Merger(MergedReads):
    """RMSNorm, then each 2x2 group of patches concatenated and through
    fc1 -> GELU (tanh form, ``jax.nn.gelu``'s default) -> fc2."""

    def __init__(self, cfg: Qwen25VisionConfig, dtype, device):
        super().__init__()
        d, md = cfg.hidden_size, cfg.hidden_size * cfg.merge_unit
        p = lambda *shape: _param(device, dtype, *shape)  # noqa: E731
        self.ln_q = p(d)
        self.fc1_w, self.fc1_b = p(md, md), p(md)
        self.fc2_w, self.fc2_b = p(md, cfg.out_hidden_size), p(cfg.out_hidden_size)

    def _norm(self, x):
        return ops.rms_norm(x, self.w("ln_q").to(x.dtype), 1e-6)

    def forward(self, x, merge_unit: int):
        dt = x.dtype
        y = self._norm(x)
        y = y.reshape(x.shape[0] // merge_unit, merge_unit * x.shape[1])
        y = F.gelu(y @ self.w("fc1_w").to(dt) + self.w("fc1_b").to(dt), approximate="tanh")
        return y @ self.w("fc2_w").to(dt) + self.w("fc2_b").to(dt)


class VisionTower(MergedReads):
    """``patch_embed`` [patch_dim, D], ``blocks`` and ``merger``; the
    family's subclass builds them and says which segment ids each layer
    attends with (``layer_segments``)."""

    PATCH_EMBED = "patch_embed"  # the reference's name of the patch-embed matrix

    def __init__(self, cfg, text: TransformerConfig):
        super().__init__()
        self.cfg, self.text = cfg, text

    def forward(self, pixel_values, pos_hw, segs: Dict[str, torch.Tensor], reverse=None, **_):
        """pixel_values [N, patch_dim] (padded) -> merged features
        [N / merge_unit, out] in image order, in the text's compute dtype."""
        cfg, dt = self.cfg, self.text.dtype
        x = pixel_values.to(dt) @ self.w(self.PATCH_EMBED).to(dt)
        cos, sin = vision_rope(pos_hw, cfg.head_dim)
        for i, block in enumerate(self.blocks):
            x = block(x, cos, sin, segs[self.layer_segments(i)][None])
        y = self.merger(x, cfg.merge_unit)
        return y if reverse is None else y[reverse.long()]


class Qwen25VisionTower(VisionTower):
    def __init__(self, cfg: Qwen25VisionConfig, text: TransformerConfig, device):
        super().__init__(cfg, text)
        self.patch_embed = _param(device, text.param_dtype, cfg.patch_dim, cfg.hidden_size)
        self.blocks = nn.ModuleList(Qwen25VisionBlock(cfg, text, device)
                                    for _ in range(cfg.depth))
        self.merger = Qwen25Merger(cfg, text.param_dtype, device)

    def layer_segments(self, i: int) -> str:
        return "vis_seg_full" if i in self.cfg.fullatt_block_indexes else "vis_seg_window"


@torch.no_grad()
def init_vision_params(tower: nn.Module, generator: torch.Generator, std: float) -> None:
    """The reference's tower init (``init_vision_params``): norm weights at
    1, biases at 0, matrices ~ N(0, std)."""
    for name, param in tower.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf.startswith(("norm", "ln_")) and not leaf.endswith("_b"):
            param.fill_(1.0)
        elif leaf.endswith("_b"):
            param.zero_()
        else:
            noise = torch.randn(param.shape, generator=generator, dtype=torch.float32,
                                device=param.device)
            param.copy_(noise * std)


# ---------------------------------------------------------------------------
# the composite and its loss
# ---------------------------------------------------------------------------

def gather_packed_features(input_ids, feats, merged_mask, image_token_id: int,
                           video_token_id: int, row_tokens: int = 0):
    """Packed per-token features [M, H] (image order) aligned with the
    placeholder tokens of ``input_ids`` [B, S]: (gathered [B*S, H], valid
    [B*S]) (``:409-437``). ``row_tokens`` 0: the features cover the whole
    batch in reading order. ``row_tokens`` R (the per-row budgets): they are
    row-major [B*R, H], each row's placeholders indexing its own R slots."""
    m = feats.shape[0]
    is_vis = (input_ids == image_token_id) | (input_ids == video_token_id)
    flat = is_vis.reshape(-1)
    if row_tokens:
        b = input_ids.shape[0]
        ordinal = torch.cumsum(is_vis.to(torch.int32), 1) - 1
        in_budget = is_vis & (ordinal < row_tokens)
        idx = (torch.arange(b, device=input_ids.device)[:, None] * row_tokens
               + ordinal.clamp(0, row_tokens - 1)).reshape(-1).long()
        return feats[idx], in_budget.reshape(-1) & merged_mask[idx]
    ordinal = torch.cumsum(flat.to(torch.int32), 0) - 1
    idx = ordinal.clamp(0, m - 1).long()
    valid = flat & (ordinal < m) & merged_mask[idx]
    return feats[idx], valid


def merge_vision_features(embeds, input_ids, feats, merged_mask, image_token_id: int,
                          video_token_id: int, row_tokens: int = 0):
    """Packed vision features scattered into the placeholder tokens of
    ``embeds`` [B, S, H] (``:440-453``)."""
    b, s, h = embeds.shape
    gathered, valid = gather_packed_features(input_ids, feats, merged_mask, image_token_id,
                                             video_token_id, row_tokens)
    out = torch.where(valid[:, None], gathered.to(embeds.dtype), embeds.reshape(b * s, h))
    return out.reshape(b, s, h)


def flatten_per_row_vision(batch, unit: int) -> Tuple[Dict[str, torch.Tensor], int]:
    """Per-row-budget vision arrays [B, Pr, ...] (a batch split over ranks,
    each row with its own patch budget) -> the packed layout the tower
    consumes, with per-row segment and index offsets so that the rows stay
    masked from each other (``:456-488``). Returns (packed arrays, merged
    tokens a row)."""
    pv = batch["pixel_values"]
    b, pr, d = pv.shape
    mr = pr // unit
    row = torch.arange(b, dtype=torch.int32, device=pv.device)[:, None]
    out = {"pixel_values": pv.reshape(b * pr, d)}
    for key in ("vis_seg_window", "vis_seg_full", "vis_seg"):
        if key in batch:
            seg = batch[key]
            # row seg ids are 1..Pr: a stride of Pr + 1 cannot collide
            out[key] = torch.where(seg > 0, seg + row * (pr + 1), torch.zeros_like(seg)).reshape(-1)
    if "vis_pos_hw" in batch:
        out["vis_pos_hw"] = batch["vis_pos_hw"].reshape(b * pr, 2)
    if "vis_reverse" in batch:
        out["vis_reverse"] = (batch["vis_reverse"] + row * mr).reshape(-1)
    if "vis_merged_mask" in batch:
        out["vis_merged_mask"] = batch["vis_merged_mask"].reshape(-1)
    if "vis_pos_interp_idx" in batch:
        # [B, 4, Pr] -> [4, B*Pr]: the indices address the one shared table
        for key in ("vis_pos_interp_idx", "vis_pos_interp_w"):
            out[key] = batch[key].transpose(0, 1).reshape(4, b * pr)
    return out, mr


class VisionLanguageModel(nn.Module):
    """``language_model`` (the text ``Transformer``) and ``vision_tower``;
    ``loss_fn`` is the reference's ``_vision_merged_hidden`` + ``head_loss``
    (``:491-529``)."""

    TOWER: type = VisionTower

    def __init__(self, cfg, generator: Optional[torch.Generator], *, device: DeviceLike = None):
        """``generator`` None leaves the parameters uninitialized, for a
        checkpoint to fill."""
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.language_model = Transformer(cfg.text, None, device=dev)
        self.vision_tower = self.TOWER(cfg.vision, cfg.text, dev)
        if generator is not None:
            init_text_params(self.language_model, generator)
            init_vision_params(self.vision_tower, generator, cfg.vision.initializer_range)

    def tower_inputs(self, batch) -> Tuple[Dict[str, torch.Tensor], Optional[torch.Tensor]]:
        """({segment-id name: [N] ids}, the reverse gather or None)."""
        return ({k: batch[k] for k in ("vis_seg_window", "vis_seg_full")}, batch["vis_reverse"])

    def tower_kwargs(self, batch) -> Dict[str, Any]:
        """The family's other tower inputs (Qwen3-VL: the position plan)."""
        return {}

    def vision_features(self, batch) -> Tuple[torch.Tensor, int, Dict[str, torch.Tensor]]:
        """([M, H] merged features in image order, merged tokens a row in
        the per-row layout else 0, the batch with its vision arrays packed);
        no autograd with ``freeze_vision``. The tower's attention runs with
        sequence parallelism off (``ParallelState.without_sp``, in
        ``VisionBlock``): its patches are the rank's whole micro-batch."""
        row_tokens = 0
        if batch["pixel_values"].ndim == 3:
            packed, row_tokens = flatten_per_row_vision(batch, self.cfg.vision.merge_unit)
            batch = {**batch, **packed}
        segs, reverse = self.tower_inputs(batch)
        with torch.set_grad_enabled(torch.is_grad_enabled() and not self.cfg.freeze_vision):
            feats = self.vision_tower(batch["pixel_values"], batch["vis_pos_hw"], segs, reverse,
                                      **self.tower_kwargs(batch))
        return feats, row_tokens, batch

    def has_vision(self, batch) -> bool:
        """Whether the tower runs on this batch (a VLM's always does; the
        omni thinkers', where the batch holds pixels)."""
        return True

    def merge_media(self, embeds, batch):
        """The embeddings with the family's other media scattered in after
        the vision features (the omni thinkers' audio); as they are here."""
        return embeds

    def merged_hidden(self, batch):
        """(final hidden [B, S(/sp), H], router aux loss, the labels) of the
        text transformer on the embeddings with the vision features
        scattered in. ``batch`` holds whole rows; under sequence parallelism
        the merged embeddings, positions, segments and labels keep this
        rank's chunk of the sequence (cp outer, ulysses inner)."""
        cfg, lm = self.cfg, self.language_model
        ids = batch["input_ids"]
        embeds = lm.embed(ids)
        residuals = None
        if self.has_vision(batch):
            feats, row_tokens, batch = self.vision_features(batch)
            # a deepstack tower (Qwen3-VL) gives its taps beside the merged features
            feats, deepstack = feats if isinstance(feats, tuple) else (feats, None)
            mask = batch["vis_merged_mask"].bool()

            def scatter(into, f):
                return merge_vision_features(into, ids, f, mask, cfg.image_token_id,
                                             cfg.video_token_id, row_tokens)

            embeds = scatter(embeds, feats)
            if deepstack is not None and deepstack.shape[0]:
                # each tap scattered to its positions, zeros elsewhere (``:511-517``)
                zeros = torch.zeros_like(embeds)
                residuals = torch.stack([scatter(zeros, f) for f in deepstack])
        embeds = self.merge_media(embeds, batch)
        pos, seg, labels = batch["position_ids"], batch.get("segment_ids"), batch.get("labels")
        ps = get_parallel_state_or_none()
        if ps is not None and ps.sp_enabled:
            from veomni_tpu_torch.parallel.sequence_parallel import sp_slice

            embeds, ids = sp_slice(embeds, ps), sp_slice(ids, ps)
            pos = sp_slice(pos, ps, dim=pos.ndim - 1)
            seg = None if seg is None else sp_slice(seg, ps)
            labels = None if labels is None else sp_slice(labels, ps)
            residuals = None if residuals is None else sp_slice(residuals, ps, dim=2)
        hidden, aux = lm.forward_hidden(ids, pos, seg, inputs_embeds=embeds,
                                        post_layer_residuals=residuals)
        return hidden, aux, labels

    def loss_fn(self, batch):
        """Token-sum NLL and metrics, as ``Transformer.loss_fn``; ``batch``:
        input_ids/labels/segment_ids [B,S], position_ids [B,3,S],
        pixel_values [N, patch_dim], vis_pos_hw [N,2], the family's segment
        ids [N], (Qwen2.5) vis_reverse [M], vis_merged_mask [M]; or the
        per-row layout's [B, Pr, ...] vision arrays."""
        hidden, aux, labels = self.merged_hidden(batch)
        return self.language_model.head_loss(hidden, labels, aux)

    def sequence_logprob_sums(self, batch) -> torch.Tensor:
        """Per-row sums of the label log-probs [B] f32 through the whole
        composite (``sequence_logprob_sums``, ``:532-545``: the VLM-DPO
        trainer's policy and reference scores), with the final softcap as
        the text model's (ROADMAP.md queue 3, diverges on purpose 7)."""
        hidden, _, labels = self.merged_hidden(batch)
        return self.language_model.logprob_sums(hidden, labels)


class Qwen25VLModel(VisionLanguageModel):
    TOWER = Qwen25VisionTower

    def save_hf(self, out_dir: str, read=None) -> None:
        save_hf_checkpoint(self, out_dir, read=read)


# ---------------------------------------------------------------------------
# HF checkpoint io
# ---------------------------------------------------------------------------

_VIS_BLOCK_MAP = [
    # (ours, hf suffix, transpose)
    ("norm1", "norm1.weight", False),
    ("norm2", "norm2.weight", False),
    ("qkv_w", "attn.qkv.weight", True),
    ("qkv_b", "attn.qkv.bias", False),
    ("proj_w", "attn.proj.weight", True),
    ("proj_b", "attn.proj.bias", False),
    ("gate_w", "mlp.gate_proj.weight", True),
    ("gate_b", "mlp.gate_proj.bias", False),
    ("up_w", "mlp.up_proj.weight", True),
    ("up_b", "mlp.up_proj.bias", False),
    ("down_w", "mlp.down_proj.weight", True),
    ("down_b", "mlp.down_proj.bias", False),
]
# merger: ours -> (hf suffix, transpose)
_MERGER_MAP = {
    "ln_q": ("merger.ln_q.weight", False),
    "fc1_w": ("merger.mlp.0.weight", True),
    "fc1_b": ("merger.mlp.0.bias", False),
    "fc2_w": ("merger.mlp.2.weight", True),
    "fc2_b": ("merger.mlp.2.bias", False),
}


def _is_visual_key(k: str) -> bool:
    return ".visual." in k or k.startswith("visual.")


def _text_key_map(k: str) -> Optional[str]:
    if _is_visual_key(k):
        return None
    return k.replace("model.language_model.", "model.").replace("language_model.model.", "model.")


def patch_embed_from_hf(w: torch.Tensor, width: int) -> torch.Tensor:
    """HF's Conv3d weight [D, C, T, P, P] -> our [C*T*P*P, D] product
    matrix: the patch rows flatten (C, T, Ph, Pw), as the processor does."""
    return w.reshape(width, -1).t()


def patch_embed_to_hf(w: torch.Tensor, vcfg) -> torch.Tensor:
    return w.t().reshape(vcfg.width, vcfg.in_channels, vcfg.temporal_patch_size,
                         vcfg.patch_size, vcfg.patch_size)


@torch.no_grad()
def hf_to_params(model_dir: Optional[str], model: VisionLanguageModel, block_map,
                 merger_map, tensors=None, tower_map=(),
                 text_key_map=_text_key_map) -> VisionLanguageModel:
    """Fill a composite from an HF checkpoint: the text tree through
    ``hf_io.hf_to_params`` with the text key map, then the tower, one tensor
    at a time (``:581-637``). ``tower_map``: (tower parameter path, HF
    suffix, transpose) of the family's other tower tensors."""
    from veomni_tpu_torch.models import hf_io

    cfg = model.cfg
    hf_io.hf_to_params(model_dir, cfg.text, model.language_model, tensors=tensors,
                       key_map=text_key_map)
    lazy = hf_io.LazyHFTensors(None if tensors is not None else model_dir, tensors)
    alias = {k[k.index("visual.") + len("visual."):]: k for k in lazy.keys() if _is_visual_key(k)}

    def read(name: str, transpose: bool = False) -> torch.Tensor:
        if name not in alias:
            raise KeyError(f"HF checkpoint {model_dir or '(in memory)'} has no tower tensor "
                           f"visual.{name}")
        x = lazy.read(alias[name])
        return x.t() if transpose else x

    def put(param, x, what):
        if tuple(x.shape) != tuple(param.shape):
            raise ValueError(f"{what}: checkpoint shape {tuple(x.shape)} (after the layout "
                             f"conversion), model {tuple(param.shape)}")
        param.copy_(x.to(param.device))  # cast and transposed on the parameter's device

    tower = model.vision_tower
    put(tower.get_parameter(tower.PATCH_EMBED),
        patch_embed_from_hf(read("patch_embed.proj.weight"), cfg.vision.width), "patch_embed")
    for i, block in enumerate(tower.blocks):
        for ours, suffix, transpose in block_map:
            put(getattr(block, ours), read(f"blocks.{i}.{suffix}", transpose), f"blocks.{i}.{ours}")
    for ours, (suffix, transpose) in merger_map.items():
        put(getattr(tower.merger, ours), read(suffix, transpose), f"merger.{ours}")
    for ours, suffix, transpose in tower_map:
        put(tower.get_parameter(ours), read(suffix, transpose), ours)
    return model


def hf_sources(model: VisionLanguageModel, block_map, merger_map, read=None, tower_map=()):
    """Every HF tensor of the composite as ``hf_io`` tensor sources: the
    text's under ``model.language_model.`` (``lm_head`` at the top), the
    tower's under ``model.visual.`` (``:640-666``). ``read(owner, name)``,
    where given, gives each tensor in place of the parameter (LoRA's merged
    export)."""
    from veomni_tpu_torch.models import hf_io

    cfg = model.cfg
    out = []
    for name, dtype, shape, produce in hf_io.hf_sources(model.language_model, cfg.text, read):
        if name != "lm_head.weight":
            name = name.replace("model.", "model.language_model.", 1)
        out.append((name, dtype, shape, produce))
    tower, pfx = model.vision_tower, "model.visual"
    vcfg = cfg.vision

    def value(owner, pname):
        return (read(owner, pname) if read else owner.get_parameter(pname)).detach()

    pe = tower.get_parameter(tower.PATCH_EMBED)
    out.append((f"{pfx}.patch_embed.proj.weight", pe.dtype,
                (vcfg.width, vcfg.in_channels, vcfg.temporal_patch_size, vcfg.patch_size,
                 vcfg.patch_size),
                lambda: patch_embed_to_hf(value(tower, tower.PATCH_EMBED),
                                          vcfg).contiguous().cpu()))

    def add(name, owner, pname, transpose):
        param = owner.get_parameter(pname)
        shape = tuple(reversed(param.shape)) if transpose else tuple(param.shape)

        def produce():
            x = value(owner, pname)
            return (x.t() if transpose else x).contiguous().cpu()

        out.append((name, param.dtype, shape, produce))

    for i, block in enumerate(tower.blocks):
        for ours, suffix, transpose in block_map:
            add(f"{pfx}.blocks.{i}.{suffix}", block, ours, transpose)
    for ours, (suffix, transpose) in merger_map.items():
        add(f"{pfx}.{suffix}", tower.merger, ours, transpose)
    for ours, suffix, transpose in tower_map:
        owner, _, pname = ours.rpartition(".")
        add(f"{pfx}.{suffix}", tower.get_submodule(owner) if owner else tower, pname, transpose)
    return sorted(out, key=lambda s: s[0])


def load_hf_checkpoint(model_dir: Optional[str], model: Qwen25VLModel,
                       tensors=None) -> Qwen25VLModel:
    return hf_to_params(model_dir, model, _VIS_BLOCK_MAP, _MERGER_MAP, tensors)


def save_hf_checkpoint(model: Qwen25VLModel, out_dir: str, read=None, **kw) -> None:
    from veomni_tpu_torch.models import hf_io

    hf_io.write_hf_checkpoint(hf_sources(model, _VIS_BLOCK_MAP, _MERGER_MAP, read),
                              hf_config(model.cfg), out_dir, **kw)


def hf_config(cfg: Qwen25VLConfig) -> Dict[str, Any]:
    """The HF ``config.json`` of the composite (``:681-704``)."""
    v = cfg.vision
    return {
        "model_type": "qwen2_5_vl",
        "architectures": ["Qwen2_5_VLForConditionalGeneration"],
        "image_token_id": cfg.image_token_id,
        "video_token_id": cfg.video_token_id,
        "vision_start_token_id": cfg.vision_start_token_id,
        "text_config": {**cfg.text.to_hf_config(), "model_type": "qwen2_5_vl_text"},
        "vision_config": {
            "model_type": "qwen2_5_vl", "depth": v.depth, "hidden_size": v.hidden_size,
            "intermediate_size": v.intermediate_size, "num_heads": v.num_heads,
            "in_channels": v.in_channels, "patch_size": v.patch_size,
            "temporal_patch_size": v.temporal_patch_size,
            "spatial_merge_size": v.spatial_merge_size, "window_size": v.window_size,
            "fullatt_block_indexes": list(v.fullatt_block_indexes),
            "out_hidden_size": v.out_hidden_size, "tokens_per_second": v.tokens_per_second,
            "hidden_act": v.hidden_act,
        },
    }


_TEXT_KEYS_AT_TOP = ("vocab_size", "hidden_size", "intermediate_size", "num_hidden_layers",
                     "num_attention_heads", "num_key_value_heads", "rope_theta", "rms_norm_eps",
                     "tie_word_embeddings", "rope_scaling", "max_position_embeddings")


def text_config_from_hf(hf: Dict[str, Any], **overrides) -> TransformerConfig:
    """The text config of a VLM ``config.json``: its ``text_config``, with
    the top-level text keys of older checkpoints filled in, as qwen2."""
    text_hf = dict(hf.get("text_config") or {})
    for key in _TEXT_KEYS_AT_TOP:
        if key not in text_hf and key in hf:
            text_hf[key] = hf[key]
    return TransformerConfig.from_hf_config({**text_hf, "model_type": "qwen2"}, **overrides)


def config_from_hf(hf: Dict[str, Any], **overrides) -> Qwen25VLConfig:
    """Build from an HF Qwen2_5_VLConfig dict (config.json, ``:709``)."""
    vis_hf = dict(hf.get("vision_config") or {})
    fields = set(Qwen25VisionConfig.__dataclass_fields__)
    return Qwen25VLConfig(
        text=text_config_from_hf(hf, **overrides),
        vision=Qwen25VisionConfig(**{k: v for k, v in vis_hf.items() if k in fields}),
        image_token_id=hf.get("image_token_id", 151655),
        video_token_id=hf.get("video_token_id", 151656),
        vision_start_token_id=hf.get("vision_start_token_id", 151652),
    )

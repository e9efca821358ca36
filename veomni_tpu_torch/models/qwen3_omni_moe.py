"""Qwen3-Omni-MoE thinker: the AuT audio tower, the Qwen3-VL deepstack
tower and the qwen3_moe LM with interleaved mrope.

Port of ``veomni_tpu/models/qwen3_omni_moe.py`` (upstream contract: HF
``Qwen3OmniMoeThinkerForConditionalGeneration``):

* the configs ``Qwen3OmniAudioConfig`` and ``Qwen3OmniMoeConfig`` (``:53-118``);
* the host-side audio plan, numpy, run by the collator (``:42-275``):
  ``audio_output_lengths`` (HF ``_get_feat_extract_output_lengths``),
  ``audio_metadata`` (chunk lengths, the frame gather over the conv output,
  window segments of ``n_window_infer // chunk_len`` chunks, the frame
  mask; 0 is padding) and ``pack_audio_chunks``;
* the audio tower (``audio_forward``, ``:285-354``): three stride-2 3x3
  convolutions over (mel, time) with exact GELU (``F.conv2d``; the
  reference's ``lax.conv`` runs outside any kernel), ``conv_out``, the
  sinusoid table per chunk position, the gather of the valid frames, pre-LN
  layers whose attention is non-causal within a window (``ops.attention``:
  on the card the ``cuda_flash`` kernels K1-K3 at head dim 1280 / 20 = 64
  when the frame buffer is a multiple of 128), then ``ln_post``, ``proj1``
  with GELU and ``proj2``, in the text's compute dtype;
* ``omni_position_ids`` (``:361-433``, the thinker's ``get_rope_index``);
* the composite's loss (``:440-501``): the Qwen3-VL tower's merged features
  and deepstack taps (``models/qwen3_vl.py``), then the audio features
  scattered into the audio placeholders, the taps added after the first K
  text layers, ``head_loss``;
* the HF I/O (``:508-810``): thinker keys (an optional ``thinker.`` prefix,
  text at ``model.*`` with per-expert MoE tensors, the tower at ``visual.*``
  with ``merger_list`` mergers named ``ln_q`` / ``mlp.0`` / ``mlp.2``, the
  audio tower at ``audio_tower.*``), ``config_from_hf`` and
  ``parallel_plan``.

PyTorch idiom: ``Qwen3OmniMoeModel`` is the port's Qwen3-VL composite with
an ``audio_tower`` module beside the vision tower; its ``layers`` are one
module each (``models/jax_weights.py`` stacks them for the reference), and
its conv kernels keep torch's (and HF's) OIHW layout, where the reference
keeps HWIO. ``freeze_audio`` runs the tower without autograd, as
``freeze_vision`` does the vision tower's.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from veomni_tpu_torch.models import qwen2_5_vl as q25
from veomni_tpu_torch.models import qwen3_vl
from veomni_tpu_torch.models.config import TransformerConfig
from veomni_tpu_torch.models.qwen2_5_omni import (
    AudioEncoderBlock,
    _sinusoid_table,
    audio_layer_norm,
    audio_sources,
    init_audio_params,
    load_audio_tower,
)
from veomni_tpu_torch.models.qwen2_5_vl import MergedReads, _param, merge_vision_features
from veomni_tpu_torch.models.qwen3_vl import Qwen3VisionConfig
from veomni_tpu_torch.utils.device import DeviceLike


def audio_output_lengths(mel_len: int) -> int:
    """HF ``_get_feat_extract_output_lengths``: the audio placeholder count of
    a mel sequence (13 conv frames a full 100-frame chunk)."""
    leave = mel_len % 100
    feat = (leave - 1) // 2 + 1
    return ((feat - 1) // 2 + 1 - 1) // 2 + 1 + (mel_len // 100) * 13


def _conv_out_len(n: int) -> int:
    """Time length after one stride-2 k3 p1 conv."""
    return (n + 2 - 3) // 2 + 1


@dataclass
class Qwen3OmniAudioConfig:
    """HF ``Qwen3OmniMoeAudioEncoderConfig`` surface."""

    d_model: int = 1280
    encoder_layers: int = 32
    encoder_attention_heads: int = 20
    encoder_ffn_dim: int = 5120
    num_mel_bins: int = 128
    max_source_positions: int = 1500
    scale_embedding: bool = False
    n_window: int = 50
    n_window_infer: int = 400
    downsample_hidden_size: int = 480
    output_dim: int = 3584
    activation_function: str = "gelu"
    initializer_range: float = 0.02

    @property
    def head_dim(self) -> int:
        return self.d_model // self.encoder_attention_heads

    @property
    def chunk_len(self) -> int:
        return 2 * self.n_window

    @property
    def chunk_out_len(self) -> int:
        """Conv time length of a full chunk."""
        return _conv_out_len(_conv_out_len(_conv_out_len(self.chunk_len)))

    @property
    def freq_out(self) -> int:
        f = self.num_mel_bins
        for _ in range(3):
            f = _conv_out_len(f)
        return f


@dataclass
class Qwen3OmniMoeConfig:
    text: TransformerConfig = field(default_factory=TransformerConfig)
    vision: Qwen3VisionConfig = field(default_factory=Qwen3VisionConfig)
    audio: Qwen3OmniAudioConfig = field(default_factory=Qwen3OmniAudioConfig)
    image_token_id: int = 151655
    video_token_id: int = 151656
    audio_token_id: int = 151646
    vision_start_token_id: int = 151652
    audio_start_token_id: int = 151647
    position_id_per_seconds: int = 13
    freeze_vision: bool = False
    freeze_audio: bool = False
    model_type: str = "qwen3_omni_moe"

    def __post_init__(self):
        if isinstance(self.text, dict):
            self.text = TransformerConfig(**self.text)
        if isinstance(self.vision, dict):
            self.vision = Qwen3VisionConfig(**self.vision)
        if isinstance(self.audio, dict):
            self.audio = Qwen3OmniAudioConfig(**self.audio)

    def __getattr__(self, name):  # FlopsCounter / trainer surface
        return getattr(object.__getattribute__(self, "text"), name)


# ---------------------------------------------------------------------------
# the host-side audio plan (numpy; runs in the collator)
# ---------------------------------------------------------------------------

def audio_metadata(feature_lens: Sequence[int], cfg: Qwen3OmniAudioConfig, n_chunk_pad: int,
                   n_frame_pad: int) -> Dict[str, np.ndarray]:
    """The static plan of a batch's audios (mel lengths ``feature_lens``):
    ``chunk_lens`` [n_chunk_pad] (mel frames a chunk, 0 = padding),
    ``frame_gather`` [n_frame_pad] (the flat index of each valid frame in the
    [n_chunk_pad * chunk_out_len] conv output), ``seg`` [n_frame_pad] (window
    segments, 0 = padding) and ``frame_mask`` [n_frame_pad] (the valid
    frames, one an audio placeholder)."""
    cl, col = cfg.chunk_len, cfg.chunk_out_len
    chunk_lens: List[int] = []
    gather, seg = [], []
    win_chunks = max(1, cfg.n_window_infer // cfg.chunk_len)
    win_seg = 0
    for mel_len in feature_lens:
        n_chunks = -(-mel_len // cl)
        start_chunk = len(chunk_lens)
        n_frames_audio = 0
        for c in range(n_chunks):
            this = min(cl, mel_len - c * cl)
            chunk_lens.append(this)
            t = this
            for _ in range(3):
                t = _conv_out_len(t)
            if c % win_chunks == 0:
                win_seg += 1
            gather.append(np.arange(t) + (start_chunk + c) * col)
            seg.append(np.full(t, win_seg, np.int32))
            n_frames_audio += t
        expected = audio_output_lengths(mel_len)
        if n_frames_audio != expected:
            raise ValueError(
                f"audio plan mismatch: conv yields {n_frames_audio} frames, placeholder "
                f"formula says {expected} (mel_len={mel_len}, n_window={cfg.n_window}); the "
                "placeholder scatter would desync")
    if len(chunk_lens) > n_chunk_pad:
        raise ValueError(f"{len(chunk_lens)} chunks exceed the static budget {n_chunk_pad}")
    n = sum(len(g) for g in gather)
    if n > n_frame_pad:
        raise ValueError(f"{n} audio frames exceed the budget {n_frame_pad}")

    def pad_to(x, size):
        out = np.zeros((size,), np.int32)
        out[: len(x)] = x
        return out

    return {
        "chunk_lens": pad_to(np.asarray(chunk_lens, np.int32), n_chunk_pad),
        "frame_gather": pad_to(np.concatenate(gather).astype(np.int32) if gather
                               else np.zeros(0, np.int32), n_frame_pad),
        "seg": pad_to(np.concatenate(seg) if seg else np.zeros(0, np.int32), n_frame_pad),
        "frame_mask": pad_to(np.ones(n, np.int32), n_frame_pad).astype(bool),
    }


def pack_audio_chunks(features: Sequence[np.ndarray], cfg: Qwen3OmniAudioConfig,
                      n_chunk_pad: int) -> np.ndarray:
    """Features [mel_bins, T] each -> the padded chunk buffer [n_chunk_pad,
    mel_bins, chunk_len] f32."""
    cl = cfg.chunk_len
    out = np.zeros((n_chunk_pad, cfg.num_mel_bins, cl), np.float32)
    i = 0
    for feat in features:
        feat = np.asarray(feat, np.float32)
        for c in range(-(-feat.shape[1] // cl)):
            piece = feat[:, c * cl:(c + 1) * cl]
            out[i, :, : piece.shape[1]] = piece
            i += 1
    return out


def omni_position_ids(input_ids: np.ndarray, cfg: Qwen3OmniMoeConfig,
                      image_grid_thw: Sequence[Tuple[int, int, int]] = (),
                      video_grid_thw: Sequence[Tuple[int, int, int]] = (),
                      audio_lens: Sequence[int] = (),
                      second_per_grids: Optional[Sequence[float]] = None) -> np.ndarray:
    """input_ids [B, S] -> position_ids [B, 3, S] int64. Media spans are
    found by their placeholder runs: text and audio take 1-D positions,
    vision spans 3-D grid positions whose t is scaled by
    ``position_id_per_seconds``. As in the reference, ``use_audio_in_video``
    is not taken, and a fractional ``spg * position_id_per_seconds`` is
    truncated to an integer (HF keeps it float)."""
    b, s = input_ids.shape
    out = np.zeros((b, 3, s), np.int64)
    img_it = iter(list(image_grid_thw))
    vid_it = iter(list(zip(video_grid_thw, second_per_grids or [1.0] * len(video_grid_thw))))
    aud_it = iter(list(audio_lens))
    m = cfg.vision.spatial_merge_size
    pps = cfg.position_id_per_seconds
    media = (cfg.image_token_id, cfg.video_token_id, cfg.audio_token_id)
    for row in range(b):
        ids = input_ids[row]
        chunks: List[np.ndarray] = []
        p = st = 0
        while p < s:
            tok = ids[p]
            if tok not in media:
                p += 1
                continue
            st_idx = (chunks[-1].max() + 1) if chunks else 0
            if p > st:
                chunks.append(np.broadcast_to(np.arange(p - st), (3, p - st)) + st_idx)
                st_idx = chunks[-1].max() + 1
            if tok == cfg.audio_token_id:
                alen = audio_output_lengths(next(aud_it))
                chunks.append(np.broadcast_to(np.arange(alen), (3, alen)) + st_idx)
                p += alen
            else:
                if tok == cfg.image_token_id:
                    (t, h, w), spg = next(img_it), 1.0
                else:
                    (t, h, w), spg = next(vid_it)
                lh, lw = h // m, w // m
                t_idx = (np.arange(t) * spg * pps).astype(np.int64)
                t_idx = t_idx[:, None].repeat(lh * lw, 1).reshape(-1)
                h_idx = np.tile(np.arange(lh)[None, :, None], (t, 1, lw)).reshape(-1)
                w_idx = np.tile(np.arange(lw)[None, None, :], (t, lh, 1)).reshape(-1)
                chunks.append(np.stack([t_idx, h_idx, w_idx]) + st_idx)
                p += t * lh * lw
            st = p
        if st < s:
            st_idx = (chunks[-1].max() + 1) if chunks else 0
            chunks.append(np.broadcast_to(np.arange(s - st), (3, s - st)) + st_idx)
        out[row] = np.concatenate(chunks, axis=1)
    return out


# ---------------------------------------------------------------------------
# the audio tower
# ---------------------------------------------------------------------------

class Qwen3OmniAudioBlock(AudioEncoderBlock):
    """One AuT layer (``_audio_layer``, ``:294-307``): LayerNorm -> biased q /
    k / v -> attention within a window -> out_proj -> LayerNorm -> fc1 ->
    exact GELU -> fc2."""

    LN = ("ln1_w", "ln1_b", "ln2_w", "ln2_b")
    K_BIAS = True
    GELU = "none"


class Qwen3OmniAudioTower(MergedReads):
    """``conv1_w`` [ds, 1, 3, 3], ``conv2_w``/``conv3_w`` [ds, ds, 3, 3] (OIHW)
    with their biases, ``conv_out_w`` [ds * freq_out, d] (no bias),
    ``layers``, ``ln_post_w``/``_b``, ``proj1_w`` [d, d] and ``proj2_w``
    [d, output_dim] with their biases."""

    # the reference's HWIO conv kernels -> OIHW
    JAX_LAYOUT = {f"conv{i}_w": (3, 2, 0, 1) for i in (1, 2, 3)}

    def __init__(self, cfg: Qwen3OmniAudioConfig, text: TransformerConfig, device):
        super().__init__()
        self.cfg, self.text = cfg, text
        d, ds = cfg.d_model, cfg.downsample_hidden_size
        p = lambda *shape: _param(device, text.param_dtype, *shape)  # noqa: E731
        self.conv1_w, self.conv1_b = p(ds, 1, 3, 3), p(ds)
        self.conv2_w, self.conv2_b = p(ds, ds, 3, 3), p(ds)
        self.conv3_w, self.conv3_b = p(ds, ds, 3, 3), p(ds)
        self.conv_out_w = p(ds * cfg.freq_out, d)
        self.layers = nn.ModuleList(Qwen3OmniAudioBlock(cfg, text, device)
                                    for _ in range(cfg.encoder_layers))
        self.ln_post_w, self.ln_post_b = p(d), p(d)
        self.proj1_w, self.proj1_b = p(d, d), p(d)
        self.proj2_w, self.proj2_b = p(d, cfg.output_dim), p(cfg.output_dim)

    def frames(self, chunk_feats, frame_gather):
        """The convolution front end: chunk_feats [n_chunks, mel, chunk_len]
        -> the packed valid frames [n_frame_pad, d] with their positions."""
        cfg, dt = self.cfg, self.text.dtype
        x = chunk_feats.to(dt)[:, None]  # NCHW [n, 1, mel, T]
        for i in (1, 2, 3):
            x = F.gelu(F.conv2d(x, self.w(f"conv{i}_w").to(dt), self.w(f"conv{i}_b").to(dt),
                                stride=2, padding=1))
        n, ds, melp, tp = x.shape
        # [n, ds, mel', T'] -> [n, T', ds * mel'], as torch's permute + flatten
        x = x.permute(0, 3, 1, 2).reshape(n, tp, ds * melp) @ self.w("conv_out_w").to(dt)
        pos = torch.from_numpy(_sinusoid_table(cfg.max_source_positions, cfg.d_model))
        x = x + pos[:tp].to(device=x.device, dtype=dt)[None]
        return x.reshape(n * tp, cfg.d_model)[frame_gather.long()]

    def forward(self, chunk_feats, frame_gather, seg):
        """chunk_feats [n_chunks, mel, chunk_len], frame_gather and seg
        [n_frame_pad] -> features [n_frame_pad, output_dim] (the packed audio
        frames in audio order) in the text's compute dtype."""
        dt = self.text.dtype
        x = self.frames(chunk_feats, frame_gather)
        seg = seg.to(torch.int32)[None]
        for layer in self.layers:
            x = layer(x, None, None, seg)
        x = audio_layer_norm(x, self.w("ln_post_w"), self.w("ln_post_b"))
        x = F.gelu(x @ self.w("proj1_w").to(dt) + self.w("proj1_b").to(dt))
        return x @ self.w("proj2_w").to(dt) + self.w("proj2_b").to(dt)


# ---------------------------------------------------------------------------
# the composite
# ---------------------------------------------------------------------------

class Qwen3OmniMoeModel(qwen3_vl.Qwen3VLModel):
    """The Qwen3-VL composite (its deepstack tower) with ``audio_tower``;
    ``loss_fn`` is the reference's ``_omni_merged_hidden`` + ``head_loss``.
    Each tower runs where the batch holds its media."""

    def __init__(self, cfg: Qwen3OmniMoeConfig, generator: Optional[torch.Generator], *,
                 device: DeviceLike = None):
        super().__init__(cfg, generator, device=device)
        dev = self.language_model.embed_tokens.device
        self.audio_tower = Qwen3OmniAudioTower(cfg.audio, cfg.text, dev)
        if generator is not None:
            init_audio_params(self.audio_tower, generator, cfg.audio.initializer_range)

    def has_vision(self, batch) -> bool:
        return "pixel_values" in batch

    def audio_features(self, batch):
        """[n_frame_pad, output_dim] packed audio features; no autograd with
        ``freeze_audio``."""
        with torch.set_grad_enabled(torch.is_grad_enabled() and not self.cfg.freeze_audio):
            return self.audio_tower(batch["audio_chunks"], batch["aud_frame_gather"],
                                    batch["aud_seg"])

    def merge_media(self, embeds, batch):
        if "audio_chunks" not in batch:
            return embeds
        cfg = self.cfg
        return merge_vision_features(embeds, batch["input_ids"], self.audio_features(batch),
                                     batch["aud_frame_mask"].bool(), cfg.audio_token_id,
                                     cfg.audio_token_id)

    def save_hf(self, out_dir: str, read=None) -> None:
        save_hf_checkpoint(self, out_dir, read=read)


# ---------------------------------------------------------------------------
# HF checkpoint io
# ---------------------------------------------------------------------------

_AUD_LAYER_MAP = [
    ("ln1_w", "self_attn_layer_norm.weight", False),
    ("ln1_b", "self_attn_layer_norm.bias", False),
    ("q_w", "self_attn.q_proj.weight", True),
    ("q_b", "self_attn.q_proj.bias", False),
    ("k_w", "self_attn.k_proj.weight", True),
    ("k_b", "self_attn.k_proj.bias", False),
    ("v_w", "self_attn.v_proj.weight", True),
    ("v_b", "self_attn.v_proj.bias", False),
    ("o_w", "self_attn.out_proj.weight", True),
    ("o_b", "self_attn.out_proj.bias", False),
    ("ln2_w", "final_layer_norm.weight", False),
    ("ln2_b", "final_layer_norm.bias", False),
    ("fc1_w", "fc1.weight", True),
    ("fc1_b", "fc1.bias", False),
    ("fc2_w", "fc2.weight", True),
    ("fc2_b", "fc2.bias", False),
]
# (ours, HF name under audio_tower., transpose): the conv kernels are OIHW in both
_AUD_TOP_MAP = [
    ("conv1_w", "conv2d1.weight", False),
    ("conv1_b", "conv2d1.bias", False),
    ("conv2_w", "conv2d2.weight", False),
    ("conv2_b", "conv2d2.bias", False),
    ("conv3_w", "conv2d3.weight", False),
    ("conv3_b", "conv2d3.bias", False),
    ("conv_out_w", "conv_out.weight", True),
    ("ln_post_w", "ln_post.weight", False),
    ("ln_post_b", "ln_post.bias", False),
    ("proj1_w", "proj1.weight", True),
    ("proj1_b", "proj1.bias", False),
    ("proj2_w", "proj2.weight", True),
    ("proj2_b", "proj2.bias", False),
]
_OMNI_MERGER_MAP = [
    ("ln_w", "ln_q.weight", False),
    ("ln_b", "ln_q.bias", False),
    ("fc1_w", "mlp.0.weight", True),
    ("fc1_b", "mlp.0.bias", False),
    ("fc2_w", "mlp.2.weight", True),
    ("fc2_b", "mlp.2.bias", False),
]


def _strip_thinker(k: str) -> str:
    return k[len("thinker."):] if k.startswith("thinker.") else k


def _text_key_map(k: str) -> Optional[str]:
    k = _strip_thinker(k)
    if ".visual." in k or k.startswith("visual.") or "audio_tower." in k:
        return None
    return k.replace("model.language_model.", "model.").replace("language_model.model.", "model.")


def _tower_map(vcfg: Qwen3VisionConfig) -> List[Tuple[str, str, bool]]:
    """(tower parameter path, HF suffix under ``visual.``, transpose) of the
    tower tensors but the patch embedding's weight and the blocks'."""
    out = [("patch_embed_b", "patch_embed.proj.bias", False),
           ("pos_embed", "pos_embed.weight", False)]
    out += [(f"merger.{ours}", f"merger.{suffix}", tr) for ours, suffix, tr in _OMNI_MERGER_MAP]
    for k in range(len(vcfg.deepstack_visual_indexes)):
        out += [(f"deepstack_mergers.{k}.{ours}", f"merger_list.{k}.{suffix}", tr)
                for ours, suffix, tr in _OMNI_MERGER_MAP]
    return out


@torch.no_grad()
def load_hf_checkpoint(model_dir: Optional[str], model: Qwen3OmniMoeModel,
                       tensors=None) -> Qwen3OmniMoeModel:
    """Fill the thinker from an HF checkpoint (``hf_to_params``, ``:568-666``),
    with or without the full model's ``thinker.`` prefix, one tensor at a
    time."""
    from veomni_tpu_torch.models import hf_io

    q25.hf_to_params(model_dir, model, qwen3_vl._VIS_BLOCK_MAP, {}, tensors,
                     tower_map=_tower_map(model.cfg.vision), text_key_map=_text_key_map)
    lazy = hf_io.LazyHFTensors(None if tensors is not None else model_dir, tensors)
    prefix = "thinker.audio_tower." if any(k.startswith("thinker.") for k in lazy.keys()) \
        else "audio_tower."
    load_audio_tower(lazy, model.audio_tower, _AUD_TOP_MAP, _AUD_LAYER_MAP, prefix,
                     model_dir or "(in memory)")
    return model


def hf_sources(model: Qwen3OmniMoeModel, read=None, prefix: str = ""):
    """Every HF tensor of the thinker (``params_to_hf``, ``:669-707``): text
    at ``model.*`` (``lm_head`` at the top), the tower at ``visual.*``, the
    audio tower at ``audio_tower.*``, each under ``prefix`` (``thinker.``:
    the full model's layout)."""
    out = []
    for name, dtype, shape, produce in q25.hf_sources(
            model, qwen3_vl._VIS_BLOCK_MAP, {}, read, _tower_map(model.cfg.vision)):
        name = name.replace("model.language_model.", "model.", 1).replace(
            "model.visual.", "visual.", 1)
        out.append((prefix + name, dtype, shape, produce))
    out += audio_sources(model.audio_tower, _AUD_TOP_MAP, _AUD_LAYER_MAP,
                         prefix + "audio_tower.", read)
    return sorted(out, key=lambda s: s[0])


def save_hf_checkpoint(model: Qwen3OmniMoeModel, out_dir: str, read=None,
                       prefix: str = "", **kw) -> None:
    """The thinker's HF checkpoint; ``prefix="thinker."`` writes the full
    model's key layout and its ``config.json`` (the thinker under
    ``thinker_config``)."""
    from veomni_tpu_torch.models import hf_io

    cfg = hf_config(model.cfg)
    if prefix:
        cfg = {"model_type": "qwen3_omni_moe",
               "architectures": ["Qwen3OmniMoeForConditionalGeneration"],
               "thinker_config": cfg}
    hf_io.write_hf_checkpoint(hf_sources(model, read, prefix), cfg, out_dir, **kw)


def hf_config(cfg: Qwen3OmniMoeConfig) -> Dict[str, Any]:
    """The thinker's ``config.json`` (``:722-762``)."""
    v, a = cfg.vision, cfg.audio
    return {
        "model_type": "qwen3_omni_moe_thinker",
        "architectures": ["Qwen3OmniMoeThinkerForConditionalGeneration"],
        "image_token_id": cfg.image_token_id,
        "video_token_id": cfg.video_token_id,
        "audio_token_id": cfg.audio_token_id,
        "vision_start_token_id": cfg.vision_start_token_id,
        "audio_start_token_id": cfg.audio_start_token_id,
        "position_id_per_seconds": cfg.position_id_per_seconds,
        "text_config": {**cfg.text.to_hf_config(), "model_type": "qwen3_omni_moe_text"},
        "vision_config": {
            "model_type": "qwen3_omni_moe_vision_encoder", "depth": v.depth,
            "hidden_size": v.hidden_size, "intermediate_size": v.intermediate_size,
            "num_heads": v.num_heads, "in_channels": v.in_channels,
            "patch_size": v.patch_size, "temporal_patch_size": v.temporal_patch_size,
            "spatial_merge_size": v.spatial_merge_size, "out_hidden_size": v.out_hidden_size,
            "num_position_embeddings": v.num_position_embeddings,
            "deepstack_visual_indexes": list(v.deepstack_visual_indexes),
            "hidden_act": v.hidden_act,
        },
        "audio_config": {
            "model_type": "qwen3_omni_moe_audio_encoder", "d_model": a.d_model,
            "encoder_layers": a.encoder_layers,
            "encoder_attention_heads": a.encoder_attention_heads,
            "encoder_ffn_dim": a.encoder_ffn_dim, "num_mel_bins": a.num_mel_bins,
            "max_source_positions": a.max_source_positions, "n_window": a.n_window,
            "n_window_infer": a.n_window_infer,
            "downsample_hidden_size": a.downsample_hidden_size, "output_dim": a.output_dim,
            "activation_function": a.activation_function,
        },
    }


def config_from_hf(hf: Dict[str, Any], **overrides) -> Qwen3OmniMoeConfig:
    """Build from a full ``Qwen3OmniMoeConfig`` dict (``{"thinker_config":
    ...}``) or a bare thinker config dict (``:767-810``): the text dialect is
    qwen3_moe with per-expert tensors, its mrope interleaved."""
    thinker = hf.get("thinker_config") or hf
    text_hf = dict(thinker.get("text_config") or {})
    rs = dict(text_hf.get("rope_scaling") or {})
    rs.setdefault("mrope_section", [24, 20, 20])
    rs.setdefault("mrope_interleaved", True)
    text_hf["rope_scaling"] = rs
    # the composite's own overrides, kept out of the text config
    composite = {k: overrides.pop(k) for k in ("freeze_vision", "freeze_audio")
                 if k in overrides}
    overrides.pop("model_type", None)
    text = TransformerConfig.from_hf_config({**text_hf, "model_type": "qwen3_moe"}, **overrides)
    vis_hf = dict(thinker.get("vision_config") or {})
    vis_fields = set(Qwen3VisionConfig.__dataclass_fields__)
    aud_hf = dict(thinker.get("audio_config") or {})
    aud_fields = set(Qwen3OmniAudioConfig.__dataclass_fields__)

    def get(k, d):
        return thinker.get(k, hf.get(k, d))

    return Qwen3OmniMoeConfig(
        text=text,
        vision=Qwen3VisionConfig(**{k: v for k, v in vis_hf.items() if k in vis_fields}),
        audio=Qwen3OmniAudioConfig(**{k: v for k, v in aud_hf.items() if k in aud_fields}),
        image_token_id=get("image_token_id", 151655),
        video_token_id=get("video_token_id", 151656),
        audio_token_id=get("audio_token_id", 151646),
        vision_start_token_id=get("vision_start_token_id", 151652),
        audio_start_token_id=get("audio_start_token_id", 151647),
        position_id_per_seconds=get("position_id_per_seconds", 13),
        **composite,
    )


def parallel_plan(cfg):
    """The text subtree's MoE rules under the composite's prefix; the towers
    take the default rule (``:813-822``)."""
    from veomni_tpu_torch.parallel.parallel_plan import ParallelPlan

    rules = {}
    if cfg.text.is_moe:
        rules[r"language_model\.layers\.experts\..*"] = ("ep", "ep_fsdp", None)
        rules[r"language_model\.layers\.router$"] = ()
    return ParallelPlan(rules=rules)

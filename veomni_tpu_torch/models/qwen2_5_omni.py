"""Qwen2.5-Omni thinker: the Whisper-style audio encoder, the Qwen2.5-VL
tower and the qwen2 LM with mrope.

Port of ``veomni_tpu/models/qwen2_5_omni.py`` (upstream contract: HF
``Qwen2_5OmniThinkerForConditionalGeneration``):

* the configs ``OmniAudioEncoderConfig`` and ``Qwen25OmniConfig`` (``:47-109``);
  every audio fills a static slot of ``audio.max_frames`` mel frames, a
  multiple of ``2 * n_window``;
* the audio encoder (``audio_encoder_forward``, ``:171-217``): per chunk of
  ``2 * n_window`` frames a k3 conv and a k3 stride-2 conv, each with the
  tanh GELU (``jax.nn.gelu``'s default), the sinusoid table restarting each
  chunk, pre-LN layers whose attention is non-causal within a chunk
  (segment ids through ``ops.attention``: on the card the ``cuda_flash``
  kernels K1-K3 at head dim 1280 / 20 = 64 when ``chunks * n_window`` is a
  multiple of 128), then pair-average pooling, ``ln_post`` and ``proj``;
* the composite's loss (``:241-300``): the Qwen2.5-VL tower's features and
  each audio's pooled features scattered into their placeholder tokens,
  then the text transformer on mrope positions (audio placeholders take
  text positions, ``models/qwen2_5_vl.py::mrope_position_ids``);
* the HF I/O (``:325-577``): thinker keys (``model.*`` text, ``visual.*``
  with split q / k / v, ``audio_tower.*``), ``config_from_hf`` and
  ``parallel_plan``.

PyTorch idiom: ``Qwen25OmniModel`` holds ``language_model``, an optional
``vision_tower`` and an optional ``audio_tower``; the conv weights are kept
in torch's (and HF's) ``[out, in, k]`` layout, which ``models/jax_weights.py``
transposes from the reference's ``[k, in, out]``. The encoder's layers take
the text config's remat policy, as the vision blocks do.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from veomni_tpu_torch.models import qwen2_5_vl as q25
from veomni_tpu_torch.models.config import TransformerConfig
from veomni_tpu_torch.models.qwen2_5_vl import MergedReads, VisionBlock, _param
from veomni_tpu_torch.models.qwen2_vl import layer_norm
from veomni_tpu_torch.models.transformer import Transformer
from veomni_tpu_torch.models.transformer import init_params as init_text_params
from veomni_tpu_torch.utils.device import DeviceLike, resolve_device


@dataclass
class OmniAudioEncoderConfig:
    """HF ``Qwen2_5OmniAudioEncoderConfig`` surface."""

    num_mel_bins: int = 128
    d_model: int = 1280
    encoder_layers: int = 32
    encoder_attention_heads: int = 20
    encoder_ffn_dim: int = 5120
    n_window: int = 100
    max_source_positions: int = 1500
    output_dim: int = 3584
    initializer_range: float = 0.02
    # static slot length in mel frames; must be a multiple of 2*n_window
    max_frames: int = 400

    @property
    def head_dim(self) -> int:
        return self.d_model // self.encoder_attention_heads

    @property
    def chunks(self) -> int:
        return self.max_frames // (2 * self.n_window)

    @property
    def tokens_per_audio(self) -> int:
        # conv2 stride-2 then pair pooling: T/4
        return self.max_frames // 4

    def __post_init__(self):
        if self.max_frames % (2 * self.n_window):
            raise ValueError(f"audio max_frames ({self.max_frames}) must be a multiple of "
                             f"2*n_window ({2 * self.n_window})")


@dataclass
class Qwen25OmniConfig:
    text: TransformerConfig = field(default_factory=TransformerConfig)
    vision: Optional[q25.Qwen25VisionConfig] = None
    audio: Optional[OmniAudioEncoderConfig] = None
    image_token_id: int = 151655
    video_token_id: int = 151656
    vision_start_token_id: int = 151652
    audio_token_id: int = 151646
    audio_start_token_id: int = 151647
    audio_end_token_id: int = 151648
    position_id_per_seconds: float = 25.0
    freeze_vision: bool = False
    freeze_audio: bool = False
    model_type: str = "qwen2_5_omni"

    def __post_init__(self):
        if isinstance(self.text, dict):
            self.text = TransformerConfig(**self.text)
        if isinstance(self.vision, dict):
            self.vision = q25.Qwen25VisionConfig(**self.vision)
        if isinstance(self.audio, dict):
            self.audio = OmniAudioEncoderConfig(**self.audio)

    def __getattr__(self, name):  # FlopsCounter / trainer surface
        return getattr(object.__getattribute__(self, "text"), name)


# ---------------------------------------------------------------------------
# shared audio pieces (the Qwen3-Omni tower uses them too)
# ---------------------------------------------------------------------------

def _sinusoid_table(length: int, channels: int) -> np.ndarray:
    """Whisper ``SinusoidsPositionEmbedding``: log-spaced timescales, sin
    then cos (``:152-157``)."""
    log_timescale = np.log(10000.0) / (channels // 2 - 1)
    inv = np.exp(-log_timescale * np.arange(channels // 2))
    scaled = np.arange(length)[:, None] * inv[None, :]
    return np.concatenate([np.sin(scaled), np.cos(scaled)], axis=1).astype(np.float32)


def audio_layer_norm(x, w, b):
    """The encoders' f32 LayerNorm at eps 1e-5 (``_layer_norm``, ``:144``)."""
    return layer_norm(x, w, b, eps=1e-5)


@torch.no_grad()
def init_audio_params(tower: nn.Module, generator: torch.Generator, std: float) -> None:
    """The reference's audio init: LayerNorm weights at 1, biases at 0,
    every other weight ~ N(0, std)."""
    for name, param in tower.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf.endswith("_b"):
            param.zero_()
        elif leaf.startswith("ln") or "_ln" in leaf:
            param.fill_(1.0)
        else:
            noise = torch.randn(param.shape, generator=generator, dtype=torch.float32,
                                device=param.device)
            param.copy_(noise * std)


class AudioEncoderBlock(VisionBlock):
    """One pre-LN encoder layer (``layer``, ``:202-211``): LayerNorm -> q (biased)
    / k (no bias) / v (biased) -> attention within a segment -> out_proj ->
    LayerNorm -> fc1 -> GELU -> fc2. ``VisionBlock`` gives it the attention
    without sequence parallelism and the remat policy."""

    LN = ("attn_ln_w", "attn_ln_b", "final_ln_w", "final_ln_b")
    K_BIAS = False
    GELU = "tanh"  # jax.nn.gelu's default

    def __init__(self, cfg, text: TransformerConfig, device):
        super().__init__(cfg, text)
        d, f = cfg.d_model, cfg.encoder_ffn_dim
        p = lambda *shape: _param(device, text.param_dtype, *shape)  # noqa: E731
        ln1w, ln1b, ln2w, ln2b = self.LN
        for name in (ln1w, ln1b, ln2w, ln2b):
            setattr(self, name, p(d))
        self.q_w, self.q_b = p(d, d), p(d)
        self.k_w = p(d, d)
        if self.K_BIAS:
            self.k_b = p(d)
        self.v_w, self.v_b = p(d, d), p(d)
        self.o_w, self.o_b = p(d, d), p(d)
        self.fc1_w, self.fc1_b = p(d, f), p(f)
        self.fc2_w, self.fc2_b = p(f, d), p(d)

    def _norm(self, x, which: int):
        w, b = self.LN[2 * (which - 1):2 * which]
        return audio_layer_norm(x, self.w(w), self.w(b))

    def _qkv(self, x, cos=None, sin=None):
        """x [..., N, D] -> q, k, v [B, N, H, hd] (B 1 for a packed [N, D])."""
        cfg = self.vcfg
        shape = (-1, x.shape[-2], cfg.encoder_attention_heads, cfg.head_dim)
        y = self._norm(x, 1)
        q = self._linear(y, "q_w", "q_b").reshape(shape)
        k = (y @ self.w("k_w").to(y.dtype)) if not self.K_BIAS else self._linear(y, "k_w", "k_b")
        v = self._linear(y, "v_w", "v_b").reshape(shape)
        return q, k.reshape(shape), v

    def _tail(self, x, attn):
        x = x + self._linear(attn.reshape(x.shape), "o_w", "o_b")
        return x + self._mlp(self._norm(x, 2))

    def _mlp(self, y):
        y = F.gelu(self._linear(y, "fc1_w", "fc1_b"), approximate=self.GELU)
        return self._linear(y, "fc2_w", "fc2_b")


class OmniAudioEncoder(MergedReads):
    """``conv1_w`` [d, mel, 3], ``conv2_w`` [d, d, 3] (torch's conv layout),
    their biases, ``layers``, ``ln_post_w``/``_b`` and ``proj_w`` [d, out]
    with its bias."""

    # the reference's [k, in, out] conv kernels -> [out, in, k]
    JAX_LAYOUT = {"conv1_w": (2, 1, 0), "conv2_w": (2, 1, 0)}

    def __init__(self, cfg: OmniAudioEncoderConfig, text: TransformerConfig, device):
        super().__init__()
        self.cfg, self.text = cfg, text
        d, mel = cfg.d_model, cfg.num_mel_bins
        p = lambda *shape: _param(device, text.param_dtype, *shape)  # noqa: E731
        self.conv1_w, self.conv1_b = p(d, mel, 3), p(d)
        self.conv2_w, self.conv2_b = p(d, d, 3), p(d)
        self.layers = nn.ModuleList(AudioEncoderBlock(cfg, text, device)
                                    for _ in range(cfg.encoder_layers))
        self.ln_post_w, self.ln_post_b = p(d), p(d)
        self.proj_w, self.proj_b = p(d, cfg.output_dim), p(cfg.output_dim)

    def forward(self, features):
        """features [N, max_frames, mels] -> [N, tokens_per_audio, output_dim]
        in the text's compute dtype."""
        cfg, dt = self.cfg, self.text.dtype
        n, t_mel, mel = features.shape
        w2 = 2 * cfg.n_window
        chunks = t_mel // w2
        x = features.to(dt).reshape(n * chunks, w2, mel).transpose(1, 2)  # [NC, mel, T]
        x = F.gelu(F.conv1d(x, self.w("conv1_w").to(dt), self.w("conv1_b").to(dt), padding=1),
                   approximate="tanh")
        x = F.gelu(F.conv1d(x, self.w("conv2_w").to(dt), self.w("conv2_b").to(dt), stride=2,
                            padding=1), approximate="tanh")
        x = x.transpose(1, 2)  # [NC, n_window, d]
        w_out = x.shape[1]
        pos = torch.from_numpy(_sinusoid_table(cfg.max_source_positions, cfg.d_model))
        x = x + pos[:w_out].to(device=x.device, dtype=dt)[None]
        x = x.reshape(n, chunks * w_out, cfg.d_model)
        seg = torch.arange(chunks, dtype=torch.int32, device=x.device).repeat_interleave(w_out)
        seg = seg[None].expand(n, chunks * w_out).contiguous()
        for layer in self.layers:
            x = layer(x, None, None, seg)
        x = x.reshape(n, (chunks * w_out) // 2, 2, cfg.d_model).mean(2)
        x = audio_layer_norm(x, self.w("ln_post_w"), self.w("ln_post_b"))
        return x @ self.w("proj_w").to(dt) + self.w("proj_b").to(dt)


def merge_audio_features(embeds, input_ids, feats, audio_mask, audio_token_id: int):
    """[N_audio, tokens_per_audio, H] scattered into the audio placeholder runs
    (``_merge_audio_features``, ``:241-249``)."""
    n, tpa, h = feats.shape
    return q25.merge_vision_features(embeds, input_ids, feats.reshape(n * tpa, h),
                                     audio_mask.reshape(-1).repeat_interleave(tpa),
                                     audio_token_id, audio_token_id)


class Qwen25OmniModel(q25.VisionLanguageModel):
    """``language_model``, ``vision_tower`` (a Qwen2.5-VL tower, when the
    config has one) and ``audio_tower`` (when it has an audio config);
    ``loss_fn`` is the reference's ``_omni_merged_hidden`` + ``head_loss``."""

    TOWER = q25.Qwen25VisionTower

    def __init__(self, cfg: Qwen25OmniConfig, generator: Optional[torch.Generator], *,
                 device: DeviceLike = None):
        nn.Module.__init__(self)
        dev = resolve_device(device)
        self.cfg = cfg
        self.language_model = Transformer(cfg.text, None, device=dev)
        if cfg.vision is not None:
            self.vision_tower = self.TOWER(cfg.vision, cfg.text, dev)
        if cfg.audio is not None:
            self.audio_tower = OmniAudioEncoder(cfg.audio, cfg.text, dev)
        if generator is not None:
            init_text_params(self.language_model, generator)
            if cfg.vision is not None:
                q25.init_vision_params(self.vision_tower, generator, cfg.vision.initializer_range)
            if cfg.audio is not None:
                init_audio_params(self.audio_tower, generator, cfg.audio.initializer_range)

    def merge_media(self, embeds, batch):
        cfg = self.cfg
        if cfg.audio is None or "audio_features" not in batch:
            return embeds
        with torch.set_grad_enabled(torch.is_grad_enabled() and not cfg.freeze_audio):
            feats = self.audio_tower(batch["audio_features"])
        mask = batch.get("audio_mask")
        if mask is None:
            mask = torch.ones(feats.shape[0], dtype=torch.bool, device=feats.device)
        return merge_audio_features(embeds, batch["input_ids"], feats, mask.bool(),
                                    cfg.audio_token_id)

    def has_vision(self, batch) -> bool:
        return self.cfg.vision is not None and "pixel_values" in batch

    def save_hf(self, out_dir: str, read=None) -> None:
        save_hf_checkpoint(self, out_dir, read=read)


# ---------------------------------------------------------------------------
# HF io
# ---------------------------------------------------------------------------

_AUDIO_LAYER_MAP = [
    ("attn_ln_w", "self_attn_layer_norm.weight", False),
    ("attn_ln_b", "self_attn_layer_norm.bias", False),
    ("q_w", "self_attn.q_proj.weight", True),
    ("q_b", "self_attn.q_proj.bias", False),
    ("k_w", "self_attn.k_proj.weight", True),
    ("v_w", "self_attn.v_proj.weight", True),
    ("v_b", "self_attn.v_proj.bias", False),
    ("o_w", "self_attn.out_proj.weight", True),
    ("o_b", "self_attn.out_proj.bias", False),
    ("final_ln_w", "final_layer_norm.weight", False),
    ("final_ln_b", "final_layer_norm.bias", False),
    ("fc1_w", "fc1.weight", True),
    ("fc1_b", "fc1.bias", False),
    ("fc2_w", "fc2.weight", True),
    ("fc2_b", "fc2.bias", False),
]
# (ours, HF name under audio_tower., transpose): conv kernels share torch's layout
_AUDIO_TOP_MAP = [
    ("conv1_w", "conv1.weight", False),
    ("conv1_b", "conv1.bias", False),
    ("conv2_w", "conv2.weight", False),
    ("conv2_b", "conv2.bias", False),
    ("ln_post_w", "ln_post.weight", False),
    ("ln_post_b", "ln_post.bias", False),
    ("proj_w", "proj.weight", True),
    ("proj_b", "proj.bias", False),
]
# the tower's blocks without the fused qkv, which the thinker stores split
_SPLIT_BLOCK_MAP = [e for e in q25._VIS_BLOCK_MAP if not e[1].startswith("attn.qkv.")]


def _text_key_map(k: str) -> Optional[str]:
    return None if k.split(".")[0] in ("visual", "audio_tower") else k


def load_audio_tower(lazy, tower: nn.Module, top_map, layer_map, prefix: str, what: str) -> None:
    """Fill an audio tower from the HF tensors under ``prefix`` (one tensor at
    a time): ``top_map`` / ``layer_map`` entries are (ours, HF suffix,
    transpose)."""

    def put(param, name, transpose):
        if name not in lazy:
            raise KeyError(f"HF checkpoint {what} has no tensor {name}")
        x = lazy.read(name)
        x = x.t() if transpose else x
        if tuple(x.shape) != tuple(param.shape):
            raise ValueError(f"{name}: checkpoint shape {tuple(x.shape)} (after the layout "
                             f"conversion), model {tuple(param.shape)}")
        param.copy_(x.to(param.device))

    for ours, suffix, transpose in top_map:
        put(tower.get_parameter(ours), f"{prefix}{suffix}", transpose)
    for i, layer in enumerate(tower.layers):
        for ours, suffix, transpose in layer_map:
            put(layer.get_parameter(ours), f"{prefix}layers.{i}.{suffix}", transpose)


def audio_sources(tower: nn.Module, top_map, layer_map, prefix: str, read=None):
    """The audio tower's HF tensor sources (``hf_io``'s (name, dtype, shape,
    producer))."""
    out = []

    def add(name, owner, pname, transpose):
        param = owner.get_parameter(pname)
        shape = tuple(reversed(param.shape)) if transpose else tuple(param.shape)

        def produce():
            x = (read(owner, pname) if read else param).detach()
            return (x.t() if transpose else x).contiguous().cpu()

        out.append((name, param.dtype, shape, produce))

    for ours, suffix, transpose in top_map:
        add(f"{prefix}{suffix}", tower, ours, transpose)
    for i, layer in enumerate(tower.layers):
        for ours, suffix, transpose in layer_map:
            add(f"{prefix}layers.{i}.{suffix}", layer, ours, transpose)
    return out


@torch.no_grad()
def load_hf_checkpoint(model_dir: Optional[str], model: Qwen25OmniModel,
                       tensors=None) -> Qwen25OmniModel:
    """Fill the thinker from an HF thinker checkpoint (``hf_to_params``,
    ``:325-432``): ``model.*`` / ``lm_head`` text keys, ``visual.*`` with the
    split q / k / v fused into ``qkv``, ``audio_tower.*``. A full-omni
    checkpoint (``thinker.`` prefix, talker and token2wav beside it) raises,
    as in the reference."""
    from veomni_tpu_torch.models import hf_io

    cfg = model.cfg
    lazy = hf_io.LazyHFTensors(None if tensors is not None else model_dir, tensors)
    if any(k.startswith("thinker.") for k in lazy.keys()):
        raise NotImplementedError("full-omni checkpoint (thinker.* prefix): extract the thinker "
                                  "subtree first (scripts/trim_checkpoint.py)")
    hf_io.hf_to_params(model_dir, cfg.text, model.language_model, tensors=tensors,
                       key_map=_text_key_map)
    what = model_dir or "(in memory)"
    if cfg.vision is not None:
        tower = model.vision_tower
        w = q25.patch_embed_from_hf(lazy.read("visual.patch_embed.proj.weight"),
                                    cfg.vision.width)
        tower.get_parameter(tower.PATCH_EMBED).copy_(w)
        for i, block in enumerate(tower.blocks):
            for ours, suffix, transpose in _SPLIT_BLOCK_MAP:
                x = lazy.read(f"visual.blocks.{i}.{suffix}")
                getattr(block, ours).copy_(x.t() if transpose else x)
            qkv = [lazy.read(f"visual.blocks.{i}.attn.{n}.weight") for n in "qkv"]
            block.qkv_w.copy_(torch.cat(qkv, 0).t())
            block.qkv_b.copy_(torch.cat([lazy.read(f"visual.blocks.{i}.attn.{n}.bias")
                                         for n in "qkv"]))
        for ours, (suffix, transpose) in q25._MERGER_MAP.items():
            x = lazy.read(f"visual.{suffix}")
            getattr(tower.merger, ours).copy_(x.t() if transpose else x)
    if cfg.audio is not None:
        load_audio_tower(lazy, model.audio_tower, _AUDIO_TOP_MAP, _AUDIO_LAYER_MAP,
                         "audio_tower.", what)
    return model


def hf_sources(model: Qwen25OmniModel, read=None):
    """Every HF tensor of the thinker, text at ``model.*``, the tower at
    ``visual.*`` with q / k / v split, the encoder at ``audio_tower.*``
    (``save_hf_checkpoint``, ``:435-490``)."""
    from veomni_tpu_torch.models import hf_io

    cfg = model.cfg
    out = list(hf_io.hf_sources(model.language_model, cfg.text, read))
    if cfg.vision is not None:
        for name, dtype, shape, produce in q25.hf_sources(model, q25._VIS_BLOCK_MAP,
                                                          q25._MERGER_MAP, read):
            if not name.startswith("model.visual."):
                continue
            name = name.replace("model.visual.", "visual.", 1)
            if ".attn.qkv." not in name:
                out.append((name, dtype, shape, produce))
                continue
            d = shape[0] // 3
            for j, n in enumerate("qkv"):
                part = (d,) + tuple(shape[1:])
                out.append((name.replace(".attn.qkv.", f".attn.{n}."), dtype, part,
                            lambda produce=produce, j=j: produce()[j * d:(j + 1) * d].clone()))
    if cfg.audio is not None:
        out += audio_sources(model.audio_tower, _AUDIO_TOP_MAP, _AUDIO_LAYER_MAP,
                             "audio_tower.", read)
    return sorted(out, key=lambda s: s[0])


def save_hf_checkpoint(model: Qwen25OmniModel, out_dir: str, read=None, **kw) -> None:
    from veomni_tpu_torch.models import hf_io

    hf_io.write_hf_checkpoint(hf_sources(model, read), hf_config(model.cfg), out_dir, **kw)


def hf_config(cfg: Qwen25OmniConfig) -> Dict[str, Any]:
    """The thinker's ``config.json`` (``:491-523``)."""
    hf: Dict[str, Any] = {
        "model_type": "qwen2_5_omni_thinker",
        "text_config": cfg.text.to_hf_config(),
        "image_token_index": cfg.image_token_id,
        "video_token_index": cfg.video_token_id,
        "audio_token_index": cfg.audio_token_id,
        "vision_start_token_id": cfg.vision_start_token_id,
        "audio_start_token_id": cfg.audio_start_token_id,
        "audio_end_token_id": cfg.audio_end_token_id,
        "position_id_per_seconds": cfg.position_id_per_seconds,
    }
    if cfg.vision is not None:
        v = cfg.vision
        hf["vision_config"] = {
            "depth": v.depth, "hidden_size": v.hidden_size,
            "intermediate_size": v.intermediate_size, "num_heads": v.num_heads,
            "in_channels": v.in_channels, "patch_size": v.patch_size,
            "temporal_patch_size": v.temporal_patch_size,
            "spatial_merge_size": v.spatial_merge_size, "window_size": v.window_size,
            "fullatt_block_indexes": list(v.fullatt_block_indexes),
            "out_hidden_size": v.out_hidden_size,
        }
    if cfg.audio is not None:
        a = cfg.audio
        hf["audio_config"] = {
            "num_mel_bins": a.num_mel_bins, "d_model": a.d_model,
            "encoder_layers": a.encoder_layers,
            "encoder_attention_heads": a.encoder_attention_heads,
            "encoder_ffn_dim": a.encoder_ffn_dim, "n_window": a.n_window,
            "max_source_positions": a.max_source_positions, "output_dim": a.output_dim,
        }
    return hf


_VISION_KEYS = ("depth", "hidden_size", "intermediate_size", "num_heads", "in_channels",
                "patch_size", "temporal_patch_size", "spatial_merge_size", "window_size",
                "fullatt_block_indexes", "out_hidden_size")
_AUDIO_KEYS = ("num_mel_bins", "d_model", "encoder_layers", "encoder_attention_heads",
               "encoder_ffn_dim", "n_window", "max_source_positions", "output_dim")


def config_from_hf(hf: Dict[str, Any], **overrides) -> Qwen25OmniConfig:
    """Build from an HF thinker config dict, or a full omni config with
    ``thinker_config`` (``:528-577``). ``audio_max_frames`` sets the static
    audio slot; the text's dtype / remat knobs go to the text config."""
    if "thinker_config" in hf:
        hf = hf["thinker_config"]
    tx = dict(hf.get("text_config", {}))
    text_over = dict(overrides.pop("text", {}) or {})
    for k in ("dtype", "param_dtype", "remat", "remat_policy", "chunk_mbs"):
        if k in overrides:
            text_over[k] = overrides.pop(k)
    overrides.pop("model_type", None)
    text = TransformerConfig.from_hf_config({**tx, "model_type": "qwen2"}, model_type="qwen2",
                                            **text_over)
    if tx.get("rope_scaling"):
        text.rope_scaling = dict(tx["rope_scaling"])
    vision = None
    if hf.get("vision_config"):
        v = hf["vision_config"]
        vision = q25.Qwen25VisionConfig(**{k: v[k] for k in _VISION_KEYS if k in v})
        vision.tokens_per_second = float(hf.get("position_id_per_seconds", 25))
    audio = None
    if hf.get("audio_config"):
        a = hf["audio_config"]
        frames = ({"max_frames": overrides.pop("audio_max_frames")}
                  if "audio_max_frames" in overrides else {})
        audio = OmniAudioEncoderConfig(**{k: a[k] for k in _AUDIO_KEYS if k in a}, **frames)
    return Qwen25OmniConfig(
        text=text, vision=vision, audio=audio,
        image_token_id=hf.get("image_token_index", 151655),
        video_token_id=hf.get("video_token_index", 151656),
        audio_token_id=hf.get("audio_token_index", 151646),
        vision_start_token_id=hf.get("vision_start_token_id", 151652),
        audio_start_token_id=hf.get("audio_start_token_id", 151647),
        audio_end_token_id=hf.get("audio_end_token_id", 151648),
        position_id_per_seconds=float(hf.get("position_id_per_seconds", 25)),
        **overrides,
    )


def parallel_plan(cfg):
    """The reference's plan (``:580-585``): no rules beyond the default
    FSDP one (its ``stacked_layer_prefixes`` are the port's one module a
    layer or block)."""
    from veomni_tpu_torch.parallel.parallel_plan import model_parallel_plan

    return model_parallel_plan(cfg)

"""Chat templates: messages -> token ids + labels (+ media payloads).

Port of ``veomni_tpu/data/chat_template.py``: ``MultimodalChatTemplate``
(``:65-134``) with its media expanders, ``qwen_vl_chat_template``
(``:137-265``; still images, resized down to a per-item patch budget),
``ChatmlTemplate`` (``:338``), ``Llama2Template`` (``:347-395``), the
registry and ``build_chat_template`` (``:388-430``); ``qwen3vl`` is the
qwen-vl template over a Qwen3-VL config (``:393``). Video expansion needs
``data/media.py::load_video`` and its decoders, and the omni and janus
templates their models: those are slice F of the port and raise
``NotImplementedError``.

Message format (HF-conversations style): ``{"role": ..., "content": str or
[{"type": "text", "text": ...}, ...]}``. Labels: only assistant-message
tokens are supervised (``IGNORE_INDEX`` elsewhere); the assistant's
closing tag is supervised so the model learns to stop.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

IGNORE_INDEX = -100

_SLICE_F = "slice F of the port (ROADMAP.md queue 1)"

# expander(item, **kwargs) -> (placeholder ids, payload merged into the sample)
MediaExpander = Callable[..., Tuple[List[int], Dict[str, Any]]]


@dataclass
class MultimodalChatTemplate:
    """The chatml message walk (``<|im_start|>role\\n ... <|im_end|>\\n``);
    a media content part goes through its type's expander, whose
    placeholder ids are never supervised and whose payload (patches, grid)
    is collected per key."""

    tokenizer: Any
    expanders: Dict[str, MediaExpander] = field(default_factory=dict)
    system_prompt: Optional[str] = None
    im_start: str = "<|im_start|>"
    im_end: str = "<|im_end|>"

    def _tok(self, text: str) -> List[int]:
        return self.tokenizer(text, add_special_tokens=False)["input_ids"]

    def _render_part(self, part, ids, labels, media, supervised, expander_kwargs=None):
        if isinstance(part, str):
            t = self._tok(part)
            ids += t
            labels += t if supervised else [IGNORE_INDEX] * len(t)
            return
        kind = part.get("type", "text")
        if kind == "text":
            self._render_part(part.get("text", ""), ids, labels, media, supervised,
                              expander_kwargs)
            return
        if kind not in self.expanders:
            raise ValueError(f"no expander for media type {kind!r}")
        item = part.get(kind, part.get("url", part.get("path")))
        placeholder_ids, payload = self.expanders[kind](item, **(expander_kwargs or {}))
        ids += placeholder_ids
        labels += [IGNORE_INDEX] * len(placeholder_ids)  # media are never supervised
        for key, value in payload.items():
            media.setdefault(key, []).append(value)

    def encode_messages(self, messages: Sequence[Dict[str, Any]],
                        **expander_kwargs) -> Dict[str, Any]:
        """``expander_kwargs`` (e.g. ``patch_budget=``) reach every media
        expander of this call."""
        ids: List[int] = []
        labels: List[int] = []
        media: Dict[str, List[Any]] = {}
        msgs = list(messages)
        if self.system_prompt and not (msgs and msgs[0].get("role") == "system"):
            msgs = [{"role": "system", "content": self.system_prompt}] + msgs
        for msg in msgs:
            role = msg["role"]
            supervised = role == "assistant"
            head = self._tok(f"{self.im_start}{role}\n")
            ids += head
            labels += [IGNORE_INDEX] * len(head)
            content = msg.get("content", "")
            parts = content if isinstance(content, list) else [content]
            for part in parts:
                self._render_part(part, ids, labels, media, supervised, expander_kwargs)
            tail = self._tok(f"{self.im_end}\n")
            ids += tail
            # the closing tag of assistant turns is supervised (stop signal)
            labels += tail if supervised else [IGNORE_INDEX] * len(tail)
        return {"input_ids": ids, "labels": labels, **media}


def qwen_vl_chat_template(tokenizer, vlm_config, *, video_kwargs: Optional[Dict[str, Any]] = None,
                          max_patches_per_sample: int = 0) -> MultimodalChatTemplate:
    """The Qwen2-VL / Qwen2.5-VL template: an image becomes ``vision_start``
    + its merged-token count of ``image_pad`` ids (+ ``vision_end`` where
    the config has one), the run the tower's output fills. A still image
    above the per-item patch budget (``max_patches_per_sample``, or a
    call's ``patch_budget=``) is first shrunk to fit: the grid comes from
    the resized array, so the placeholders stay consistent. Video parts
    raise (``data/media.py::load_video`` is slice F); the reference's
    stateful ``set_patch_budget`` is not here (its VLM-DPO transform passes
    the per-call ``patch_budget=``), its ``min_patch_block`` is.""" 
    from veomni_tpu_torch.data.multimodal import image_to_qwen_patches, load_image

    cfg = vlm_config
    vcfg = cfg.vision
    m = vcfg.spatial_merge_size
    vision_end = getattr(cfg, "vision_end_token_id", None)

    def _wrap(core_ids: List[int]) -> List[int]:
        return [cfg.vision_start_token_id] + core_ids + ([vision_end] if vision_end is not None
                                                         else [])

    def _norm_budget(n: int) -> int:
        """A nonzero budget floored at one merge block (m * m patches)."""
        return max(m * m, int(n)) if n else 0

    def _cap_resize(arr: np.ndarray, budget: int) -> np.ndarray:
        if not budget:
            return arr
        ps = vcfg.patch_size
        unit_px = ps * m
        h, w = arr.shape[:2]
        n_patches = (h // ps) * (w // ps)  # a still image is one temporal row
        if n_patches <= budget:
            return arr
        scale = (budget / max(n_patches, 1)) ** 0.5
        nh = max(unit_px, int(h * scale) // unit_px * unit_px)
        nw = max(unit_px, int(w * scale) // unit_px * unit_px)
        ys = np.linspace(0, h - 1, nh).astype(np.int64)
        xs = np.linspace(0, w - 1, nw).astype(np.int64)
        return arr[ys][:, xs]

    def expand_image(item, patch_budget=None) -> Tuple[List[int], Dict[str, Any]]:
        budget = max_patches_per_sample if patch_budget is None else _norm_budget(patch_budget)
        arr = (load_image(item, image_size=0) if isinstance(item, str)
               else np.asarray(item, np.float32))
        if arr.max() > 1.5:
            arr = arr / 255.0
        patches, grid = image_to_qwen_patches(_cap_resize(arr, budget), vcfg)
        t, gh, gw = grid
        return _wrap([cfg.image_token_id] * (t * (gh // m) * (gw // m))), {
            "vis_patches": patches, "vis_grids": grid}

    def expand_video(item, patch_budget=None):
        raise NotImplementedError(f"video content parts need data/media.py::load_video and its "
                                  f"decoders: {_SLICE_F}")

    template = MultimodalChatTemplate(tokenizer=tokenizer,
                                      expanders={"image": expand_image, "video": expand_video})
    # the smallest per-item budget, one merge block: the VLM-DPO transform
    # drops trailing media when its per-sample budget splits below it
    template.min_patch_block = m * m
    return template


def ChatmlTemplate(tokenizer) -> MultimodalChatTemplate:
    """Tokenizer-independent chatml rendering (the text-only
    MultimodalChatTemplate), for tokenizers without a jinja template."""
    return MultimodalChatTemplate(tokenizer=tokenizer)


@dataclass
class Llama2Template:
    """Llama-2 ``[INST]`` dialog rendering."""

    tokenizer: Any

    def _tok(self, text: str) -> List[int]:
        return self.tokenizer(text, add_special_tokens=False)["input_ids"]

    def encode_messages(self, messages: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
        ids: List[int] = []
        labels: List[int] = []
        system = ""
        for msg in messages:
            content = msg.get("content", "")
            if not isinstance(content, str):
                content = "".join(
                    p.get("text", "") if isinstance(p, dict) else str(p)
                    for p in content
                )
            role = msg["role"]
            if role == "system":
                system = f"<<SYS>>\n{content}\n<</SYS>>\n\n"
                continue
            if role == "user":
                t = self._tok(f"[INST] {system}{content} [/INST]")
                system = ""
                ids += t
                labels += [IGNORE_INDEX] * len(t)
            else:
                # the closing </s> is supervised so the model learns to stop
                eos = getattr(self.tokenizer, "eos_token", None) or "</s>"
                t = self._tok(f" {content} {eos}")
                ids += t
                labels += t
        return {"input_ids": ids, "labels": labels}


def _not_ported_template(name: str) -> Callable:
    def build(tok, cfg=None, **kw):
        raise NotImplementedError(f"chat template {name!r} expands the media of a model the port "
                                  f"does not have yet: {_SLICE_F}")

    return build


# the reference's name -> builder map; builders take (tokenizer, config)
CHAT_TEMPLATE_REGISTRY: Dict[str, Callable] = {
    "qwen2vl": lambda tok, cfg, **kw: qwen_vl_chat_template(tok, cfg, **kw),
    "qwen2_5vl": lambda tok, cfg, **kw: qwen_vl_chat_template(tok, cfg, **kw),
    "qwen25_vl": lambda tok, cfg, **kw: qwen_vl_chat_template(tok, cfg, **kw),
    "qwen3vl": lambda tok, cfg, **kw: qwen_vl_chat_template(tok, cfg, **kw),
    **{name: _not_ported_template(name) for name in ("qwen2_5omni", "qwen3omni", "janus")},
    "chatml": lambda tok, cfg=None, **kw: ChatmlTemplate(tok),
    "llama2": lambda tok, cfg=None, **kw: Llama2Template(tok),
}
# the templates that expand media, and so need the model config
_MEDIA_TEMPLATE_NAMES = frozenset(n for n in CHAT_TEMPLATE_REGISTRY
                                  if n not in ("chatml", "llama2"))

# model_type -> template name (so data.chat_template: default resolves)
_MODEL_TYPE_TEMPLATES = {
    "qwen2_vl": "qwen2vl",
    "qwen2_5_vl": "qwen2_5vl",
    "qwen3_vl": "qwen3vl",
    "qwen3_vl_moe": "qwen3vl",
    "qwen2_5_omni": "qwen2_5omni",
    "qwen3_omni_moe": "qwen3omni",
    "janus": "janus",
}


def build_chat_template(name: str, tokenizer, config=None, **kw):
    """Resolve a template by explicit name, or by the config's model_type
    when ``name`` is empty/"default"."""
    if (not name or name == "default") and config is not None:
        name = _MODEL_TYPE_TEMPLATES.get(getattr(config, "model_type", ""), name)
    if name in _MEDIA_TEMPLATE_NAMES and config is None:
        raise ValueError(f"chat template {name!r} expands media and needs the model config (use "
                         "it through the VLM data pipeline, or pick a text template: chatml / "
                         "llama2)")
    if name in CHAT_TEMPLATE_REGISTRY:
        return CHAT_TEMPLATE_REGISTRY[name](tokenizer, config, **kw)
    raise ValueError(
        f"unknown chat template {name!r}; known: {sorted(CHAT_TEMPLATE_REGISTRY)}"
    )

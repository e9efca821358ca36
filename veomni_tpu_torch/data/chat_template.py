"""Chat templates: messages -> token ids + labels, text part.

Port of the text part of ``veomni_tpu/data/chat_template.py``: the
message walk of ``MultimodalChatTemplate`` (``:61``) without media
expanders, ``ChatmlTemplate`` (``:338``), ``Llama2Template``
(``:347-395``), the registry and ``build_chat_template`` (``:419``). The
media templates (qwen2vl / qwen2_5vl / qwen3vl / qwen2_5omni / qwen3omni /
janus) expand images, videos and audio and need ``data/{media,multimodal}
.py``: they are slice F of the port and raise ``NotImplementedError``, as
does a media content part in a text template.

Message format (HF-conversations style): ``{"role": ..., "content": str or
[{"type": "text", "text": ...}, ...]}``. Labels: only assistant-message
tokens are supervised (``IGNORE_INDEX`` elsewhere); the assistant's
closing tag is supervised so the model learns to stop.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence

IGNORE_INDEX = -100

_SLICE_F = "slice F of the port (data/{media,multimodal}.py)"


@dataclass
class MultimodalChatTemplate:
    """The chatml message walk (``<|im_start|>role\\n ... <|im_end|>\\n``)
    of the reference's template class, for text content."""

    tokenizer: Any
    system_prompt: Optional[str] = None
    im_start: str = "<|im_start|>"
    im_end: str = "<|im_end|>"

    def _tok(self, text: str) -> List[int]:
        return self.tokenizer(text, add_special_tokens=False)["input_ids"]

    def _render_part(self, part, ids, labels, supervised):
        if isinstance(part, str):
            t = self._tok(part)
            ids += t
            labels += t if supervised else [IGNORE_INDEX] * len(t)
            return
        kind = part.get("type", "text")
        if kind != "text":
            raise NotImplementedError(f"media content part {kind!r}: {_SLICE_F}")
        self._render_part(part.get("text", ""), ids, labels, supervised)

    def encode_messages(self, messages: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
        ids: List[int] = []
        labels: List[int] = []
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
                self._render_part(part, ids, labels, supervised)
            tail = self._tok(f"{self.im_end}\n")
            ids += tail
            # the closing tag of assistant turns is supervised (stop signal)
            labels += tail if supervised else [IGNORE_INDEX] * len(tail)
        return {"input_ids": ids, "labels": labels}


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


def _media_template(name: str) -> Callable:
    def build(tok, cfg=None, **kw):
        raise NotImplementedError(f"chat template {name!r} expands media: {_SLICE_F}")

    return build


# the reference's name -> builder map; builders take (tokenizer, config)
_MEDIA_TEMPLATE_NAMES = frozenset(
    ("qwen2vl", "qwen2_5vl", "qwen25_vl", "qwen3vl", "qwen2_5omni", "qwen3omni", "janus"))
CHAT_TEMPLATE_REGISTRY: Dict[str, Callable] = {
    **{name: _media_template(name) for name in sorted(_MEDIA_TEMPLATE_NAMES)},
    "chatml": lambda tok, cfg=None, **kw: ChatmlTemplate(tok),
    "llama2": lambda tok, cfg=None, **kw: Llama2Template(tok),
}

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
    if name in CHAT_TEMPLATE_REGISTRY:
        return CHAT_TEMPLATE_REGISTRY[name](tokenizer, config, **kw)
    raise ValueError(
        f"unknown chat template {name!r}; known: {sorted(CHAT_TEMPLATE_REGISTRY)}"
    )

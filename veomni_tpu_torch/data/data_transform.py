"""Data transforms: raw rows -> tokenized samples {input_ids, labels}.

Reference: ``veomni/data/data_transform.py:33-399`` (DATA_TRANSFORM_REGISTRY:
plaintext/conversation/dpo/classification + per-VLM transforms).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

from veomni_tpu_torch.utils.registry import Registry

DATA_TRANSFORM_REGISTRY = Registry("data_transforms")

IGNORE_INDEX = -100


@DATA_TRANSFORM_REGISTRY.register("pretokenized")
def build_pretokenized_transform(tokenizer=None, channel_list=None, **_) -> Callable:
    channel_index = {name: i for i, name in enumerate(channel_list or [])}

    def transform(row: Dict[str, Any]) -> Dict[str, Any]:
        ids = list(row["input_ids"])
        out = {"input_ids": ids, "labels": list(row.get("labels", ids))}
        if "channel" in row:
            ch = row["channel"]
            out["channel"] = channel_index.get(ch, ch if isinstance(ch, int) else -1)
        return out

    return transform


@DATA_TRANSFORM_REGISTRY.register("plaintext")
def build_plaintext_transform(tokenizer, text_keys: str = "text", max_seq_len: int = 0, **_):
    def transform(row: Dict[str, Any]) -> Dict[str, Any]:
        text = row[text_keys] if isinstance(text_keys, str) else "".join(row[k] for k in text_keys)
        ids = tokenizer(text, add_special_tokens=True)["input_ids"]
        if max_seq_len:
            ids = ids[:max_seq_len]
        return {"input_ids": ids, "labels": list(ids)}

    return transform


@DATA_TRANSFORM_REGISTRY.register("conversation")
def build_conversation_transform(tokenizer, max_seq_len: int = 0,
                                 messages_key: str = "messages",
                                 chat_template: str = "default", **_):
    """SFT chat transform: loss only on assistant turns (prompt masked).

    ``chat_template`` other than "default" renders through the named
    registry template (chatml/llama2/... — reference chat_template.py)
    instead of the tokenizer's own jinja template."""
    if chat_template and chat_template != "default":
        from veomni_tpu_torch.data.chat_template import build_chat_template

        tmpl = build_chat_template(chat_template, tokenizer)

        def transform(row: Dict[str, Any]) -> Dict[str, Any]:
            enc = tmpl.encode_messages(row[messages_key])
            ids, labels = enc["input_ids"], enc["labels"]
            if max_seq_len:
                ids, labels = ids[:max_seq_len], labels[:max_seq_len]
            return {"input_ids": ids, "labels": labels}

        return transform

    def transform(row: Dict[str, Any]) -> Dict[str, Any]:
        messages = row[messages_key]
        input_ids: List[int] = []
        labels: List[int] = []
        for i, msg in enumerate(messages):
            rendered = tokenizer.apply_chat_template(
                messages[: i + 1], tokenize=True,
                add_generation_prompt=False,
            )
            new = rendered[len(input_ids):]
            if msg.get("role") == "assistant":
                labels.extend(new)
            else:
                labels.extend([IGNORE_INDEX] * len(new))
            input_ids.extend(new)
        if max_seq_len:
            input_ids = input_ids[:max_seq_len]
            labels = labels[:max_seq_len]
        return {"input_ids": input_ids, "labels": labels}

    return transform


# transforms registered outside this module, keyed by the module that owns
# them. The lookup owner (this function) imports the registering module on
# demand so callers never depend on import order (a fresh process calling
# build_data_transform("qwen3_omni") must not KeyError just because nothing
# imported omni_data yet).
_LAZY_TRANSFORM_MODULES = {
    "qwen3_omni": "veomni_tpu_torch.data.omni_data",
    "vlm": "veomni_tpu_torch.data.multimodal",
    "qwen2_5_vl": "veomni_tpu_torch.data.multimodal",
    "qwen3_vl": "veomni_tpu_torch.data.multimodal",
    "qwen2_vl": "veomni_tpu_torch.data.multimodal",
    "qwen2_5_vl_conversation": "veomni_tpu_torch.data.multimodal",
    "rl": "veomni_tpu_torch.trainer.rl_trainer",
    "dpo": "veomni_tpu_torch.trainer.dpo_trainer",
    "vlm_dpo": "veomni_tpu_torch.trainer.dpo_trainer",
    "distill": "veomni_tpu_torch.trainer.distill_trainer",
}


def build_data_transform(data_type: str, tokenizer=None, **kwargs) -> Callable:
    if data_type not in DATA_TRANSFORM_REGISTRY and data_type in _LAZY_TRANSFORM_MODULES:
        import importlib

        importlib.import_module(_LAZY_TRANSFORM_MODULES[data_type])
    return DATA_TRANSFORM_REGISTRY.get(data_type)(tokenizer=tokenizer, **kwargs)

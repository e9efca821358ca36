"""A tokenizer read from a local HF tokenizer directory.

The reference's ``build_tokenizer`` (``veomni_tpu/models/auto.py:533-551``)
is ``transformers.AutoTokenizer``. The port wraps the engine under
transformers' fast tokenizers, ``tokenizers.Tokenizer``, read from the
directory's ``tokenizer.json``, in the surface the data transforms call:
``tok(text, add_special_tokens=...)["input_ids"]``, :meth:`encode`,
:meth:`decode`, the special-token strings from ``tokenizer_config.json``
and :meth:`apply_chat_template`, which renders the jinja ``chat_template``
(from ``tokenizer_config.json`` or a ``chat_template.jinja`` beside it) in
the environment transformers renders it in. The ids and text are
``transformers.PreTrainedTokenizerFast``'s for the same directory.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Iterable, List, Optional, Sequence


def _render_chat(template: str, messages, add_generation_prompt: bool, **variables) -> str:
    """Render a chat template in the environment transformers uses: a
    sandbox with trim_blocks and lstrip_blocks, loop controls, the
    ``{% generation %}`` tag, ``raise_exception``, ``strftime_now`` and a
    ``tojson`` that keeps non-ASCII characters."""
    try:
        import jinja2
        from jinja2 import nodes
        from jinja2.ext import Extension, loopcontrols
        from jinja2.sandbox import ImmutableSandboxedEnvironment
    except ImportError as e:
        raise ImportError(
            "the tokenizer's jinja chat template needs jinja2; without it, pick a named "
            "template (data.chat_template: chatml or llama2)") from e
    from datetime import datetime

    class Generation(Extension):
        tags = {"generation"}

        def parse(self, parser):
            lineno = next(parser.stream).lineno
            body = parser.parse_statements(("name:endgeneration",), drop_needle=True)
            return nodes.CallBlock(self.call_method("_pass", []), [], [], body).set_lineno(lineno)

        def _pass(self, caller):
            return caller()

    def raise_exception(message):
        raise jinja2.exceptions.TemplateError(message)

    def tojson(x, ensure_ascii=False, indent=None, separators=None, sort_keys=False):
        return json.dumps(x, ensure_ascii=ensure_ascii, indent=indent, separators=separators,
                          sort_keys=sort_keys)

    env = ImmutableSandboxedEnvironment(trim_blocks=True, lstrip_blocks=True,
                                        extensions=[Generation, loopcontrols])
    env.filters["tojson"] = tojson
    env.globals["raise_exception"] = raise_exception
    env.globals["strftime_now"] = lambda fmt: datetime.now().strftime(fmt)
    return env.from_string(template).render(messages=messages, tools=None, documents=None,
                                            add_generation_prompt=add_generation_prompt,
                                            **variables)


def _token_content(value) -> Optional[str]:
    if isinstance(value, dict):
        return value.get("content")
    return value


def _clean_up_tokenization(text: str) -> str:
    """transformers' ``clean_up_tokenization``."""
    for a, b in ((" .", "."), (" ?", "?"), (" !", "!"), (" ,", ","), (" ' ", "'"),
                 (" n't", "n't"), (" 'm", "'m"), (" 's", "'s"), (" 've", "'ve"), (" 're", "'re")):
        text = text.replace(a, b)
    return text


class Tokenizer:
    """A ``tokenizers.Tokenizer`` with the special tokens, clean-up setting
    and chat template of its ``tokenizer_config.json``."""

    def __init__(self, backend, config: Optional[Dict[str, Any]] = None,
                 chat_template: Optional[str] = None):
        config = config or {}
        # transformers turns off a tokenizer.json's truncation and padding
        # unless a call asks for them
        backend.no_truncation()
        backend.no_padding()
        self.backend = backend
        for name in ("bos_token", "eos_token", "unk_token", "pad_token"):
            setattr(self, name, _token_content(config.get(name)))
        self.clean_up_tokenization_spaces = bool(config.get("clean_up_tokenization_spaces", False))
        template = chat_template if chat_template is not None else config.get("chat_template")
        if isinstance(template, list):
            template = {t["name"]: t["template"] for t in template}.get("default")
        self.chat_template: Optional[str] = template

    @classmethod
    def from_pretrained(cls, path: str) -> "Tokenizer":
        """Read ``tokenizer.json``, ``tokenizer_config.json`` and
        ``chat_template.jinja`` (the last two optional) from ``path``."""
        from tokenizers import Tokenizer as Backend

        backend = Backend.from_file(os.path.join(path, "tokenizer.json"))
        config: Dict[str, Any] = {}
        cfg_path = os.path.join(path, "tokenizer_config.json")
        if os.path.exists(cfg_path):
            with open(cfg_path, encoding="utf-8") as f:
                config = json.load(f)
        template = None
        jinja_path = os.path.join(path, "chat_template.jinja")
        if os.path.exists(jinja_path):
            with open(jinja_path, encoding="utf-8") as f:
                template = f.read()
        return cls(backend, config, template)

    def encode(self, text: str, add_special_tokens: bool = True) -> List[int]:
        return self.backend.encode(text, add_special_tokens=add_special_tokens).ids

    def __call__(self, text: str, add_special_tokens: bool = True) -> Dict[str, List[int]]:
        ids = self.encode(text, add_special_tokens=add_special_tokens)
        return {"input_ids": ids, "attention_mask": [1] * len(ids)}

    def decode(self, ids: Iterable[int], skip_special_tokens: bool = False) -> str:
        text = self.backend.decode([int(i) for i in ids], skip_special_tokens=skip_special_tokens)
        return _clean_up_tokenization(text) if self.clean_up_tokenization_spaces else text

    @property
    def eos_token_id(self) -> Optional[int]:
        """The id of ``eos_token`` (None without one), as transformers'."""
        return None if self.eos_token is None else self.backend.token_to_id(self.eos_token)

    def __len__(self) -> int:
        return self.backend.get_vocab_size(with_added_tokens=True)

    def apply_chat_template(self, messages: Sequence[Dict[str, Any]], tokenize: bool = True,
                            add_generation_prompt: bool = False,
                            chat_template: Optional[str] = None, **kwargs):
        """Render ``messages`` with the tokenizer's jinja chat template (as
        ``transformers``' ``apply_chat_template`` does: the special-token
        strings and ``kwargs`` are template variables), then, with
        ``tokenize``, encode the text without adding special tokens."""
        template = chat_template or self.chat_template
        if template is None:
            raise ValueError("the tokenizer has no chat_template; pick a named template "
                             "(data.chat_template: chatml or llama2)")
        variables = {k: getattr(self, k) for k in ("bos_token", "eos_token", "unk_token",
                                                   "pad_token") if getattr(self, k) is not None}
        text = _render_chat(template, list(messages), add_generation_prompt,
                            **{**variables, **kwargs})
        return self.encode(text, add_special_tokens=False) if tokenize else text

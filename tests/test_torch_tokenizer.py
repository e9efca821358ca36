"""The port's tokenizer (``veomni_tpu_torch/data/tokenizer.py``, the
``tokenizers`` library's reader behind the transforms' surface) against
``transformers.PreTrainedTokenizerFast``, on the CPU, with no download.

* Both kinds of BPE of ``tests/fixtures/tokenizers/make_fixtures.py``,
  trained here from text in the repository (``docs/resilience.md`` and
  ``docs/MIGRATION.md``, vocab 1024): byte-level with Qwen2's Split
  pre-tokenizer, and ``▁``-marked BPE with byte fallback in
  Llama-2/TinyLlama's form. On held-out repo text (``docs/serving.md``,
  whole and by paragraph) and on strings with characters the training text
  never had (accents, CJK, emoji, control and separator characters, added
  tokens inside words), the port's ids with and without special tokens
  equal transformers' exactly; its decode, with and without the special
  tokens and with ``clean_up_tokenization_spaces`` on and off, equals
  transformers' and round-trips every text that does not start with
  whitespace or hold added-token text.
* ``apply_chat_template`` (text and ids) equals transformers' on a template
  string written here, with a system turn, ``loop`` variables,
  ``raise_exception`` and ``add_generation_prompt``.
* The two committed fixture directories, read by ``build_tokenizer`` and by
  ``transformers.PreTrainedTokenizerFast``: the same length and special
  tokens, equal ids on held-out text and equal rendered chat templates; a
  ``chat_template.jinja`` beside them takes the place of the config's; a
  hub id or a directory without ``tokenizer.json`` raises.
"""

import os
import shutil
import sys

import pytest

from veomni_tpu_torch.data.tokenizer import Tokenizer
from veomni_tpu_torch.models.auto import build_tokenizer
from test_torch_threads import one_torch_thread  # noqa: F401  (one torch thread a worker)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures", "tokenizers")
sys.path.insert(0, FIXTURES)

from make_fixtures import KINDS, repo_text, tokenizer_config, train  # noqa: E402

with open(os.path.join(REPO, "docs", "serving.md"), encoding="utf-8") as _f:
    HELD_OUT = _f.read()[:24000]
UNSEEN = [
    "Héllo wörld! ½ café — naïve 東京 🤖 emoji",
    "  leading spaces\n\n\ttabs and trailing  ",
    "<s>hi</s> <|im_start|>user\nx<|im_end|>",
    "It's we'll THEY'RE 12345 ¹²³ ٣٤ , end .",
    "\x1c\x1dseparators nbsp line",
    "a<s>b </s> c<|endoftext|>d",
    "",
]


def _texts():
    return [HELD_OUT] + UNSEEN + [p for p in HELD_OUT.split("\n\n") if p][:40]


@pytest.fixture(scope="module")
def trained():
    """kind -> (transformers tokenizer, port tokenizer) on the same BPE."""
    from transformers import PreTrainedTokenizerFast

    out = {}
    for kind in KINDS:
        tok = train(kind, repo_text(("docs/resilience.md", "docs/MIGRATION.md")), 1024)
        cfg = tokenizer_config(kind)
        specials = {k: cfg[k] for k in ("bos_token", "eos_token", "unk_token", "pad_token")}
        hf = PreTrainedTokenizerFast(tokenizer_object=tok, chat_template=cfg["chat_template"],
                                     **specials)
        out[kind] = hf, Tokenizer(tok, cfg)
    return out


@pytest.mark.parametrize("kind", KINDS)
def test_ids_and_decode_match_transformers(trained, kind):
    hf, port = trained[kind]
    for text in _texts():
        for special in (False, True):
            want = hf(text, add_special_tokens=special)["input_ids"]
            assert port(text, add_special_tokens=special)["input_ids"] == want, (kind, text[:60])
        ids = port.encode(text, add_special_tokens=True)
        for clean in (False, True):
            hf.clean_up_tokenization_spaces = port.clean_up_tokenization_spaces = clean
            for skip in (False, True):
                assert port.decode(ids, skip_special_tokens=skip) == hf.decode(
                    ids, skip_special_tokens=skip), (kind, clean, skip, text[:60])
        port.clean_up_tokenization_spaces = False
        if "<" not in text and not text[:1].isspace():  # no added-token text in it
            assert port.decode(port.encode(text, add_special_tokens=False)) == text


TEMPLATE = (
    "{% if messages[0]['role'] == 'system' %}{% set system = messages[0]['content'] %}"
    "{% set loop_messages = messages[1:] %}{% else %}{% set system = 'You are helpful.' %}"
    "{% set loop_messages = messages %}{% endif %}"
    "{{ bos_token or '' }}{{ '<|im_start|>system\\n' + system + '<|im_end|>\\n' }}"
    "{% for message in loop_messages %}"
    "{% if (message['role'] == 'user') != (loop.index0 % 2 == 0) %}"
    "{{ raise_exception('roles must alternate user/assistant') }}{% endif %}"
    "{{ '<|im_start|>' + message['role'] + '\\n' + message['content'] | trim + '<|im_end|>\\n' }}"
    "{% endfor %}{% if add_generation_prompt %}{{ '<|im_start|>assistant\\n' }}{% endif %}")
MESSAGES = [
    {"role": "system", "content": "Answer in one line."},
    {"role": "user", "content": "What does the prefix cache keep?  "},
    {"role": "assistant", "content": "Blocks of a shared prompt — ½ of them, café."},
    {"role": "user", "content": "And the scheduler?"},
]


@pytest.mark.parametrize("kind", KINDS)
def test_chat_template_matches_transformers(trained, kind):
    hf, port = trained[kind]
    for msgs in (MESSAGES, MESSAGES[1:3]):
        for gen in (False, True):
            kw = dict(chat_template=TEMPLATE, add_generation_prompt=gen)
            assert (port.apply_chat_template(msgs, tokenize=False, **kw)
                    == hf.apply_chat_template(msgs, tokenize=False, **kw))
            assert (port.apply_chat_template(msgs, tokenize=True, **kw)
                    == hf.apply_chat_template(msgs, tokenize=True, **kw))
    with pytest.raises(Exception, match="alternate"):
        port.apply_chat_template(MESSAGES[1:2] * 2, chat_template=TEMPLATE)


@pytest.mark.parametrize("kind", KINDS)
def test_fixture_directories_match_transformers(kind):
    from transformers import PreTrainedTokenizerFast

    path = os.path.join(FIXTURES, kind)
    hf, port = PreTrainedTokenizerFast.from_pretrained(path), build_tokenizer(path)
    assert len(port) == len(hf) <= 4096
    assert os.path.getsize(os.path.join(path, "tokenizer.json")) < 300_000
    for name in ("bos_token", "eos_token", "unk_token", "pad_token"):
        assert getattr(port, name) == getattr(hf, name), name
    for text in [HELD_OUT] + UNSEEN:
        for special in (False, True):
            assert port(text, add_special_tokens=special)["input_ids"] == hf(
                text, add_special_tokens=special)["input_ids"]
    for gen in (False, True):
        assert port.apply_chat_template(MESSAGES, add_generation_prompt=gen) == \
            hf.apply_chat_template(MESSAGES, add_generation_prompt=gen)


def test_directory_reading(tmp_path):
    """A ``chat_template.jinja`` beside the files is the template, as in
    transformers; a hub id and a directory without ``tokenizer.json``
    raise (the port downloads nothing)."""
    for name in ("tokenizer.json", "tokenizer_config.json"):
        shutil.copy(os.path.join(FIXTURES, "bytelevel", name), tmp_path / name)
    (tmp_path / "chat_template.jinja").write_text(TEMPLATE)
    assert build_tokenizer(str(tmp_path)).chat_template == TEMPLATE
    with pytest.raises(FileNotFoundError, match="downloads nothing"):
        build_tokenizer("Qwen/Qwen3-0.6B")
    (tmp_path / "tokenizer.json").unlink()
    with pytest.raises(FileNotFoundError, match="no tokenizer.json"):
        build_tokenizer(str(tmp_path))

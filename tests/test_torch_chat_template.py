"""The port's chat templates and ``conversation`` transform against the JAX
package's, on the CPU.

* The reference's ``tests/test_chat_templates.py`` text-template assertions
  replayed with its ``FakeTok``: the registry holds the reference's names,
  ``chatml`` and ``llama2`` supervise the assistant turns only, an unknown
  name raises; the port's ``encode_messages`` equals the JAX one's. The
  media templates, and a media part in a text template, raise naming
  slice F.
* The ``conversation`` transform, both branches (a named template, and
  ``default``, which re-renders each message prefix through the tokenizer's
  jinja template and slices it at the ids so far), on rows built from repo
  text: the port's transform with the port's tokenizer gives the
  ``input_ids`` and ``labels`` of the JAX transform with
  ``transformers.PreTrainedTokenizerFast`` on the same fixture directory, with and
  without ``max_seq_len``. The ``bytefallback`` fixture's template
  (TinyLlama-Chat's) ends every turn in ``</s>`` and a newline, so a BPE
  merge across a turn boundary would shift the slice: the port mirrors the
  reference there rather than re-aligning.
"""

import os

import pytest

from veomni_tpu.data.chat_template import build_chat_template as j_build_chat_template
from veomni_tpu.data.data_transform import build_data_transform as j_build_data_transform
from veomni_tpu_torch.data.chat_template import CHAT_TEMPLATE_REGISTRY, build_chat_template
from veomni_tpu_torch.data.data_transform import IGNORE_INDEX, build_data_transform
from veomni_tpu_torch.models.auto import build_tokenizer

from test_chat_templates import MESSAGES as REF_MESSAGES
from test_chat_templates import FakeTok

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures", "tokenizers")


def test_registry_covers_reference_names():
    for name in ("qwen2vl", "qwen2_5vl", "qwen3vl", "qwen2_5omni", "janus", "chatml", "llama2"):
        assert name in CHAT_TEMPLATE_REGISTRY, name
    with pytest.raises(ValueError, match="unknown chat template"):
        build_chat_template("nope", FakeTok())
    for name in ("qwen2vl", "janus", "qwen2_5omni"):
        with pytest.raises(NotImplementedError, match="slice F"):
            build_chat_template(name, FakeTok(), object())
    with pytest.raises(NotImplementedError, match="slice F"):
        build_chat_template("chatml", FakeTok()).encode_messages(
            [{"role": "user", "content": [{"type": "image", "image": "x.png"}]}])


@pytest.mark.parametrize("name", ["chatml", "llama2"])
def test_text_templates_supervise_assistant_only(name):
    enc = build_chat_template(name, FakeTok()).encode_messages(REF_MESSAGES)
    ids, labels = enc["input_ids"], enc["labels"]
    assert len(ids) == len(labels)
    sup = [lab for lab in labels if lab != IGNORE_INDEX]
    assert 0 < len(sup) < len(ids)
    assert all(lab == i for lab, i in zip(labels, ids) if lab != IGNORE_INDEX)
    ref = j_build_chat_template(name, FakeTok()).encode_messages(REF_MESSAGES)
    assert enc == {"input_ids": ref["input_ids"], "labels": ref["labels"]}


def _rows():
    """Conversations from docs/performance.md's paragraphs: a system turn on
    every other row, then user/assistant pairs, one with list content."""
    with open(os.path.join(REPO, "docs", "performance.md"), encoding="utf-8") as f:
        paras = [p.strip() for p in f.read().split("\n\n") if p.strip()]
    rows = []
    for r in range(6):
        chunk = paras[4 * r:4 * r + 4]
        msgs = ([{"role": "system", "content": "Answer from the performance guide."}]
                if r % 2 else [])
        for i, text in enumerate(chunk):
            msgs.append({"role": "user" if i % 2 == 0 else "assistant", "content": text})
        rows.append({"messages": msgs})
    rows[0]["messages"][0]["content"] = [{"type": "text", "text": paras[0]}]
    return rows


@pytest.fixture(scope="module")
def tokenizers():
    from transformers import PreTrainedTokenizerFast

    return {kind: (PreTrainedTokenizerFast.from_pretrained(os.path.join(FIXTURES, kind)),
                   build_tokenizer(os.path.join(FIXTURES, kind)))
            for kind in ("bytelevel", "bytefallback")}


@pytest.mark.parametrize("kind,template", [
    ("bytelevel", "chatml"), ("bytefallback", "llama2"),
    ("bytelevel", "default"), ("bytefallback", "default"),
], ids=["bytelevel-chatml", "bytefallback-llama2", "bytelevel-default", "bytefallback-default"])
def test_conversation_transform_matches_jax(tokenizers, kind, template):
    hf, port = tokenizers[kind]
    rows = _rows()
    if template == "default":  # the jinja templates take string content
        rows[0]["messages"][0]["content"] = rows[0]["messages"][0]["content"][0]["text"]
    for max_seq_len in (0, 96):
        got = build_data_transform("conversation", tokenizer=port, max_seq_len=max_seq_len,
                                   chat_template=template)
        want = j_build_data_transform("conversation", tokenizer=hf, max_seq_len=max_seq_len,
                                      chat_template=template)
        for row in rows:
            g, w = got(row), want(row)
            assert g["input_ids"] == list(w["input_ids"])
            assert g["labels"] == list(w["labels"])
            assert IGNORE_INDEX in g["labels"]
            if not max_seq_len:
                assert any(lab != IGNORE_INDEX for lab in g["labels"])

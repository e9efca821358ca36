"""Train the small HF tokenizers the port's tests and ``chip_smoke.py`` use.

Two kinds, trained with the ``tokenizers`` library from text in this
repository (no download):

* ``bytelevel``: byte-level BPE with Qwen2/Qwen3's ``Split`` pre-tokenizer,
  NFC, the ChatML special tokens and a ChatML jinja chat template;
* ``bytefallback``: BPE over ``▁``-marked text with byte fallback and
  Llama-2/TinyLlama's ``Prepend``/``Replace`` normalizers, ``<s>`` added by
  a TemplateProcessing post-processor and TinyLlama-Chat's jinja template.

The tests also train both kinds at a smaller vocabulary. Write the two
fixture directories (vocab 4096 each)::

    python tests/fixtures/tokenizers/make_fixtures.py
"""

import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(os.path.dirname(HERE)))

QWEN2_PATTERN = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}| ?[^\s\p{L}\p{N}]+"
                 r"[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")
CHATML_TEMPLATE = (
    "{% for message in messages %}{{ '<|im_start|>' + message['role'] + '\\n' + "
    "message['content'] + '<|im_end|>' + '\\n' }}{% endfor %}{% if add_generation_prompt %}"
    "{{ '<|im_start|>assistant\\n' }}{% endif %}")
# TinyLlama-1.1B-Chat-v1.0's template
ZEPHYR_TEMPLATE = (
    "{% for message in messages %}\n{% if message['role'] == 'user' %}\n"
    "{{ '<|user|>\\n' + message['content'] + eos_token }}\n"
    "{% elif message['role'] == 'system' %}\n{{ '<|system|>\\n' + message['content'] + eos_token }}\n"
    "{% elif message['role'] == 'assistant' %}\n"
    "{{ '<|assistant|>\\n'  + message['content'] + eos_token }}\n{% endif %}\n"
    "{% if loop.last and add_generation_prompt %}\n{{ '<|assistant|>' }}\n{% endif %}\n"
    "{% endfor %}")
TRAIN_FILES = ("SURVEY.md", "docs/resilience.md", "docs/observability.md", "docs/performance.md")

KINDS = ("bytelevel", "bytefallback")


def repo_text(files=TRAIN_FILES):
    out = []
    for name in files:
        with open(os.path.join(REPO, name), encoding="utf-8") as f:
            out.append(f.read())
    return out


def train(kind, texts, vocab_size):
    """A ``tokenizers.Tokenizer`` of ``kind`` trained on ``texts``."""
    from tokenizers import Regex, Tokenizer, decoders, models, normalizers, pre_tokenizers
    from tokenizers import processors, trainers

    if kind == "bytelevel":
        tok = Tokenizer(models.BPE())
        tok.normalizer = normalizers.NFC()
        tok.pre_tokenizer = pre_tokenizers.Sequence([
            pre_tokenizers.Split(Regex(QWEN2_PATTERN), behavior="isolated"),
            pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=False)])
        tok.decoder = decoders.ByteLevel()
        tok.post_processor = processors.ByteLevel(trim_offsets=False)
        specials = ["<|endoftext|>", "<|im_start|>", "<|im_end|>"]
        trainer = trainers.BpeTrainer(vocab_size=vocab_size, special_tokens=specials,
                                      initial_alphabet=pre_tokenizers.ByteLevel.alphabet(),
                                      show_progress=False)
        tok.train_from_iterator(texts, trainer)
        return tok
    if kind != "bytefallback":
        raise ValueError(kind)
    tok = Tokenizer(models.BPE(unk_token="<unk>", byte_fallback=True, fuse_unk=True))
    tok.normalizer = normalizers.Sequence([normalizers.Prepend("▁"),
                                           normalizers.Replace(" ", "▁")])
    tok.decoder = decoders.Sequence([decoders.Replace("▁", " "), decoders.ByteFallback(),
                                     decoders.Fuse(), decoders.Strip(" ", 1, 0)])
    byte_tokens = [f"<0x{b:02X}>" for b in range(256)]
    trainer = trainers.BpeTrainer(vocab_size=vocab_size,
                                  special_tokens=["<unk>", "<s>", "</s>"] + byte_tokens,
                                  show_progress=False)
    tok.train_from_iterator(texts, trainer)
    tok.post_processor = processors.TemplateProcessing(single="<s> $A", pair="<s> $A <s> $B",
                                                       special_tokens=[("<s>", 1)])
    # the byte tokens are vocabulary entries, not added tokens (Llama-2)
    data = json.loads(tok.to_str())
    data["added_tokens"] = [t for t in data["added_tokens"] if t["content"] not in byte_tokens]
    return Tokenizer.from_str(json.dumps(data))


def tokenizer_config(kind):
    """``tokenizer_config.json`` of a trained tokenizer of ``kind``."""
    base = {"tokenizer_class": "PreTrainedTokenizerFast", "clean_up_tokenization_spaces": False,
            "model_max_length": 4096}
    if kind == "bytelevel":
        return {**base, "bos_token": None, "eos_token": "<|im_end|>", "pad_token": "<|endoftext|>",
                "unk_token": None, "chat_template": CHATML_TEMPLATE}
    return {**base, "bos_token": "<s>", "eos_token": "</s>", "unk_token": "<unk>",
            "pad_token": None, "chat_template": ZEPHYR_TEMPLATE}


def write(kind, out_dir, texts, vocab_size):
    os.makedirs(out_dir, exist_ok=True)
    train(kind, texts, vocab_size).save(os.path.join(out_dir, "tokenizer.json"))
    with open(os.path.join(out_dir, "tokenizer_config.json"), "w") as f:
        json.dump(tokenizer_config(kind), f, indent=2)


def main():
    for kind in KINDS:
        out = os.path.join(HERE, kind)
        write(kind, out, repo_text(), 4096)
        print(out, os.path.getsize(os.path.join(out, "tokenizer.json")), "bytes")


if __name__ == "__main__":
    sys.exit(main())
